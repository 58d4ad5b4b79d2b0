"""The port's recognition filter over a bucket (``HippoRAG._rerank_candidates``
and ``RecognitionMemoryFilter.select``), on the CPU.

- Parity with the JAX package: both packages' ``_rerank_candidates``, each
  through a stand-in ``self`` and a recording LLM of its own, receive the
  same message lists (as a multiset: calls run concurrently) and return
  equal ``top_idx``, ``top_mask``, ``sel_scores`` and ``batch_top_facts``,
  over non-ASCII facts, repeated texts, ``-inf`` padding (one entry sharing
  a row with a kept candidate), a question with no candidates, echoed,
  near-miss, malformed and failing responses, a ``link_top_k`` cut and an
  index with no facts. The fact-text table of a sample index holds each
  fact's ``json.dumps(list(triple))``.
- The executor: one per filter however many buckets and calls, sized by
  ``HippoRAG``; an LLM that mutates the messages it is handed changes
  neither the template nor the next question's messages; the pipelined
  and serial bucket drivers give equal solutions.
"""

import copy
import json
import os
import re
import threading
import types

import numpy as np
import pytest
import torch

import hipporag_tpu.hipporag as jax_hipporag
import hipporag_tpu.rerank as jax_rerank
import hipporag_tpu_torch
import hipporag_tpu_torch.hipporag as port_hipporag
import hipporag_tpu_torch.rerank as port_rerank
from hipporag_tpu_torch.datasets import load_dataset

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_QUESTION = re.compile(r"\[\[ ## question ## \]\]\n(.*?)\n\n", re.DOTALL)
_FACTS = re.compile(r"\[\[ ## fact_before_filter ## \]\]\n(.*?)\n\n", re.DOTALL)


def _shown(messages):
    """(question, facts) of a filter prompt's last message."""
    content = messages[-1]["content"]
    return _QUESTION.search(content).group(1), json.loads(_FACTS.search(content).group(1))["fact"]


def _answer(facts):
    return f"[[ ## fact_after_filter ## ]]\n{json.dumps({'fact': facts})}\n\n[[ ## completed ## ]]"


def echo(question, facts):
    return _answer(facts)


def reorder(question, facts):
    """The facts backwards, the last one twice."""
    return _answer(facts[::-1] + facts[-1:])


def near_miss(question, facts):
    """Each fact with its subject's last character dropped: none is a
    candidate's text, so each goes to the closest-match scan."""
    return _answer([[s[:-1], p, o] for s, p, o in facts])


def malformed(question, facts):
    return "[[ ## fact_after_filter ## ]]\nnot json at all\n\n[[ ## completed ## ]]" if question == "q1" else echo(
        question, facts)


def fails_once(question, facts):
    if question == "q2":
        raise RuntimeError("the LLM is down for q2")
    return reorder(question, facts)


class RecordingLLM:
    """Answers with ``respond(question, facts)``; records each call's
    messages (as JSON, when received) and keyword arguments."""

    def __init__(self, respond):
        self.respond = respond
        self.calls = []
        self._lock = threading.Lock()

    def infer(self, messages, **kwargs):
        with self._lock:
            self.calls.append((json.dumps(messages, sort_keys=True), sorted(kwargs.items())))
        return self.respond(*_shown(messages)), {}, False


FACTS = [
    ("mira voss", "born in", "calder county"),
    ("calder county", "located in", "port ellery"),
    ("zoë brandt", "lives in", "münchen"),
    ("北京", "capital of", "中国"),
    ("orin bay", "is", "a village 🐟"),
    ("tess quill", "wrote", "a novel"),
    ("lena marsh", "plays", "violin"),
    ("mira voss", "born in", "calder county"),  # a second row with row 0's text
]

# each case: (cand_idx, cand_vals, link_top_k, respond); rows past the
# questions are the bucket's padding
NEG = -np.inf
CASES = {
    "non_ascii": ([[2, 3, 4], [3, 2, 1], [0, 0, 0]], [[0.9, 0.8, 0.7], [0.6, 0.5, 0.4], [NEG, NEG, NEG]], 3, reorder),
    "same_text": ([[0, 7, 1], [7, 0, 5]], [[0.9, 0.8, 0.7], [0.6, 0.5, 0.4]], 3, echo),
    "padded_rows": ([[1, 3, 1, 5], [5, 4, 5, 2], [6, 6, 0, 1]],
                    [[0.9, 0.8, NEG, NEG], [NEG, 0.7, 0.6, NEG], [0.5, NEG, 0.4, NEG]], 4, reorder),
    "no_candidates": ([[1, 2, 3], [0, 0, 0], [4, 5, 6]], [[0.9, 0.8, 0.7], [NEG, NEG, NEG], [0.3, 0.2, 0.1]], 3, echo),
    "near_miss": ([[0, 1, 2], [3, 4, 5], [6, 1, 0]], [[0.9, 0.8, 0.7], [0.6, 0.5, 0.4], [0.3, 0.2, 0.1]], 3, near_miss),
    "malformed": ([[0, 1, 2], [3, 4, 5], [6, 1, 0]], [[0.9, 0.8, 0.7], [0.6, 0.5, 0.4], [0.3, 0.2, 0.1]], 3, malformed),
    "fails_once": ([[0, 1, 2], [3, 4, 5], [6, 1, 0]], [[0.9, 0.8, 0.7], [0.6, 0.5, 0.4], [0.3, 0.2, 0.1]], 3, fails_once),
    "link_top_k_cut": ([[0, 1, 2, 3, 4], [6, 5, 4, 3, 2]], [[0.9, 0.8, 0.7, 0.6, 0.5], [0.5, 0.4, 0.3, 0.2, 0.1]], 2,
                       reorder),
    "no_facts": ([], [], 3, echo),
    "one_question": ([[4, 1, 0]], [[0.3, 0.2, 0.1]], 3, reorder),
}


def _bucket(case):
    """(questions, cand_idx, cand_vals, link_top_k, b_pad, num_facts, respond)
    of a case, the candidates padded with one row of -inf."""
    cand_idx, cand_vals, link_top_k, respond = CASES[case]
    if not cand_idx:  # an index with no facts: [b_pad, 0] candidates
        return ["q0", "q1"], np.zeros((3, 0), np.int64), np.zeros((3, 0), np.float32), link_top_k, 3, 0, respond
    idx = np.asarray(cand_idx + [[0] * len(cand_idx[0])], np.int64)
    vals = np.asarray(cand_vals + [[NEG] * len(cand_idx[0])], np.float32)
    return [f"q{i}" for i in range(len(cand_idx))], idx, vals, link_top_k, idx.shape[0], len(FACTS), respond


def _stand_in(pkg_filter, respond):
    llm = RecordingLLM(respond)
    rag = types.SimpleNamespace(
        _fact_tuples=list(FACTS),
        _fact_texts=np.array([json.dumps(list(t)) for t in FACTS], dtype=object),
        rerank_filter=pkg_filter(llm),
    )
    return rag, llm


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_bucket_filter_matches_the_jax_package(case):
    questions, idx, vals, link_top_k, b_pad, num_facts, respond = _bucket(case)
    port, port_llm = _stand_in(port_rerank.RecognitionMemoryFilter, respond)
    ref, ref_llm = _stand_in(jax_rerank.RecognitionMemoryFilter, respond)
    got = port_hipporag.HippoRAG._rerank_candidates(port, questions, idx, vals, link_top_k, b_pad, num_facts)
    want = jax_hipporag.HippoRAG._rerank_candidates(ref, questions, idx, vals, link_top_k, b_pad, num_facts)[:4]

    assert sorted(port_llm.calls) == sorted(ref_llm.calls)
    assert len(port_llm.calls) == (len(questions) if num_facts else 0)
    assert all(kw == [("max_completion_tokens", 512), ("response_format", None)] for _, kw in port_llm.calls)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and g.shape == w.shape == (b_pad, link_top_k)
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]
    if case == "padded_rows":  # a kept row scores as its last entry: -inf here
        assert got[1][0].sum() == 2 and np.isneginf(got[2][0, got[3][0].index(FACTS[1])])
    if num_facts:
        assert got[1].sum() > 0


def test_the_fact_text_table_is_each_facts_json(tmp_path):
    docs, queries, _, _ = load_dataset("sample", os.path.join(ROOT, "data"))
    rag = hipporag_tpu_torch.HippoRAG(_config(tmp_path), device="cpu")
    rag.index(docs)
    rag.prepare_retrieval_objects()
    assert len(rag._fact_texts) == len(rag._fact_tuples) == len(rag.fact_node_keys) > 0
    assert rag._fact_texts.dtype == object
    assert list(rag._fact_texts) == [json.dumps(list(t)) for t in rag._fact_tuples]
    contents = rag.fact_embedding_store.get_rows(rag.fact_node_keys)
    assert list(rag._fact_texts) == [contents[k]["content"] for k in rag.fact_node_keys]


def _config(save_dir, **kw):
    return hipporag_tpu_torch.BaseConfig(
        llm_name="mock", embedding_model_name="mock", vector_store_type="memory",
        save_dir=str(save_dir), **kw,
    )


@pytest.fixture(scope="module")
def sample_six():
    """The sample's passages and six questions: its own three and three more."""
    docs, queries, _, _ = load_dataset("sample", os.path.join(ROOT, "data"))
    return docs, list(queries) + [f"{q.rstrip('?')} exactly?" for q in queries]


class BarrierLLM:
    """Echoes; each call waits until ``parties`` calls are in flight, so a
    bucket of that many questions needs that many workers at once."""

    def __init__(self, parties):
        self.barrier = threading.Barrier(parties, timeout=60)

    def infer(self, messages, **kwargs):
        self.barrier.wait()
        return echo(*_shown(messages)), {}, False


def test_one_executor_serves_every_bucket_and_call(tmp_path, sample_six, monkeypatch):
    made = []

    class CountingExecutor(port_rerank.ThreadPoolExecutor):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(port_rerank, "ThreadPoolExecutor", CountingExecutor)
    monkeypatch.setattr(port_hipporag, "FILTER_CALLS_PER_BUCKET", 2)
    docs, queries = sample_six
    rag = hipporag_tpu_torch.HippoRAG(_config(tmp_path, ppr_batch_size=2, pipeline_rerank=False), device="cpu")
    rag.index(docs)
    rag.rerank_filter.llm = BarrierLLM(2)
    assert rag.rerank_filter.max_workers == 2 and made == []

    def live_workers():
        (pool,) = made
        return sum(t.is_alive() for t in pool._threads)

    first = rag.retrieve(queries)  # three buckets of two questions
    after_first = live_workers()
    second = rag.retrieve(queries)
    assert len(made) == 1 and made[0]._max_workers == 2
    assert live_workers() == after_first == 2
    assert [s.docs for s in first] == [s.docs for s in second]


@pytest.mark.parametrize("pipelined, depth, workers", [(False, 2, 16), (True, 2, 32), (True, 3, 48)])
def test_the_executor_keeps_sixteen_calls_per_bucket_in_flight(tmp_path, pipelined, depth, workers):
    cfg = _config(tmp_path, pipeline_rerank=pipelined, pipeline_depth=depth)
    assert hipporag_tpu_torch.HippoRAG(cfg, device="cpu").rerank_filter.max_workers == workers


class MutatingLLM:
    """Echoes, then mangles the messages it was handed."""

    def __init__(self):
        self.seen = []
        self._lock = threading.Lock()

    def infer(self, messages, **kwargs):
        with self._lock:
            self.seen.append(json.dumps(messages))
        out = echo(*_shown(messages))
        for m in messages:
            m["content"] += " (mangled)"
            m["role"] = "mangled"
        messages.append({"role": "user", "content": "extra"})
        del messages[0]
        return out, {}, False


@pytest.mark.parametrize("questions", [1, 4], ids=["inline", "executor"])
def test_an_llm_that_mutates_its_messages_changes_no_later_prompt(questions):
    mutating, clean = MutatingLLM(), MutatingLLM()
    filt = port_rerank.RecognitionMemoryFilter(mutating)
    template = copy.deepcopy(filt.message_template)
    qs = [f"question {i}?" for i in range(questions)]
    cands = [[json.dumps(list(FACTS[(i + j) % 7])) for j in range(3)] for i in range(questions)]
    for _ in range(3):
        assert filt.select(qs, cands) == [[0, 1, 2]] * questions
    assert filt.message_template == template
    port_rerank.RecognitionMemoryFilter(clean).select(qs, cands)
    assert sorted(mutating.seen) == sorted(clean.seen * 3)


def test_pipelined_and_serial_buckets_give_equal_solutions(tmp_path, sample_six):
    docs, queries = sample_six
    rag = hipporag_tpu_torch.HippoRAG(_config(tmp_path, ppr_batch_size=2, pipeline_rerank=False), device="cpu")
    rag.index(docs)
    serial = rag.retrieve(queries)
    rag.global_config.pipeline_rerank = True
    pipelined = rag.retrieve(queries)
    assert len(serial) == len(pipelined) == len(queries)
    assert any(s.graph_seeds for s in serial)
    for s, p in zip(serial, pipelined):
        assert (s.question, s.docs, s.doc_metadata, s.graph_seeds) == (p.question, p.docs, p.doc_metadata,
                                                                      p.graph_seeds)
        assert s.doc_scores.dtype == p.doc_scores.dtype
        np.testing.assert_array_equal(s.doc_scores, p.doc_scores)


def test_the_closest_match_scan_matches_difflib_and_the_jax_package():
    """The scan a generated fact takes when no candidate text equals it
    (and, called directly, on an exact echo too) picks what
    ``difflib.get_close_matches(n=1, cutoff=0.0)`` + ``.index`` picks, as
    the JAX package's does: duplicates, ties and empty strings included."""
    import difflib
    import random

    def reference(s, cands):
        m = difflib.get_close_matches(s, cands, n=1, cutoff=0.0)
        return cands.index(m[0]) if m else None

    rnd = random.Random(11)

    def rand_str():
        return "".join(rnd.choice("abcdef") for _ in range(rnd.randint(0, 8)))

    cases = [("abc", ["abc", "abd", "abc"]), ("abc", ["xyz", "abd", "acb"]), ("", ["", "a", ""]),
             ("aa", ["ab", "ba"]), ("q", [])]
    cases += [(rand_str(), [rand_str() for _ in range(rnd.randint(1, 12))]) for _ in range(300)]
    cases += [(c[rnd.randrange(len(c))], c) for _, c in cases[5:100]]  # exact echoes
    for s, cands in cases:
        want = reference(s, cands)
        assert port_rerank._closest_candidate(s, cands) == jax_rerank._closest_candidate(s, cands) == want, (s, cands)


def test_concurrent_buckets_share_one_executor(monkeypatch):
    """Sixteen callers filtering at once, with the interpreter switching
    threads as often as it can: the first use makes one executor, and each
    caller gets its own questions' facts back. (Making the executor is
    slowed, so that callers that raced past an unguarded first use would
    each make one.)"""
    import sys
    import time

    made = []

    class CountingExecutor(port_rerank.ThreadPoolExecutor):
        def __init__(self, *args, **kwargs):
            time.sleep(0.05)
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(port_rerank, "ThreadPoolExecutor", CountingExecutor)
    filt = port_rerank.RecognitionMemoryFilter(RecordingLLM(reorder), max_workers=4)
    callers, start = 16, threading.Barrier(16, timeout=60)
    got = [None] * callers

    def bucket(c):
        qs = [f"caller {c} question {i}" for i in range(3)]
        cands = [[json.dumps(list(FACTS[(c + i + j) % 7])) for j in range(3)] for i in range(3)]
        start.wait()
        got[c] = filt.select(qs, cands)

    old = sys.getswitchinterval()
    try:
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=bucket, args=(c,)) for c in range(callers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(made) == 1 and len(filt.llm.calls) == 3 * callers
    assert got == [[[2, 1, 0]] * 3] * callers
