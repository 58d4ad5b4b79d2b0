"""The port's dataset-scale harnesses against the JAX package's, on a small
in-test corpus in the 2WikiMultihopQA corpus schema (``[{"title", "text"}]``).

The corpus is made from a numpy seed: 48 passages whose texts name other
passages' titles, so the 2wiki query synthesis finds bridge pairs and the
mock OpenIE links them. Through both packages: the 2wiki query synthesis,
the hotpotqa and musique sample synthesis (the files they write, and the
gold docs the port's loader rebuilds from them), and the whole
``run_2wiki_eval`` (NumPy twin and exact-solver check included),
``run_hotpot_eval`` and ``run_musique_eval``. Their numbers must be equal;
only wall-clock fields differ. The replay-quality harness needs the
2WikiMultihopQA corpus and the recorded LLM responses, and skips without
them, as the JAX package's test does.
"""

import json
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)

MEMORY = {"vector_store_type": "memory", "embedding_dim": 256}
TIMING_KEYS = {"index_s", "retrieve_s", "twin_s", "check_s"}


def _corpus(n=48, seed=0):
    rng = np.random.default_rng(seed)
    first = ["Aldric", "Belmonte", "Corvina", "Dunmore", "Elspeth", "Farrowe", "Galloway", "Hartwell"]
    last = ["Ashcombe", "Blackwood", "Carraway", "Davenport", "Ellsworth", "Fairbanks"]
    titles = [f"{a} {b}" for a in first for b in last][:n]
    rng.shuffle(titles)
    places = ["Norwick", "Tallis Bay", "Ormond", "Kestrel Fen", "Marrow Cross", "Quillon"]
    jobs = ["painter", "engineer", "botanist", "composer", "cartographer", "sailor"]
    corpus = []
    for i, title in enumerate(titles):
        links = [titles[(i * 7 + 3) % n], titles[(i * 11 + 5) % n]]
        links = [t for t in dict.fromkeys(links) if t != title]
        text = (f"{title} was a {jobs[rng.integers(len(jobs))]} from {places[rng.integers(len(places))]}. "
                f"In later years the work was shaped by {links[0]}, who taught there. ")
        if len(links) > 1:
            text += f"Letters to {links[1]} survive in the archive. "
        text += f"The family kept a house near {places[rng.integers(len(places))]} for decades."
        corpus.append({"title": title, "text": text})
    return corpus


@pytest.fixture(scope="module")
def corpus_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("corpus") / "2wikimultihopqa_corpus.json"
    path.write_text(json.dumps(_corpus()))
    return str(path)


def _without_timings(d):
    if isinstance(d, dict):
        return {k: _without_timings(v) for k, v in d.items() if k not in TIMING_KEYS}
    return d


def test_twiki_synthesis_matches_jax(corpus_path):
    from hipporag_tpu.evaluation import twiki as ref
    from hipporag_tpu_torch.evaluation import twiki as port

    corpus = port.load_corpus(corpus_path)
    assert corpus == ref.load_corpus(corpus_path)
    assert [port.doc_text(c) for c in corpus] == [ref.doc_text(c) for c in corpus]
    got = port.synthesize_multihop_queries(corpus, max_queries=30)
    assert got == ref.synthesize_multihop_queries(corpus, max_queries=30)
    assert len(got) >= 20
    for question, golds, bridge in got:
        assert bridge not in question and golds[1].split("\n")[0] == bridge


def test_run_2wiki_eval_matches_jax(corpus_path, tmp_path):
    from hipporag_tpu.evaluation.twiki import run_2wiki_eval as ref_run
    from hipporag_tpu_torch.evaluation.twiki import run_2wiki_eval as port_run

    kw = dict(n_queries=0, exact_queries=0, config_overrides=MEMORY)
    want = ref_run(corpus_path, str(tmp_path / "ref"), **kw)
    got = port_run(corpus_path, str(tmp_path / "port"), device="cpu", **kw)
    assert _without_timings(got) == _without_timings(want)
    assert got["exact"]["solver"] == "native_ppr_serial" and got["rank_agreement"] == 1.0
    assert got["num_queries"] >= 20


def test_split_sentences_reconstructs_exactly():
    from hipporag_tpu.evaluation.hotpot_synth import split_sentences as ref_split
    from hipporag_tpu_torch.evaluation.hotpot_synth import split_sentences

    for text in ("One. Two! Three? Four", "No punctuation at all", "Trailing. ",
                 "Multi  space.  And\ttabs.\nNewlines too. end", "...", ""):
        assert "".join(split_sentences(text)) == text
        assert split_sentences(text) == ref_split(text)


def test_hotpot_samples_and_files_match_jax(corpus_path, tmp_path):
    from hipporag_tpu.evaluation import hotpot_synth as ref
    from hipporag_tpu_torch.datasets import load_dataset
    from hipporag_tpu_torch.evaluation import hotpot_synth as port
    from hipporag_tpu_torch.evaluation.twiki import load_corpus

    corpus = load_corpus(corpus_path)
    samples = port.synthesize_hotpot_samples(corpus)
    assert samples == ref.synthesize_hotpot_samples(corpus)
    assert {s["type"] for s in samples} == {"bridge", "comparison"}
    port.write_hotpot_files(corpus, samples, str(tmp_path / "port"))
    ref.write_hotpot_files(corpus, samples, str(tmp_path / "ref"))
    for name in (f"{port.DATASET_NAME}.json", f"{port.DATASET_NAME}_corpus.json"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "ref" / name).read_text()
    docs, questions, gold_docs, _answers = load_dataset(port.DATASET_NAME, str(tmp_path / "port"))
    assert len(docs) == len(corpus) and len(questions) == len(samples)
    assert all(len(g) == 2 and set(g) <= set(docs) for g in gold_docs)


def test_run_hotpot_eval_matches_jax(corpus_path, tmp_path):
    from hipporag_tpu.evaluation.hotpot_synth import run_hotpot_eval as ref_run
    from hipporag_tpu_torch.evaluation.hotpot_synth import run_hotpot_eval as port_run

    want = ref_run(corpus_path, str(tmp_path / "ref"), config_overrides=MEMORY)
    got = port_run(corpus_path, str(tmp_path / "port"), config_overrides=MEMORY, device="cpu")
    assert _without_timings(got) == _without_timings(want)
    assert set(got["by_type"]) == {"bridge", "comparison"}


def test_musique_samples_match_jax(corpus_path, tmp_path):
    from hipporag_tpu.evaluation import musique_synth as ref
    from hipporag_tpu_torch.datasets import get_gold_docs, load_dataset
    from hipporag_tpu_torch.evaluation import musique_synth as port
    from hipporag_tpu_torch.evaluation.twiki import load_corpus

    corpus = load_corpus(corpus_path)
    samples = port.synthesize_musique_samples(corpus)
    assert samples == ref.synthesize_musique_samples(corpus)
    assert [port.to_contexts_schema(s) for s in samples] == [ref.to_contexts_schema(s) for s in samples]
    for s in samples:
        assert len(s["paragraphs"]) == port.PARAGRAPHS_PER_SAMPLE
        assert sum(p["is_supporting"] for p in s["paragraphs"]) == 2
    port.write_musique_files(corpus, samples, str(tmp_path))
    docs, _questions, gold_docs, _answers = load_dataset(port.DATASET_NAME, str(tmp_path))
    assert all(len(g) == 2 and set(g) <= set(docs) for g in gold_docs)
    assert get_gold_docs([port.to_contexts_schema(s) for s in samples], port.DATASET_NAME) == gold_docs


def test_run_musique_eval_matches_jax(corpus_path, tmp_path):
    from hipporag_tpu.evaluation.musique_synth import run_musique_eval as ref_run
    from hipporag_tpu_torch.evaluation.musique_synth import run_musique_eval as port_run

    want = ref_run(corpus_path, str(tmp_path / "ref"), config_overrides=MEMORY)
    got = port_run(corpus_path, str(tmp_path / "port"), config_overrides=MEMORY, device="cpu")
    assert _without_timings(got) == _without_timings(want)


def _quality_inputs():
    from hipporag_tpu_torch.evaluation.replay_quality import QUALITY_CORPUS

    fixture = os.path.join(ROOT, "tests", "fixtures", "replay_2wiki_quality_cache.sqlite")
    return fixture, QUALITY_CORPUS


@pytest.mark.skipif(not all(os.path.exists(p) for p in _quality_inputs()),
                    reason="quality fixture or 2wiki corpus not present")
def test_replay_quality_matches_jax(tmp_path):
    from hipporag_tpu.evaluation.replay_quality import run_replay_quality_eval as ref_run
    from hipporag_tpu_torch.evaluation.replay_quality import run_replay_quality_eval as port_run

    fixture, corpus = _quality_inputs()
    want = ref_run(fixture, str(tmp_path / "ref"), corpus_path=corpus)
    got = port_run(fixture, str(tmp_path / "port"), corpus_path=corpus, device="cpu")
    assert _without_timings(got) == _without_timings(want)
