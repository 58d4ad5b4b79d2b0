"""The port's span recorder (``utils/timing``) and the spans of its retrieve
path, on the CPU.

A ``retrieve`` under ``recording()`` gives one call's tree of stage spans,
serially, with the filter pipelined on worker threads and on a mesh of
virtual shards; with recording off it records nothing and opens no
profiler range; under a profiler every span is a ``user_annotation`` of
its name at the same time. Result building counts the passages it places.
The filter counts its candidates, the facts it kept and the generated
facts it matched by the closest-match scan (``facts_fuzzy``). The PageRank solvers count per tile the
iterations they return, and rankings do not depend on recording.
"""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

import hipporag_tpu_torch
from hipporag_tpu_torch.datasets import load_dataset
from hipporag_tpu_torch.models.retrieval import graph_search_batch
from hipporag_tpu_torch.ops import pagerank
from hipporag_tpu_torch.utils import timing
from hipporag_tpu_torch.utils.timing import StageTimers, count, dropped_spans, recording, span, spans

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKET_SPANS = {"retrieve/fact_topk", "retrieve/filter", "retrieve/graph_search", "retrieve/build_result"}
SEARCH_SPANS = {"retrieve/seeds", "retrieve/ppr", "retrieve/doc_topk"}
STAGES = {"retrieve", "retrieve/embed"} | BUCKET_SPANS | SEARCH_SPANS
BUCKET = 2  # ppr_batch_size: the sample's three questions make two buckets


def _config(save_dir, **kw):
    return hipporag_tpu_torch.BaseConfig(
        llm_name="mock", embedding_model_name="mock", vector_store_type="memory",
        save_dir=str(save_dir), ppr_batch_size=BUCKET, pipeline_rerank=False, **kw,
    )


@pytest.fixture(scope="module")
def sample():
    docs, queries, _, _ = load_dataset("sample", os.path.join(ROOT, "data"))
    return docs, queries


def _indexed(tmp_path_factory, sample, name, **kw):
    docs, queries = sample
    rag = hipporag_tpu_torch.HippoRAG(_config(tmp_path_factory.mktemp(name), **kw), device="cpu")
    rag.index(docs)
    return rag, rag.retrieve(queries)  # recording off


@pytest.fixture(scope="module")
def single(tmp_path_factory, sample):
    return _indexed(tmp_path_factory, sample, "single")


@pytest.fixture(scope="module")
def sharded(tmp_path_factory, sample):
    return _indexed(tmp_path_factory, sample, "sharded", mesh_shape=(1, 2))


def _check_call(recorded, queries, results):
    """One call's spans: the stage names, one root and call id, parents
    that enclose their children, and bucket attrs; each bucket's
    ``retrieve/build_result`` counts as ``docs`` the passages of its results."""
    by_id = {s.span_id: s for s in recorded}
    (root,) = [s for s in recorded if s.parent_id is None]
    assert root.name == "retrieve" and root.call_id == root.span_id
    assert root.attrs["questions"] == len(queries)
    assert {s.call_id for s in recorded} == {root.span_id}
    assert {s.name for s in recorded} == STAGES
    for s in recorded:
        if s is root:
            continue
        parent = by_id[s.parent_id]
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns, (s.name, parent.name)
        want = "retrieve/graph_search" if s.name in SEARCH_SPANS else "retrieve"
        assert parent.name == want, s.name
    n_buckets = -(-len(queries) // BUCKET)
    for name in BUCKET_SPANS:
        assert sorted(s.attrs["bucket"] for s in recorded if s.name == name) == list(range(n_buckets)), name
    for name in SEARCH_SPANS:
        assert len([s for s in recorded if s.name == name]) == n_buckets, name
    topk = {s.attrs["bucket"]: s.attrs for s in recorded if s.name == "retrieve/fact_topk"}
    built = {s.attrs["bucket"]: s.attrs["results"] for s in recorded if s.name == "retrieve/build_result"}
    assert sum(a["b_real"] for a in topk.values()) == len(queries)
    assert all(a["b_pad"] >= a["b_real"] for a in topk.values())
    assert built == {b: a["b_real"] for b, a in topk.items()}
    placed = {s.attrs["bucket"]: s.attrs["docs"] for s in recorded if s.name == "retrieve/build_result"}
    assert placed == {
        b: sum(len(r.docs) for r in results[b * BUCKET : (b + 1) * BUCKET]) for b in range(n_buckets)
    }
    assert sum(placed.values()) > 0
    for s in recorded:
        if s.name == "retrieve/filter":
            assert s.attrs["candidates"] >= s.attrs["facts_kept"] > 0
        if s.name == "retrieve/ppr":
            assert s.attrs["iterations"] >= s.attrs["tiles"] >= 1


def _same_rankings(got, want):
    assert [s.docs for s in got] == [s.docs for s in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.doc_scores, w.doc_scores)


@pytest.mark.parametrize("pipelined", [False, True], ids=["serial", "pipeline_rerank"])
def test_retrieve_records_one_call_of_stage_spans(single, sample, pipelined):
    rag, off = single
    queries = sample[1]
    rag.global_config.pipeline_rerank = pipelined
    try:
        with recording() as rec:
            on = rag.retrieve(queries)
    finally:
        rag.global_config.pipeline_rerank = False
    _check_call(rec.spans(), queries, on)
    _same_rankings(on, off)


def test_the_sharded_path_records_the_same_stages(sharded, sample):
    rag, off = sharded
    assert rag._backend.mesh.corpus == 2
    with recording() as rec:
        on = rag.retrieve(sample[1])
    _check_call(rec.spans(), sample[1], on)
    _same_rankings(on, off)


class _FilterLLM:
    """Answers the filter with the facts it was shown, echoed or each with
    its subject's last character dropped; counts the facts shown."""

    def __init__(self, paraphrase):
        self.paraphrase, self.shown = paraphrase, 0
        self._lock = threading.Lock()

    def infer(self, messages, **kwargs):
        shown = messages[-1]["content"].split("[[ ## fact_before_filter ## ]]\n", 1)[1].split("\n\n", 1)[0]
        facts = json.loads(shown)["fact"]
        with self._lock:
            self.shown += len(facts)
        if self.paraphrase:
            facts = [[s[:-1], p, o] for s, p, o in facts]
        return f"[[ ## fact_after_filter ## ]]\n{json.dumps({'fact': facts})}\n\n[[ ## completed ## ]]", {}, False


@pytest.mark.parametrize("paraphrase", [False, True], ids=["echo", "paraphrase"])
def test_the_filter_counts_its_candidates_kept_and_fuzzy_facts(single, sample, paraphrase):
    """Each bucket's ``retrieve/filter`` counts as ``facts_fuzzy`` the
    generated facts no candidate text equals: none from an echo, every
    fact from a paraphrase. ``candidates`` are the facts shown and
    ``facts_kept`` those its results carry; an echo keeps them all."""
    rag, _ = single
    queries = sample[1]
    llm, held = _FilterLLM(paraphrase), rag.rerank_filter.llm
    rag.rerank_filter.llm = llm
    try:
        with recording() as rec:
            results = rag.retrieve(queries)
    finally:
        rag.rerank_filter.llm = held
    filters = {s.attrs["bucket"]: s.attrs for s in rec.spans() if s.name == "retrieve/filter"}
    assert sorted(filters) == list(range(-(-len(queries) // BUCKET)))
    for b, attrs in filters.items():
        kept = sum(len(r.graph_seeds) for r in results[b * BUCKET : (b + 1) * BUCKET])
        assert attrs["facts_kept"] == kept > 0
        assert attrs["facts_fuzzy"] == (attrs["candidates"] if paraphrase else 0)
        if not paraphrase:
            assert attrs["candidates"] == kept
    assert sum(a["candidates"] for a in filters.values()) == llm.shown > 0


class _CountingRange(torch.autograd.profiler.record_function):
    entered = []

    def __enter__(self):
        _CountingRange.entered.append(self.name)
        return super().__enter__()


def test_with_recording_off_nothing_is_recorded(single, sample, monkeypatch):
    rag, off = single
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _CountingRange)
    _CountingRange.entered = []
    before, dropped = spans(), dropped_spans()
    _same_rankings(rag.retrieve(sample[1]), off)
    with span("outside") as opened:
        count("n")
    assert opened is None and spans() == before and dropped_spans() == dropped
    assert _CountingRange.entered == []


def _profiled_call(rag, queries, path):
    """One profiled retrieve: (its rankings, its spans from the log, start
    ns of each user_annotation of the exported trace by name)."""
    _CountingRange.entered = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sols = rag.retrieve(queries)
    log = spans()
    root = [s for s in log if s.name == "retrieve" and s.parent_id is None][-1]
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        trace = json.load(fh)
    base = int(trace.get("baseTimeNanoseconds", 0))
    starts = {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            starts.setdefault(e["name"], []).append(base + round(float(e["ts"]) * 1000))
    return sols, [s for s in log if s.call_id == root.call_id], starts


def test_spans_lie_on_the_profiler_timeline(single, sample, monkeypatch, tmp_path):
    """Each span of a profiled serial call is a user_annotation of its name,
    whose start, mapped through the trace's baseTimeNanoseconds, is the
    span's within 100 us. (The profiler follows the thread that started
    it: spans on ``pipeline_rerank``'s worker threads are logged but are
    not in its trace.) A first profiled range in the process sets the
    profiler up and is left out. A thread descheduled between the two
    clock readings of one span puts that span off by the pause, so the
    timing holds in one of three calls; a second clock would put every
    call off."""
    rag, off = single
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("warm-up"):
            pass
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _CountingRange)
    worst = []
    for attempt in range(3):
        on, recorded, starts = _profiled_call(rag, sample[1], tmp_path / f"trace-{attempt}.json")
        _same_rankings(on, off)
        _check_call(recorded, sample[1], on)
        assert sorted(_CountingRange.entered) == sorted(s.name for s in recorded)
        for s in recorded:
            assert len(starts[s.name]) == len([r for r in recorded if r.name == s.name]), s.name
        worst.append(max(min(abs(t - s.start_ns) for t in starts[s.name]) for s in recorded))
        if worst[-1] <= 100_000:
            break
    assert min(worst) <= 100_000, worst


def _graph(num_nodes=300, num_edges=2400, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_nodes, num_edges)
    dst = rng.integers(0, num_nodes, num_edges)
    keep = src != dst
    node_cap = -(-(num_nodes + 1) // 128) * 128
    s2, d2, w2, dang = pagerank.normalize_symmetric_coo(
        src[keep], dst[keep], rng.uniform(0.1, 1.0, keep.sum()), num_nodes, node_cap)
    return s2, d2, w2, dang, num_nodes, node_cap


def _tile_iterations(iters):
    starts = range(0, iters.shape[0], 128)
    return len(starts), int(sum(int(iters[s]) for s in starts))


@pytest.mark.parametrize("solver", ["power", "chebyshev", "coo"])
def test_the_solver_counts_each_tile_and_its_iterations(solver):
    s2, d2, w2, dang, n, cap = _graph()
    rng = np.random.default_rng(1)
    reset = torch.from_numpy(rng.uniform(0.0, 1.0, (200, cap)).astype(np.float32))  # two tiles
    with recording() as rec:
        with span("retrieve/ppr"):
            if solver == "coo":
                graph = pagerank.COOGraph(s2, d2, w2, dang, np.int32(n)).to("cpu")
                _, iters = pagerank.batched_ppr(graph, reset, tol=1e-6, return_iters=True)
            else:
                graph = pagerank.ell_from_coo(s2, d2, w2, dang, n, cap)
                _, iters = pagerank.batched_ppr_ell(graph, reset, tol=1e-6, accel=solver, return_iters=True)
    (ppr,) = rec.spans()
    tiles, iterations = _tile_iterations(iters)
    # the ELL solver also counts the iterations its step kernel solved: none on the CPU
    kernel = {} if solver == "coo" else {"kernel_iterations": 0}
    assert tiles == 2 and ppr.attrs == {"tiles": tiles, "iterations": iterations, **kernel}


def test_graph_search_counts_the_iterations_it_returns(single):
    rag, _ = single
    index = rag._backend.index
    rng = np.random.default_rng(2)
    b, k = 130, 5
    sel = torch.from_numpy(rng.uniform(0.1, 1.0, (b, k)).astype(np.float32))
    top = torch.from_numpy(rng.integers(0, index.num_facts, (b, k)).astype(np.int32))
    mask = torch.ones(b, k)
    dpr = torch.from_numpy(rng.uniform(0.0, 1.0, (b, index.passage_node_ids.shape[0])).astype(np.float32))
    with recording() as rec:
        _, iters = graph_search_batch(index, sel, top, mask, dpr, link_top_k=k, ppr_tol=1e-6, return_iters=True)
    by_name = {s.name: s for s in rec.spans()}
    assert set(by_name) == {"retrieve/seeds", "retrieve/ppr"}
    tiles, iterations = _tile_iterations(iters)
    assert by_name["retrieve/ppr"].attrs == {"tiles": tiles, "iterations": iterations,
                                             "kernel_iterations": 0} and tiles == 2


def test_the_log_keeps_its_newest_spans_and_counts_the_rest():
    try:
        timing.reset_spans(capacity=4)
        with recording() as rec:
            for i in range(10):
                with span("s", i=i):
                    count("n", 2)
        assert [s.attrs for s in spans()] == [{"i": i, "n": 2} for i in range(6, 10)]
        assert [s.attrs["i"] for s in rec.spans()] == [6, 7, 8, 9] and dropped_spans() == 6
        timing.reset_spans(capacity=4)
        assert spans() == [] and dropped_spans() == 0
    finally:
        timing.reset_spans()


def test_concurrent_spans_lose_no_record_or_count():
    """Threads opening nested spans at once: every span is kept or counted
    as dropped, each keeps its own counts, and a child's parent is its own
    thread's root."""
    threads_n, per_thread = 16, 200
    old = sys.getswitchinterval()
    try:
        timing.reset_spans(capacity=256)
        sys.setswitchinterval(1e-6)

        def work():
            for _ in range(per_thread):
                with span("outer"):
                    with span("inner"):
                        count("n")
                        count("n", 2)
                    count("m")

        with recording():
            threads = [threading.Thread(target=work) for _ in range(threads_n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        kept = spans()
        assert len(kept) + dropped_spans() == 2 * threads_n * per_thread and len(kept) == 256
        for s in kept:
            if s.name == "inner":
                assert s.attrs == {"n": 3} and s.parent_id == s.call_id != s.span_id
            else:
                assert s.attrs == {"m": 1} and s.parent_id is None and s.call_id == s.span_id
    finally:
        sys.setswitchinterval(old)
        timing.reset_spans()


def test_stage_timers_track_a_span_and_keep_their_totals():
    timers = StageTimers()
    with recording() as rec:
        with timers.track("index/openie"):
            count("rows", 5)
    with timers.track("index/openie"):
        pass
    (s,) = rec.spans()
    assert s.name == "index/openie" and s.attrs == {"rows": 5}
    assert timers.counts["index/openie"] == 2 and timers.totals["index/openie"] >= s.seconds
