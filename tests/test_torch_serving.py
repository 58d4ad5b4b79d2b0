"""The port's serving layer against the JAX package's serving tests.

The non-sharded cases of ``tests/test_serving.py``, run on the port: the
micro-batcher's semantics, the service facade over the port's ``HippoRAG``
and ``StandardRAG`` on the CPU (parity with the direct batch path,
per-request top_k, hot-query dedup, both lanes, the LRU response cache and
its generation guard, online index and delete, shedding, the closed
service, a soak), and the HTTP contract on both front ends (stdlib threads
and the C++ epoll loop, built here from the port's copy of the source with
``make``). A cross-package case posts one request sequence to both
packages' ``dispatch`` on the sample corpus and requires identical status
codes and JSON bodies (scores to 1e-5). The two sharded serving cases run
a ``mesh_shape=(2, 4)`` engine on eight CPU virtual shards.
"""

import json
import os
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from hipporag_tpu_torch import BaseConfig, HippoRAG, load_dataset
from hipporag_tpu_torch.parallel.backend import ShardedBackend
from hipporag_tpu_torch.serving import (
    BatcherClosed,
    BatcherSaturated,
    MicroBatcher,
    RetrievalService,
)
from hipporag_tpu_torch.serving.http_server import make_server

torch.set_num_threads(1)

DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "data")


def _config(**kw):
    """The JAX tests' configuration on the port, with the memory store."""
    return BaseConfig(llm_name="mock", embedding_model_name="mock", vector_store_type="memory", **kw)


def _make_frontend(kind, svc):
    """Build a server of the requested front-end kind (stdlib or native C++
    epoll); both must honor the same wire contract. Skips if the native
    library can't be built in this environment."""
    if kind == "stdlib":
        return make_server(svc, port=0)
    from hipporag_tpu_torch.serving.native_http import make_native_server

    try:
        return make_native_server(svc, port=0, num_workers=8)
    except RuntimeError as exc:  # no C++ toolchain in this image
        pytest.skip(f"native front-end unavailable: {exc}")


# ======================================================================
# MicroBatcher unit tests
# ======================================================================


def test_batcher_result_alignment():
    mb = MicroBatcher(lambda xs: [x * 2 for x in xs], max_wait_ms=0)
    try:
        futs = [mb.submit(i) for i in range(20)]
        assert [f.result(timeout=10) for f in futs] == [2 * i for i in range(20)]
    finally:
        mb.close()


def test_batcher_coalesces_concurrent_callers():
    calls = []

    def fn(xs):
        calls.append(len(xs))
        time.sleep(0.02)  # hold the "device" so later arrivals pile up
        return xs

    mb = MicroBatcher(fn, max_batch_size=64, max_wait_ms=50)
    try:
        with ThreadPoolExecutor(max_workers=16) as pool:
            out = list(pool.map(lambda i: mb(i, timeout=30), range(32)))
        assert sorted(out) == list(range(32))
        st = mb.stats()
        assert st["requests"] == 32
        assert st["batches"] < 32, f"no coalescing happened: {st}"
        assert st["mean_batch_size"] > 1
    finally:
        mb.close()


def test_batcher_max_batch_respected():
    sizes = []
    release = threading.Event()

    def fn(xs):
        sizes.append(len(xs))
        release.wait(5)
        return xs

    mb = MicroBatcher(fn, max_batch_size=4, max_wait_ms=0)
    try:
        futs = [mb.submit(i) for i in range(10)]
        release.set()
        for f in futs:
            f.result(timeout=10)
        assert max(sizes) <= 4
        assert sum(sizes) == 10
    finally:
        mb.close()


def test_batcher_exception_fails_batch_but_keeps_serving():
    def fn(xs):
        if any(x < 0 for x in xs):
            raise ValueError("negative")
        return xs

    mb = MicroBatcher(fn, max_wait_ms=0)
    try:
        bad = mb.submit(-1)
        with pytest.raises(ValueError):
            bad.result(timeout=10)
        assert mb.submit(7).result(timeout=10) == 7
        assert mb.stats()["failed_batches"] == 1
    finally:
        mb.close()


def test_batcher_wrong_length_result_fails_batch():
    mb = MicroBatcher(lambda xs: xs[:-1] if len(xs) > 0 else xs, max_wait_ms=0)
    try:
        with pytest.raises(RuntimeError, match="results"):
            mb.submit(1).result(timeout=10)
    finally:
        mb.close()


def test_batcher_close_drains_then_rejects():
    done = []

    def fn(xs):
        time.sleep(0.01)
        done.extend(xs)
        return xs

    mb = MicroBatcher(fn, max_wait_ms=100)
    futs = [mb.submit(i) for i in range(5)]
    mb.close()  # must drain queued work, not drop it
    assert sorted(f.result(timeout=1) for f in futs) == list(range(5))
    assert sorted(done) == list(range(5))
    with pytest.raises(BatcherClosed):
        mb.submit(99)


def test_batcher_sheds_load_at_max_pending():
    release = threading.Event()

    def fn(xs):
        release.wait(5)
        return xs

    mb = MicroBatcher(fn, max_batch_size=2, max_wait_ms=0, max_pending=3)
    try:
        first = mb.submit(0)
        # wait (not sleep-and-hope) until the worker drained item 0 into
        # its in-flight batch, so the queue is empty before we fill it
        deadline = time.time() + 5
        while mb.stats()["pending"] and time.time() < deadline:
            time.sleep(0.005)
        assert mb.stats()["pending"] == 0
        kept = [mb.submit(i) for i in range(1, 4)]  # fills the queue
        with pytest.raises(BatcherSaturated):
            mb.submit(99)
        assert mb.stats()["shed"] == 1
        release.set()
        assert first.result(timeout=10) == 0
        assert [f.result(timeout=10) for f in kept] == [1, 2, 3]
    finally:
        mb.close()


# ======================================================================
# RetrievalService over a real (mock-provider) HippoRAG index
# ======================================================================


@pytest.fixture(scope="module")
def served_rag(tmp_path_factory):
    docs, queries, gold_docs, _ = load_dataset("sample", DATA_DIR)
    cfg = _config(
        save_dir=str(tmp_path_factory.mktemp("serve")),
        embedding_dim=96,
        ppr_batch_size=8,
        retrieval_top_k=9,
    )
    rag = HippoRAG(global_config=cfg, device="cpu")
    rag.index(docs)
    return rag, queries


def test_service_matches_direct_retrieve(served_rag):
    rag, queries = served_rag
    direct = rag.retrieve(list(queries))
    with RetrievalService(rag, max_wait_ms=20) as svc:
        with ThreadPoolExecutor(max_workers=len(queries)) as pool:
            served = list(pool.map(svc.retrieve, queries))
    for d, s in zip(direct, served):
        assert s.question == d.question
        assert s.docs == d.docs
        np.testing.assert_allclose(s.doc_scores, d.doc_scores, rtol=1e-5)


def test_service_per_request_top_k(served_rag):
    rag, queries = served_rag
    with RetrievalService(rag, max_wait_ms=50) as svc:
        with ThreadPoolExecutor(max_workers=2) as pool:
            f_small = pool.submit(svc.retrieve, queries[0], 2)
            f_big = pool.submit(svc.retrieve, queries[1], 7)
            small, big = f_small.result(timeout=60), f_big.result(timeout=60)
    assert len(small.docs) == 2 and len(small.doc_scores) == 2
    assert len(big.docs) == 7
    st = rag  # noqa: F841 — keep fixture alive for later tests


def test_service_hot_query_dedup(served_rag):
    # N concurrent clients asking the SAME question cost one device row
    rag, queries = served_rag
    direct = rag.retrieve([queries[0]])[0]
    with RetrievalService(rag, max_wait_ms=100) as svc:
        with ThreadPoolExecutor(max_workers=8) as pool:
            sols = list(pool.map(lambda _: svc.retrieve(queries[0]), range(8)))
        st = svc.stats()
    assert all(s.docs == direct.docs for s in sols)
    # isolation: one caller mutating its response must not corrupt another
    # caller's (ndarray slices are views unless copied) or the engine's
    assert len({id(s) for s in sols}) == 8
    before = sols[1].doc_scores[0]
    sols[0].doc_scores[0] = -123.0
    sols[0].docs[0] = "clobbered"
    assert sols[1].doc_scores[0] == before
    assert sols[1].docs[0] == direct.docs[0]
    assert st["dedup_saved"] >= 1, st


def test_service_mixed_lanes_concurrent(served_rag):
    # retrieve and qa lanes have separate workers but share one engine;
    # hammer both at once and check results stay correct (engine lock)
    rag, queries = served_rag
    direct = rag.retrieve(list(queries))
    expect = {d.question: d.docs for d in direct}
    with RetrievalService(rag, max_wait_ms=5) as svc:

        def worker(i):
            q = queries[i % len(queries)]
            if i % 3 == 0:
                sol = svc.qa(q, top_k=3)
                assert sol.answer and len(sol.docs) == 3
            else:
                sol = svc.retrieve(q)
                assert sol.docs == expect[q]

        with ThreadPoolExecutor(max_workers=12) as pool:
            list(pool.map(worker, range(36)))
        st = svc.stats()
        assert st["retrieve"]["requests"] == 24
        assert st["qa"]["requests"] == 12


def test_service_qa_and_stats(served_rag):
    rag, queries = served_rag
    with RetrievalService(rag, max_wait_ms=10) as svc:
        sol = svc.qa(queries[0], top_k=3)
        assert sol.answer  # mock LLM always answers
        assert len(sol.docs) == 3
        st = svc.stats()
        assert st["qa"]["requests"] == 1
        assert st["latency_ms"]["qa"]["p50_ms"] > 0
        assert st["latency_ms"]["qa"]["window"] == 1
        assert svc.health()["status"] == "ok"
        # reset clears the latency windows but not the monotonic counters
        svc.reset_stats()
        st = svc.stats()
        assert st["latency_ms"]["qa"] is None
        assert st["qa"]["requests"] == 1


def test_service_over_sharded_backend(tmp_path, served_rag):
    # serving composes with the multi-device orchestrator: a mesh-backed
    # engine behind the same RetrievalService must rank like the
    # single-device one under concurrent coalesced traffic
    single_rag, queries = served_rag
    docs, _, _, _ = load_dataset("sample", DATA_DIR)
    cfg = _config(save_dir=str(tmp_path / "mesh"), embedding_dim=96, ppr_batch_size=8, retrieval_top_k=9)
    cfg.mesh_shape = (2, 4)
    rag = HippoRAG(global_config=cfg, device="cpu")
    rag.index(docs)
    want = {q: s.docs for q, s in zip(queries, single_rag.retrieve(list(queries)))}
    with RetrievalService(rag, max_wait_ms=20) as svc:
        with ThreadPoolExecutor(max_workers=len(queries)) as pool:
            served = list(pool.map(svc.retrieve, queries))
    assert isinstance(rag._backend, ShardedBackend), "sharded backend not active"
    for q, s in zip(queries, served):
        assert s.docs == want[q]


def test_service_response_cache(tmp_path):
    # retrieval_top_k=2 == the requested k: the service clamps device
    # solves to max(k, default), so a smaller default would silently
    # deepen cache entries and defeat the deep-miss scenario below
    cfg = _config(
        save_dir=str(tmp_path / "cache"), embedding_dim=96,
        ppr_batch_size=4, retrieval_top_k=2,
    )
    rag = HippoRAG(global_config=cfg, device="cpu")
    rag.index(["Alpha Doc is about quasars.", "Beta Doc is about pulsars.",
               "Gamma Doc is about magnetars."])
    with RetrievalService(rag, max_wait_ms=0, response_cache_size=8) as svc:
        q = "What is a pulsar?"
        s1 = svc.retrieve(q, top_k=2)
        st = svc.stats()
        assert st["response_cache"] == {"hits": 0, "entries": 1, "size": 8}
        batches_before = st["retrieve"]["batches"]

        s2 = svc.retrieve(q, top_k=2)  # hot: served from LRU, no device work
        st = svc.stats()
        assert st["response_cache"]["hits"] == 1
        assert st["retrieve"]["batches"] == batches_before
        assert s2.docs == s1.docs
        s2.doc_scores[0] = -9  # cached buffers are copied per hit
        assert svc.retrieve(q, top_k=2).doc_scores[0] != -9  # hit #2

        # a deeper request can't be served by a shallower entry
        s3 = svc.retrieve(q, top_k=3)
        st = svc.stats()
        assert st["response_cache"]["hits"] == 2  # the deep request missed
        assert len(s3.docs) == 3

        # index updates invalidate the whole cache
        svc.index(["Delta Doc is about blazars."])
        st = svc.stats()
        assert st["response_cache"]["entries"] == 0
        svc.retrieve(q, top_k=3)
        st2 = svc.stats()
        assert st2["response_cache"]["hits"] == 2  # post-update miss went to device
        assert st2["response_cache"]["entries"] == 1


def test_service_over_standard_rag(tmp_path):
    # the service facade is retriever-agnostic: the dense-only
    # StandardRAG serves through the same lanes (incl. /health without
    # get_graph_info)
    from hipporag_tpu_torch import StandardRAG

    docs, queries, _, _ = load_dataset("sample", DATA_DIR)
    cfg = _config(
        save_dir=str(tmp_path / "std"), embedding_dim=96, retrieval_top_k=5,
    )
    rag = StandardRAG(global_config=cfg, device="cpu")
    rag.index(docs)
    direct = rag.retrieve(list(queries))
    with RetrievalService(rag, max_wait_ms=20) as svc:
        with ThreadPoolExecutor(max_workers=len(queries)) as pool:
            served = list(pool.map(svc.retrieve, queries))
        assert svc.qa(queries[0], top_k=3).answer
        assert svc.health()["status"] == "ok"
    for d, s in zip(direct, served):
        assert s.docs == d.docs


def test_service_online_index_update_and_delete(tmp_path):
    cfg = _config(
        save_dir=str(tmp_path),
        embedding_dim=96, ppr_batch_size=4, retrieval_top_k=5,
    )
    rag = HippoRAG(global_config=cfg, device="cpu")
    rag.index(["Alpha Doc is about quasars.", "Beta Doc is about pulsars.",
               "Gamma Doc is about magnetars."])
    new_doc = "Delta Doc is about blazars."
    with RetrievalService(rag, max_wait_ms=5) as svc:
        before = svc.retrieve("Which doc mentions blazars?", top_k=4).docs
        assert not any("blazars" in d for d in before)

        # update while traffic is in flight from other threads
        with ThreadPoolExecutor(max_workers=5) as pool:
            traffic = [
                pool.submit(svc.retrieve, "What is a pulsar?", 3)
                for _ in range(4)
            ]
            pool.submit(svc.index, [new_doc]).result(timeout=120)
            for f in traffic:
                assert f.result(timeout=120).docs

        after = svc.retrieve("Which doc mentions blazars?", top_k=4).docs
        assert any("blazars" in d for d in after)

        svc.delete([new_doc])
        again = svc.retrieve("Which doc mentions blazars?", top_k=4).docs
        assert not any("blazars" in d for d in again)


def test_service_rejects_bad_cache_size_and_closed_requests(served_rag):
    rag, queries = served_rag
    with pytest.raises(ValueError, match="response_cache_size"):
        RetrievalService(rag, response_cache_size=-1)
    svc = RetrievalService(rag, max_wait_ms=0, response_cache_size=4)
    svc.retrieve(queries[0], top_k=2)
    svc.close()
    # a closed service is uniformly closed — no stale cache serves
    with pytest.raises(BatcherClosed):
        svc.retrieve(queries[0], top_k=2)


def test_service_soak_mixed_workload(tmp_path):
    """Bounded soak: sustained concurrent retrieve+qa+update+cache traffic
    must stay live (no deadlock between the engine lock, lane workers,
    and mutations) and every request must complete or shed cleanly."""
    cfg = _config(
        save_dir=str(tmp_path / "soak"), embedding_dim=96,
        ppr_batch_size=8, retrieval_top_k=4,
    )
    rag = HippoRAG(global_config=cfg, device="cpu")
    rag.index([f"SoakDoc{i} relates to SoakEntity{i % 7}." for i in range(12)])
    errors = []
    done = threading.Event()

    with RetrievalService(
        rag, max_wait_ms=2, max_pending=64, response_cache_size=16
    ) as svc:
        svc.retrieve("warm", top_k=2)

        def client(i):
            n = 0
            while not done.is_set():
                try:
                    if i == 0 and n % 7 == 3:
                        svc.index([f"HotDoc{i}_{n} relates to SoakEntity1."])
                    elif i % 3 == 0:
                        assert svc.qa(f"Who relates to SoakEntity{n % 7}?",
                                      top_k=2, timeout=60).answer
                    else:
                        # alternate hot (cacheable) and cold queries
                        q = ("What relates to SoakEntity1?" if n % 2
                             else f"cold query {i} {n}?")
                        assert svc.retrieve(q, top_k=3, timeout=60).docs
                except BatcherSaturated:
                    pass  # shedding is a valid outcome under burst load
                except Exception as exc:  # noqa: BLE001
                    errors.append(f"client {i}: {exc!r}")
                    return
                n += 1
            return n

        with ThreadPoolExecutor(max_workers=6) as pool:
            futs = [pool.submit(client, i) for i in range(6)]
            time.sleep(8)
            done.set()
            counts = [f.result(timeout=120) for f in futs]

        st = svc.stats()
    assert not errors, errors
    assert all(c is not None and c > 0 for c in counts), counts
    assert st["retrieve"]["failed_batches"] == 0
    assert st["qa"]["failed_batches"] == 0
    assert st["response_cache"]["hits"] > 0  # hot query actually cached
    assert st["retrieve"]["pending"] == 0 and st["qa"]["pending"] == 0


# ======================================================================
# HTTP front-end
# ======================================================================


def _post(url, payload):
    req = urllib.request.Request(
        url,
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read().decode())


@pytest.mark.parametrize("frontend", ["stdlib", "native"])
def test_http_maps_saturation_to_503(frontend):
    # overload maps to 503 (load shedding), not 500 — pin via a stub
    # service so the test doesn't depend on queue-timing races
    class Saturated:
        def retrieve(self, *a, **kw):
            raise BatcherSaturated("64 requests already queued")

        def health(self):
            return {"status": "ok"}

        def stats(self):
            return {}

    server = _make_frontend(frontend, Saturated())
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        code, body = _post(
            f"http://127.0.0.1:{port}/retrieve", {"query": "q", "top_k": 1}
        )
        assert code == 503 and "overloaded" in body["error"]
    finally:
        server.shutdown()
        server.server_close()


@pytest.mark.parametrize("frontend", ["stdlib", "native"])
def test_http_server_end_to_end(served_rag, frontend):
    rag, queries = served_rag
    with RetrievalService(rag, max_wait_ms=5) as svc:
        server = _make_frontend(frontend, svc)
        port = server.server_address[1]
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        base = f"http://127.0.0.1:{port}"
        try:
            with urllib.request.urlopen(base + "/health", timeout=30) as resp:
                health = json.loads(resp.read().decode())
            assert health["status"] == "ok"
            assert health["graph"]["num_passage_nodes"] == 9

            code, body = _post(base + "/retrieve", {"query": queries[0], "top_k": 3})
            assert code == 200
            assert len(body["docs"]) == 3
            assert body["doc_scores"] == sorted(body["doc_scores"], reverse=True)

            code, body = _post(base + "/qa", {"query": queries[0], "top_k": 2})
            assert code == 200 and body["answer"]

            code, body = _post(base + "/retrieve", {"query": ""})
            assert code == 400 and "query" in body["error"]
            code, body = _post(base + "/retrieve", {"query": "q", "top_k": 0})
            assert code == 400
            code, body = _post(base + "/nope", {"query": "q"})
            assert code == 404

            with urllib.request.urlopen(base + "/stats", timeout=30) as resp:
                stats = json.loads(resp.read().decode())
            # the 400s never reach the lanes — exactly one request each
            assert stats["retrieve"]["requests"] == 1
            assert stats["qa"]["requests"] == 1

            # Prometheus exposition: text/plain content type on BOTH
            # transports, counters agree with /stats
            with urllib.request.urlopen(base + "/metrics", timeout=30) as resp:
                ctype = resp.headers.get("Content-Type", "")
                metrics = resp.read().decode()
            assert ctype.startswith("text/plain"), ctype
            assert "version=0.0.4" in ctype, ctype
            assert 'hipporag_requests_total{lane="retrieve"} 1' in metrics
            assert 'hipporag_requests_total{lane="qa"} 1' in metrics
            assert "# TYPE hipporag_requests_total counter" in metrics
            assert 'hipporag_latency_ms{lane="retrieve",quantile="0.5"}' in metrics
            for line in metrics.splitlines():  # exposition-format shape
                assert line.startswith("#") or " " in line, line

            code, body = _post(base + "/index", {"docs": ["not", ""]})
            assert code == 400 and "docs" in body["error"]
            code, body = _post(
                base + "/index", {"docs": ["Epsilon Doc is about novae."]}
            )
            assert code == 200 and body == {"ok": True, "docs": 1}
            code, body = _post(base + "/retrieve", {"query": "novae?", "top_k": 10})
            assert any("novae" in d for d in body["docs"])
            code, body = _post(
                base + "/delete", {"docs": ["Epsilon Doc is about novae."]}
            )
            assert code == 200
            code, body = _post(base + "/retrieve", {"query": "novae?", "top_k": 10})
            assert not any("novae" in d for d in body["docs"])
        finally:
            server.shutdown()
            server.server_close()


def test_native_http_protocol_errors_and_counters():
    """Malformed wire input is answered directly by the C++ event loop
    (400/413/501) with Connection: close — it never reaches dispatch."""
    import socket

    class Stub:
        def health(self):
            return {"status": "ok"}

        def stats(self):
            return {}

    server = _make_frontend("native", Stub())
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()

    def raw(payload):
        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        s.sendall(payload)
        chunks = b""
        while True:
            b = s.recv(4096)
            if not b:
                break
            chunks += b
        s.close()
        return chunks

    try:
        r = raw(b"GARBAGE\r\n\r\n")
        assert r.startswith(b"HTTP/1.1 400"), r[:60]
        assert b"Connection: close" in r

        big = str(100 << 20).encode()  # 100 MiB > the 64 MiB cap
        r = raw(b"POST /index HTTP/1.1\r\nContent-Length: " + big + b"\r\n\r\n")
        assert r.startswith(b"HTTP/1.1 413"), r[:60]

        r = raw(
            b"POST /retrieve HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n"
        )
        assert r.startswith(b"HTTP/1.1 501"), r[:60]

        r = raw(b"POST /retrieve HTTP/1.1\r\nContent-Length: nope\r\n\r\n")
        assert r.startswith(b"HTTP/1.1 400"), r[:60]

        # a well-formed request still works after the garbage
        r = raw(b"GET /health HTTP/1.1\r\nConnection: close\r\n\r\n")
        assert r.startswith(b"HTTP/1.1 200"), r[:60]
        assert b'"status": "ok"' in r

        c = server.counters()
        assert c["protocol_errors"] == 4, c
        assert c["parsed"] >= 1 and c["responded"] >= c["parsed"], c
    finally:
        server.shutdown()
        server.server_close()


def test_native_http_busy_connection_buffer_cap():
    """While a response is in flight, a client streaming extra bytes is
    capped at the SMALL body limit (~1 MiB), not max_body_ (64 MiB) — one
    connection must not pin tens of MiB of event-loop memory (review
    finding: per-path caps only applied at header-parse time)."""
    import socket

    release = threading.Event()

    class Slow:
        def retrieve(self, query, top_k=None, timeout=None):
            from hipporag_tpu_torch.utils.misc import QuerySolution

            release.wait(timeout=30)
            return QuerySolution(
                question=query, docs=["d"], doc_scores=np.array([1.0])
            )

        def health(self):
            return {"status": "ok"}

        def stats(self):
            return {}

    server = _make_frontend("native", Slow())
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        body = json.dumps({"query": "q"}).encode()
        req = (
            b"POST /retrieve HTTP/1.1\r\nContent-Type: application/json\r\n"
            b"Content-Length: " + str(len(body)).encode() + b"\r\n\r\n" + body
        )
        s = socket.create_connection(("127.0.0.1", port), timeout=15)
        s.sendall(req)  # dispatched -> connection busy on the slow service
        # Flood while busy. The fix caps c.in at ~1.06 MiB; pre-fix the
        # loop would buffer all 4 MiB (up to 64 MiB) without complaint.
        flood = b"x" * (4 << 20)
        try:
            s.sendall(flood)
        except (BrokenPipeError, ConnectionResetError):
            pass  # server may 413+close before we finish writing
        release.set()
        s.settimeout(15)
        chunks = b""
        try:
            while len(chunks) < 1 << 16:
                b = s.recv(4096)
                if not b:
                    break
                chunks += b
        except (ConnectionResetError, socket.timeout):
            pass
        s.close()
        # first response may be the slow retrieve's 200; the flood itself
        # must have drawn a 413 and a close — never a silent 64 MiB buffer
        assert b"413" in chunks, chunks[:200]
        assert server.counters()["protocol_errors"] >= 1
    finally:
        release.set()
        server.shutdown()
        server.server_close()


def test_native_http_survives_garbage_fuzz():
    """Seeded wire fuzz: random byte streams, truncated requests, and
    oversized header lines must never kill the event loop — every
    connection gets an error or a close, and a clean request still works
    afterward."""
    import random
    import socket

    class Stub:
        def health(self):
            return {"status": "ok"}

        def stats(self):
            return {}

    server = _make_frontend("native", Stub())
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    rng = random.Random(42)
    try:
        for i in range(50):
            kind = i % 5
            if kind == 0:  # pure random bytes
                payload = bytes(rng.randrange(256) for _ in range(rng.randrange(1, 2048)))
            elif kind == 1:  # truncated valid-looking request
                payload = b"POST /retrieve HTTP/1.1\r\nContent-Length: 999\r\n\r\n{"
            elif kind == 2:  # absurd header line, no terminator
                payload = b"GET /" + b"A" * rng.randrange(1, 40000)
            elif kind == 3:  # null bytes in the request line
                payload = b"GE\x00T /health HTTP/1.1\r\n\r\n"
            else:  # random method + random path
                payload = (
                    bytes(rng.choices(b"ABCDEFGH", k=4)) + b" /"
                    + bytes(rng.choices(b"abcdefgh/._-", k=30))
                    + b" HTTP/1.1\r\nConnection: close\r\n\r\n"
                )
            try:
                s = socket.create_connection(("127.0.0.1", port), timeout=5)
                s.sendall(payload)
                # short drain: incomplete requests legitimately get no
                # response (the server waits for more bytes) — this fuzz
                # asserts liveness, not per-payload replies
                s.settimeout(0.25)
                try:
                    while s.recv(4096):
                        pass
                except socket.timeout:
                    pass
                s.close()
            except OSError:
                pass  # reset/refused mid-fuzz is acceptable; hang is not

        # the loop is still alive and correct after the storm
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request("GET", "/health")
        resp = conn.getresponse()
        assert resp.status == 200
        assert json.loads(resp.read())["status"] == "ok"
        conn.close()
        c = server.counters()
        assert c["responded"] >= 1 and c["accepted"] >= 25
    finally:
        server.shutdown()
        server.server_close()


def test_native_http_large_index_body_accepted():
    """Regression (review finding on the busy-cap fix): a legitimate
    multi-MiB /index body sent in ONE fast burst must NOT trip the
    small-body flood cap — a fast client can land headers + body without
    the event loop ever hitting EAGAIN, so entitlement must be
    established by parsing, not only after the read drain."""
    import http.client

    class Counter:
        def __init__(self):
            self.docs = []

        def index(self, docs, timeout=None):
            self.docs.extend(docs)
            return {"ok": True, "docs": len(docs)}

        def health(self):
            return {"status": "ok"}

        def stats(self):
            return {}

    svc = Counter()
    server = _make_frontend("native", svc)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        # ~8 MiB body: far over the ~1 MiB small cap, far under the
        # 64 MiB /index cap
        big_doc = "x" * (8 << 20)
        body = json.dumps({"docs": [big_doc]})
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/index", body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        out = json.loads(resp.read())
        assert resp.status == 200 and out == {"ok": True, "docs": 1}, out
        assert svc.docs and len(svc.docs[0]) == (8 << 20)
        assert server.counters()["protocol_errors"] == 0
        # the same size on a SMALL-cap path must still 413
        conn2 = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            conn2.request("POST", "/retrieve", body,
                          {"Content-Type": "application/json"})
            resp2 = conn2.getresponse()
            assert resp2.status == 413, resp2.status
        except (BrokenPipeError, ConnectionResetError):
            pass  # server may 413+close before the client finishes writing
        conn.close()
        conn2.close()
    finally:
        server.shutdown()
        server.server_close()


def test_stdlib_head_returns_headers_only():
    """HEAD must send status + Content-Length but no body (HTTP/1.1);
    a body on HEAD desyncs keep-alive clients and health probes. Read the
    RAW socket: http.client never reads a body for HEAD, so it would mask
    exactly the bug this pins (do_HEAD used to alias do_POST)."""
    import socket

    class Stub:
        def health(self):
            return {"status": "ok"}

        def stats(self):
            return {}

    server = _make_frontend("stdlib", Stub())
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        s.sendall(b"HEAD /health HTTP/1.1\r\nHost: x\r\n"
                  b"Connection: close\r\n\r\n")
        raw = b""
        while True:
            b_ = s.recv(4096)
            if not b_:
                break
            raw += b_
        s.close()
        head, _, after = raw.partition(b"\r\n\r\n")
        assert head.startswith(b"HTTP/1.0 200") or head.startswith(
            b"HTTP/1.1 200"
        ), raw[:80]
        clen = int(
            [ln for ln in head.split(b"\r\n")
             if ln.lower().startswith(b"content-length:")][0].split(b":")[1]
        )
        assert clen > 0  # advertises the GET body size…
        assert after == b""  # …but the wire carries NO body bytes
    finally:
        server.shutdown()
        server.server_close()


def test_native_http_keep_alive_sequential_requests():
    """One connection, several requests: the native loop parses the next
    request only after the previous response is written (no pipelining
    reorder hazard) and keeps the connection open."""
    import http.client

    class Echo:
        def retrieve(self, query, top_k=None, timeout=None):
            from hipporag_tpu_torch.utils.misc import QuerySolution

            return QuerySolution(question=query, docs=[f"doc-for-{query}"],
                                 doc_scores=np.array([1.0]))

        def health(self):
            return {"status": "ok"}

        def stats(self):
            return {}

    server = _make_frontend("native", Echo())
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        for i in range(5):
            conn.request(
                "POST", "/retrieve", json.dumps({"query": f"q{i}"}),
                {"Content-Type": "application/json"},
            )
            resp = conn.getresponse()
            body = json.loads(resp.read())
            assert resp.status == 200 and body["docs"] == [f"doc-for-q{i}"]
        conn.close()
        assert server.counters()["accepted"] == 1  # one reused connection
    finally:
        server.shutdown()
        server.server_close()


def test_native_http_head_returns_headers_only():
    """The NATIVE transport (the production default) must also answer HEAD
    with headers only — the stdlib fix alone left the preferred transport
    writing a body that desyncs keep-alive clients. Pipelines a GET behind
    the HEAD on the same connection: if any body bytes leaked, the GET
    response would not start at the expected offset."""
    import socket

    class Stub:
        def health(self):
            return {"status": "ok"}

        def stats(self):
            return {}

    server = _make_frontend("native", Stub())
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        s.sendall(
            b"HEAD /health HTTP/1.1\r\nHost: x\r\n\r\n"
            b"GET /health HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n"
        )
        raw = b""
        while True:
            b_ = s.recv(4096)
            if not b_:
                break
            raw += b_
        s.close()
        head1, _, rest = raw.partition(b"\r\n\r\n")
        assert head1.startswith(b"HTTP/1.1 200"), raw[:80]
        clen = int(
            [ln for ln in head1.split(b"\r\n")
             if ln.lower().startswith(b"content-length:")][0].split(b":")[1]
        )
        assert clen > 0  # advertises the GET body size…
        # …but the next wire bytes are the SECOND response's status line,
        # not the suppressed HEAD body
        assert rest.startswith(b"HTTP/1.1 200"), rest[:80]
        assert b'"status": "ok"' in rest  # the GET body does arrive
        assert server.counters()["protocol_errors"] == 0
    finally:
        server.shutdown()
        server.server_close()


def test_native_http_expect_100_continue_once():
    """Expect: 100-continue draws exactly ONE interim response even when
    the declared body streams in over many read events (each event
    re-scans the buffered headers; pre-fix every re-scan appended another
    '100 Continue')."""
    import socket

    class Echo:
        def retrieve(self, query, top_k=None, timeout=None):
            from hipporag_tpu_torch.utils.misc import QuerySolution

            return QuerySolution(question=query, docs=["d"],
                                 doc_scores=np.array([1.0]))

        def health(self):
            return {"status": "ok"}

        def stats(self):
            return {}

    server = _make_frontend("native", Echo())
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        body = json.dumps({"query": "q" * 2000}).encode()
        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        s.sendall(
            b"POST /retrieve HTTP/1.1\r\nHost: x\r\n"
            b"Content-Type: application/json\r\n"
            b"Expect: 100-continue\r\n"
            b"Content-Length: " + str(len(body)).encode() + b"\r\n"
            b"Connection: close\r\n\r\n"
        )
        time.sleep(0.1)  # let the headers land as their own read event
        third = len(body) // 3
        for chunk in (body[:third], body[third : 2 * third], body[2 * third :]):
            s.sendall(chunk)
            time.sleep(0.05)  # separate read events while body incomplete
        raw = b""
        s.settimeout(15)
        while True:
            try:
                b_ = s.recv(4096)
            except socket.timeout:
                break
            if not b_:
                break
            raw += b_
        s.close()
        assert raw.count(b"HTTP/1.1 100 Continue") == 1, raw[:200]
        assert b"HTTP/1.1 200" in raw, raw[:200]
    finally:
        server.shutdown()
        server.server_close()


def test_native_http_pipelined_request_behind_large_body():
    """A keep-alive client may pipeline a second in-limit request (body
    >16 KiB) in the same burst as a multi-MiB /index upload. Pre-fix the
    read-loop cap judged those pipelined bytes against the large body's
    exact entitlement (+16 KiB slack) and 413'd the whole connection;
    now the completed large request is consumed mid-burst and the
    pipelined bytes fall under the busy small-cap."""
    import socket

    class Svc:
        def __init__(self):
            self.docs = []

        def index(self, docs, timeout=None):
            self.docs.extend(docs)
            return {"ok": True, "docs": len(docs)}

        def retrieve(self, query, top_k=None, timeout=None):
            from hipporag_tpu_torch.utils.misc import QuerySolution

            return QuerySolution(question=query, docs=["d"],
                                 doc_scores=np.array([1.0]))

        def health(self):
            return {"status": "ok"}

        def stats(self):
            return {}

    svc = Svc()
    server = _make_frontend("native", svc)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        index_body = json.dumps({"docs": ["x" * (2 << 20)]}).encode()
        retrieve_body = json.dumps({"query": "y" * (64 << 10)}).encode()
        burst = (
            b"POST /index HTTP/1.1\r\nHost: x\r\n"
            b"Content-Type: application/json\r\n"
            b"Content-Length: " + str(len(index_body)).encode() + b"\r\n\r\n"
            + index_body
            + b"POST /retrieve HTTP/1.1\r\nHost: x\r\n"
            b"Content-Type: application/json\r\n"
            b"Content-Length: " + str(len(retrieve_body)).encode() + b"\r\n"
            b"Connection: close\r\n\r\n" + retrieve_body
        )
        s = socket.create_connection(("127.0.0.1", port), timeout=30)
        s.sendall(burst)
        raw = b""
        s.settimeout(30)
        while True:
            try:
                b_ = s.recv(65536)
            except socket.timeout:
                break
            if not b_:
                break
            raw += b_
        s.close()
        assert raw.count(b"HTTP/1.1 200") == 2, raw[:300]
        assert b"413" not in raw, raw[:300]
        assert svc.docs and len(svc.docs[0]) == (2 << 20)
        assert server.counters()["protocol_errors"] == 0
    finally:
        server.shutdown()
        server.server_close()


@pytest.mark.parametrize("frontend", ["stdlib", "native"])
def test_http_contract_identical_across_frontends(frontend):
    """Divergences found in review, now pinned: oversize body -> 413 on
    both transports; unsupported method -> JSON 405 (not stdlib's HTML
    501); a raising health()/stats() -> JSON 500 (never a dropped
    connection)."""

    class Flaky:
        fail = False

        def health(self):
            if self.fail:
                raise RuntimeError("engine down")
            return {"status": "ok"}

        def stats(self):
            return {}

    svc = Flaky()
    server = _make_frontend(frontend, svc)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{port}"

    def req(method, path, body=b""):
        r = urllib.request.Request(base + path, data=body or None, method=method)
        try:
            with urllib.request.urlopen(r, timeout=30) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as err:
            return err.code, json.loads(err.read())

    try:
        # oversize /retrieve body: the per-path 1 MiB cap, not the 64 MiB
        # /index cap, applies — and the status is 413 on both transports.
        # Send headers ONLY (raw socket): both front-ends must reject from
        # the declared Content-Length before any body is buffered (urllib
        # would race its body send against the early 413 + close).
        import socket

        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        s.sendall(
            b"POST /retrieve HTTP/1.1\r\nContent-Length: "
            + str((1 << 20) + 64).encode()
            + b"\r\n\r\n"
        )
        first = s.recv(4096)
        s.close()
        assert b"413" in first.split(b"\r\n")[0], first[:80]

        code, body = req("PUT", "/health")
        assert code == 405 and "PUT" in body["error"], (code, body)

        svc.fail = True
        code, body = req("GET", "/health")
        assert code == 500 and "engine down" in body["error"], (code, body)
        svc.fail = False
        code, body = req("GET", "/health")
        assert code == 200 and body["status"] == "ok", (code, body)
    finally:
        server.shutdown()
        server.server_close()

# ======================================================================
# The two packages behind one route dispatcher, and the CLI
# ======================================================================


def test_sharded_serving_soak_native_frontend(tmp_path):
    """Online mutation + SHARDED retrieval (mesh_shape=(2, 4) on eight CPU
    virtual shards) + the C++ native transport, exercised together. No
    status code other than 200/503-shed may ever escape, and the response
    cache must be generation-invalidated by online /index and /delete while
    concurrent traffic is in flight."""
    import http.client

    cfg = _config(save_dir=str(tmp_path / "shard_soak"), embedding_dim=96, ppr_batch_size=8, retrieval_top_k=5)
    cfg.mesh_shape = (2, 4)
    rag = HippoRAG(global_config=cfg, device="cpu")
    rag.index([f"ShardDoc{i} relates to ShardEntity{i % 5}." for i in range(16)])

    svc = RetrievalService(rag, max_wait_ms=2, max_pending=64, response_cache_size=32)
    server = _make_frontend("native", svc)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{port}"
    bad_codes, errors = [], []
    done = threading.Event()

    def post(path, payload):
        code, body = _post(base + path, payload)
        if code not in (200, 503):
            bad_codes.append((path, code, body))
        return code, body

    try:
        svc.retrieve("warm", top_k=2)
        assert isinstance(rag._backend, ShardedBackend), "sharded backend not active"

        def client(i):
            n = 0
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            while not done.is_set():
                try:
                    if i == 0 and n % 9 == 4:
                        post("/index", {"docs": [f"Hot{i}_{n} relates to ShardEntity1."]})
                    elif i == 0 and n % 9 == 8:
                        post("/delete", {"docs": [f"Hot{i}_{n - 4} relates to ShardEntity1."]})
                    elif i % 3 == 2:
                        conn.request("GET", "/metrics" if n % 2 else "/health")
                        resp = conn.getresponse()
                        resp.read()
                        if resp.status != 200:
                            bad_codes.append(("/health", resp.status, None))
                    else:
                        q = "What relates to ShardEntity1?" if n % 2 else f"cold shard query {i} {n}?"
                        code, body = post("/retrieve", {"query": q, "top_k": 3})
                        if code == 200:
                            assert body["docs"], body
                except Exception as exc:  # noqa: BLE001
                    errors.append(f"client {i}: {exc!r}")
                    return n
                n += 1
            conn.close()
            return n

        with ThreadPoolExecutor(max_workers=5) as pool:
            futs = [pool.submit(client, i) for i in range(5)]
            time.sleep(8)
            done.set()
            counts = [f.result(timeout=120) for f in futs]

        # generation-correct cache invalidation across a mutation, via HTTP
        probe_q = {"query": "Which doc relates to CacheProbeEntity?", "top_k": 4}
        code, before = post("/retrieve", probe_q)
        assert code == 200 and not any("CacheProbe" in d for d in before["docs"])
        code, again = post("/retrieve", probe_q)  # now cached
        assert code == 200 and again["docs"] == before["docs"]
        code, _ = post("/index", {"docs": ["CacheProbeDoc relates to CacheProbeEntity."]})
        assert code == 200
        code, after = post("/retrieve", probe_q)
        assert code == 200 and any("CacheProbe" in d for d in after["docs"]), (
            "response cache served a stale generation after online /index"
        )
        code, _ = post("/delete", {"docs": ["CacheProbeDoc relates to CacheProbeEntity."]})
        assert code == 200
        code, gone = post("/retrieve", probe_q)
        assert code == 200 and not any("CacheProbe" in d for d in gone["docs"])
        st = svc.stats()
    finally:
        done.set()
        server.shutdown()
        server.server_close()
        svc.close()

    assert not errors, errors
    assert not bad_codes, bad_codes
    assert all(c is not None and c > 0 for c in counts), counts
    assert st["retrieve"]["failed_batches"] == 0
    assert st["response_cache"]["hits"] > 0
    assert server.counters()["protocol_errors"] == 0


def _contract_sequence(docs, queries):
    """(method, path, body) triples covering every route and error path."""
    new_doc = "Zephyr Quill\nZephyr Quill is a lighthouse keeper on Port Ellery."

    def post(path, payload):
        return ("POST", path, json.dumps(payload).encode())

    return [
        ("GET", "/health", b""),
        post("/retrieve", {"query": queries[0], "top_k": 3}),
        post("/retrieve", {"query": queries[1]}),
        post("/retrieve", {"query": queries[0], "top_k": 20}),
        post("/qa", {"query": queries[2], "top_k": 2}),
        post("/retrieve", {"query": ""}),
        post("/retrieve", {"query": "q", "top_k": 0}),
        post("/retrieve", {"query": "q", "top_k": "3"}),
        ("POST", "/retrieve", b"{not json"),
        ("POST", "/retrieve", b"[1, 2]"),
        ("POST", "/retrieve", b""),
        ("POST", "/retrieve", b"x" * ((1 << 20) + 1)),
        post("/nope", {"query": "q"}),
        ("GET", "/nope", b""),
        ("PUT", "/health", b""),
        post("/index", {"docs": ["not", ""]}),
        post("/index", {"docs": [new_doc]}),
        post("/retrieve", {"query": "Who keeps the lighthouse, Zephyr Quill?", "top_k": 4}),
        post("/delete", {"docs": [new_doc, docs[0]]}),
        post("/retrieve", {"query": "Who keeps the lighthouse, Zephyr Quill?", "top_k": 4}),
        post("/qa", {"query": queries[0]}),
        ("GET", "/stats", b""),
        ("GET", "/metrics", b""),
    ]


def _comparable(path, payload):
    """Drop what depends on the clock: uptime, latencies, queue waits."""
    if isinstance(payload, str):  # /metrics
        return [ln for ln in payload.splitlines() if "latency" not in ln and "queue_wait" not in ln], None
    payload = json.loads(json.dumps(payload))
    payload.pop("uptime_s", None)
    if path == "/stats":
        payload.pop("latency_ms")
        for lane in ("retrieve", "qa"):
            payload[lane].pop("mean_queue_wait_ms")
            payload[lane].pop("max_queue_wait_ms")
    scores = payload.pop("doc_scores", None)
    return payload, scores


def test_dispatch_contract_identical_across_packages(tmp_path):
    """One request sequence through both packages' ``routes.dispatch`` on
    the sample corpus: the same status codes and JSON bodies, scores to
    1e-5, with online /index and /delete in the middle."""
    import hipporag_tpu
    from hipporag_tpu.serving import RetrievalService as RefService
    from hipporag_tpu.serving.routes import dispatch as ref_dispatch

    from hipporag_tpu_torch.serving.routes import dispatch

    docs, queries, _, _ = load_dataset("sample", DATA_DIR)
    kw = dict(llm_name="mock", embedding_model_name="mock", vector_store_type="memory",
              embedding_dim=96, ppr_batch_size=8, retrieval_top_k=9)
    ref_rag = hipporag_tpu.HippoRAG(global_config=hipporag_tpu.BaseConfig(save_dir=str(tmp_path / "ref"), **kw))
    port_rag = HippoRAG(global_config=BaseConfig(save_dir=str(tmp_path / "port"), **kw), device="cpu")
    outs = []
    for rag, service_cls, route in ((ref_rag, RefService, ref_dispatch), (port_rag, RetrievalService, dispatch)):
        rag.index(docs)
        with service_cls(rag, max_wait_ms=0, response_cache_size=4) as svc:
            outs.append([route(svc, m, p, b, 60.0) for m, p, b in _contract_sequence(docs, queries)])
    for (m, p, _), (want_code, want), (got_code, got) in zip(_contract_sequence(docs, queries), *outs):
        assert got_code == want_code, (m, p, got_code, want_code, got)
        assert type(got) is type(want), (m, p)
        got_body, got_scores = _comparable(p, got)
        want_body, want_scores = _comparable(p, want)
        assert got_body == want_body, (m, p)
        if want_scores is not None:
            np.testing.assert_allclose(got_scores, want_scores, atol=1e-5, err_msg=f"{m} {p}")
    codes = [code for code, _ in outs[1]]
    assert codes.count(200) == 12 and {400, 404, 405, 413} <= set(codes)


def test_cli_serve_answers_and_drains(tmp_path):
    """``python -m hipporag_tpu_torch --serve`` on the CPU: it indexes the
    sample corpus, answers /health and /retrieve on the stdlib front end,
    and exits 0 on SIGTERM after draining."""
    import signal
    import socket
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "hipporag_tpu_torch", "--dataset", "sample", "--data_dir", DATA_DIR,
         "--llm_name", "mock", "--embedding_name", "mock", "--device", "cpu",
         "--vector_store_type", "memory", "--save_dir", str(tmp_path), "--serve",
         "--serve_frontend", "stdlib", "--port", str(port)],
        cwd=root, env={**os.environ, "PYTHONPATH": root, "OMP_NUM_THREADS": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 240
        while True:
            assert proc.poll() is None, proc.stdout.read().decode()[-3000:]
            try:
                with urllib.request.urlopen(base + "/health", timeout=5) as resp:
                    assert json.loads(resp.read())["graph"]["num_passage_nodes"] == 9
                break
            except OSError:
                assert time.time() < deadline, "server did not come up"
                time.sleep(0.5)
        code, body = _post(base + "/retrieve", {"query": "Who is Mira Voss?", "top_k": 3})
        assert code == 200 and len(body["docs"]) == 3
    finally:
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0, out.decode()[-3000:]
