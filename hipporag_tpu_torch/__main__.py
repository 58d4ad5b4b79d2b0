"""Experiment CLI of the port: index a dataset corpus, then retrieval + QA evaluation.

The counterpart of the repository's ``main.py`` on a torch device:

    python -m hipporag_tpu_torch --dataset sample --llm_name mock \\
        --embedding_name jax/random-768x12
    python -m hipporag_tpu_torch --dataset sample --rag_type standard \\
        --llm_name mock --embedding_name mock --device cpu

``--vector_store_type memory`` runs without pyarrow (the default parquet
store needs it). ``--serve`` serves the index over HTTP instead of running
the evaluation:

    python -m hipporag_tpu_torch --dataset sample --llm_name mock \
        --embedding_name jax/random-768x12 --vector_store_type memory --serve
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

from .utils.misc import string_to_bool

from . import BaseConfig, HippoRAG, StandardRAG, load_dataset


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m hipporag_tpu_torch",
        description="hipporag_tpu_torch retrieval and QA experiments",
    )
    p.add_argument("--dataset", default="sample", help="Dataset name under --data_dir")
    p.add_argument("--data_dir", default="data", help="Directory with <dataset>_corpus.json + <dataset>.json")
    p.add_argument("--rag_type", choices=["hipporag", "standard"], default="hipporag")
    p.add_argument("--device", default="cuda", help="torch device the retrieval and the encoder run on")
    p.add_argument("--llm_base_url", default=None, help="OpenAI-compatible LLM base URL")
    p.add_argument("--llm_name", default="gpt-4o-mini")
    p.add_argument("--embedding_name", default="mock")
    p.add_argument("--embedding_base_url", default=None)
    p.add_argument("--azure_endpoint", default=None)
    p.add_argument("--azure_embedding_endpoint", default=None)
    p.add_argument("--embedding_batch_size", type=int, default=32)
    p.add_argument("--vector_store_type", choices=["parquet", "memory"], default="parquet")
    p.add_argument("--force_index_from_scratch", default="false")
    p.add_argument("--force_openie_from_scratch", default="false")
    p.add_argument("--openie_mode", choices=["online", "offline"], default="online")
    p.add_argument("--save_dir", default="outputs")
    p.add_argument("--rerank_dspy_file_path", default=None)
    p.add_argument("--corpus_len", type=int, default=None, help="Truncate corpus for smoke runs")
    p.add_argument("--output_json", default=None, help="Write per-query solutions + metrics here")
    p.add_argument(
        "--serve", action="store_true",
        help="After indexing, serve HTTP retrieval/QA (POST /retrieve, /qa, /index, /delete; "
             "GET /health, /stats, /metrics) instead of running the batch evaluation. "
             "Concurrent requests are micro-batched onto the device.",
    )
    p.add_argument("--host", default="127.0.0.1", help="--serve bind host")
    p.add_argument("--port", type=int, default=8734, help="--serve bind port")
    p.add_argument(
        "--serve_max_wait_ms", type=float, default=8.0,
        help="Micro-batching coalescing window (p50 latency tax under load)",
    )
    p.add_argument(
        "--serve_frontend", choices=["stdlib", "native", "auto"], default="auto",
        help="HTTP transport: 'native' is the C++ epoll front-end (socket I/O and HTTP "
             "parsing outside the GIL), 'stdlib' the threaded http.server. 'auto' tries "
             "native and falls back to stdlib if the C++ toolchain is unavailable. The "
             "wire contract is identical.",
    )
    return p.parse_args(argv)


def serve(rag, args, queries) -> None:
    """Serve ``rag`` over HTTP until SIGTERM or Ctrl-C."""
    from .serving import RetrievalService
    from .serving.http_server import serve_forever

    service = RetrievalService(rag, max_wait_ms=args.serve_max_wait_ms)
    service.warmup(queries[0] if queries else "warmup query")
    server = None
    if args.serve_frontend in ("native", "auto"):
        from .serving.native_http import make_native_server

        try:
            server = make_native_server(service, host=args.host, port=args.port)
        except (RuntimeError, OSError):
            if args.serve_frontend == "native":
                raise
            logging.getLogger(__name__).warning("native front-end unavailable; falling back to stdlib")
    serve_forever(service, host=args.host, port=args.port, server=server)


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    save_dir = os.path.join(args.save_dir, args.dataset)

    docs, queries, gold_docs, gold_answers = load_dataset(args.dataset, args.data_dir)
    if args.corpus_len:
        docs = docs[: args.corpus_len]

    config = BaseConfig(
        save_dir=save_dir,
        llm_base_url=args.llm_base_url,
        llm_name=args.llm_name,
        azure_endpoint=args.azure_endpoint,
        azure_embedding_endpoint=args.azure_embedding_endpoint,
        dataset=args.dataset,
        embedding_model_name=args.embedding_name,
        embedding_base_url=args.embedding_base_url,
        force_index_from_scratch=string_to_bool(args.force_index_from_scratch),
        force_openie_from_scratch=string_to_bool(args.force_openie_from_scratch),
        rerank_dspy_file_path=args.rerank_dspy_file_path,
        retrieval_top_k=200,
        linking_top_k=5,
        qa_top_k=5,
        embedding_batch_size=args.embedding_batch_size,
        openie_mode=args.openie_mode,
        vector_store_type=args.vector_store_type,
    )

    rag_class = HippoRAG if args.rag_type == "hipporag" else StandardRAG
    rag = rag_class(global_config=config, device=args.device)
    rag.index(docs)

    if args.serve:
        serve(rag, args, queries)
        return 0

    out = rag.rag_qa(queries=queries, gold_docs=gold_docs, gold_answers=gold_answers)

    if gold_answers is not None:
        solutions, _, _, retrieval_eval, qa_eval = out
        print("Retrieval:", json.dumps(retrieval_eval))
        print("QA:", json.dumps(qa_eval))
    else:
        solutions = out[0]
        retrieval_eval = qa_eval = None

    if args.output_json:
        payload = {
            "retrieval_eval": retrieval_eval,
            "qa_eval": qa_eval,
            "solutions": [s.to_dict() for s in solutions],
        }
        with open(args.output_json, "w") as f:
            json.dump(payload, f, indent=1, default=str)
        print(f"wrote {args.output_json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
