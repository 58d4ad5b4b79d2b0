"""Global configuration for hipporag_tpu_torch.

A single flat dataclass threaded (by reference) through every component,
mirroring the configuration surface of the reference framework
(reference: src/hipporag/utils/config_utils.py:14-295) while adding the
device knobs (mesh shape, PPR solver settings, kernel tile sizes). The
fields are the JAX package's, so one set of values drives both packages.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, fields
from typing import Literal, Optional, Union


@dataclass
class BaseConfig:
    # ------------------------------------------------------------------ LLM
    llm_name: str = "gpt-4o-mini"
    llm_base_url: Optional[str] = None
    embedding_base_url: Optional[str] = None
    azure_endpoint: Optional[str] = None
    azure_embedding_endpoint: Optional[str] = None
    max_new_tokens: Union[None, int] = 2048
    num_gen_choices: int = 1
    seed: Union[None, int] = None
    temperature: float = 0.0
    response_format: Union[dict, None] = field(
        default_factory=lambda: {"type": "json_object"}
    )
    max_retry_attempts: int = 5
    # Bedrock auth knobs (reference config_utils.py:58-68): "api_key" reads
    # AWS_BEARER_TOKEN_BEDROCK; "aws_credentials" SigV4-signs with the named
    # profile and requires bedrock_region
    bedrock_mantle_auth: str = "api_key"  # "api_key" | "aws_credentials"
    bedrock_aws_profile: Optional[str] = None
    bedrock_region: Optional[str] = None
    # read-only reference-format SQLite cache (llm/replay_cache.py): lets
    # recorded reference-run LLM responses (OpenIE / filter / QA) replay
    # through this framework for pinned parity evals
    llm_replay_cache_path: Optional[str] = None

    # -------------------------------------------------------------- indexing
    force_openie_from_scratch: bool = False
    force_index_from_scratch: bool = False
    rerank_dspy_file_path: Optional[str] = None
    passage_node_weight: float = 0.05
    save_openie: bool = True

    # --------------------------------------------------------- preprocessing
    text_preprocessor_class_name: str = "TextPreprocessor"
    preprocess_encoder_name: str = "gpt-4o"
    preprocess_chunk_overlap_token_size: int = 128
    preprocess_chunk_max_token_size: Optional[int] = None
    preprocess_chunk_func: Literal["by_token", "by_word"] = "by_token"

    # ------------------------------------------------- information extraction
    information_extraction_model_name: str = "openie_openai_gpt"
    openie_mode: Literal["offline", "online"] = "online"
    skip_graph: bool = False

    # -------------------------------------------------------------- embedding
    embedding_model_name: str = "mock"
    embedding_batch_size: int = 16
    embedding_return_as_normalized: bool = True
    embedding_max_seq_len: int = 2048
    embedding_dim: int = 128  # used by mock / synthetic embedders
    embedding_model_dtype: Literal["float16", "float32", "bfloat16", "auto"] = "auto"

    # --------------------------------------------------------- synonymy edges
    synonymy_edge_topk: int = 2047
    synonymy_edge_query_batch_size: int = 1000
    synonymy_edge_key_batch_size: int = 10000
    synonymy_edge_sim_threshold: float = 0.8
    synonymy_edge_max_neighbors: int = 100
    is_directed_graph: bool = False

    # -------------------------------------------------------------- retrieval
    linking_top_k: int = 5
    retrieval_top_k: int = 200
    damping: float = 0.5

    # ------------------------------------------------------------------- QA
    max_qa_steps: int = 1
    qa_top_k: int = 5

    # ------------------------------------------------------------------ paths
    save_dir: Optional[str] = None

    # ----------------------------------------------------------- vector store
    vector_store_type: Literal["parquet", "memory", "qdrant", "chroma", "milvus"] = (
        "parquet"
    )
    qdrant_url: Optional[str] = None
    qdrant_api_key: Optional[str] = None
    chroma_host: Optional[str] = None
    chroma_port: int = 8000
    milvus_uri: Optional[str] = None
    milvus_token: Optional[str] = None
    milvus_db_name: Optional[str] = None
    milvus_consistency_level: Optional[
        Literal["Strong", "Session", "Bounded", "Eventually"]
    ] = None

    # ------------------------------------------------------------ experiments
    dataset: Optional[str] = None
    graph_type: str = "facts_and_sim_passage_node_unidirectional"
    corpus_len: Optional[int] = None

    # ----------------------------------------------------------------- device
    # Mesh layout: ("dp", "corpus"). dp shards the query batch, corpus shards
    # the passage/fact/graph-node axis. (1, 1) = single device.
    mesh_shape: tuple = (1, 1)
    # Batched PPR solver
    ppr_max_iters: int = 64
    # 1e-6 keeps the f32 solver's top-20 documents equal to a float64
    # tol-1e-12 serial solve on the 2wiki harness; 1e-8 recovers
    # probability-level exactness at more iterations.
    ppr_tol: float = 1.0e-6
    # queries per device batch in retrieval; the ELL solver tiles larger
    # batches at 128 columns with a per-tile early exit.
    ppr_batch_size: int = 128
    # "bfloat16" halves SpMV gather traffic (f32 accumulation); "float32"
    # keeps exact reference-parity scores.
    ppr_compute_dtype: str = "float32"
    # >1 streams the edge list in chunks through the SpMV so huge graphs
    # (100M+ edges) never materialize the [E, B] gather at once (COO only).
    ppr_edge_chunks: int = 1
    # "ell": scatter-free bucketed-ELL SpMV; "coo": gather + segment sum over
    # the dst-sorted edge list (supports edge_chunks + bf16 gathers).
    ppr_format: Literal["ell", "coo"] = "ell"
    # Overlap bucket N's host-side recognition-memory LLM calls with bucket
    # N-1's device graph search (per-bucket results are independent, so
    # output is bit-identical to the serial ordering). Depth = how many
    # buckets may be in the score+rerank stage at once.
    pipeline_rerank: bool = True
    pipeline_depth: int = 2
    # Kernel configuration
    score_block_n: int = 2048  # fact/passage tile size for chunked scoring
    use_pallas_kernels: bool = True  # False keeps fact_topk off the fused kernel
    compute_dtype: str = "float32"  # scoring dtype on device ("bfloat16"|"float32")
    # Graph capacity growth factor for padded device buffers (amortizes
    # recompilation during incremental indexing).
    graph_capacity_factor: float = 1.25
    # Profiling trace directory (the JAX package's; the port refuses it).
    profile_log_dir: Optional[str] = None
    # The JAX package's compile-cache directory; unused by the port.
    jax_compilation_cache_dir: Optional[str] = "auto"

    def __post_init__(self):
        if self.save_dir is None:
            if self.dataset is None:
                self.save_dir = "outputs"
            else:
                self.save_dir = os.path.join("outputs", self.dataset)

    @classmethod
    def from_kwargs(cls, **kwargs) -> "BaseConfig":
        valid = {f.name for f in fields(cls)}
        unknown = set(kwargs) - valid
        if unknown:
            raise ValueError(f"Unknown config fields: {sorted(unknown)}")
        return cls(**kwargs)

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}
