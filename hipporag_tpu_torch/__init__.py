"""hipporag_tpu_torch — the HippoRAG retrieval system on PyTorch and CUDA.

A port of ``hipporag_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA GPU,
module for module: ``hipporag_tpu_torch/ops/pagerank.py`` is the
counterpart of ``hipporag_tpu/ops/pagerank.py``, and so on. The device
code is torch plus hand-written CUDA kernels (``csrc/``); it never imports
JAX, nor anything of ``hipporag_tpu``. The host components (config, LLMs,
embedders, stores, OpenIE, prompts, the rerank filter, dataset loading, the
serving layer) are the package's own copies of the JAX package's JAX-free
modules, in the same layout, with the same on-disk formats.
"""

from .config import BaseConfig
from .datasets import load_dataset
from .utils.misc import Chunk, QuerySolution, RetrievalResult, compute_mdhash_id

__all__ = [
    "BaseConfig",
    "Chunk",
    "HippoRAG",
    "QuerySolution",
    "RetrievalResult",
    "StandardRAG",
    "compute_mdhash_id",
    "load_dataset",
]


def __getattr__(name):
    # lazy: `import hipporag_tpu_torch` stays light until the orchestrator is used
    if name == "HippoRAG":
        from .hipporag import HippoRAG

        return HippoRAG
    if name == "StandardRAG":
        from .standard_rag import StandardRAG

        return StandardRAG
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
