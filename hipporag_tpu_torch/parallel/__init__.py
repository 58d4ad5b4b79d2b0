"""Host-side helpers of the multi-device layer; only the seed twin is ported."""

from .seeds import build_reset_vectors

__all__ = ["build_reset_vectors"]
