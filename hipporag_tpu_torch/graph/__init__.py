from .builder import GraphBuilder
from .csr import compile_device_graph, pick_capacity, round_up

__all__ = ["GraphBuilder", "compile_device_graph", "pick_capacity", "round_up"]
