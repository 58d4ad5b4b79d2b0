"""Plain reference of the retrieval the benchmark measures: NumPy and plain
PyTorch, importing nothing of the port or of JAX. It rebuilds the graph and
its synonymy edges from the benchmark's OpenIE rows and vectors, solves
Personalized PageRank in its natural node space (no ELL layout)."""
