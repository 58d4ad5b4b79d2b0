"""Device ops of the PyTorch port: scoring, fused top-k, kNN, PageRank."""
