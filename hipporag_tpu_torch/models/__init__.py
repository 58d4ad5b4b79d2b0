"""Batched graph retrieval of the PyTorch port."""
