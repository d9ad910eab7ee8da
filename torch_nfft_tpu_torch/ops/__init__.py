"""Transforms of the PyTorch port, one module per JAX counterpart."""
