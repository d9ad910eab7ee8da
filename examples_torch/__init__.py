"""Application demos of the PyTorch port (see README.md)."""
