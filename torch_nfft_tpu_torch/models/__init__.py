"""Kernel-matrix layer of the PyTorch port: the Gaussian kernel and its
lazy operators."""

from .kernel import GaussianKernel
from .matrices import AbstractMatrix, AdjacencyMatrix, GramMatrix

__all__ = ["AbstractMatrix", "AdjacencyMatrix", "GaussianKernel", "GramMatrix"]
