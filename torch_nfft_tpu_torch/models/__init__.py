"""Kernel-matrix layer of the PyTorch port: the Gaussian and radial
kernels and their lazy operators."""

from .kernel import GaussianKernel
from .matrices import AbstractMatrix, AdjacencyMatrix, GramMatrix
from .radial import InverseMultiquadricKernel, LaplaceKernel, MaternKernel, RadialKernel

__all__ = ["AbstractMatrix", "AdjacencyMatrix", "GaussianKernel", "GramMatrix",
           "InverseMultiquadricKernel", "LaplaceKernel", "MaternKernel", "RadialKernel"]
