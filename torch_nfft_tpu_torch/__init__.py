"""PyTorch and CUDA port of the JAX NFFT package, for NVIDIA Hopper (H100).

The binned adjoint + forward NFFT pair of the JAX package, with the spread
and gather window contractions as hand-written CUDA kernels (``csrc/``,
built by ``nvcc`` at first CUDA use) and the spectral stage on ``torch.fft``.
It imports neither JAX nor the JAX package.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card and without ``device=`` they raise.
"""

from ._device import resolve_device
from .convert import plan_from_numpy, plan_to_numpy
from .ops.binned import BinnedPlan, build_plan_device, gather_binned, spread_binned
from .ops.ndft import ndft_adjoint, ndft_forward
from .ops.planar import nfft_adjoint_planar, nfft_forward_planar, nfft_pair_planar

__all__ = [
    "BinnedPlan",
    "build_plan_device",
    "gather_binned",
    "ndft_adjoint",
    "ndft_forward",
    "nfft_adjoint_planar",
    "nfft_forward_planar",
    "nfft_pair_planar",
    "plan_from_numpy",
    "plan_to_numpy",
    "resolve_device",
    "spread_binned",
]
