"""PyTorch and CUDA port of the JAX NFFT package, for NVIDIA Hopper (H100).

The binned adjoint and forward NFFT of the JAX package (``nfft_adjoint``,
``nfft_forward`` and the planar entry points), with the spread, gather and
position-gradient window contractions and the user <-> slot permutations
(Benes network and ragged row passes) as hand-written CUDA kernels
(``csrc/*.cu``, built by ``nvcc`` at first CUDA use) and the spectral stage
on ``torch.fft``. Plans come from the host builder (``build_plan``, native
C++ in ``csrc/*.cpp`` built by ``g++`` at first use) or the device builder
(``build_plan_device``); ``plan.with_benes_tables()`` routes the Benes
network. Every transform is differentiable in its values and in the point
positions. It imports neither JAX nor the JAX package.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card and without ``device=`` they raise.
"""

from ._device import resolve_device
from .convert import plan_from_numpy, plan_to_numpy
from .ops.benes import BenesTables
from .ops.binned import (
    BinnedPlan,
    build_plan,
    build_plan_device,
    from_slot_order,
    gather_binned,
    plan_slot_pos_user,
    spread_binned,
    to_slot_order,
)
from .ops.ndft import ndft_adjoint, ndft_forward
from .ops.nfft import clear_plan_cache, nfft_adjoint, nfft_forward
from .ops.planar import nfft_adjoint_planar, nfft_forward_planar, nfft_pair_planar

__all__ = [
    "BenesTables",
    "BinnedPlan",
    "build_plan",
    "build_plan_device",
    "clear_plan_cache",
    "from_slot_order",
    "gather_binned",
    "ndft_adjoint",
    "ndft_forward",
    "nfft_adjoint",
    "nfft_forward",
    "nfft_adjoint_planar",
    "nfft_forward_planar",
    "nfft_pair_planar",
    "plan_from_numpy",
    "plan_slot_pos_user",
    "plan_to_numpy",
    "resolve_device",
    "spread_binned",
    "to_slot_order",
]
