"""Accuracy self-check: the NFFT against the dense NDFT on a subsample.

Counterpart of the JAX package's ``utils/diagnostics.py``: one call gives
the adjoint's error for the caller's (N, m, points) at O(samples * N^dim).
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..ops.ndft import ndft_adjoint
from ..ops.nfft import nfft_adjoint

__all__ = ["accuracy_check"]


def accuracy_check(pos, bandwidth=16, cutoff=3, *, sample_points=256, columns=2, seed=0,
                   sigma=2.0, window="gaussian", device=None) -> float:
    """Relative L2 error of the adjoint NFFT against the dense NDFT (float64)
    on a random subsample of ``pos`` (one batch). The subsample and the
    values come from ``np.random.default_rng(seed)`` exactly as in the JAX
    package, so both check the same points; ``pos`` is read on the host (a
    tensor is copied there). Both transforms run on ``device``, the card
    unless ``device="cpu"``."""
    if isinstance(pos, torch.Tensor):
        pos = pos.detach().cpu().numpy()
    pos = np.asarray(pos)
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = pos.shape[0]
    take = min(int(sample_points), n)
    idx = rng.choice(n, size=take, replace=False)
    sub = pos[idx].astype(np.float32)
    x = rng.standard_normal((take, columns)).astype(np.float32)
    approx = nfft_adjoint(x, sub, bandwidth=bandwidth, cutoff=cutoff, sigma=sigma,
                          window=window, device=dev)
    exact = ndft_adjoint(torch.from_numpy(x).to(dev, torch.float64),
                         torch.from_numpy(sub).to(dev, torch.float64), N=bandwidth)
    num = float(torch.linalg.vector_norm(approx.to(exact.dtype) - exact))
    den = float(torch.linalg.vector_norm(exact))
    return num / max(den, 1e-30)
