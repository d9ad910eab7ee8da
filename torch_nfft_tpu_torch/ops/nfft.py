"""The public adjoint and forward NFFT on the binned engine.

Counterparts of ``nfft_adjoint`` and ``nfft_forward`` in the JAX package's
``ops/nfft.py``, with the same signatures and layouts:

  adjoint:  y[b, k, c] = sum_{i in batch b} x[i, c] exp(+2 pi i k.pos_i)
  forward:  y[i, c]    = sum_k x[batch_i, k, c] exp(-2 pi i k.pos_i)

with k in [-N/2, N/2)^dim stored at index k + N/2. x carries trailing
column dimensions, flattened to C columns for the engine. The spectral
stage is ``torch.fft`` C2C (ops/fft.py). A complex x travels through the
real window kernels as its real and imaginary planes side by side on the
column axis (2C columns); the window weights are real, so the planes never
mix, and they are recombined on the grid.

Both are differentiable in x and, when ``pos`` is a tensor that requires
grad, in the positions. Only the binned strategy is ported: ``"auto"`` and
``"binned"`` run it; ``"scatter"`` and ``"matmul"`` raise. With
``plan=None`` the host plan (``build_plan``) is built on the first call for
a point set and kept in a least-recently-used cache of four plans keyed by
the content of (pos, batch) and the geometry, as the JAX package does;
:func:`clear_plan_cache` empties it. Each call runs on the CUDA card unless
``device="cpu"`` is given; on the card m is at most 9 (2m + 2 <= 20 window
cells, ``ops/contract.py:check_window_width``), checked before any plan is
built or kernel launched.
"""

from __future__ import annotations

import hashlib
import math
from collections import OrderedDict

import numpy as np
import torch

from .._device import resolve_device
from .binned import build_plan, gather_binned, host_array, spread_binned
from .contract import check_window_width
from .fft import spectral_adjoint, spectral_forward
from .planar import check_strategy, grad_pos, setup_plan, shape_of
from .window import DEFAULT_SIGMA, DEFAULT_WINDOW

__all__ = ["nfft_adjoint", "nfft_forward", "clear_plan_cache"]

# plans built by the entry points, least recently used first
_PLAN_CACHE: OrderedDict = OrderedDict()
_PLAN_CACHE_MAX = 4


def clear_plan_cache() -> None:
    """Drop every cached plan (frees its device tensors)."""
    _PLAN_CACHE.clear()


def _cached_plan(pos, batch, *, N, m, sigma, batch_size, window, device):
    """The host plan of (pos, batch) for this geometry on ``device``, from
    the cache when the same content was planned before. The key hashes the
    float32 positions and the batch vector, read on the host."""
    dev = resolve_device(device)
    check_window_width(m, dev)
    p = host_array(pos, np.float32)
    h = hashlib.blake2b(p.tobytes(), digest_size=16)
    b = None if batch is None else host_array(batch, np.int32)
    if b is not None:
        h.update(b.tobytes())
    key = (h.digest(), p.shape, N, m, float(sigma), batch_size, window, str(dev))
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        plan = build_plan(p, b, N=N, m=m, sigma=sigma, batch_size=batch_size,
                          window=window, device=dev)
        _PLAN_CACHE[key] = plan
        while len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
            _PLAN_CACHE.popitem(last=False)
    else:
        _PLAN_CACHE.move_to_end(key)
    return plan


def _normalize_batch(batch, batch_size):
    """(batch, batch_size) as the JAX package resolves them: no batch vector
    means one batch; a batch vector without ``batch_size`` means
    ``batch[-1] + 1`` batches (the vector is sorted)."""
    if batch is None:
        return None, 1
    batch = torch.as_tensor(batch)
    if batch_size is None:
        batch_size = int(batch[-1]) + 1
    return batch, int(batch_size)


def _tensor(a, dev) -> torch.Tensor:
    """``a`` on ``dev`` as float32 or complex64."""
    a = torch.as_tensor(a, device=dev)
    return a.to(torch.complex64 if a.is_complex() else torch.float32)


def nfft_adjoint(x, pos, batch=None, bandwidth=16, cutoff=3, real_output=False, *,
                 batch_size=None, N=None, m=None, sigma=DEFAULT_SIGMA,
                 strategy="auto", plan=None, window=DEFAULT_WINDOW, device=None):
    """Adjoint NFFT: x (n, *cols) real or complex -> (batch_size, N, ..., N,
    *cols) complex64 (float32, the real part, with ``real_output``).
    ``N``/``m`` are aliases of ``bandwidth``/``cutoff``."""
    check_strategy(strategy)
    N = int(bandwidth if N is None else N)
    m = int(cutoff if m is None else m)
    batch, batch_size = _normalize_batch(batch, batch_size)
    if plan is None:
        plan = _cached_plan(pos, batch, N=N, m=m, sigma=sigma, batch_size=batch_size,
                            window=window, device=device)
    dev, plan = setup_plan(pos, batch, plan, batch_size=batch_size, N=N, m=m,
                            sigma=float(sigma), window=window, device=device)
    x = _tensor(x, dev)
    n, trailing = x.shape[0], tuple(x.shape[1:])
    C = math.prod(trailing)
    xf = x.reshape(n, C)
    planes = torch.cat([xf.real, xf.imag], dim=1) if x.is_complex() else xf
    g = spread_binned(plan, planes, grad_pos(pos))  # (B, C or 2C, M^dim)
    if x.is_complex():
        g = torch.complex(g[:, :C], g[:, C:])
    y = spectral_adjoint(g, plan.dim, N, m, float(sigma), window)  # (B, C, N^dim)
    y = y.movedim(1, -1).reshape((batch_size,) + (N,) * plan.dim + trailing)
    return y.real if real_output else y


def nfft_forward(x, pos, batch=None, cutoff=3, real_output=False, *,
                 batch_size=None, m=None, sigma=DEFAULT_SIGMA, strategy="auto",
                 plan=None, window=DEFAULT_WINDOW, device=None):
    """Forward NFFT: x (batch_size, N, ..., N, *cols) real or complex, with
    ``pos.shape[1]`` spatial axes -> (n, *cols) complex64 (float32, the
    real part, with ``real_output``)."""
    check_strategy(strategy)
    m = int(cutoff if m is None else m)
    n, dim = shape_of(pos)
    batch, batch_size = _normalize_batch(batch, batch_size)
    xs = shape_of(x)
    if xs[0] != batch_size:
        raise ValueError(f"x.shape[0] = {xs[0]} must equal batch_size = {batch_size}")
    N = xs[1]
    if plan is None:
        plan = _cached_plan(pos, batch, N=N, m=m, sigma=sigma, batch_size=batch_size,
                            window=window, device=device)
    dev, plan = setup_plan(pos, batch, plan, batch_size=batch_size, N=N, m=m,
                            sigma=float(sigma), window=window, device=device)
    x = _tensor(x, dev)
    trailing = tuple(x.shape[1 + dim:])
    C = math.prod(trailing)
    z = x.reshape((batch_size,) + (N,) * dim + (C,)).movedim(-1, 1)
    g = spectral_forward(z.to(torch.complex64), dim, plan.M, m, float(sigma),
                         window)  # (B, C, M^dim)
    p = grad_pos(pos)
    if real_output:
        return gather_binned(plan, g.real.contiguous(), p).reshape((n,) + trailing)
    y = gather_binned(plan, torch.cat([g.real, g.imag], dim=1), p)
    return torch.complex(y[:, :C], y[:, C:]).reshape((n,) + trailing)
