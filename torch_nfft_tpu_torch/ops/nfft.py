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
``plan=None`` a plan is built per call (the JAX package's plan cache is not
ported). Each call runs on the CUDA card unless ``device="cpu"`` is given.
"""

from __future__ import annotations

import math

import torch

from .binned import gather_binned, spread_binned
from .fft import spectral_adjoint, spectral_forward
from .planar import grad_pos, setup_plan, shape_of
from .window import DEFAULT_SIGMA, DEFAULT_WINDOW

__all__ = ["nfft_adjoint", "nfft_forward"]

_STRATEGIES = ("auto", "binned")


def _check_strategy(strategy: str) -> None:
    if strategy in ("scatter", "matmul"):
        raise NotImplementedError(
            f"strategy={strategy!r} is not ported yet (ROADMAP.md, item A4); "
            "use strategy='binned' or 'auto'")
    if strategy not in _STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; supported: {_STRATEGIES}")


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
    _check_strategy(strategy)
    N = int(bandwidth if N is None else N)
    m = int(cutoff if m is None else m)
    batch, batch_size = _normalize_batch(batch, batch_size)
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
    _check_strategy(strategy)
    m = int(cutoff if m is None else m)
    n, dim = shape_of(pos)
    batch, batch_size = _normalize_batch(batch, batch_size)
    xs = shape_of(x)
    if xs[0] != batch_size:
        raise ValueError(f"x.shape[0] = {xs[0]} must equal batch_size = {batch_size}")
    N = xs[1]
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
