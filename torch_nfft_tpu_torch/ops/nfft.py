"""The public adjoint and forward NFFT and the fastsum on the binned engine.

Counterparts of ``nfft_adjoint``, ``nfft_forward`` and ``nfft_fastsum`` in
the JAX package's ``ops/nfft.py``, with the same signatures and layouts:

  adjoint:  y[b, k, c] = sum_{i in batch b} x[i, c] exp(+2 pi i k.pos_i)
  forward:  y[i, c]    = sum_k x[batch_i, k, c] exp(-2 pi i k.pos_i)
  fastsum:  y = forward(coeffs * adjoint(x)), per batch and column

with k in [-N/2, N/2)^dim stored at index k + N/2. x carries trailing
column dimensions, flattened to C columns for the engine. The spectral
stage is ``torch.fft`` complex to complex (ops/fft.py), as the JAX
package's complex-dtype entry points run it, except in the fastsum of a
real x, whose real output is the round trip on half spectra (``rfftn``,
the coefficients' Hermitian part, ``irfftn``). A complex x travels
through the real window kernels as its real and imaginary planes side by
side on the column axis (2C columns); the window weights are real, so the
planes never mix, and they are recombined on the grid.

All are differentiable in x and, when ``pos`` is a tensor that requires
grad, in the positions. ``strategy`` follows the JAX package's
``_maybe_build_plan`` (``spread_gather.plan_or_engine``): with a plan the
binned engine; without one, ``"auto"`` plans from 4096 points on where the
one-hot operands would exceed 2^24 entries and otherwise runs the matmul
engine (scatter beyond 2^24 entries), ``"binned"`` plans, ``"scatter"`` and
``"matmul"`` run those engines. A plan they build is the host plan
(``build_plan``), kept in a least-recently-used cache of four plans keyed
by the content of (pos, batch) and the geometry, as the JAX package does;
:func:`clear_plan_cache` empties it. Each call runs on the CUDA card unless
``device="cpu"`` is given; on the card the binned engine takes m up to 9
(2m + 2 <= 20 window cells, ``ops/contract.py:check_window_width``),
checked before any plan is built or kernel launched.

Under ``TORCH_NFFT_TPU_DEBUG=1`` each entry point first checks its points
and batch vectors (``utils/debug.py:validate_inputs``).
:func:`set_complex_override` (or ``TORCH_NFFT_TPU_COMPLEX=0``) switches the
complex pipelines off, as on the JAX package's complex-free TPU runtime.
"""

from __future__ import annotations

import hashlib
import math
import os
from collections import OrderedDict

import numpy as np
import torch

from .. import trace
from .._device import resolve_device
from .binned import build_plan, host_array, run_stages
from .contract import check_window_width
from .fft import spectral_adjoint, spectral_forward
from .planar import (
    _tensor,
    check_strategy,
    fastsum_spectral_stages,
    nfft_adjoint_planar,
    nfft_fastsum_real,
    nfft_forward_planar,
    no_columns,
    points_route,
    shape_of,
)
from .spread_gather import plan_or_engine
from .window import DEFAULT_SIGMA, DEFAULT_WINDOW

__all__ = ["nfft_adjoint", "nfft_forward", "nfft_fastsum", "clear_plan_cache",
           "set_complex_override"]

# None: the complex pipelines run unless TORCH_NFFT_TPU_COMPLEX says 0
_COMPLEX_OK = None

# nfft_fastsum calls by the spectral route they took ("half" spectra or
# "c2c"); trace.counters() reports them as fastsum_route.<route>
fastsum_routes = {"half": 0, "c2c": 0}


def set_complex_override(value: bool | None) -> None:
    """Switch the complex-dtype pipelines on (``True``) or off (``False``),
    or back to the ``TORCH_NFFT_TPU_COMPLEX`` variable (``None``, the
    default; unset means on). Off, as on the JAX package's complex-free
    TPU runtime: a real input with a real output runs the planar pipeline
    (ops/planar.py), anything else raises ``ValueError``."""
    global _COMPLEX_OK
    _COMPLEX_OK = None if value is None else bool(value)


def _complex_ok() -> bool:
    if _COMPLEX_OK is not None:
        return _COMPLEX_OK
    return os.environ.get("TORCH_NFFT_TPU_COMPLEX", "1") not in ("0", "false", "no")


def _no_complex_error(op: str) -> ValueError:
    return ValueError(
        f"{op} needs a complex-valued FFT pipeline, but the complex pipelines are "
        "switched off (set_complex_override(False) or TORCH_NFFT_TPU_COMPLEX=0). "
        "Either pass real_output=True with real inputs (routes through the pure-real "
        "planar pipeline), call the planar APIs directly (nfft_adjoint_planar / "
        "nfft_forward_planar / nfft_fastsum_real), or switch them on with "
        "set_complex_override(True).")


def _validate(pos, batch, batch_size) -> None:
    """``utils.debug.validate_inputs`` under ``TORCH_NFFT_TPU_DEBUG=1``."""
    from ..utils.debug import debug_enabled, validate_inputs  # utils imports this module

    if debug_enabled():
        validate_inputs(pos, batch, batch_size)

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


def _side(pos, batch, plan, *, strategy, batch_size, N, m, sigma, window, device, C):
    """(device, route) of one side of a transform, as the JAX package's
    ``_maybe_build_plan`` decides it for C columns: a plan passed in, a
    cached host plan, or the plan-free engine."""
    check_strategy(strategy)
    n, dim = shape_of(pos)
    engine = "binned" if plan is not None else plan_or_engine(
        strategy, n, dim, batch_size, int(round(sigma * N)), C)
    if engine == "binned" and plan is None:
        plan = _cached_plan(pos, batch, N=N, m=m, sigma=sigma, batch_size=batch_size,
                            window=window, device=device)
    return points_route(pos, batch, plan, strategy=strategy, batch_size=batch_size, N=N,
                        m=m, sigma=float(sigma), window=window, device=device, C=C,
                        engine=engine)


def _empty(shape, complex_out: bool, allowed: bool, op: str, strategy, device):
    """``planar.no_columns`` in complex64 or float32; raises where the
    complex pipelines are off and the call needs them (not ``allowed``)."""
    if not allowed:
        raise _no_complex_error(op)
    return no_columns(shape, strategy, device,
                      torch.complex64 if complex_out else torch.float32)


def _is_complex(a) -> bool:
    return torch.as_tensor(a).is_complex()


def _planes(x: torch.Tensor) -> torch.Tensor:
    """(n, C) complex -> (n, 2C) real: the real and imaginary planes."""
    return torch.cat([x.real, x.imag], dim=1) if x.is_complex() else x


@trace.spanned("nfft_adjoint")
def nfft_adjoint(x, pos, batch=None, bandwidth=16, cutoff=3, real_output=False, *,
                 batch_size=None, N=None, m=None, sigma=DEFAULT_SIGMA,
                 strategy="auto", plan=None, window=DEFAULT_WINDOW, device=None):
    """Adjoint NFFT: x (n, *cols) real or complex -> (batch_size, N, ..., N,
    *cols) complex64 (float32, the real part, with ``real_output``).
    ``N``/``m`` are aliases of ``bandwidth``/``cutoff``."""
    N = int(bandwidth if N is None else N)
    m = int(cutoff if m is None else m)
    batch, batch_size = _normalize_batch(batch, batch_size)
    _validate(pos, batch, batch_size)
    xs = shape_of(x)
    trailing = tuple(xs[1:])
    C = math.prod(trailing)
    if C == 0:
        return _empty((batch_size,) + (N,) * shape_of(pos)[1] + trailing, not real_output,
                      _complex_ok() or (real_output and not _is_complex(x)),
                      "nfft_adjoint with complex output", strategy, device)
    dev, route = _side(pos, batch, plan, strategy=strategy, batch_size=batch_size, N=N, m=m,
                       sigma=sigma, window=window, device=device, C=C)
    x = _tensor(x, dev)
    xf = x.reshape(xs[0], C)
    if not _complex_ok():
        if not (real_output and not x.is_complex()):
            raise _no_complex_error("nfft_adjoint with complex output")
        yr, _ = nfft_adjoint_planar(xf, pos, batch, route.plan, batch_size=batch_size, N=N,
                                    m=m, sigma=float(sigma), strategy=strategy,
                                    window=window, device=dev)
        return yr.reshape((batch_size,) + (N,) * route.dim + trailing)
    g = route.spread(_planes(xf))  # (B, C or 2C, M^dim)
    if x.is_complex():
        g = torch.complex(g[:, :C], g[:, C:])
    y = spectral_adjoint(g, route.dim, N, m, float(sigma), window)  # (B, C, N^dim)
    y = y.movedim(1, -1).reshape((batch_size,) + (N,) * route.dim + trailing)
    return y.real if real_output else y


@trace.spanned("nfft_forward")
def nfft_forward(x, pos, batch=None, cutoff=3, real_output=False, *,
                 batch_size=None, m=None, sigma=DEFAULT_SIGMA, strategy="auto",
                 plan=None, window=DEFAULT_WINDOW, device=None):
    """Forward NFFT: x (batch_size, N, ..., N, *cols) real or complex, with
    ``pos.shape[1]`` spatial axes -> (n, *cols) complex64 (float32, the
    real part, with ``real_output``)."""
    m = int(cutoff if m is None else m)
    n, dim = shape_of(pos)
    batch, batch_size = _normalize_batch(batch, batch_size)
    xs = shape_of(x)
    if xs[0] != batch_size:
        raise ValueError(f"x.shape[0] = {xs[0]} must equal batch_size = {batch_size}")
    _validate(pos, batch, batch_size)
    N = xs[1]
    trailing = tuple(xs[1 + dim:])
    C = math.prod(trailing)
    if C == 0:
        return _empty((n,) + trailing, not real_output,
                      _complex_ok() or (real_output and not _is_complex(x)),
                      "nfft_forward with complex output", strategy, device)
    dev, route = _side(pos, batch, plan, strategy=strategy, batch_size=batch_size, N=N, m=m,
                       sigma=sigma, window=window, device=device, C=C)
    x = _tensor(x, dev)
    if not _complex_ok():
        if not (real_output and not x.is_complex()):
            raise _no_complex_error("nfft_forward with complex output")
        yr, _ = nfft_forward_planar(
            x.reshape((batch_size,) + (N,) * dim + (C,)), None, pos, batch, route.plan,
            batch_size=batch_size, dim=dim, m=m, sigma=float(sigma), strategy=strategy,
            real_output=True, window=window, device=dev)
        return yr.reshape((n,) + trailing)
    z = x.reshape((batch_size,) + (N,) * dim + (C,)).movedim(-1, 1)
    g = spectral_forward(z.to(torch.complex64), dim, route.M, m, float(sigma),
                         window)  # (B, C, M^dim)
    if real_output:
        return route.gather(g.real.contiguous()).reshape((n,) + trailing)
    y = route.gather(torch.cat([g.real, g.imag], dim=1))
    return torch.complex(y[:, :C], y[:, C:]).reshape((n,) + trailing)


@trace.spanned("nfft_fastsum")
def nfft_fastsum(x, coeffs, sources, targets=None, source_batch=None, target_batch=None,
                 /, batch=None, cutoff=3, *, batch_size=None, m=None, sigma=DEFAULT_SIGMA,
                 strategy="auto", source_plan=None, target_plan=None,
                 window=DEFAULT_WINDOW, device=None):
    """Fast multiplication with the trigonometric kernel (Gram) matrix:
    ``y[t] ~= sum_s K(sources[s] - targets[t]) x[s]``, K the trigonometric
    series with centered coefficients ``coeffs`` ((N,)*dim, frequency l at
    index l + N/2). x (n_src, *cols) real or complex -> (n_tgt, *cols):
    real for real x (also with complex coefficients), complex64 for
    complex x.

    Without ``targets`` the targets are the sources. Source and target
    share one plan when ``targets is sources`` and ``target_batch is
    source_batch`` (identity, not equal values) and the source side
    plans; otherwise each side has its own, from
    ``source_plan``/``target_plan``, the plan cache, or none (the plan-free
    engines, by the rule of the module note). The pipeline: spread on the
    source side, unnormalised inverse DFT, the band filter
    ``coeffs * phi_hat_inv^2``, forward DFT, gather on the target side.
    Differentiable in x, in the coefficients and, for tensors that require
    grad, in the sources and targets.

    The spectral route follows the dtype of x. A complex x takes complex
    to complex (``fastsum_spectral_stages(hermitian=False)``). A real x
    takes half spectra (``hermitian=True``: ``rfftn``, the half spectrum
    of the coefficients' Hermitian part, ``irfftn``): its real grid is the
    real plane of the complex-to-complex round trip, for real and complex
    coefficients alike, and so are the gradients. ``trace.counters()``
    counts the calls of each as ``fastsum_route.c2c`` /
    ``fastsum_route.half``."""
    check_strategy(strategy)
    m = int(cutoff if m is None else m)
    if targets is None:
        targets, target_batch = sources, source_batch
        if target_plan is None:
            target_plan = source_plan
    if batch is not None:
        source_batch = target_batch = batch
    symmetric = targets is sources and target_batch is source_batch
    dev = resolve_device(device)
    coeffs = _tensor(coeffs, dev)
    n_src, dim = shape_of(sources)
    N = coeffs.shape[0]
    if coeffs.ndim != dim:
        raise ValueError(f"coeffs must be {dim}-dimensional, got {coeffs.ndim}")
    if any(s != N for s in coeffs.shape):
        raise ValueError("coeffs must have equal size N in every dimension")
    source_batch, bs_src = _normalize_batch(source_batch, batch_size)
    target_batch, bs_tgt = _normalize_batch(target_batch, batch_size)
    if bs_src != bs_tgt:
        raise ValueError(f"source batch size {bs_src} != target batch size {bs_tgt}")
    _validate(sources, source_batch, bs_src)
    _validate(targets, target_batch, bs_tgt)
    xs = shape_of(x)
    if xs[0] != n_src:
        raise ValueError(f"x has {xs[0]} rows for {n_src} sources")
    trailing = tuple(xs[1:])
    C = math.prod(trailing)
    if C == 0:
        complex_x = _is_complex(x)
        return _empty((shape_of(targets)[0],) + trailing, complex_x,
                      _complex_ok() or not (complex_x or coeffs.is_complex()),
                      "nfft_fastsum with complex inputs", strategy, dev)
    kw = dict(strategy=strategy, batch_size=bs_src, N=N, m=m, sigma=sigma, window=window,
              device=dev, C=C)
    _, src = _side(sources, source_batch, source_plan, **kw)
    if symmetric and target_plan is None:
        tgt = src  # one plan, or one engine on the same points
    else:
        _, tgt = _side(targets, target_batch, target_plan, **kw)

    x = _tensor(x, dev)
    xf = x.reshape(n_src, C)
    half = not x.is_complex()
    complex_ok = _complex_ok()
    if not complex_ok and (x.is_complex() or coeffs.is_complex()):
        raise _no_complex_error("nfft_fastsum with complex inputs")
    fastsum_routes["half" if half else "c2c"] += 1
    if not complex_ok:
        y = nfft_fastsum_real(xf, coeffs, sources, targets, source_batch, target_batch,
                              src.plan, tgt.plan, batch_size=bs_src, N=N, m=m,
                              sigma=float(sigma), strategy=strategy, window=window, device=dev)
        return y.reshape((tgt.n,) + trailing)
    g = src.spread(_planes(xf))
    g = run_stages(fastsum_spectral_stages(
        coeffs, dim=dim, N=N, M=src.M, m=m, sigma=float(sigma), window=window,
        complex_x=x.is_complex(), hermitian=half), g)
    y = tgt.gather(g)
    if x.is_complex():
        y = torch.complex(y[:, :C], y[:, C:])
    return y.reshape((tgt.n,) + trailing)
