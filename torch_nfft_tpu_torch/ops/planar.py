"""Planar NFFT entry points: real inputs, (real, imaginary) plane outputs.

Counterparts of ``nfft_adjoint_planar``, ``nfft_forward_planar`` and
``nfft_pair_planar`` in the JAX package's ``ops/planar.py``, with the same
argument and result layouts: x (n, C); spectra (batch_size, (N,)*dim, C) as
two real planes. They run the binned engine (ops/binned.py) around the
``torch.fft`` spectral stage (ops/fft.py). With ``plan=None`` a plan is built
for the points; pass one to reuse it across calls.

Every entry point runs on the CUDA card unless ``device="cpu"`` is given,
and raises when no card is there and no device was asked for.
"""

from __future__ import annotations

import torch

from .._device import resolve_device
from .binned import (
    BinnedPlan,
    build_plan_device,
    check_points,
    gather_binned,
    gather_stages,
    run_stages,
    spread_binned,
    spread_stages,
)
from .fft import spectral_adjoint, spectral_forward
from .window import DEFAULT_SIGMA, DEFAULT_WINDOW

__all__ = ["nfft_adjoint_planar", "nfft_forward_planar", "nfft_pair_planar",
           "pair_stages"]


def _check_window_match(window, plan, *, m, M, sigma):
    """A plan built for another window family or (M, m, sigma) geometry
    would give wrong results at full speed: fail loudly. sigma is compared
    directly, not only through M: the window weights depend on sigma, so two
    (N, sigma) pairs with the same M must still be told apart."""
    if plan.window != window:
        raise ValueError(
            f"plan was built with window={plan.window!r} but the transform "
            f"uses window={window!r} — rebuild the plan or pass the matching "
            "window="
        )
    if plan.m != m:
        raise ValueError(
            f"plan was built with cutoff m={plan.m} but the transform uses "
            f"m={m} — rebuild the plan for this geometry"
        )
    if plan.M != M:
        raise ValueError(
            f"plan was built for an oversampled grid M={plan.M} but the "
            f"transform uses M={M} (sigma*N mismatch) — rebuild the plan "
            "with this N and sigma"
        )
    if plan.sigma != float(sigma):
        raise ValueError(
            f"plan was built with sigma={plan.sigma} but the transform uses "
            f"sigma={float(sigma)} (same M={plan.M}, different N) — the "
            "plan's window weights depend on sigma; rebuild the plan for "
            "this (N, sigma)"
        )


def _shape(a) -> tuple:
    return tuple(a.shape) if hasattr(a, "shape") else tuple(torch.as_tensor(a).shape)


def _setup(pos, batch, plan, *, batch_size, N, m, sigma, window, device):
    """Resolve the device and return a plan for (pos, batch) that matches the
    transform's geometry."""
    dev = resolve_device(device)
    M = int(round(sigma * N))
    if plan is None:
        plan = build_plan_device(pos, batch, N=N, m=m, sigma=sigma,
                                 batch_size=batch_size, window=window, device=dev)
    if not isinstance(plan, BinnedPlan):
        raise TypeError(f"plan must be a BinnedPlan, got {type(plan).__name__}")
    _check_window_match(window, plan, m=m, M=M, sigma=sigma)
    if plan.device != dev:
        raise ValueError(f"the plan lives on {plan.device}, the transform runs on {dev}")
    if _shape(pos) != (plan.n, plan.dim):
        raise ValueError(f"pos has shape {_shape(pos)}; the plan was built "
                         f"for ({plan.n}, {plan.dim})")
    if batch_size != plan.batch_size:
        raise ValueError(f"batch_size={batch_size} but the plan was built for "
                         f"batch_size={plan.batch_size}")
    return dev, plan


def _real(a, dev) -> torch.Tensor:
    return torch.as_tensor(a, device=dev).to(torch.float32)


def nfft_adjoint_planar(x, pos, batch=None, plan=None, *, batch_size: int,
                        N: int, m: int, sigma: float = DEFAULT_SIGMA,
                        window: str = DEFAULT_WINDOW, device=None):
    """Adjoint NFFT of real samples x (n, C): returns (yr, yi), each
    (batch_size, (N,)*dim, C), y[b, k] = sum_i x_i exp(+2 pi i k.pos_i)."""
    dev, plan = _setup(pos, batch, plan, batch_size=batch_size, N=N, m=m,
                       sigma=sigma, window=window, device=device)
    g = spread_binned(plan, _real(x, dev))
    y = spectral_adjoint(g, plan.dim, N, m, sigma, window).movedim(1, -1)
    return y.real.contiguous(), y.imag.contiguous()


def nfft_forward_planar(xr, xi, pos, batch=None, plan=None, *, batch_size: int,
                        dim: int, m: int, sigma: float = DEFAULT_SIGMA,
                        real_output: bool = False,
                        window: str = DEFAULT_WINDOW, device=None):
    """Forward NFFT of a planar spectrum xr/xi (batch_size, (N,)*dim, C),
    xi may be None: returns (yr, yi), each (n, C),
    y_i = sum_k x[batch_i, k] exp(-2 pi i k.pos_i). With ``real_output``
    only the real plane is gathered and the result is (yr, None)."""
    N = _shape(xr)[1]
    dev, plan = _setup(pos, batch, plan, batch_size=batch_size, N=N, m=m,
                       sigma=sigma, window=window, device=device)
    if plan.dim != dim:
        raise ValueError(f"dim={dim} but the plan was built for dim={plan.dim}")
    z = _real(xr, dev)
    if xi is not None:
        z = torch.complex(z, _real(xi, dev))
    z = z.to(torch.complex64).movedim(-1, 1)
    g = spectral_forward(z, dim, plan.M, m, sigma, window)  # (B, C, M^dim)
    if real_output:
        return gather_binned(plan, g.real.contiguous()), None
    C = z.shape[1]
    y = gather_binned(plan, torch.cat([g.real, g.imag], dim=1))
    return y[:, :C], y[:, C:]


def pair_stages(plan: BinnedPlan, *, N: int, m: int, sigma: float,
                window: str) -> tuple:
    """The pair as (name, function) stages in order: the spread stages, the
    two spectral stages, the gather stages. :func:`nfft_pair_planar` runs
    them; chip_smoke.py times them one by one."""
    dim, M = plan.dim, plan.M
    return spread_stages(plan) + (
        ("spectral adjoint", lambda g: spectral_adjoint(g, dim, N, m, sigma, window)),
        ("spectral forward",
         lambda y: spectral_forward(y, dim, M, m, sigma, window).real.contiguous()),
    ) + gather_stages(plan)


def nfft_pair_planar(x, pos, batch=None, plan=None, *, batch_size: int, N: int,
                     m: int, sigma: float = DEFAULT_SIGMA,
                     window: str = DEFAULT_WINDOW, device=None) -> torch.Tensor:
    """Adjoint followed by a real-output forward on the same points:
    x (n, C) real -> (n, C) real, equal to
    ``nfft_forward_planar(*nfft_adjoint_planar(...), real_output=True)[0]``."""
    dev, plan = _setup(pos, batch, plan, batch_size=batch_size, N=N, m=m,
                       sigma=sigma, window=window, device=device)
    x = _real(x, dev)
    check_points(plan, x)
    return run_stages(pair_stages(plan, N=N, m=m, sigma=sigma, window=window), x)
