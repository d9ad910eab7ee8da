"""Planar NFFT entry points: real inputs, (real, imaginary) plane outputs.

Counterparts of ``nfft_adjoint_planar``, ``nfft_forward_planar``,
``nfft_pair_planar`` and ``nfft_fastsum_real`` in the JAX package's
``ops/planar.py``, with the same argument and result layouts: x (n, C);
spectra (batch_size, (N,)*dim, C) as two real planes. They run the binned
engine (ops/binned.py), or without a plan the scatter or the one-hot
matmul engine (ops/spread_gather.py), around the ``torch.fft`` spectral
stage (ops/fft.py): its Hermitian formulation (the stages ``rfftn`` and
``irfftn``, pruned to the band) wherever the grid or the output is real (the adjoint of real samples, the
pair, the real-output forward and the real fastsum, as the JAX package's
planar pipelines carry half spectra), complex to complex for the
two-plane forward.

Each entry point takes ``strategy`` as the JAX functions do. A plan passed
in runs the binned engine. Without one, ``"auto"`` follows the JAX
package's rule (``spread_gather.plan_or_engine``): the binned engine on a
plan built for the points from 4096 points on where the one-hot operands
would exceed 2^24 entries, else the matmul engine up to 2^24 entries and
the scatter engine beyond; ``"binned"`` always plans, ``"scatter"`` and
``"matmul"`` never do. A plan passed in is checked against the
transform's geometry and, for NumPy positions, against the bin-id
fingerprint of the points it was built for (host plans carry one).

Each entry point is differentiable in its values and, when ``pos`` is a
tensor that requires grad, in the point positions (ops/binned.py; autograd
through the plan-free engines). Every entry point runs on the CUDA card
unless ``device="cpu"`` is given, and raises when no card is there and no
device was asked for. On the card the binned engine takes m up to 9
(``ops/contract.py:check_window_width``), checked before any plan is built
or kernel launched; the CPU and the plan-free engines take any m.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from .._device import resolve_device
from .binned import (
    BinnedPlan,
    build_plan_device,
    gather_binned,
    gather_binned_slot,
    position_fingerprint,
    run_stages,
    spread_binned,
    spread_binned_slot,
    tile_route,
)
from .contract import check_window_width
from .fft import (
    band_filter_half,
    full_to_half,
    half_spectrum_to_full,
    spectral_adjoint_half,
    spectral_forward,
    spectral_forward_half,
)
from .spectral import fastsum_band_filter
from .spread_gather import gather, plan_or_engine, spread
from .tilefold import FOLD_BUDGET
from .window import DEFAULT_SIGMA, DEFAULT_WINDOW

__all__ = ["nfft_adjoint_planar", "nfft_forward_planar", "nfft_pair_planar",
           "nfft_fastsum_real", "pair_stages", "pair_spectral_stages",
           "fastsum_spectral_stages",
           "fastsum_stages", "slot_io_ok", "grad_pos", "setup_plan", "shape_of",
           "check_strategy", "points_route", "no_columns"]

# the JAX package's largest grid for its pruned DFTs (ops/fft.py:PRUNED_MAX),
# part of its rule for the slot-layout fastsum (slot_io_ok)
PRUNED_MAX = 2048

_STRATEGIES = ("auto", "binned", "scatter", "matmul")


def check_strategy(strategy: str) -> None:
    """Accept the four strategies of the JAX package; anything else raises."""
    if strategy not in _STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; supported: {_STRATEGIES}")


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


def shape_of(a) -> tuple:
    return tuple(a.shape) if hasattr(a, "shape") else tuple(torch.as_tensor(a).shape)


def grad_pos(pos):
    """The input that receives the position gradient: ``pos`` when it is a
    tensor that requires grad, else None (no position gradient)."""
    return pos if isinstance(pos, torch.Tensor) and pos.requires_grad else None


def setup_plan(pos, batch, plan, *, batch_size, N, m, sigma, window, device):
    """Resolve the device and return a plan for (pos, batch) that matches the
    transform's geometry."""
    dev = resolve_device(device)
    check_window_width(m, dev)
    M = int(round(sigma * N))
    if plan is None:
        if isinstance(pos, torch.Tensor):
            pos = pos.detach()
        plan = build_plan_device(pos, batch, N=N, m=m, sigma=sigma,
                                 batch_size=batch_size, window=window, device=dev)
    if not isinstance(plan, BinnedPlan):
        raise TypeError(f"plan must be a BinnedPlan, got {type(plan).__name__}")
    if plan.slot_pt.dim() == 3:
        raise ValueError(
            f"plan is a stack of {plan.slot_pt.shape[0]} member plans (stack_plans); "
            "pass one member, index_plan(plans, i), with its own points")
    _check_window_match(window, plan, m=m, M=M, sigma=sigma)
    if plan.device != dev:
        raise ValueError(f"the plan lives on {plan.device}, the transform runs on {dev}")
    if shape_of(pos) != (plan.n, plan.dim):
        raise ValueError(f"pos has shape {shape_of(pos)}; the plan was built "
                         f"for ({plan.n}, {plan.dim})")
    if batch_size != plan.batch_size:
        raise ValueError(f"batch_size={batch_size} but the plan was built for "
                         f"batch_size={plan.batch_size}")
    if isinstance(pos, np.ndarray) and plan.pos_fp is not None \
            and position_fingerprint(pos, plan.M, plan.m) != plan.pos_fp:
        raise ValueError(
            "plan does not match these positions (bin-id fingerprint differs) "
            "— plans are tied to the exact point set they were built on; "
            "rebuild with build_plan(pos, ...)")
    return dev, plan


class _Route:
    """How an entry point moves values between its points and the grid:
    the binned engine on ``plan``, or the plan-free ``engine`` at ``pos``."""

    def __init__(self, *, plan=None, pos=None, batch=None, engine=None, batch_size,
                 N, m, sigma, window, grad):
        self.plan, self.pos, self.batch, self.engine = plan, pos, batch, engine
        self.batch_size, self.N, self.m, self.sigma, self.window = (
            batch_size, N, m, sigma, window)
        self.grad = grad  # the input that receives the position gradient
        self.dim = pos.shape[1] if plan is None else plan.dim
        self.M = int(round(sigma * N))
        self.n = pos.shape[0] if plan is None else plan.n

    def spread(self, x: torch.Tensor) -> torch.Tensor:
        if self.plan is not None:
            return spread_binned(self.plan, x, self.grad)
        return spread(x, self.pos, self.batch, self.batch_size, self.N, self.m, self.sigma,
                      self.engine, window=self.window)

    def gather(self, g: torch.Tensor) -> torch.Tensor:
        if self.plan is not None:
            return gather_binned(self.plan, g, self.grad)
        return gather(g, self.pos, self.batch, self.batch_size, self.N, self.m, self.sigma,
                      self.engine, window=self.window)


def points_route(pos, batch, plan, *, strategy, batch_size, N, m, sigma, window, device,
                 C, engine=None):
    """(device, route) of one side of a transform: the binned engine when a
    plan is given or the rule of :func:`spread_gather.plan_or_engine` for C
    columns picks it (the plan from :func:`setup_plan`, or from ``engine``'s
    caller), else the plan-free engine; ``engine`` overrides the pick."""
    check_strategy(strategy)
    n, dim = shape_of(pos)
    pick = engine
    if engine is None:
        engine = "binned" if plan is not None else plan_or_engine(
            strategy, n, dim, batch_size, int(round(sigma * N)), C)
        # "auto" keeps picking per call from each call's columns, as the
        # JAX package's spread and gather do
        pick = strategy if strategy == "auto" else engine
    if engine == "binned":
        dev, plan = setup_plan(pos, batch, plan, batch_size=batch_size, N=N, m=m,
                               sigma=sigma, window=window, device=device)
        return dev, _Route(plan=plan, batch_size=batch_size, N=N, m=m, sigma=sigma,
                           window=window, grad=grad_pos(pos))
    dev = resolve_device(device)
    p = torch.as_tensor(pos, device=dev)
    p = p if p.dtype == torch.float32 else p.to(torch.float32)
    b = None
    if batch is not None:
        b = torch.as_tensor(batch, device=dev)
        if b.numel() and (int(b.min()) < 0 or int(b.max()) >= batch_size):
            raise ValueError(f"batch ids must lie in [0, {batch_size})")
    return dev, _Route(pos=p, batch=b, engine=pick, batch_size=batch_size, N=N, m=m,
                       sigma=sigma, window=window, grad=None)


def no_columns(shape, strategy, device, dtype=torch.float32) -> torch.Tensor:
    """The result of a call with no columns (C = 0), as the JAX package
    returns it: zeros of its shape and dtype on the call's device, with
    nothing planned, spread, transformed or launched."""
    check_strategy(strategy)
    return torch.zeros(shape, dtype=dtype, device=resolve_device(device))


def _real(a, dev) -> torch.Tensor:
    return torch.as_tensor(a, device=dev).to(torch.float32)


def _tensor(a, dev) -> torch.Tensor:
    """``a`` on ``dev`` as float32 or complex64."""
    a = torch.as_tensor(a, device=dev)
    return a.to(torch.complex64 if a.is_complex() else torch.float32)


@trace.spanned("nfft_adjoint_planar")
def nfft_adjoint_planar(x, pos, batch=None, plan=None, *, batch_size: int,
                        N: int, m: int, sigma: float = DEFAULT_SIGMA,
                        strategy: str = "auto", window: str = DEFAULT_WINDOW,
                        device=None):
    """Adjoint NFFT of real samples x (n, C): returns (yr, yi), each
    (batch_size, (N,)*dim, C), y[b, k] = sum_i x_i exp(+2 pi i k.pos_i).
    The spectrum of real samples is conjugate symmetric: the spectral
    stage computes half of it (``rfftn``) and mirrors the rest."""
    if shape_of(x)[1] == 0:
        y = no_columns((batch_size,) + (N,) * shape_of(pos)[1] + (0,), strategy, device)
        return y, y.clone()
    dev, route = points_route(pos, batch, plan, strategy=strategy, batch_size=batch_size,
                              N=N, m=m, sigma=sigma, window=window, device=device,
                              C=shape_of(x)[1])
    g = route.spread(_real(x, dev))
    y = half_spectrum_to_full(spectral_adjoint_half(g, route.dim, N, m, sigma, window),
                              route.dim, N).movedim(1, -1)
    return y.real.contiguous(), y.imag.contiguous()


@trace.spanned("nfft_forward_planar")
def nfft_forward_planar(xr, xi, pos, batch=None, plan=None, *, batch_size: int,
                        dim: int, m: int, sigma: float = DEFAULT_SIGMA,
                        strategy: str = "auto", real_output: bool = False,
                        window: str = DEFAULT_WINDOW, device=None):
    """Forward NFFT of a planar spectrum xr/xi (batch_size, (N,)*dim, C),
    xi may be None: returns (yr, yi), each (n, C),
    y_i = sum_k x[batch_i, k] exp(-2 pi i k.pos_i). With ``real_output``
    only the real plane is computed, from the half spectrum of the input's
    Hermitian part (``irfftn``), and the result is (yr, None)."""
    N = shape_of(xr)[1]
    C = shape_of(xr)[-1]
    if C == 0:
        y = no_columns((shape_of(pos)[0], 0), strategy, device)
        return (y, None) if real_output else (y, y.clone())
    dev, route = points_route(pos, batch, plan, strategy=strategy, batch_size=batch_size,
                              N=N, m=m, sigma=sigma, window=window, device=device, C=C)
    if route.dim != dim:
        raise ValueError(f"dim={dim} but the points have dim={route.dim}")
    z = _real(xr, dev)
    if xi is not None:
        z = torch.complex(z, _real(xi, dev))
    z = z.movedim(-1, 1)  # (B, C, N^dim)
    if real_output:
        g = spectral_forward_half(full_to_half(z, dim, N), dim, N, route.M, m, sigma, window)
        return route.gather(g), None
    g = spectral_forward(z.to(torch.complex64), dim, route.M, m, sigma, window)
    y = route.gather(torch.cat([g.real, g.imag], dim=1))
    return y[:, :C], y[:, C:]


def pair_spectral_stages(*, dim: int, N: int, M: int, m: int, sigma: float,
                         window: str, device) -> tuple:
    """The pair's spectral stages: the adjoint's half spectrum (``rfftn``)
    and, through the band's Hermitian filter, the real grid of the
    real-output forward (``irfftn``). The grid operator they make is
    symmetric (the pair's kernel is real and even), so the same stages
    carry a cotangent's grid back (``ops/streaming.py``'s backward)."""
    w = band_filter_half(dim, N, device)

    def forward(h):
        return spectral_forward_half(h if w is None else h * w, dim, N, M, m, sigma, window)

    return (
        ("rfftn", lambda g: spectral_adjoint_half(g, dim, N, m, sigma, window)),
        ("irfftn", forward),
    )


def pair_stages(plan: BinnedPlan, *, N: int, m: int, sigma: float,
                window: str, C: int = 1) -> tuple:
    """The pair's forward for C columns as (name, function) stages in order:
    the spread stages, the two spectral stages, the gather stages, each on
    the route (dense or flat grid) the pair takes for C.
    :func:`nfft_pair_planar` runs them (the spread and gather stages inside
    their autograd Functions); chip_smoke.py times them one by one."""
    route = tile_route(plan, C)
    return (route.spreading
            + pair_spectral_stages(dim=plan.dim, N=N, M=plan.M, m=m, sigma=sigma,
                                   window=window, device=plan.device)
            + route.gathering)


@trace.spanned("nfft_pair_planar")
def nfft_pair_planar(x, pos, batch=None, plan=None, *, batch_size: int, N: int,
                     m: int, sigma: float = DEFAULT_SIGMA, strategy: str = "auto",
                     window: str = DEFAULT_WINDOW, device=None) -> torch.Tensor:
    """Adjoint followed by a real-output forward on the same points:
    x (n, C) real -> (n, C) real, equal to
    ``nfft_forward_planar(*nfft_adjoint_planar(...), real_output=True)[0]``.
    The spectrum travels as a half spectrum (``rfftn`` and ``irfftn``)."""
    if shape_of(x)[1] == 0:
        return no_columns((shape_of(pos)[0], 0), strategy, device)
    dev, route = points_route(pos, batch, plan, strategy=strategy, batch_size=batch_size,
                              N=N, m=m, sigma=sigma, window=window, device=device,
                              C=shape_of(x)[1])
    g = route.spread(_real(x, dev))
    y = run_stages(pair_spectral_stages(dim=route.dim, N=N, M=route.M, m=m, sigma=sigma,
                                        window=window, device=dev), g)
    return route.gather(y)


# ---------------------------------------------------------------------------
# Fastsum
# ---------------------------------------------------------------------------


def fastsum_spectral_stages(coeffs: torch.Tensor, *, dim: int, N: int, M: int, m: int,
                            sigma: float, window: str, complex_x: bool = False,
                            hermitian: bool = True) -> tuple:
    """The fastsum's spectral round trip as (name, function) stages, grid
    (batch_size, C, M^dim) in and out.

    ``hermitian`` (real x and a real output): the adjoint's half spectrum
    (``rfftn``), the filter (the half spectrum of the coefficients'
    Hermitian part, ``fft.full_to_half``), the real grid (``irfftn``).
    Exact for real and complex coefficients alike: the real grid is the
    real plane of the complex-to-complex round trip. :func:`nfft_fastsum_real`
    runs it, and ``nfft_fastsum`` for every real x. Otherwise complex to
    complex (``nfft_fastsum`` with a complex x): the
    unnormalised inverse DFT, the band filter (``fastsum_band_filter``,
    built in the stage), the forward DFT; a real x keeps the output's real
    plane, a complex x arrives and leaves as its real and imaginary planes
    side by side (2C columns)."""
    if hermitian:
        if complex_x:
            raise ValueError("the Hermitian fastsum takes real values")
        return (
            ("rfftn", lambda g: spectral_adjoint_half(g, dim, N, m, sigma, window)),
            ("filter", lambda h: h * full_to_half(coeffs, dim, N)),
            ("irfftn", lambda h: spectral_forward_half(h, dim, N, M, m, sigma, window)),
        )
    axes = tuple(range(2, 2 + dim))

    def ifftn(g):
        if complex_x:
            C = g.shape[1] // 2
            g = torch.complex(g[:, :C], g[:, C:])
        return torch.fft.ifftn(g, dim=axes, norm="forward")

    def fftn(gh):
        g2 = torch.fft.fftn(gh, dim=axes)
        return torch.cat([g2.real, g2.imag], dim=1) if complex_x else g2.real.contiguous()

    return (
        ("ifftn", ifftn),
        ("filter", lambda gh: gh * fastsum_band_filter(coeffs, N, m, M, sigma, window)),
        ("fftn", fftn),
    )


def fastsum_stages(source_plan: BinnedPlan, target_plan: BinnedPlan, coeffs: torch.Tensor,
                   *, m: int, sigma: float, window: str, C: int = 1,
                   hermitian: bool = True) -> tuple:
    """The real fastsum for C columns as (name, function) stages in order:
    the source plan's spread stages, the spectral round trip, the target
    plan's gather stages, each on the route (dense or flat grid) its plan
    takes for C. The round trip is Hermitian by default, as
    :func:`nfft_fastsum_real` and, for a real x, ``nfft_fastsum`` and so
    ``GramMatrix.apply`` run it; with ``hermitian=False`` it is complex to
    complex, as ``nfft_fastsum`` runs it for a complex x (whose two
    planes take 2C columns there). The entry points run them (the
    spread and gather stages inside their autograd Functions);
    chip_smoke.py times them one by one."""
    N = coeffs.shape[0]
    return (tile_route(source_plan, C).spreading
            + fastsum_spectral_stages(coeffs, dim=source_plan.dim, N=N, M=source_plan.M,
                                      m=m, sigma=sigma, window=window, hermitian=hermitian)
            + tile_route(target_plan, C).gathering)


def slot_io_ok(plan, C: int, batch_size: int) -> bool:
    """The JAX package's condition for the slot-layout fastsum, copied: a
    grid of at most ``PRUNED_MAX`` cells an axis, a plan whose tiles
    partition the grid with a halo of at most one tile (M % T == 0,
    H - T <= T), and a dense tile array for C float32 columns within the
    6 GiB budget, counted over the plan's active slab in 3D where it has
    one (JAX's ``_dft_route``). The port's slot vector is the same on
    both of its routes; the rule keeps the port refusing where JAX does."""
    if plan is None or plan.M > PRUNED_MAX:
        return False
    if plan.M % plan.T or plan.H - plan.T > plan.T:
        return False
    nb = plan.M // plan.T
    runs = plan.active if plan.active is not None and plan.dim == 3 else ((0, nb),) * plan.dim
    tiles = batch_size
    for _, count in runs:
        tiles *= count
    return tiles * C * plan.H**plan.dim * 4 <= FOLD_BUDGET


@trace.spanned("nfft_fastsum_real")
def nfft_fastsum_real(x, coeffs, sources, targets, source_batch=None, target_batch=None,
                      source_plan=None, target_plan=None, *, batch_size: int, N: int,
                      m: int, sigma: float = DEFAULT_SIGMA, strategy: str = "auto",
                      slot_io: bool = False, window: str = DEFAULT_WINDOW,
                      device=None) -> torch.Tensor:
    """Fastsum of real samples x (n_src, C): the real output (n_tgt, C) of
    y[t] = sum_s K(sources[s] - targets[t]) x[s]. The spectral round trip
    runs on half spectra, with the coefficients' Hermitian part as the
    filter: exact for any coefficients (the JAX package's half path assumes
    even ones, which the Gaussian and radial kernels' are).

    ``slot_io=True`` takes and returns slot-layout vectors: x is a
    (C, S_src*K) vector of the source plan (``to_slot_order``) and the
    result a (C, S_tgt*K) vector of the target plan, with no point-order
    permutation; both plans must be given and meet :func:`slot_io_ok`
    (a ``ValueError`` otherwise, as in the JAX package)."""
    check_strategy(strategy)
    M = int(round(sigma * N))
    C = shape_of(x)[0] if slot_io else shape_of(x)[1]
    if slot_io and not (slot_io_ok(source_plan, C, batch_size)
                        and slot_io_ok(target_plan, C, batch_size)):
        raise ValueError(
            "slot_io=True requires fold-capable source and target plans "
            f"(M <= {PRUNED_MAX}, tiles that partition the grid, a dense tile array "
            "within the budget for both plans); build binned plans for this "
            "geometry or use the user-order entry point.")
    if C == 0 and not slot_io:
        return no_columns((shape_of(targets)[0], 0), strategy, device)
    kw = dict(batch_size=batch_size, N=N, m=m, sigma=sigma, window=window, device=device)
    if slot_io:
        dev, source_plan = setup_plan(sources, source_batch, source_plan, **kw)
        _, target_plan = setup_plan(targets, target_batch, target_plan, **kw)
        spectral = fastsum_spectral_stages(_tensor(coeffs, dev), dim=source_plan.dim, N=N,
                                           M=M, m=m, sigma=sigma, window=window)
        g = spread_binned_slot(source_plan, _real(x, dev))
        return gather_binned_slot(target_plan, run_stages(spectral, g))
    dev, src = points_route(sources, source_batch, source_plan, strategy=strategy, C=C, **kw)
    _, tgt = points_route(targets, target_batch, target_plan, strategy=strategy, C=C, **kw)
    spectral = fastsum_spectral_stages(_tensor(coeffs, dev), dim=src.dim, N=N, M=M, m=m,
                                       sigma=sigma, window=window)
    return tgt.gather(run_stages(spectral, src.spread(_real(x, dev))))
