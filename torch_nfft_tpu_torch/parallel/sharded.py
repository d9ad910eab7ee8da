"""Point-sharded transforms over a mesh axis of ranks.

Counterpart of the JAX package's ``parallel/sharded.py``:

* **adjoint**: every rank spreads its block of the points into its own
  oversampled grid, ONE all-reduce over the points axis sums the grids, and
  the spectral stage runs replicated;
* **forward**: the spectrum is replicated, the spectral stage runs on every
  rank and each gathers its block of the points;
* **fastsum**: spread(local) -> all-reduce -> spectral round trip ->
  gather(local).

The optional columns axis splits the trailing columns into blocks with no
communication. Global in, global out: every rank calls a transform with
the same global tensors, computes the contiguous ``n/P`` rows of its place
on the points axis (and its block of the flattened columns), and returns
the same global result, assembled by an all-gather. Gradients follow
``parallel/_comm.py``. ``n`` must divide by the points axis (pad with
:func:`~.mesh.pad_points`).

Pass ``plans=`` from :func:`build_sharded_plans` to run the binned engine
(the card's kernels) on each rank's block. Without plans a rank's block
runs the plan-free engine by the JAX package's one-hot limit under
``"auto"`` (``spread_gather._pick_strategy``), as JAX's shard bodies do,
whose positions are traced; ``"binned"`` plans the block on its device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._device import resolve_device
from ..ops.binned import build_plan, host_array, run_stages
from ..ops.fft import (
    _axis_contract_planar,
    _cells_spec,
    _pruned_mats,
    spectral_adjoint,
    spectral_forward,
)
from ..ops.nfft import _complex_ok, _no_complex_error, _planes
from ..ops.plan_stack import index_plan, pad_plan_rows, stack_plans
from ..ops.planar import _real, _tensor, fastsum_spectral_stages, points_route
from ..ops.spread_gather import _pick_strategy
from ..ops.window import DEFAULT_SIGMA, DEFAULT_WINDOW
from ._comm import all_gather_rows, rank, reduce, size, to_varying
from .mesh import axis_group, mesh_device

__all__ = [
    "nfft_adjoint_sharded",
    "nfft_forward_sharded",
    "nfft_fastsum_sharded",
    "fastsum_local",
    "build_sharded_plans",
    "spectral_adjoint_pruned_dft_sharded",
    "spectral_forward_pruned_dft_sharded",
]


def _check_plans_geometry(plans, N, m, sigma, window, what="plans"):
    """A plan whose window geometry disagrees with the transform's would
    spread with one window and deconvolve with the other, silently wrong:
    fail loudly. Point counts are not checked here (stacked plans carry a
    shard's n against global points)."""
    if plans is None:
        return
    if (
        (plans.N, plans.m) != (int(N), int(m))
        or plans.sigma != float(sigma)
        or plans.window != window
    ):
        raise ValueError(
            f"{what} were built for (N={plans.N}, m={plans.m}, "
            f"sigma={plans.sigma}, window={plans.window!r}) but the "
            f"transform uses (N={int(N)}, m={int(m)}, sigma={float(sigma)}, "
            f"window={window!r}) — rebuild with build_sharded_plans(..., "
            "matching window/sigma) or pass the matching window= here"
        )


def build_sharded_plans(pos, batch=None, *, n_shards: int, N: int, m: int,
                        sigma: float = DEFAULT_SIGMA, batch_size: int | None = None,
                        window: str = DEFAULT_WINDOW, device=None):
    """One host plan per contiguous block of ``n / n_shards`` points, the
    first block's K and T forced on the rest, padded to one row count and
    stacked (``ops/plan_stack.py``), on ``device`` (the card unless
    ``device="cpu"``). Each plan carries the global batch ids, so that
    every rank spreads into the right grid rows before the all-reduce. A
    rank takes its member with ``index_plan(plans, rank)``; the transforms
    do that themselves."""
    dev = resolve_device(device)
    pos = host_array(pos, np.float32)
    n = pos.shape[0]
    if n % n_shards:
        raise ValueError(f"n={n} not divisible by n_shards={n_shards}; pad_points first")
    n_loc = n // n_shards
    if batch is None:
        batch = np.zeros((n,), np.int32)
        batch_size = 1 if batch_size is None else batch_size
    batch = host_array(batch, np.int32)
    if batch_size is None:
        batch_size = int(batch[-1]) + 1
    plans, K, T = [], None, None
    for s in range(n_shards):
        sl = slice(s * n_loc, (s + 1) * n_loc)
        p = build_plan(pos[sl], batch[sl], N=N, m=m, sigma=sigma, batch_size=batch_size,
                       T=T, K=K, window=window, device=dev)
        if K is None:
            K, T = p.K, p.T
        plans.append(p)
    S_max = max(p.S for p in plans)
    return stack_plans([pad_plan_rows(p, S_max) for p in plans])


def _block(n: int, group, what: str) -> slice:
    """This rank's contiguous block of n along an axis of ``size(group)``."""
    P = size(group)
    if n % P:
        raise ValueError(f"{what}: {n} not divisible by the axis size {P}; pad first")
    r, n_loc = rank(group), n // P
    return slice(r * n_loc, (r + 1) * n_loc)


def _member(plans, group):
    """This rank's plan of a stack of one plan per rank on the axis."""
    if plans is None:
        return None
    P = size(group)
    if plans.slot_pt.dim() != 3 or plans.slot_pt.shape[0] != P:
        raise ValueError(f"plans must be a stack of {P} member plans (build_sharded_plans "
                         f"with n_shards={P})")
    return index_plan(plans, rank(group))


def _batch(batch, n, batch_size, dev):
    """(batch vector on dev, batch_size) by the JAX rule: none means one
    batch, else ``batch[-1] + 1`` batches unless given."""
    if batch is None:
        return torch.zeros((n,), dtype=torch.int32, device=dev), \
            1 if batch_size is None else int(batch_size)
    batch = torch.as_tensor(batch, device=dev).to(torch.int32)
    return batch, int(batch[-1]) + 1 if batch_size is None else int(batch_size)


def _local_route(pos, batch, plan, *, strategy, batch_size, N, m, sigma, window, device, C):
    """The engine of one rank's block: the binned engine on its plan, else
    JAX's shard-body rule (plan-free engine by the one-hot limit)."""
    if plan is not None:
        engine = "binned"
    elif strategy == "auto":
        n, dim = pos.shape
        engine = _pick_strategy("auto", n, dim, batch_size, int(round(sigma * N)), C)
    else:
        engine = strategy
    return points_route(pos, batch, plan, strategy=strategy, batch_size=batch_size, N=N,
                        m=m, sigma=float(sigma), window=window, device=device, C=C,
                        engine=engine)[1]


def fastsum_local(xf, sources, source_batch, targets, target_batch, coeffs, *,
                  batch_size, N, m, sigma=DEFAULT_SIGMA, window=DEFAULT_WINDOW,
                  strategy="auto", group=None, source_plan=None, target_plan=None,
                  device=None):
    """One rank's fastsum: spread(local) -> all-reduce over ``group`` ->
    spectral round trip -> gather(local). ``group`` None runs it alone on
    one device. Shapes: xf (n_src, C), sources/targets (n, dim) -> (n_tgt, C).
    With the complex pipelines off (``set_complex_override(False)``), real
    values run the Hermitian round trip of ``nfft_fastsum_real`` (the
    all-reduce moves the real grid, as JAX's planar branch); otherwise the
    complex one of ``nfft_fastsum``."""
    _check_plans_geometry(source_plan, N, m, sigma, window, what="source_plan")
    _check_plans_geometry(target_plan, N, m, sigma, window, what="target_plan")
    dev = resolve_device(device)
    xf = _tensor(xf, dev)
    coeffs = _tensor(coeffs, dev)
    C, dim = xf.shape[1], sources.shape[1]
    M = int(round(sigma * N))
    planar = not (xf.is_complex() or _complex_ok())
    if planar and coeffs.is_complex():
        raise _no_complex_error("fastsum_local with complex coefficients")
    Cw = 2 * C if xf.is_complex() else C
    kw = dict(strategy=strategy, batch_size=batch_size, N=N, m=m, sigma=sigma,
              window=window, device=dev, C=Cw)
    src = _local_route(sources, source_batch, source_plan, **kw)
    if targets is sources and target_batch is source_batch and target_plan is source_plan:
        tgt = src
    else:
        tgt = _local_route(targets, target_batch, target_plan, **kw)
    g = reduce(src.spread(_planes(xf)), group)
    g = run_stages(fastsum_spectral_stages(
        coeffs, dim=dim, N=N, M=M, m=m, sigma=float(sigma), window=window,
        complex_x=xf.is_complex(), hermitian=planar), g)
    y = tgt.gather(to_varying(g, group))
    return torch.complex(y[:, :C], y[:, C:]) if xf.is_complex() else y


def nfft_adjoint_sharded(x, pos, batch=None, bandwidth=16, cutoff=3, real_output=False, *,
                         mesh, points_axis="points", cols_axis=None, batch_size=None,
                         sigma=DEFAULT_SIGMA, window=DEFAULT_WINDOW, strategy="auto",
                         plans=None):
    """Adjoint NFFT with the points sharded over ``points_axis``: x (n,
    *cols) -> (batch_size, (N,)*dim, *cols), complex64 (its real part with
    ``real_output``), the same on every rank. ``plans=`` from
    :func:`build_sharded_plans` runs the binned engine on each block."""
    N, m = int(bandwidth), int(cutoff)
    _check_plans_geometry(plans, N, m, sigma, window)
    dev = mesh_device(mesh)
    pg, cg = axis_group(mesh, points_axis), axis_group(mesh, cols_axis)
    x = _tensor(x, dev)
    pos = _real(pos, dev)
    n, dim = pos.shape
    batch, batch_size = _batch(batch, n, batch_size, dev)
    trailing = tuple(x.shape[1:])
    C = math.prod(trailing)
    rows, cols = _block(n, pg, "points"), _block(C, cg, "columns")
    xl = to_varying(x.reshape(n, C), pg, cg)[rows, cols]
    Cl = xl.shape[1]
    route = _local_route(to_varying(pos, pg, cg)[rows], batch[rows], _member(plans, pg),
                         strategy=strategy, batch_size=batch_size, N=N, m=m, sigma=sigma,
                         window=window, device=dev, C=2 * Cl if xl.is_complex() else Cl)
    g = reduce(route.spread(_planes(xl)), pg)
    if xl.is_complex():
        g = torch.complex(g[:, :Cl], g[:, Cl:])
    y = spectral_adjoint(g, dim, N, m, float(sigma), window).movedim(1, -1)
    y = all_gather_rows(y, cg, dim=-1)
    y = y.reshape((batch_size,) + (N,) * dim + trailing)
    return y.real if real_output else y


def nfft_forward_sharded(x, pos, batch=None, cutoff=3, real_output=False, *, mesh,
                         points_axis="points", cols_axis=None, batch_size=None,
                         sigma=DEFAULT_SIGMA, window=DEFAULT_WINDOW, strategy="auto",
                         plans=None):
    """Forward NFFT with the points sharded over ``points_axis``: the
    spectrum x (batch_size, (N,)*dim, *cols), replicated, -> (n, *cols)
    complex64 (its real part with ``real_output``), the same on every rank.
    ``plans=`` as in :func:`nfft_adjoint_sharded`."""
    m = int(cutoff)
    dev = mesh_device(mesh)
    pg, cg = axis_group(mesh, points_axis), axis_group(mesh, cols_axis)
    x = _tensor(x, dev)
    pos = _real(pos, dev)
    n, dim = pos.shape
    N = x.shape[1]
    _check_plans_geometry(plans, N, m, sigma, window)
    M = int(round(sigma * N))
    batch, _ = _batch(batch, n, batch_size, dev)
    batch_size = x.shape[0] if batch_size is None else int(batch_size)
    trailing = tuple(x.shape[1 + dim:])
    C = math.prod(trailing)
    rows, cols = _block(n, pg, "points"), _block(C, cg, "columns")
    z = to_varying(x.reshape((batch_size,) + (N,) * dim + (C,)), pg, cg)[..., cols]
    Cl = z.shape[-1]
    g = spectral_forward(z.movedim(-1, 1).to(torch.complex64), dim, M, m, float(sigma),
                         window)  # (B, Cl, M^dim)
    route = _local_route(to_varying(pos, pg, cg)[rows], batch[rows], _member(plans, pg),
                         strategy=strategy, batch_size=batch_size, N=N, m=m, sigma=sigma,
                         window=window, device=dev, C=Cl if real_output else 2 * Cl)
    if real_output:
        y = route.gather(g.real.contiguous())
    else:
        y = route.gather(torch.cat([g.real, g.imag], dim=1))
        y = torch.complex(y[:, :Cl], y[:, Cl:])
    y = all_gather_rows(all_gather_rows(y, pg, 0), cg, 1)
    return y.reshape((n,) + trailing)


def nfft_fastsum_sharded(x, coeffs, sources, targets=None, source_batch=None,
                         target_batch=None, /, batch=None, cutoff=3, *, mesh,
                         points_axis="points", cols_axis=None, batch_size=None,
                         sigma=DEFAULT_SIGMA, window=DEFAULT_WINDOW, strategy="auto",
                         source_plans=None, target_plans=None):
    """Fastsum with sources and targets both sharded over ``points_axis``
    and one all-reduce of the oversampled grid in between: x (n_src, *cols)
    -> (n_tgt, *cols), the same on every rank. ``source_plans=`` /
    ``target_plans=`` from :func:`build_sharded_plans` run the binned
    engine on each block."""
    m = int(cutoff)
    dev = mesh_device(mesh)
    pg, cg = axis_group(mesh, points_axis), axis_group(mesh, cols_axis)
    x = _tensor(x, dev)
    coeffs = _tensor(coeffs, dev)
    sources = _real(sources, dev)
    symmetric = targets is None
    if symmetric:
        targets, target_batch = sources, source_batch
    targets = _real(targets, dev)
    if batch is not None:
        source_batch = target_batch = batch
    n_src, dim = sources.shape
    n_tgt = targets.shape[0]
    source_batch, batch_size = _batch(source_batch, n_src, batch_size, dev)
    target_batch, _ = _batch(target_batch, n_tgt, batch_size, dev)
    N = coeffs.shape[0]
    _check_plans_geometry(source_plans, N, m, sigma, window, what="source_plans")
    _check_plans_geometry(target_plans, N, m, sigma, window, what="target_plans")
    trailing = tuple(x.shape[1:])
    C = math.prod(trailing)
    rs, rt = _block(n_src, pg, "sources"), _block(n_tgt, pg, "targets")
    cols = _block(C, cg, "columns")
    xl = to_varying(x.reshape(n_src, C), pg, cg)[rs, cols]
    src_l = to_varying(sources, pg, cg)[rs]
    tgt_l = src_l if symmetric and rs == rt else to_varying(targets, pg, cg)[rt]
    sb_l = source_batch[rs]
    tb_l = sb_l if symmetric and rs == rt else target_batch[rt]
    sp = _member(source_plans, pg)
    tp = sp if target_plans is source_plans else _member(target_plans, pg)
    y = fastsum_local(xl, src_l, sb_l, tgt_l, tb_l, to_varying(coeffs, cg),
                      batch_size=batch_size, N=N, m=m, sigma=sigma, window=window,
                      strategy=strategy, group=pg, source_plan=sp, target_plan=tp, device=dev)
    y = all_gather_rows(all_gather_rows(y, pg, 0), cg, 1)
    return y.reshape((n_tgt,) + trailing)


# ---------------------------------------------------------------------------
# Spectral stages on a grid sharded on its axis 1: the pruned DFT's
# contraction of that axis is a row block per rank, so the adjoint needs ONE
# all-reduce of the N^dim spectrum and the forward none. Grids here are the
# port's channel-first (B, C, M0, M1, ...), spectra (B, C, N, ..., N); the
# JAX functions take its DFT layout (B, M1, ..., C, M0).
# ---------------------------------------------------------------------------


def _check_dim(dim: int) -> None:
    if dim < 2:
        raise ValueError(
            f"grid-sharded spectral transforms need dim >= 2 (got dim={dim}):"
            " they shard the grid's M_1 axis, which a 1D grid does not have"
        )


def spectral_adjoint_pruned_dft_sharded(gr, gi, dim, N, m, sigma, group, M, cells=None,
                                        window=DEFAULT_WINDOW):
    """Adjoint spectral stage on this rank's slab (B, C, L0, L1/P, L2, ...)
    of a channel-first grid sharded on grid axis 1 over ``group`` (gi may
    be None): the replicated centered spectrum planes (B, C, (N,)*dim),
    after one all-reduce of each plane. ``cells`` (offset, count) per axis
    as in the JAX function; the sharded axis's entry is the full axis, of
    which each rank contracts its row block."""
    _check_dim(dim)
    spec = _cells_spec(dim, M, cells)
    dev = gr.device

    def mats(d):
        off, L = spec[d]
        return _pruned_mats(N, M, m, sigma, +1, off, L, window, dev)

    for d in [0] + list(range(2, dim)):
        gr, gi = _axis_contract_planar(gr, gi, *mats(d), 2 + d)
    mr, mi = mats(1)
    L1_loc = gr.shape[3]
    if mr.shape[0] % L1_loc or mr.shape[0] // L1_loc != size(group):
        raise ValueError(
            f"local slab rows {L1_loc} do not evenly divide the full sharded "
            f"axis length {mr.shape[0]} — equal per-chip row blocks are "
            "required (a remainder would drop trailing grid rows)"
        )
    blk = slice(rank(group) * L1_loc, (rank(group) + 1) * L1_loc)
    gr, gi = _axis_contract_planar(gr, gi, mr[blk], mi[blk], 3)
    return reduce(gr, group), reduce(gi, group)


def spectral_forward_pruned_dft_sharded(xr, xi, dim, M, m, sigma, group, n_shards,
                                        cells=None, window=DEFAULT_WINDOW):
    """Forward spectral stage producing this rank's slab of a grid sharded
    on axis 1: the replicated spectrum planes xr/xi (B, C, (N,)*dim) (xi may
    be None) -> the slab (B, C, L0, L1/P, L2, ...), with no collective."""
    _check_dim(dim)
    N = xr.shape[2]
    spec = _cells_spec(dim, M, cells)
    dev = xr.device

    def mats(d):
        off, L = spec[d]
        return _pruned_mats(N, M, m, sigma, -1, off, L, window, dev, transpose=True)

    mr, mi = mats(1)
    L1 = mr.shape[1]
    if L1 % n_shards:
        raise ValueError(
            f"sharded grid axis length L1={L1} is not divisible by "
            f"n_shards={n_shards} — equal per-chip row blocks are required "
            "(a remainder would silently truncate the grid)"
        )
    xr = to_varying(xr, group)
    xi = None if xi is None else to_varying(xi, group)
    L1_loc = L1 // n_shards
    blk = slice(rank(group) * L1_loc, (rank(group) + 1) * L1_loc)
    xr, xi = _axis_contract_planar(xr, xi, *mats(0), 2)
    xr, xi = _axis_contract_planar(xr, xi, mr[:, blk], mi[:, blk], 3)
    for d in range(2, dim):
        xr, xi = _axis_contract_planar(xr, xi, *mats(d), 2 + d)
    return xr, xi
