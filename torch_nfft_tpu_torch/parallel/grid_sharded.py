"""Grid-sharded NFFT transforms: the oversampled grid itself is cut into
axis-0 slabs, one per rank, for N^dim grids beyond one device's memory.

Counterpart of the JAX package's ``parallel/grid_sharded.py``. Where
``parallel/sharded.py`` shards the points and every rank holds a whole
grid, here:

* every point belongs to the slab holding its window-origin tile, so the
  point set partitions by slab (:func:`build_grid_sharded_layout`, one plan
  per slab with its rows in the slab's local tile space);
* the **spread** forms the slab's dense tiles (B1 with local tile ids),
  folds axes 1.. with the periodic wrap and axis 0 WITHOUT it (one
  ``csrc/tilefold.cu`` slab fold), and hands the E = 2m+1 cells that spill
  past the slab to the next rank with ONE ring shift;
* the **adjoint spectral stage** takes the half spectrum of the slab's
  own axes 1.. with cuFFT (``rfftn``, cropped to the band, rolloff), then
  the slab's row block of the axis-0 pruned DFT matrix as one complex
  matmul, then ONE all-reduce of the half spectrum (half the N^dim band);
* the **forward spectral stage** builds the rank's slab from the
  replicated spectrum with no collective (the axis-0 block, then
  ``irfftn`` of axes 1..), and the **gather** (B2) reads the next slab's
  first E cells through one ring shift the other way (one slab unfold).

A slab's tiles are (L0/T) * (M/T)^(dim-1) dense tiles of H^dim cells: at
3D N = 1024, m = 4, sigma = 2 on four ranks that is 32.8 GB a rank, so no
stage holds more than one copy of it, and neither spectral stage forms a
replicated N x M^(dim-1) partial.

Grids are the port's channel-first (B, C, M0, M1, ...), sharded on M0.
Scope as in JAX: dim >= 2, batch size 1, real planar inputs. The
transforms take and return global tensors, the same on every rank, and
are differentiable in their values (``parallel/_comm.py``); the positions
are frozen into the layout. JAX's engine switch inside the shard bodies
(``_use_pallas_shard``, ``TORCH_NFFT_TPU_SHARD_PALLAS``) has no
counterpart: the kernels run on the card and their plain versions on the
CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device
from ..ops.binned import BinnedPlan, TileRoute, build_plan, default_tile, host_array
from .. import trace
from ..ops.fft import (
    _cells_spec,
    _pruned_mats,
    full_to_half,
    half_spectrum_to_full,
    spectral_adjoint_half,
    spectral_forward_half,
)
from ..ops.plan_stack import index_plan, pad_plan_rows, stack_plans
from ..ops.tilefold import fold_tiles_to_slab, unfold_slab_to_tiles
from ._comm import all_gather_rows, rank, reduce, ring_shift, size, to_varying
from .mesh import axis_group, mesh_device

__all__ = [
    "GridShardedLayout",
    "build_grid_sharded_layout",
    "nfft_adjoint_grid_sharded",
    "nfft_forward_grid_sharded",
    "nfft_fastsum_grid_sharded",
    "spectral_adjoint_pruned_dft_sharded0",
    "spectral_forward_pruned_dft_sharded0",
]


@dataclass
class GridShardedLayout:
    """Host-built partition of a point set by grid-axis-0 tile slab."""

    plans: BinnedPlan  # stacked, one member per slab
    pos_stack: torch.Tensor  # (P, n_loc, dim) float32
    point_index: torch.Tensor  # (P, n_loc) int32; n marks a padded slot
    n: int
    n_shards: int
    dim: int
    N: int
    m: int
    sigma: float
    T: int
    A0_loc: int  # axis-0 tiles per slab
    window: str = "gaussian"

    @property
    def M(self) -> int:
        return int(round(self.sigma * self.N))

    @property
    def NT(self) -> int:
        """Tiles of a slab's dense tile array: A0_loc * nb^(dim-1)."""
        return self.A0_loc * (self.M // self.T) ** (self.dim - 1)


def build_grid_sharded_layout(pos, *, n_shards: int, N: int, m: int, sigma: float = 2.0,
                              T: int | None = None, K: int | None = None,
                              window: str = "gaussian", device=None) -> GridShardedLayout:
    """Partition ``pos`` by axis-0 tile slab and build one plan per slab,
    on ``device`` (the card unless ``device="cpu"``).

    Requires dim >= 2, M % T == 0, T >= 2m+1 and ``nb % n_shards == 0``
    (equal slabs). A slab's points are padded to the largest slab's count
    with copies of its first point (weight 0); an empty slab gets a filler
    point inside it. Each plan's filled rows are checked to lie in their
    slab, the rule the slab assignment and the plan's binning must share."""
    dev = resolve_device(device)
    pos = host_array(pos, np.float32)
    n, dim = pos.shape
    if dim < 2:
        raise ValueError("grid sharding needs dim >= 2")
    M = int(round(sigma * N))
    if T is None:
        T = default_tile(dim, m, M)
    if M % T:
        raise ValueError(f"M={M} must be divisible by the tile size T={T}")
    if T < 2 * m + 1:
        raise ValueError(
            f"tile size T={T} must be >= the window halo E=2m+1={2 * m + 1}"
            " (the overlap-add spill must fit one neighbouring tile)"
        )
    nb = M // T
    if nb % n_shards:
        raise ValueError(f"tiles per axis nb={nb} not divisible by n_shards={n_shards}")
    A0_loc = nb // n_shards

    s0 = ((np.floor(pos[:, 0] * M).astype(np.int64) - m) % M) // T
    shard = s0 // A0_loc
    counts = np.bincount(shard, minlength=n_shards)
    n_loc = max(1, int(counts.max()))

    pos_stack = np.empty((n_shards, n_loc, dim), np.float32)
    point_index = np.full((n_shards, n_loc), n, np.int32)
    plans, K_sh = [], K
    for p in range(n_shards):
        idx = np.flatnonzero(shard == p)
        if idx.size == 0:
            filler = np.zeros((dim,), np.float32)
            filler[0] = ((p * A0_loc * T + m) % M + 0.5) / M
            pos_p = np.broadcast_to(filler, (n_loc, dim)).copy()
        else:
            full = np.concatenate([idx, idx[np.zeros(n_loc - idx.size, np.int64)]])
            pos_p = pos[full]
            point_index[p, : idx.size] = idx
        pos_stack[p] = pos_p
        plan = build_plan(pos_p, None, N=N, m=m, sigma=sigma, batch_size=1, T=T, K=K_sh,
                          window=window, device=dev)
        t0 = (plan.origin[:, 0] // T)[plan.row_count > 0].cpu().numpy()
        if t0.size == 0 or t0.min() < p * A0_loc or t0.max() >= (p + 1) * A0_loc:
            raise RuntimeError(f"slab {p}'s plan bins points outside its axis-0 tiles "
                               f"[{p * A0_loc}, {(p + 1) * A0_loc})")
        if K_sh is None:
            K_sh = plan.K
        plans.append(plan)
    S_max = max(pl.S for pl in plans)
    return GridShardedLayout(
        plans=stack_plans([pad_plan_rows(pl, S_max) for pl in plans]),
        pos_stack=torch.as_tensor(pos_stack, device=dev),
        point_index=torch.as_tensor(point_index, device=dev),
        n=n, n_shards=n_shards, dim=dim, N=N, m=m, sigma=float(sigma), T=int(T),
        A0_loc=int(A0_loc), window=str(window),
    )


def _local_tile_ids(plan: BinnedPlan, A0_loc: int, shard: int) -> torch.Tensor:
    """(S,) int32 dense tile id of each plan row in its slab's tile space,
    ((t0 - shard*A0_loc) * nb + t1) * nb + ...; every empty row takes the
    tile of the filled row before it, so that each tile's rows stay one
    run (B1's precondition; an empty row's origin is 0, in slab 0)."""
    nb = plan.M // plan.T
    t = torch.div(plan.origin, plan.T, rounding_mode="floor")
    tid = t[:, 0] - shard * A0_loc
    for d in range(1, plan.dim):
        tid = tid * nb + t[:, d]
    idx = torch.arange(tid.shape[0], device=tid.device)
    prev = torch.cummax(torch.where(plan.row_count > 0, idx, 0), dim=0).values
    return tid[prev].to(torch.int32)


# ---------------------------------------------------------------------------
# The slab's fold and unfold: axes 1.. with the periodic wrap, axis 0
# without it (its spill crosses to the next rank instead), on the
# ``csrc/tilefold.cu`` slab kernels (plain versions on the CPU)
# ---------------------------------------------------------------------------


def _fold_to_slab(tiles: torch.Tensor, plan: BinnedPlan, A0: int, group) -> torch.Tensor:
    """The slab's dense tiles -> its grid slab (1, C, L0, M, ...), L0 = A0 T:
    the fold writes the E rows past the slab, which ONE ring shift adds onto
    the next rank's first E."""
    with trace.span("fold"):
        ext = fold_tiles_to_slab(tiles, plan, A0)
    L0 = A0 * plan.T
    recv = ring_shift(ext[:, :, L0:], group, +1)
    slab = ext[:, :, :L0]
    slab[:, :, : recv.shape[2]] += recv
    return slab


def _unfold_from_slab(g: torch.Tensor, plan: BinnedPlan, A0: int, group) -> torch.Tensor:
    """The grid slab (1, C, L0, M, ...) -> its dense tiles; ONE ring shift
    brings the next slab's first E rows, the unfold's halo."""
    halo = ring_shift(g[:, :, : plan.H - plan.T], group, -1)
    with trace.span("unfold"):
        return unfold_slab_to_tiles(g, halo, plan, A0)


# ---------------------------------------------------------------------------
# Spectral stages of a grid sharded on axis 0: cuFFT's half spectra over the
# slab's own axes 1.., the slab's rows of the axis-0 pruned DFT matrix as
# one complex matmul, one all-reduce of the half spectrum
# ---------------------------------------------------------------------------


def _axis0_dft(N: int, M: int, m: int, sigma: float, sign: int, off: int, L: int, window: str,
               device, half: bool) -> torch.Tensor:
    """(L, K) complex64 rows off + [0, L) of the pruned DFT matrix of axis 0,
    D[a, k] = exp(sign 2 pi i (off + a) k / M) phi_hat_inv(k): k in the band
    [-h, N - h) (K = N) or, with ``half``, in the half spectrum's leading
    range [-h, h] (K = 2h + 1; the +h column of an even N is the -h
    column's conjugate, phi_hat being even)."""
    mr, mi = _pruned_mats(N, M, m, sigma, sign, off, L, window, device)
    D = torch.complex(mr, mi)
    if half and N % 2 == 0:
        D = torch.cat([D, D[:, :1].conj()], dim=1)
    return D


def _contract0(x: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """Axis 2 of x (B, C, L_in, ...) contracted with D (L_in, L_out): one
    complex matmul of (L_out, L_in) by (L_in, rest)."""
    B, C, L = x.shape[:3]
    y = torch.matmul(D.transpose(0, 1), x.reshape(B * C, L, -1))
    return y.reshape((B, C, D.shape[1]) + tuple(x.shape[3:]))


def _whole_axes(g: torch.Tensor, spec: tuple, M: int, embed: bool) -> torch.Tensor:
    """Axes 1.. of a grid slab between their cells ``spec[d]`` = (offset,
    count) and the whole M-cell axis: zero-padded to M (``embed``) or cut
    from it."""
    for d, (off, L) in enumerate(spec[1:], start=1):
        ax = 2 + d
        if (off, L) == (0, M):
            continue
        if embed:
            pad = [0, 0] * (g.ndim - 1 - ax) + [off, M - off - L]
            g = torch.nn.functional.pad(g, pad)
        else:
            g = g.narrow(ax, off, L)
    return g


def spectral_adjoint_pruned_dft_sharded0(gr, gi, dim, N, m, sigma, group, M, cells=None,
                                         window="gaussian"):
    """Adjoint spectral stage of this rank's slab (B, C, L0/P, M1, ...) of
    a channel-first grid sharded on axis 0 over ``group`` (gi may be None).
    Per real plane: the half spectrum of axes 1.. (``rfftn``, crop, rolloff;
    :func:`ops.fft.spectral_adjoint_half`), then the slab's row block of the
    axis-0 pruned DFT matrix over the half spectrum's leading range, then
    one all-reduce of the half spectrum, expanded to the band. Returns the
    replicated spectrum planes (B, C, (N,)*dim)."""
    spec = _cells_spec(dim, M, cells)
    off0, L0 = spec[0]
    L0_loc = gr.shape[2]
    if L0 % L0_loc:
        raise ValueError(f"local slab length {L0_loc} does not divide axis length {L0}")
    off = off0 + rank(group) * L0_loc
    planes = (gr,) if gi is None else (gr, gi)
    with trace.span("slab spectral"):
        D = _axis0_dft(N, M, m, sigma, +1, off, L0_loc, window, gr.device, half=True)
        half = torch.stack([
            _contract0(spectral_adjoint_half(_whole_axes(g, spec, M, True), dim - 1, N, m,
                                             sigma, window), D) for g in planes])
    half = torch.view_as_complex(reduce(torch.view_as_real(half), group))
    with trace.span("slab spectral"):
        y = half_spectrum_to_full(half[0], dim, N)
        if gi is not None:
            y = y + 1j * half_spectrum_to_full(half[1], dim, N)
        return y.real, y.imag


def spectral_forward_pruned_dft_sharded0(xr, xi, dim, M, m, sigma, group, n_shards,
                                         cells=None, real_only=False, window="gaussian"):
    """Forward spectral stage producing this rank's axis-0 slab
    (B, C, L0/P, M1, ...) from the replicated spectrum planes xr/xi
    (B, C, (N,)*dim), with no collective: the slab's columns of the axis-0
    pruned DFT matrix as one complex matmul, then axes 1.. by ``irfftn`` of
    the half spectrum of the Hermitian part (the real plane) and of the
    Hermitian part of -i times it (the imaginary plane;
    :func:`ops.fft.full_to_half`, :func:`ops.fft.spectral_forward_half`).
    ``real_only`` returns (real plane, None)."""
    N = xr.shape[2]
    spec = _cells_spec(dim, M, cells)
    off0, L0 = spec[0]
    if L0 % n_shards:
        raise ValueError(f"L0={L0} not divisible by n_shards={n_shards}")
    L0_loc = L0 // n_shards
    off = off0 + rank(group) * L0_loc
    xr = to_varying(xr, group)
    xi = None if xi is None else to_varying(xi, group)
    with trace.span("slab spectral"):
        D = _axis0_dft(N, M, m, sigma, -1, off, L0_loc, window, xr.device, half=False)
        z = torch.complex(xr, torch.zeros_like(xr) if xi is None else xi)
        w = _contract0(z, D.transpose(0, 1))  # (B, C, L0_loc, N, ...)
        del z
        out = [_whole_axes(spectral_forward_half(full_to_half(v, dim - 1, N), dim - 1, N, M,
                                                 m, sigma, window), spec, M, False)
               for v in ((w,) if real_only else (w, -1j * w))]
    return out[0], None if real_only else out[1]


# ---------------------------------------------------------------------------
# Public transforms
# ---------------------------------------------------------------------------


class _Shard:
    """One rank's view of a layout on a mesh axis: its plan, its points,
    the packing of global values into its slab, and its tile route (the
    slab's local tile ids, its fold and its unfold), on which the spread
    and the gather run as the binned engine's autograd Functions."""

    def __init__(self, layout: GridShardedLayout, mesh, axis_name: str):
        self.lay = layout
        self.group = axis_group(mesh, axis_name)
        self.dev = mesh_device(mesh)
        if size(self.group) != layout.n_shards:
            raise ValueError(f"the layout has {layout.n_shards} slabs, the mesh axis "
                             f"{axis_name!r} {size(self.group)} ranks")
        if layout.plans.device != self.dev:
            raise ValueError(f"the layout lives on {layout.plans.device}, the mesh "
                             f"computes on {self.dev}")
        self.r = rank(self.group)
        self.plan = plan = index_plan(layout.plans, self.r)
        self.index = layout.point_index[self.r].to(torch.int64)
        A0, group = layout.A0_loc, self.group
        self.route = TileRoute(plan, "local", tid=_local_tile_ids(plan, A0, self.r),
                               NT=layout.NT,
                               fold=lambda tiles: _fold_to_slab(tiles, plan, A0, group),
                               unfold=lambda g: _unfold_from_slab(g, plan, A0, group))

    def pack(self, x: torch.Tensor) -> torch.Tensor:
        """(n, C) global values -> this slab's (n_loc, C), padded slots 0."""
        x = to_varying(torch.as_tensor(x, device=self.dev).to(torch.float32), self.group)
        xp = torch.cat([x, x.new_zeros((1, x.shape[1]))])
        return xp.index_select(0, self.index)

    def unpack(self, y: torch.Tensor) -> torch.Tensor:
        """This slab's (n_loc, C) -> the global (n, C), padded slots dropped."""
        flat = all_gather_rows(y, self.group, 0)
        idx = self.lay.point_index.reshape(-1).to(torch.int64)
        out = flat.new_zeros((self.lay.n + 1, flat.shape[1]))
        return out.index_copy(0, idx, flat)[: self.lay.n]

    def spread(self, x: torch.Tensor) -> torch.Tensor:
        """(n, C) global values -> this rank's grid slab (1, C, L0, M, ...)."""
        return self.route.spread(self.pack(x))

    def gather(self, g: torch.Tensor) -> torch.Tensor:
        """This rank's grid slab -> the global (n, C)."""
        return self.unpack(self.route.gather(g))


def _spectrum_in(a, dev) -> torch.Tensor:
    """(1, (N,)*dim, C) -> channel-first (1, C, (N,)*dim) float32."""
    return torch.as_tensor(a, device=dev).to(torch.float32).movedim(-1, 1)


@trace.spanned("nfft_adjoint_grid_sharded")
def nfft_adjoint_grid_sharded(x, layout: GridShardedLayout, mesh, *, axis_name: str = "grid"):
    """Grid-sharded adjoint NFFT of real samples x (n, C), in the user point
    order of the ``pos`` the layout was built from. Returns the planes
    (yr, yi), each (1, (N,)*dim, C), the same on every rank: one ring shift
    (halo) and one all-reduce (spectrum)."""
    sh, lay = _Shard(layout, mesh, axis_name), layout
    yr, yi = spectral_adjoint_pruned_dft_sharded0(
        sh.spread(x), None, lay.dim, lay.N, lay.m, lay.sigma, sh.group, lay.M,
        window=lay.window)
    return yr.movedim(1, -1), yi.movedim(1, -1)


@trace.spanned("nfft_forward_grid_sharded")
def nfft_forward_grid_sharded(xr, xi, layout: GridShardedLayout, mesh, *,
                              axis_name: str = "grid", real_output: bool = False):
    """Grid-sharded forward NFFT of the planar spectrum xr/xi, each
    (1, (N,)*dim, C) (xi may be None), the same on every rank. Returns
    (yr, yi), each (n, C) in user point order (yi None with
    ``real_output``). Its one collective is the halo's ring shift; the rows
    are assembled by an all-gather."""
    sh, lay = _Shard(layout, mesh, axis_name), layout
    C = xr.shape[-1]
    gr, gi = spectral_forward_pruned_dft_sharded0(
        _spectrum_in(xr, sh.dev), None if xi is None else _spectrum_in(xi, sh.dev),
        lay.dim, lay.M, lay.m, lay.sigma, sh.group, lay.n_shards,
        real_only=real_output, window=lay.window)
    if real_output:
        return sh.gather(gr), None
    y = sh.gather(torch.cat([gr, gi], dim=1))
    return y[:, :C], y[:, C:]


@trace.spanned("nfft_fastsum_grid_sharded")
def nfft_fastsum_grid_sharded(x, coeffs, layout: GridShardedLayout, mesh, *,
                              axis_name: str = "grid"):
    """Grid-sharded fastsum (the Gram matvec) of real samples x (n, C) with
    real even coefficients (N,)*dim: spread -> band filter on the
    replicated N^dim spectrum -> gather, every grid-sized stage on one slab
    a rank; sources = targets = the layout's points. Two ring shifts and one
    all-reduce. Returns y (n, C), the same on every rank. The phi_hat_inv^2
    factor rides in the two pruned DFT matrices; ``coeffs`` multiplies the
    centered band."""
    sh, lay = _Shard(layout, mesh, axis_name), layout
    cf = torch.as_tensor(coeffs, device=sh.dev)
    cf = (cf.real if cf.is_complex() else cf).to(torch.float32)[None, None]
    sr, si = spectral_adjoint_pruned_dft_sharded0(
        sh.spread(x), None, lay.dim, lay.N, lay.m, lay.sigma, sh.group, lay.M,
        window=lay.window)
    gr, _ = spectral_forward_pruned_dft_sharded0(
        sr * cf, si * cf, lay.dim, lay.M, lay.m, lay.sigma, sh.group, lay.n_shards,
        real_only=True, window=lay.window)
    return sh.gather(gr)
