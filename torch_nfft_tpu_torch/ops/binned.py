"""Binned spread/gather: plan the point-to-tile assignment once, then run the
window contractions tile by tile.

Counterpart of the JAX package's ``ops/binned.py`` on its sort route (no Benes
tables). Each point's window starts at cell s = (floor(M*pos) - m) mod M; the
grid is cut into tiles of T cells per axis and each point joins the tile that
contains s. Points are sorted by (batch, tile) and packed into rows of at
most K points of one tile. Per row, the spread kernel forms the H^dim halo
tile (H = T + 2m + 1) and accumulates it into a dense tile array; the fold
(ops/tilefold.py) overlap-adds the tiles onto the grid. The gather runs the
same steps backwards.

Both directions are differentiable in the values and in the point
positions (``_Spread``, ``_Gather``): each value cotangent runs the other
direction's kernel, and each position cotangent the derivative-window
kernel ``pos_grad`` on the unfolded tiles, as the JAX package's fused
backward does. Positions are never read for the forward: the plan's
``slot_pos`` is, and ``pos`` is the input that receives the gradient.

The T/K heuristics are copied from the JAX package for parity; they encode
TPU limits and are not tuned for the GPU.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device
from .contract import gather_points, pos_grad, spread_tiles_dense
from .tilefold import (
    fold_tiles_to_grid,
    row_tile_ids,
    tiles_per_axis,
    unfold_grid_to_tiles,
)
from .window import check_window

__all__ = [
    "BinnedPlan",
    "build_plan_device",
    "default_tile",
    "spread_binned",
    "gather_binned",
    "spread_stages",
    "gather_stages",
    "run_stages",
]


def _next_pow2(v: int) -> int:
    return 1 << max(0, (int(v) - 1).bit_length())


@dataclass
class BinnedPlan:
    """Sorted point-to-tile assignment for one (pos, batch) point set."""

    slot_pt: torch.Tensor  # (S, K) int32: user point index per slot
    slot_pos: torch.Tensor  # (dim, S*K) float32: slot-ordered coordinates
    origin: torch.Tensor  # (S, dim) int32: tile origin cell per row
    row_batch: torch.Tensor  # (S,) int32
    fill_keys: torch.Tensor  # (S*K,) int32: a permutation of [0, S*K); the
    # head [:n] is each user point's slot, the tail lists the empty slots
    row_count: torch.Tensor  # (S,) int32: points filling each row
    n: int
    dim: int
    N: int
    m: int
    sigma: float
    T: int
    K: int
    batch_size: int
    window: str = "gaussian"
    # per-axis (start_tile, num_tiles) run covering every occupied tile and
    # its +1 neighbour, or None when every axis is full (kept for parity
    # with the JAX plan; the port folds the full grid)
    active: tuple | None = None

    @property
    def M(self) -> int:
        return int(round(self.sigma * self.N))

    @property
    def H(self) -> int:
        return self.T + 2 * self.m + 1

    @property
    def S(self) -> int:
        return self.slot_pt.shape[0]

    @property
    def NT(self) -> int:
        """Tiles of the dense tile array: batch_size * ceil(M/T)^dim."""
        return self.batch_size * tiles_per_axis(self) ** self.dim

    @property
    def device(self) -> torch.device:
        return self.slot_pt.device

    @property
    def inv_slot(self) -> torch.Tensor:
        """(n,) int32 flat slot id per user point."""
        return self.fill_keys[: self.n]


def _min_cyclic_run(cover, nb: int):
    """(start, count) of the minimal cyclic run covering the tile set."""
    if cover.size >= nb:
        return (0, nb)
    s = np.sort(cover)
    gaps = np.diff(np.concatenate([s, s[:1] + nb]))
    i = int(np.argmax(gaps))
    start = int(s[(i + 1) % s.size])
    count = nb - int(gaps[i]) + 1
    return (start, count)


def _active_runs(origin_np, T: int, M: int, dim: int) -> tuple | None:
    """Per-axis minimal cyclic tile run covering every occupied tile and its
    +1 neighbour; None when every axis is full."""
    nb = M // T
    runs = []
    any_partial = False
    for d in range(dim):
        occ = np.unique(np.asarray(origin_np)[:, d] // T)
        if occ.size == 0:
            return None
        cover = np.unique(np.concatenate([occ, (occ + 1) % nb]))
        run = _min_cyclic_run(cover, nb)
        runs.append(run)
        if run[1] < nb:
            any_partial = True
    return tuple(runs) if any_partial else None


def default_tile(dim: int, m: int, M: int) -> int:
    """Tile edge T: 64/32/16 for 1/2/3 dims, at least the halo-fold minimum
    2m+1, dropped to a power-of-two divisor of M where the preferred T does
    not divide M."""
    base = {1: 64, 2: 32, 3: 16}.get(dim, 16)
    tmin = _next_pow2(2 * m + 1)
    T = min(max(base, tmin), M)
    if M % T:
        t = T
        while t > tmin and M % t:
            t //= 2
        if t >= tmin and M % t == 0:
            T = t
    return T


def _pick_K_cap(mean_occ: float) -> int:
    """Row capacity from the mean bin occupancy, capped at 1024."""
    return int(min(1024, max(8, _next_pow2(math.ceil(mean_occ)))))


# Row budget of the JAX package's TPU kernels (scalar-prefetch memory);
# kept so that both packages choose the same K.
_MAX_ROWS_SMEM = 36000


def _choose_K(cnt, n: int) -> int:
    """Row capacity from the occupied-bin histogram: the mean-occupancy power
    of two, halved to 512 when that saves >= 3% of n in padding slots and
    the row count stays inside the row budget."""
    mean_occ = float(cnt.mean()) if cnt.size else 1.0
    K = _pick_K_cap(mean_occ)
    if K == 1024:
        s512 = int(np.sum(-(-cnt // 512)))
        pad512 = s512 * 512 - n
        pad1024 = int(np.sum(-(-cnt // 1024))) * 1024 - n
        if pad1024 - pad512 >= 0.03 * n and s512 <= _MAX_ROWS_SMEM:
            return 512
    return K


def _sorted_bins(pos, batch, *, M, m, t, nb, nbins, dim):
    """(order, counts): stable argsort of the per-point bin ids and the
    per-bin histogram, on the device of ``pos``."""
    s_mod = torch.remainder(torch.floor(pos * M).to(torch.int64) - m, M)
    b = torch.div(s_mod, t, rounding_mode="floor")
    bid = batch.to(torch.int64)
    for d in range(dim):
        bid = bid * nb + b[:, d]
    order = torch.sort(bid, stable=True).indices
    counts = torch.bincount(bid, minlength=nbins)
    return order, counts


def build_plan_device(pos, batch=None, *, N: int, m: int, sigma: float = 2.0,
                      batch_size: int | None = None, T: int | None = None,
                      K: int | None = None, window: str = "gaussian",
                      device=None) -> BinnedPlan:
    """Build a :class:`BinnedPlan` with every O(n) step on ``device`` (the
    CUDA card unless ``device="cpu"``; raises when no card is there and no
    device was asked for). The host lays out only the O(rows) row tables
    from the per-bin histogram."""
    check_window(window)
    dev = resolve_device(device)
    # binning must match the float32 kernels
    pos = torch.as_tensor(pos, device=dev).to(torch.float32)
    n, dim = pos.shape
    if batch is None:
        batch_t = torch.zeros((n,), dtype=torch.int32, device=pos.device)
        batch_size = 1 if batch_size is None else int(batch_size)
    else:
        batch_t = torch.as_tensor(batch, device=pos.device).to(torch.int32)
        if batch_size is None:
            batch_size = int(batch_t[-1]) + 1
    M = int(round(sigma * N))

    def histogram(t):
        nb = -(-M // t)
        nbins = batch_size * nb**dim
        order, counts = _sorted_bins(pos, batch_t, M=M, m=m, t=t, nb=nb,
                                     nbins=nbins, dim=dim)
        return order, counts.cpu().numpy(), nb

    def finish(order, counts_np, t, nb):
        return _finish_plan(pos, order, counts_np, n, dim, N, m, sigma, t,
                            nb, K, batch_size, window)

    if T is None:
        T = default_tile(dim, m, M)
        if T == 16 and dim == 3 and M % 32 == 0 and M > 32:
            # density probe of the JAX package: sparse sets take T=32, dense
            # sets T=8 when its row count stays inside the row budget
            order, counts_np, nb = histogram(16)
            occ16 = n / max(1, int((counts_np > 0).sum()))
            if occ16 < 64:
                T = 32
            elif occ16 >= 1024 and K is None and 2 * m + 1 <= 8 and M % 8 == 0:
                o8, c8_np, nb8 = histogram(8)
                cnt8 = c8_np[c8_np > 0].astype(np.int64)
                rows8 = int(np.sum(-(-cnt8 // _choose_K(cnt8, n))))
                if rows8 <= 56000:
                    return finish(o8, c8_np, 8, nb8)
            if T == 16:
                return finish(order, counts_np, 16, nb)
    T = min(T, M)
    order, counts_np, nb = histogram(T)
    return finish(order, counts_np, T, nb)


def _finish_plan(pos, order, counts_np, n, dim, N, m, sigma, T, nb, K,
                 batch_size, window) -> BinnedPlan:
    """Host row layout from the histogram, then the slot tables on the
    device of ``pos``."""
    M = int(round(sigma * N))
    dev = pos.device
    uniq = np.flatnonzero(counts_np)
    cnt = counts_np[uniq].astype(np.int64)
    if K is None:
        K = _choose_K(cnt, n)
    rows_per_bin = -(-cnt // K)
    S = int(rows_per_bin.sum())
    row_bin = np.repeat(np.arange(len(uniq)), rows_per_bin)
    row_rank = np.arange(S) - np.repeat(
        np.concatenate([[0], np.cumsum(rows_per_bin)[:-1]]), rows_per_bin
    )
    start_idx = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    row_start = start_idx[row_bin] + row_rank * K
    row_count = np.minimum(cnt[row_bin] - row_rank * K, K).astype(np.int32)

    bid = uniq[row_bin]
    origin = np.empty((S, dim), np.int32)
    for d in range(dim - 1, -1, -1):
        origin[:, d] = (bid % nb) * T
        bid = bid // nb
    row_batch = bid.astype(np.int32)

    row_start_t = torch.as_tensor(row_start, dtype=torch.int64, device=dev)
    row_count_t = torch.as_tensor(row_count, device=dev)
    k_ar = torch.arange(K, dtype=torch.int64, device=dev)[None, :]
    gidx = torch.clamp(row_start_t[:, None] + k_ar, max=n - 1)
    slot_pt = order[gidx]  # (S, K); empty slots repeat a real point
    slot_pos = pos[slot_pt.reshape(-1)].T.contiguous()
    # Rows cut the sorted order into consecutive runs, so the j-th filled
    # slot in row-major order holds sorted point j.
    valid = (k_ar < row_count_t[:, None]).reshape(-1)
    slot_ids = torch.arange(S * K, dtype=torch.int64, device=dev)
    inv_slot = torch.empty((n,), dtype=torch.int64, device=dev)
    inv_slot[order] = slot_ids[valid]
    fill_keys = torch.cat([inv_slot, slot_ids[~valid]])
    return BinnedPlan(
        slot_pt=slot_pt.to(torch.int32),
        slot_pos=slot_pos,
        origin=torch.as_tensor(origin, device=dev),
        row_batch=torch.as_tensor(row_batch, device=dev),
        fill_keys=fill_keys.to(torch.int32),
        row_count=row_count_t,
        n=n, dim=dim, N=N, m=m, sigma=float(sigma), T=int(T), K=int(K),
        batch_size=int(batch_size), window=str(window),
        active=_active_runs(origin, T, M, dim) if M % T == 0 else None,
    )


# ---------------------------------------------------------------------------
# Execute
# ---------------------------------------------------------------------------


def slot_values(plan: BinnedPlan, x: torch.Tensor) -> torch.Tensor:
    """(n, C) user-order values -> (C, S*K) slot order, empty slots zero.
    A scatter through the plan's point->slot map (the sort route of the JAX
    package sorts by the same keys)."""
    S, K = plan.slot_pt.shape
    vals = x.new_zeros((S * K, x.shape[1]))
    vals.index_copy_(0, plan.inv_slot.to(torch.int64), x)
    return vals.T.contiguous()


def unslot_values(plan: BinnedPlan, out_flat: torch.Tensor) -> torch.Tensor:
    """(S*K, C) slot-order values -> (n, C) user order (empty slots drop)."""
    return out_flat.index_select(0, plan.inv_slot)


def dense_tile_ids(plan: BinnedPlan) -> torch.Tensor:
    """Row tile ids with every empty row (row_count == 0) pointed at the
    nearest preceding filled row's tile, so each tile's rows stay one
    consecutive run (the spread kernel's precondition)."""
    tid = row_tile_ids(plan)
    valid = plan.row_count > 0
    idx = torch.arange(tid.shape[0], dtype=torch.int64, device=tid.device)
    prev_valid = torch.cummax(torch.where(valid, idx, 0), dim=0).values
    return tid[prev_valid]


def _check_values(plan: BinnedPlan, v: torch.Tensor, what: str) -> None:
    if v.device != plan.device:
        raise ValueError(f"{what} is on {v.device} but the plan is on {plan.device}")


def check_points(plan: BinnedPlan, x: torch.Tensor) -> None:
    """x (n, C) must hold one row per planned point, on the plan's device."""
    _check_values(plan, x, "x")
    if x.shape[0] != plan.n:
        raise ValueError(f"x has {x.shape[0]} points, the plan {plan.n}")


def spread_stages(plan: BinnedPlan) -> tuple:
    """The spread as (name, function) stages in order, each function taking
    the previous one's result: x (n, C) -> grid (batch_size, C, M^dim).
    :func:`spread_binned` runs them; chip_smoke.py times them one by one."""
    return (
        ("slot_values", lambda x: slot_values(plan, x.to(torch.float32))),
        ("spread kernel",
         lambda v: spread_tiles_dense(plan, v, dense_tile_ids(plan), plan.NT)),
        ("fold", lambda tiles: fold_tiles_to_grid(tiles, plan)),
    )


def gather_stages(plan: BinnedPlan) -> tuple:
    """The gather as stages, the transpose of :func:`spread_stages`:
    grid (batch_size, C, M^dim) -> (n, C)."""
    return (
        ("unfold", lambda g: unfold_grid_to_tiles(g.to(torch.float32), plan)),
        ("gather kernel", lambda tiles: gather_points(plan, tiles, row_tile_ids(plan))),
        ("unslot_values",  # (S, C, K) -> (S*K, C) -> user order
         lambda y: unslot_values(plan, y.transpose(1, 2).reshape(-1, y.shape[1]))),
    )


def run_stages(stages: tuple, v):
    """Run (name, function) stages in order on v."""
    for _, fn in stages:
        v = fn(v)
    return v


def _pos_cotangent(plan: BinnedPlan, tiles, w_slot, pos) -> torch.Tensor:
    """(n, dim) position cotangent, on ``pos``'s device and in its dtype,
    from the dense tiles and the slot-ordered point weights."""
    dp = pos_grad(plan, tiles, w_slot, row_tile_ids(plan))  # (S, dim, K)
    dp = unslot_values(plan, dp.transpose(1, 2).reshape(-1, plan.dim))
    return dp.to(pos)


class _Spread(torch.autograd.Function):
    """x (n, C), pos (n, dim) or None -> grid (batch_size, C, M^dim).
    Backward: dx = gather(unfold(g_bar)), dpos = pos_grad(unfold(g_bar),
    w = x), the tiles unfolded once for both."""

    @staticmethod
    def forward(ctx, plan, x, pos):
        stages = spread_stages(plan)
        vals = run_stages(stages[:1], x)  # slot-ordered (C, S*K)
        ctx.plan = plan
        ctx.save_for_backward(vals if ctx.needs_input_grad[2] else None, pos)
        return run_stages(stages[1:], vals)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_bar):
        plan = ctx.plan
        vals, pos = ctx.saved_tensors
        stages = gather_stages(plan)
        tiles = run_stages(stages[:1], g_bar)
        dx = dpos = None
        if ctx.needs_input_grad[1]:
            dx = run_stages(stages[1:], tiles)
        if ctx.needs_input_grad[2]:
            dpos = _pos_cotangent(plan, tiles, vals, pos)
        return None, dx, dpos


class _Gather(torch.autograd.Function):
    """grid (batch_size, C, M^dim), pos (n, dim) or None -> (n, C).
    Backward: dg = spread(y_bar), dpos = pos_grad(unfold(g), w = y_bar),
    y_bar put in slot order once for both."""

    @staticmethod
    def forward(ctx, plan, g, pos):
        ctx.plan = plan
        ctx.save_for_backward(g if ctx.needs_input_grad[2] else None, pos)
        return run_stages(gather_stages(plan), g)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, y_bar):
        plan = ctx.plan
        g, pos = ctx.saved_tensors
        stages = spread_stages(plan)
        w_slot = run_stages(stages[:1], y_bar)  # slot-ordered (C, S*K)
        dg = dpos = None
        if ctx.needs_input_grad[1]:
            dg = run_stages(stages[1:], w_slot)
        if ctx.needs_input_grad[2]:
            tiles = run_stages(gather_stages(plan)[:1], g)
            dpos = _pos_cotangent(plan, tiles, w_slot, pos)
        return None, dg, dpos


def _check_pos(plan: BinnedPlan, pos) -> None:
    if pos is not None and tuple(pos.shape) != (plan.n, plan.dim):
        raise ValueError(f"pos has shape {tuple(pos.shape)}; the plan was built "
                         f"for ({plan.n}, {plan.dim})")


def spread_binned(plan: BinnedPlan, x: torch.Tensor,
                  pos: torch.Tensor | None = None) -> torch.Tensor:
    """Spread x (n, C) onto the oversampled grid, (batch_size, C, M^dim).
    Differentiable in x and, when given, in ``pos`` (the plan's points,
    (n, dim); the forward reads the plan's copy)."""
    check_points(plan, x)
    _check_pos(plan, pos)
    return _Spread.apply(plan, x, pos)


def gather_binned(plan: BinnedPlan, g: torch.Tensor,
                  pos: torch.Tensor | None = None) -> torch.Tensor:
    """Gather the grid (batch_size, C, M^dim) back to the points, (n, C):
    the transpose of :func:`spread_binned`, differentiable in g and, when
    given, in ``pos``."""
    _check_values(plan, g, "the grid")
    if g.ndim != 2 + plan.dim or g.shape[0] != plan.batch_size or any(
            s != plan.M for s in g.shape[2:]):
        raise ValueError(f"the grid has shape {tuple(g.shape)}, the plan needs "
                         f"({plan.batch_size}, C) + {(plan.M,) * plan.dim}")
    _check_pos(plan, pos)
    return _Gather.apply(plan, g, pos)
