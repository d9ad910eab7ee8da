"""Binned spread/gather: plan the point-to-tile assignment once, then run the
window contractions tile by tile.

Counterpart of the JAX package's ``ops/binned.py``. Each point's window starts at cell s = (floor(M*pos) - m) mod M; the
grid is cut into tiles of T cells per axis and each point joins the tile that
contains s. Points are sorted by (batch, tile) and packed into rows of at
most K points of one tile. Per row, the spread kernel forms the H^dim halo
tile (H = T + 2m + 1) and accumulates it into a dense tile array; the fold
(ops/tilefold.py) overlap-adds the tiles onto the grid. The gather runs the
same steps backwards.

Where the dense tile array for C columns would exceed the memory budget of
``tilefold.use_fold`` (the JAX package's rule), both directions take the
flat-grid route instead: the spread forms each row's own tile
(``spread_tiles``) and adds it onto the grid cell by cell, each cell
wrapped mod M (the JAX package's scatter onto the periodically extended
grid and its fold of the extension, in another order of the float sums);
the gather reads each row's tile from the grid and runs the gather kernel
on the per-row tiles.

Plans come from the host builder :func:`build_plan` (the native counting
sort of ``csrc/plan_builder.cpp``; it also keeps the sorted ``order``,
``row_start`` and the bin-id fingerprint ``pos_fp``) or from
:func:`build_plan_device` (every O(n) step on the device). The user <-> slot
permutations run as an ``index_copy_``/``index_select`` through the plan's
point -> slot map (the sort route), or, once ``with_benes_tables`` has
routed them, through the Benes network (ops/benes.py) and the ragged row
passes (ops/ragged.py), as the JAX package's default headline does.

A call's way between the points and the grid (the permutation, the tile
space, the movement between tiles and grid) is one :class:`TileRoute`,
which :func:`tile_route` picks. Both directions are differentiable in the
values and in the point positions (``_Spread``, ``_Gather``, on any
route): each value cotangent runs the other direction's kernel, and each
position cotangent the derivative-window kernel ``pos_grad`` on the
unfolded tiles, as the JAX package's fused backward does. Positions are never read for the forward: the plan's
``slot_pos`` is, and ``pos`` is the input that receives the gradient.

The T/K heuristics are copied from the JAX package for parity; they encode
TPU limits and are not tuned for the GPU.
"""

from __future__ import annotations

import math
from collections.abc import Callable
from dataclasses import dataclass, replace

import numpy as np
import torch

from .. import trace
from .._device import resolve_device
from .._native import plan_tables
from .benes import apply_benes_, plan_benes_tables
from .contract import gather_points, pos_grad, spread_tiles, spread_tiles_dense
from .ragged import compact_rows, expand_rows, row_start_from_counts
from .tilefold import (
    fold_tiles_to_grid,
    row_tile_ids,
    tiles_per_axis,
    unfold_grid_to_tiles,
    use_fold,
)
from .window import check_window

__all__ = [
    "BinnedPlan",
    "build_plan",
    "build_plan_device",
    "position_fingerprint",
    "plan_tables_np",
    "to_slot_order",
    "from_slot_order",
    "plan_slot_pos_user",
    "default_tile",
    "merge_active_runs",
    "spread_binned",
    "gather_binned",
    "spread_binned_slot",
    "gather_binned_slot",
    "TileRoute",
    "tile_route",
    "tiles_to_grid",
    "grid_to_tiles",
    "run_stages",
    "dense_tiles_local",
    "points_from_tiles_local",
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
    # bin-id fingerprint of the point set (position_fingerprint), set by the
    # host builder and checked against NumPy positions by the entry points;
    # None for device plans
    pos_fp: int | None = None
    # host-side sorted layout (NumPy, host builder only): point ids in
    # (batch, tile) order, and each row's start in that order
    order: np.ndarray | None = None
    row_start: np.ndarray | None = None
    # occupied (batch, tile) groups among the filled rows
    S_occ: int | None = None
    # routed Benes tables of the user <-> slot permutation
    # (with_benes_tables), or None for the sort route
    benes: object = None

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

    def with_benes_tables(self, block_log2: int = 18, compact: bool = True,
                          pos=None, batch=None) -> "BinnedPlan":
        """A copy of this plan whose user <-> slot permutations run through
        routed Benes tables (ops/benes.py): one host routing, then every
        transform applies them on the plan's device. ``compact`` (default)
        routes the n-point rank space and pads it into the slot rows with
        the ragged passes; ``compact=False`` routes the padded slot space.
        For device plans pass the host ``pos`` (and ``batch``): the rank is
        then derived on the host and checked against the plan.
        ``block_log2`` keeps the JAX signature: it sets the TPU kernels'
        mask layout, which the CUDA kernels do not have, and is unused."""
        del block_log2
        return replace(self, benes=plan_benes_tables(
            self, compact=compact, pos=pos, batch=batch))


def _count_row_groups(origin_np, row_batch_np, row_count_np) -> int:
    """Number of occupied (batch, tile) groups among the filled rows: rows
    are grouped by (batch, tile) in plan order, so a group starts wherever
    the key differs from the previous row's."""
    valid = np.asarray(row_count_np) > 0
    key = np.concatenate([np.asarray(row_batch_np)[:, None], np.asarray(origin_np)],
                         axis=1)
    if key.shape[0] == 0:
        return 0
    d = np.any(key[1:] != key[:-1], axis=1)
    first = np.concatenate([[True], d]) & valid
    return int(first.sum())


def position_fingerprint(pos, M: int, m: int) -> int:
    """Exact fingerprint of the binning geometry: the sum of all window-start
    cell ids. Two point sets that bin alike run alike under a plan."""
    pos = np.asarray(pos, dtype=np.float32)
    s_mod = (np.floor(pos * M).astype(np.int64) - m) % M
    return int(s_mod.sum())


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


def merge_active_runs(actives, nb: int, dim: int) -> tuple | None:
    """Union of per-plan active runs, for stacked plans whose members share
    one slab: an axis that is full (or unknown, None) in any member is full;
    otherwise the minimal cyclic run over the union of the members' tiles.
    None when every axis is full."""
    runs = []
    any_partial = False
    for d in range(dim):
        if any(a is None or a[d][1] >= nb for a in actives):
            runs.append((0, nb))
            continue
        tiles = np.concatenate([(s + np.arange(c)) % nb for s, c in (a[d] for a in actives)])
        run = _min_cyclic_run(np.unique(tiles), nb)
        runs.append(run)
        any_partial = any_partial or run[1] < nb
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


@trace.spanned("build_plan_device")
def build_plan_device(pos, batch=None, *, N: int, m: int, sigma: float = 2.0,
                      batch_size: int | None = None, T: int | None = None,
                      K: int | None = None, window: str = "gaussian",
                      device=None) -> BinnedPlan:
    """Build a :class:`BinnedPlan` with every O(n) step on ``device`` (the
    CUDA card unless ``device="cpu"``; raises when no card is there and no
    device was asked for). The host lays out only the O(rows) row tables
    from the per-bin histogram. A batch id outside [0, batch_size) raises
    ``ValueError``, as in the host builder (the JAX builders drop such
    points)."""
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
        if n:
            # the host builder's check (_native.plan_tables), as one min/max
            # pass on the device: the JAX builders drop such points silently
            lo, hi = torch.aminmax(batch_t)
            if int(lo) < 0 or int(hi) >= batch_size:
                raise ValueError("a point's bin lies outside the bin range (batch id "
                                 "outside [0, batch_size)?)")
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
        S_occ=len(uniq),
    )


def host_array(a, dtype) -> np.ndarray:
    """``a`` (a tensor on any device, or array-like) as a contiguous host
    array of ``dtype``."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a, dtype=dtype)


def _bin_ids_np(pos, batch, *, M: int, m: int, t: int, nb: int) -> np.ndarray:
    """(n,) int64 bin id per point: batch, then the window-start tile per axis."""
    b = ((np.floor(pos * M).astype(np.int64) - m) % M) // t
    ids = np.asarray(batch, dtype=np.int64)
    for d in range(pos.shape[1]):
        ids = ids * nb + b[:, d]
    return ids


def plan_tables_np(pos, batch, M, m, T, nb, K, batch_size, pick_K=None):
    """NumPy version of the native :func:`_native.plan_tables` (the JAX
    package's reference path): the same tables from a stable argsort. They
    agree on every filled slot; in a padded slot ``slot_pt`` repeats
    ``order[min(row_start + k, n - 1)]``, as the device builder does, where
    the native builder writes 0."""
    n, dim = pos.shape
    bin_id = _bin_ids_np(pos, np.zeros(n) if batch is None else batch, M=M, m=m,
                         t=T, nb=nb)
    order = np.argsort(bin_id, kind="stable")
    uniq, start_idx, counts = np.unique(bin_id[order], return_index=True,
                                        return_counts=True)
    if K is None:
        dense = np.zeros(int(batch_size) * nb**dim, np.int64)
        dense[uniq] = counts
        K = int(pick_K(dense))
    rows_per_bin = -(-counts // K)
    S = int(rows_per_bin.sum())
    row_bin = np.repeat(np.arange(len(uniq)), rows_per_bin)
    row_rank = np.arange(S) - np.repeat(
        np.concatenate([[0], np.cumsum(rows_per_bin)[:-1]]), rows_per_bin)
    row_start = start_idx[row_bin] + row_rank * K
    row_count = np.minimum(counts[row_bin] - row_rank * K, K)
    k_ar = np.arange(K)[None, :]
    slot_pt = order[np.minimum(row_start[:, None] + k_ar, n - 1)].astype(np.int32)
    slot_valid = (k_ar < row_count[:, None]).astype(np.float32)
    bid = uniq[row_bin]
    origin = np.empty((S, dim), np.int32)
    for d in range(dim - 1, -1, -1):
        origin[:, d] = (bid % nb) * T
        bid = bid // nb
    valid = slot_valid.reshape(-1) > 0
    inv_slot = np.empty((n,), np.int32)
    inv_slot[slot_pt.reshape(-1)[valid]] = np.flatnonzero(valid)
    tables = (slot_pt, slot_valid, origin, bid.astype(np.int32), inv_slot,
              order.astype(np.int32), row_start.astype(np.int32),
              row_count.astype(np.int32))
    return tables, int(K)


@trace.spanned("build_plan")
def build_plan(pos, batch=None, *, N: int, m: int, sigma: float = 2.0,
               batch_size: int | None = None, T: int | None = None,
               K: int | None = None, window: str = "gaussian",
               device=None) -> BinnedPlan:
    """Build a :class:`BinnedPlan` on the host with the native counting sort
    (csrc/plan_builder.cpp), then move its tables to ``device`` (the CUDA
    card unless ``device="cpu"``; ``slot_pos`` is gathered there). The plan
    keeps the host ``order`` and ``row_start`` and the bin-id fingerprint
    ``pos_fp`` of its points; it equals the JAX package's ``build_plan``
    field by field."""
    check_window(window)
    dev = resolve_device(device)
    # bin in float32, as the kernels evaluate the windows
    pos = host_array(pos, np.float32)
    n, dim = pos.shape
    if batch is None:
        batch = np.zeros((n,), np.int64)
        batch_size = 1 if batch_size is None else batch_size
    batch = host_array(batch, np.int64)
    if batch_size is None:
        batch_size = int(batch[-1]) + 1
    M = int(round(sigma * N))
    if T is None:
        T = default_tile(dim, m, M)
        if dim == 3 and M % 32 == 0 and M > 32:
            # density probe of build_plan_device: sparse sets take T=32,
            # dense sets T=8 when its row count stays inside the row budget
            ids16 = _bin_ids_np(pos, batch, M=M, m=m, t=16, nb=M // 16)
            occ16 = n / max(1, np.unique(ids16).size)
            if occ16 < 64:
                T = 32
            elif occ16 >= 1024 and K is None and 2 * m + 1 <= 8 and M % 8 == 0:
                ids8 = _bin_ids_np(pos, batch, M=M, m=m, t=8, nb=M // 8)
                cnt8 = np.unique(ids8, return_counts=True)[1].astype(np.int64)
                if int(np.sum(-(-cnt8 // _choose_K(cnt8, n)))) <= 56000:
                    T = 8
    T = min(T, M)
    nb = -(-M // T)

    def pick_K(counts):
        return _choose_K(counts[counts > 0].astype(np.int64), n)

    (slot_pt, slot_valid, origin, row_batch, inv_slot, order, row_start,
     row_count), K = plan_tables(pos, batch.astype(np.int32), M, m, T, nb,
                                 None if K is None else int(K), batch_size,
                                 pick_K=pick_K)
    slot_pt_t = torch.from_numpy(slot_pt).to(dev)
    slot_pos = torch.from_numpy(pos).to(dev)[slot_pt_t.reshape(-1).long()].T
    flat_ids = np.arange(slot_pt.size, dtype=np.int32)
    fill_keys = np.concatenate([inv_slot, flat_ids[slot_valid.reshape(-1) <= 0]])
    return BinnedPlan(
        slot_pt=slot_pt_t,
        slot_pos=slot_pos.contiguous(),
        origin=torch.from_numpy(origin).to(dev),
        row_batch=torch.from_numpy(row_batch).to(dev),
        fill_keys=torch.from_numpy(fill_keys).to(dev),
        row_count=torch.from_numpy(row_count).to(dev),
        n=n, dim=dim, N=N, m=m, sigma=float(sigma), T=int(T), K=int(K),
        batch_size=int(batch_size), window=str(window),
        active=_active_runs(origin, T, M, dim) if M % T == 0 else None,
        pos_fp=position_fingerprint(pos, M, m),
        order=order, row_start=row_start,
        S_occ=_count_row_groups(origin, row_batch, row_count),
    )


# ---------------------------------------------------------------------------
# Execute
# ---------------------------------------------------------------------------


def slot_values(plan: BinnedPlan, x: torch.Tensor) -> torch.Tensor:
    """(n, C) user-order values -> (C, S*K) slot order, empty slots zero.

    Sort route: a scatter through the plan's point -> slot map. Benes route
    (``plan.benes``): all C columns through the network at once, then, for
    compact tables, the ragged expansion of the rank stream into the rows
    (the JAX package's ``ops/pallas/contract.py:_slot_values``)."""
    S, K = plan.slot_pt.shape
    bt = plan.benes
    if bt is None:
        vals = x.new_zeros((S * K, x.shape[1]))
        vals.index_copy_(0, plan.inv_slot.to(torch.int64), x)
        return vals.T.contiguous()
    n, C = x.shape
    v = x.new_empty((C, bt.n))
    v[:, n:] = 0  # the padding enters the network as zeros
    v[:, :n] = x.T
    out = apply_benes_(v, bt)
    if not bt.compact:
        return out[:, : S * K].contiguous()
    # the expansion reads only the n ranks (the JAX kernel's window read
    # ((n - 1) // K + 2) * K)
    rs = row_start_from_counts(plan.row_count)
    return expand_rows(out, rs, plan.row_count, K).reshape(C, S * K)


def unslot_values(plan: BinnedPlan, out_flat: torch.Tensor) -> torch.Tensor:
    """(S*K, C) slot-order values -> (n, C) user order (empty slots drop):
    the transpose of :func:`slot_values`. On the Benes route the rows are
    compacted into the rank stream (compact tables) or zero-padded (slot
    space) to the network's length, and the network runs in reverse."""
    bt = plan.benes
    if bt is None:
        return out_flat.index_select(0, plan.inv_slot)
    S, K = plan.slot_pt.shape
    n, C = plan.n, out_flat.shape[1]
    if bt.compact:
        rs = row_start_from_counts(plan.row_count)
        v = compact_rows(out_flat.T.reshape(C, S, K), rs, plan.row_count, n,
                         size=bt.n)
    else:
        v = out_flat.new_empty((C, bt.n))
        v[:, S * K:] = 0
        v[:, : S * K] = out_flat.T
    return apply_benes_(v, bt, reverse=True)[:, :n].T.contiguous()


def to_slot_order(plan: BinnedPlan, x: torch.Tensor) -> torch.Tensor:
    """(n, C) user-order values -> (C, S*K) slot-layout values, empty slots
    zero: the plan's own execution order, on its permutation route."""
    _check_values(plan, x, "x")
    return slot_values(plan, x)


def from_slot_order(plan: BinnedPlan, v: torch.Tensor) -> torch.Tensor:
    """(C, S*K) slot-layout values -> (n, C) user order: the inverse of
    :func:`to_slot_order` on its image (empty slots drop)."""
    _check_values(plan, v, "v")
    return unslot_values(plan, v.T)


def plan_slot_pos_user(plan: BinnedPlan) -> torch.Tensor:
    """(n, dim) float32 user-order positions from the plan's slot-ordered
    coordinates: exactly the coordinates the plan binned."""
    return unslot_values(plan, plan.slot_pos.T)


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


def _cell_chunks(plan: BinnedPlan, C: int, entries: int = 1 << 23):
    """Row ranges whose (R, C, H^dim) cell index stays under ``entries``."""
    S = plan.S
    R = max(1, entries // (C * plan.H**plan.dim))
    return [(r0, min(S, r0 + R)) for r0 in range(0, S, R)]


def _tile_cells(plan: BinnedPlan, r0: int, r1: int, C: int) -> torch.Tensor:
    """(R, C, H^dim) int64 flat index into the (batch_size, C, M^dim) grid of
    every cell of the tiles of rows [r0, r1): cell u of an axis is
    (origin + u) mod M, the periodic wrap."""
    dim, H, M = plan.dim, plan.H, plan.M
    u = torch.arange(H, dtype=torch.int64, device=plan.device)
    cells = torch.remainder(plan.origin[r0:r1].to(torch.int64)[:, :, None] + u, M)
    lin = cells[:, 0]
    for d in range(1, dim):
        lin = lin[..., None] * M + cells[:, d].reshape((r1 - r0,) + (1,) * d + (H,))
    ch = torch.arange(C, dtype=torch.int64, device=plan.device)
    base = (plan.row_batch[r0:r1].to(torch.int64)[:, None] * C + ch) * M**dim
    return base[:, :, None] + lin.reshape(r1 - r0, 1, H**dim)


def tiles_to_grid(plan: BinnedPlan, tiles: torch.Tensor) -> torch.Tensor:
    """Per-row tiles (S, C, H, H^{dim-1}) -> grid (batch_size, C, M^dim):
    each tile added onto the cells it covers (``index_add_``, chunked over
    rows to bound the index)."""
    C = tiles.shape[1]
    g = tiles.new_zeros((plan.batch_size, C) + (plan.M,) * plan.dim)
    flat, rows = g.view(-1), tiles.reshape(plan.S, -1)
    for r0, r1 in _cell_chunks(plan, C):
        flat.index_add_(0, _tile_cells(plan, r0, r1, C).reshape(-1),
                        rows[r0:r1].reshape(-1))
    return g


def grid_to_tiles(plan: BinnedPlan, g: torch.Tensor) -> torch.Tensor:
    """Grid (batch_size, C, M^dim) -> per-row tiles (S, C, H, H^{dim-1}):
    row s's tile read from the cells it covers (the transpose of
    :func:`tiles_to_grid`)."""
    C, H = g.shape[1], plan.H
    flat = g.contiguous().view(-1)
    out = g.new_empty((plan.S, C, H, H ** (plan.dim - 1)))
    rows = out.view(plan.S, -1)
    for r0, r1 in _cell_chunks(plan, C):
        rows[r0:r1] = flat[_tile_cells(plan, r0, r1, C).reshape(r1 - r0, -1)]
    return out


class _Mark(torch.autograd.Function):
    """Identity whose backward calls ``mark`` (a :class:`trace.Deferred`'s
    ``open`` or ``close``) as the gradient passes."""

    @staticmethod
    def forward(ctx, v, mark):
        ctx.mark = mark
        return v.view_as(v)

    @staticmethod
    def backward(ctx, g):
        ctx.mark()
        return g, None


def run_stages(stages: tuple, v):
    """Run (name, function) stages in order on v, each in a span of its
    name (:mod:`torch_nfft_tpu_torch.trace`). While the recorder is on and
    v requires grad, the autograd nodes of each stage's backward run
    inside spans ``backward`` > name as well: marks after the stage open
    them, marks before it close them."""
    for name, fn in stages:
        marks = None
        if trace.enabled() and torch.is_grad_enabled() and v.requires_grad:
            marks = trace.deferred(("backward", name))
            v = _Mark.apply(v, marks.close)
        with trace.span(name):
            v = fn(v)
        if marks is not None:
            v = _Mark.apply(v, marks.open)
    return v


@dataclass(frozen=True, eq=False)
class TileRoute:
    """How one call's values travel between its points and the grid, as
    named (name, function) stages for :func:`run_stages`.

    The permutation: user order (n, C) <-> the (C, S*K) slot layout
    (``into_slots``: ``slot_values``; ``out_of_slots``: ``unslot_values``),
    or, with ``slots``, values already in the slot layout, which only
    change shape. The tile ``space`` of the kernels and the movement
    between its tiles and the grid (``to_grid``, ``to_tiles``):

    * ``"dense"``: the dense tile array, row s spreading into tile
      :func:`dense_tile_ids` ``[s]`` and reading tile ``row_tile_ids[s]``,
      moved by the fold and unfold of ops/tilefold.py;
    * ``"flat"``: per-row tiles (``spread_tiles``, the identity tile
      index), moved by :func:`tiles_to_grid` and :func:`grid_to_tiles`;
    * ``"local"``: a caller's dense space of ``NT`` tiles, row s on tile
      ``tid[s]``, moved by the caller's ``fold`` and ``unfold`` (which
      record their own spans) or not at all.

    :func:`tile_route` picks a call's route; ``spread`` and ``gather`` run
    it as an autograd Function. Each tile index is formed in the stage
    that reads it."""

    plan: BinnedPlan
    space: str
    slots: bool = False
    tid: torch.Tensor | None = None
    NT: int = 0
    fold: Callable | None = None  # local: tiles -> grid
    unfold: Callable | None = None  # local: grid -> tiles

    @property
    def into_slots(self) -> tuple:
        plan = self.plan
        return () if self.slots else (
            ("slot_values", lambda x: slot_values(plan, x.to(torch.float32))),)

    @property
    def spread_kernel(self) -> tuple:
        plan = self.plan
        if self.space == "flat":
            return (("spread tiles kernel", lambda v: spread_tiles(plan, v)),)
        return (("spread kernel", lambda v: spread_tiles_dense(plan, v, *self._spread_ids())),)

    @property
    def to_grid(self) -> tuple:
        plan = self.plan
        if self.space == "dense":
            return (("fold", lambda tiles: fold_tiles_to_grid(tiles, plan)),)
        if self.space == "flat":
            return (("tiles to grid", lambda tiles: tiles_to_grid(plan, tiles)),)
        return ()

    @property
    def to_tiles(self) -> tuple:
        plan = self.plan
        if self.space == "dense":
            return (("unfold", lambda g: unfold_grid_to_tiles(g.to(torch.float32), plan)),)
        if self.space == "flat":
            return (("grid to tiles", lambda g: grid_to_tiles(plan, g.to(torch.float32))),)
        return ()

    @property
    def gather_kernel(self) -> tuple:
        return (("gather kernel",
                 lambda tiles: gather_points(self.plan, tiles, self.tile_index())),)

    @property
    def out_of_slots(self) -> tuple:
        plan = self.plan
        return () if self.slots else (
            ("unslot_values",  # (S, C, K) -> (S*K, C) -> user order
             lambda y: unslot_values(plan, y.transpose(1, 2).reshape(-1, y.shape[1]))),)

    @property
    def spreading(self) -> tuple:
        """The spread, x (n, C) -> grid (batch_size, C, M^dim), on a
        user-order dense or flat route."""
        return self.into_slots + self.spread_kernel + self.to_grid

    @property
    def gathering(self) -> tuple:
        """The gather, the transpose of :attr:`spreading`."""
        return self.to_tiles + self.gather_kernel + self.out_of_slots

    def _spread_ids(self) -> tuple:
        """(row tile ids, tile count) of the spread into dense tiles."""
        if self.space == "local":
            return self.tid, self.NT
        return dense_tile_ids(self.plan), self.plan.NT

    def tile_index(self) -> torch.Tensor:
        """(S,) int32 index of the tile that row s reads."""
        if self.space == "dense":
            return row_tile_ids(self.plan)
        if self.space == "flat":  # row s reads per-row tile s
            return torch.arange(self.plan.S, dtype=torch.int32, device=self.plan.device)
        return self.tid

    def values_in(self, x: torch.Tensor) -> torch.Tensor:
        """The values in the slot layout (C, S*K), contiguous."""
        return run_stages(self.into_slots, x).contiguous()

    def values_out(self, y: torch.Tensor) -> torch.Tensor:
        """The gather kernel's (S, C, K) -> the caller's order."""
        if self.slots:
            return y.transpose(0, 1).reshape(y.shape[1], -1)
        return run_stages(self.out_of_slots, y)

    def grid_from(self, tiles: torch.Tensor) -> torch.Tensor:
        if self.fold is not None:
            return self.fold(tiles)
        return run_stages(self.to_grid, tiles)

    def tiles_from(self, g: torch.Tensor) -> torch.Tensor:
        """The kernels' tiles, contiguous, of the grid (or local tiles) g."""
        if self.unfold is not None:
            return self.unfold(g)
        return run_stages(self.to_tiles, g).contiguous()

    def spread(self, x: torch.Tensor, pos: torch.Tensor | None = None) -> torch.Tensor:
        return _Spread.apply(self, x, pos)

    def gather(self, g: torch.Tensor, pos: torch.Tensor | None = None) -> torch.Tensor:
        return _Gather.apply(self, g, pos)


def tile_route(plan: BinnedPlan, C: int, *, slots: bool = False) -> TileRoute:
    """The route for C columns on ``plan``: the dense tile space unless its
    array exceeds the budget of :func:`tilefold.use_fold`, then flat."""
    dense = use_fold(plan, C, 4, plan.batch_size)
    return TileRoute(plan, "dense" if dense else "flat", slots=slots)


def _pos_cotangent(route: TileRoute, tiles, w_slot, pos) -> torch.Tensor:
    """(n, dim) position cotangent, on ``pos``'s device and in its dtype,
    from the route's tiles and the slot-ordered point weights."""
    plan, tile_index = route.plan, route.tile_index()
    with trace.span("pos_grad"):
        dp = pos_grad(plan, tiles, w_slot, tile_index)  # (S, dim, K)
    with trace.span("unslot_values"):
        dp = unslot_values(plan, dp.transpose(1, 2).reshape(-1, plan.dim))
    return dp.to(pos)


class _Spread(torch.autograd.Function):
    """Values, pos (n, dim) or None -> the route's grid. Backward: dx = the
    gather of g_bar, dpos = pos_grad(tiles of g_bar, w = x in slot order),
    the tiles read once for both."""

    @staticmethod
    def forward(ctx, route, x, pos):
        vals = route.values_in(x)
        ctx.route = route
        ctx.save_for_backward(vals if ctx.needs_input_grad[2] else None, pos)
        return route.grid_from(run_stages(route.spread_kernel, vals))

    @staticmethod
    @torch.autograd.function.once_differentiable
    @trace.spanned("backward")
    def backward(ctx, g_bar):
        route = ctx.route
        vals, pos = ctx.saved_tensors
        tiles = route.tiles_from(g_bar)
        dx = dpos = None
        if ctx.needs_input_grad[1]:
            dx = route.values_out(run_stages(route.gather_kernel, tiles))
        if ctx.needs_input_grad[2]:
            dpos = _pos_cotangent(route, tiles, vals, pos)
        return None, dx, dpos


class _Gather(torch.autograd.Function):
    """The route's grid, pos (n, dim) or None -> values: the transpose of
    :class:`_Spread`. Backward: dg = spread(y_bar), dpos = pos_grad(tiles
    of g, w = y_bar), y_bar put in slot order once for both."""

    @staticmethod
    def forward(ctx, route, g, pos):
        ctx.route = route
        ctx.save_for_backward(g if ctx.needs_input_grad[2] else None, pos)
        return route.values_out(run_stages(route.gather_kernel, route.tiles_from(g)))

    @staticmethod
    @torch.autograd.function.once_differentiable
    @trace.spanned("backward")
    def backward(ctx, y_bar):
        route = ctx.route
        g, pos = ctx.saved_tensors
        w_slot = route.values_in(y_bar)
        dg = dpos = None
        if ctx.needs_input_grad[1]:
            dg = route.grid_from(run_stages(route.spread_kernel, w_slot))
        if ctx.needs_input_grad[2]:
            dpos = _pos_cotangent(route, route.tiles_from(g), w_slot, pos)
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
    return tile_route(plan, x.shape[1]).spread(x, pos)


def _check_grid(plan: BinnedPlan, g: torch.Tensor) -> None:
    _check_values(plan, g, "the grid")
    if g.ndim != 2 + plan.dim or g.shape[0] != plan.batch_size or any(
            s != plan.M for s in g.shape[2:]):
        raise ValueError(f"the grid has shape {tuple(g.shape)}, the plan needs "
                         f"({plan.batch_size}, C) + {(plan.M,) * plan.dim}")


def gather_binned(plan: BinnedPlan, g: torch.Tensor,
                  pos: torch.Tensor | None = None) -> torch.Tensor:
    """Gather the grid (batch_size, C, M^dim) back to the points, (n, C):
    the transpose of :func:`spread_binned`, differentiable in g and, when
    given, in ``pos``."""
    _check_grid(plan, g)
    _check_pos(plan, pos)
    return tile_route(plan, g.shape[1]).gather(g, pos)


# Slot layout: the spread and gather without the user <-> slot permutation,
# for iterated matvecs on one point set (the JAX package's
# ``spread_binned_dft_slot`` / ``gather_binned_dft_slot``). The slot vector
# is the same (C, S*K) on the dense and the flat route.


def spread_binned_slot(plan: BinnedPlan, v: torch.Tensor) -> torch.Tensor:
    """:func:`spread_binned` of a (C, S*K) slot-layout vector
    (:func:`to_slot_order`): the grid (batch_size, C, M^dim), with no
    permutation. Differentiable in ``v`` only (the positions live in the
    plan)."""
    _check_values(plan, v, "v")
    if v.ndim != 2 or v.shape[1] != plan.S * plan.K:
        raise ValueError(f"v has shape {tuple(v.shape)}, the plan's slot vectors "
                         f"are (C, {plan.S * plan.K})")
    return tile_route(plan, v.shape[0], slots=True).spread(v.to(torch.float32))


def gather_binned_slot(plan: BinnedPlan, g: torch.Tensor) -> torch.Tensor:
    """:func:`gather_binned` returning the (C, S*K) slot-layout vector, with
    no permutation (the transpose of :func:`spread_binned_slot`).
    Differentiable in ``g`` only."""
    _check_grid(plan, g)
    return tile_route(plan, g.shape[1], slots=True).gather(g.to(torch.float32))


# Local tile spaces for the grid-sharded transforms (parallel/grid_sharded.py,
# the JAX package's ``dense_tiles_local``/``points_from_tiles_local``): the
# dense-route kernels with the caller's row tile ids and tile count, on a
# local route with no tile movement.


def dense_tiles_local(NT: int, plan: BinnedPlan, x: torch.Tensor, pos, tid: torch.Tensor):
    """x (n, C) -> dense tiles (NT, C, H, H^{dim-1}) of a local tile space:
    row s accumulates into tile ``tid[s]`` (each tile's rows one run, B1's
    precondition). Differentiable in x (B2) and, when ``pos`` (n, dim)
    requires grad, in the positions (B5)."""
    check_points(plan, x)
    _check_pos(plan, pos)
    return TileRoute(plan, "local", tid=tid, NT=NT).spread(x, pos)


def points_from_tiles_local(NT: int, plan: BinnedPlan, tiles: torch.Tensor, pos,
                            tid: torch.Tensor):
    """Dense tiles (NT, C, H, H^{dim-1}) of a local tile space -> (n, C) in
    user order, row s reading tile ``tid[s]``: the transpose of
    :func:`dense_tiles_local`. Differentiable in the tiles (B1) and, when
    ``pos`` requires grad, in the positions (B5)."""
    _check_values(plan, tiles, "tiles")
    _check_pos(plan, pos)
    return TileRoute(plan, "local", tid=tid, NT=NT).gather(tiles, pos)
