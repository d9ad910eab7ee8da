"""The spread and gather window contractions: CUDA kernels and their plain
PyTorch versions.

For a plan row s of at most K points over one tile (origin o_s, halo edge
H = T + 2m + 1) and window matrices A_d[u, k] = phi(M*x_kd - o_sd - u)
restricted to each point's 2m+2 window cells:

    spread:  tile[u, v, w] += sum_k x[k] A_0[u, k] A_1[v, k] A_2[w, k]
    gather:  y[k] = sum_{u,v,w} A_0[u, k] A_1[v, k] A_2[w, k] tile[u, v, w]
    pos_grad: dpos[d, k] = sum_c w[c, k] sum_{u,v,w} tile[c, u, v, w]
              * D_d[., k] prod_{e != d} A_e[., k]

with D_d = M * phi'(t) the derivative windows (d t / d pos = M; the floor
in t is piecewise constant). ``pos_grad`` is the position cotangent of
both the spread (tiles of the grid cotangent, w the values) and the gather
(tiles of the primal grid, w the point cotangent).

``spread_tiles`` replaces ``ops/pallas/contract.py:spread_tiles_pallas``:
the same spread into each row's own tile, (S, C, H, H^{dim-1}), the tiles
of the flat-grid route (ops/binned.py). ``spread_tiles_dense`` replaces the
JAX package's TPU kernel
``ops/pallas/contract.py:spread_tiles_dense_pallas`` (and
its row-batched twin ``spread_tiles_rb_pallas``, which computes the same
function); ``gather_points`` replaces ``gather_points_pallas`` (and
``gather_points_rb_pallas``); ``pos_grad`` replaces ``pos_grad_pallas``.
The kernels are in ``csrc/contract.cu``; the design and the bound on the
H100 are in the note there.

The two spreads have two designs, chosen per call by :func:`spread_design`
from the tile's geometry and the columns: the register-tiled contraction
(``"contraction"``, no atomics, bitwise reproducible), which does
H^dim / L^dim times the sparse work, and, where that ratio exceeds
``DENSE_RATIO_MAX``'s limit for C, the sparse kernel with shared-memory
atomics (``"wide"``).

Each wrapper launches its kernel for CUDA tensors, or raises; it takes the
plain version only for CPU tensors. ``launches`` on each wrapper counts the
kernel launches; the spreads also count them per design in
``launches_by_design``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from .._build import check, library
from .window import (
    window_deriv_param,
    window_params,
    window_value_and_deriv_fn,
    window_value_fn,
)

__all__ = [
    "SpreadDesign",
    "spread_design",
    "spread_tiles",
    "spread_tiles_dense",
    "gather_points",
    "pos_grad",
    "spread_tiles_plain",
    "spread_tiles_dense_plain",
    "gather_points_plain",
    "pos_grad_plain",
]

_MAX_L = 20  # window cells per axis the kernels hold: 2m + 2 <= 20

# The spread's contraction design runs while a tile's cells over a point's
# window cells, (H / L)^dim, stay at or under DENSE_RATIO_MAX[c], c the
# largest key at or under the columns C; wider tiles take the wide-tile
# design. The wide design slows per column as C grows (its tile, C H^dim
# floats, fills shared memory, then spills to global atomics) and the
# contraction does not, so the limit grows with C. chip_smoke.py phase 6b
# times both designs on the headline points binned at T = 8-24 (ratios
# 10.2-112.9) at C = 1, 2, 4, 8: at C <= 2 the contraction is faster up to
# 15.6 and not from 22.7; at C = 4 and 8 at every ratio measured.
DENSE_RATIO_MAX = {1: 16.0, 4: 113.0}
# Default bands of the contraction: at most BAND_THREADS threads, and 16
# points a chunk for a band of at most 16 rows (C = 1 at the headline),
# else 32, halved while a block needs more than SMEM_TARGET bytes.
BAND_THREADS, SMEM_TARGET = 256, 100 * 1024
# csrc/contract.cu:spread_contract_kernel holds TM x TN outputs a thread
# (its kTM, kTN; the launch refuses others) in blocks of at most
# MAX_THREADS threads (its __launch_bounds__) and SMEM_MAX bytes of shared
# memory (the H100's opt-in limit per block). The rest of its launch is
# laid out here, in SpreadDesign, and passed to it whole.
TM, TN, MAX_THREADS, SMEM_MAX = 8, 8, 512, 232448


@dataclass(frozen=True)
class SpreadDesign:
    """How a spread of ``C`` columns into tiles of edge ``H`` runs: ``name``
    is ``"contraction"`` or ``"wide"``, ``ratio`` is (H / L)^dim. For the
    contraction, the launch of csrc/contract.cu:spread_contract_kernel:
    bands of ``R`` rows and ``PB`` columns of the tile matrix OUT (C*H rows,
    H^{dim-1} columns), ``row_bands`` x ``col_bands`` blocks per plan row of
    ``threads`` threads, each holding TM x TN outputs of a grid of ``RG`` x
    ``CG`` thread tiles; ``KC`` points a chunk, the rows of a band touching
    at most ``NCH`` columns C; two chunk buffers of ``buf`` floats and
    ``smem`` bytes of shared memory a block."""

    name: str
    dim: int
    H: int
    C: int
    ratio: float
    R: int = 0
    PB: int = 0
    KC: int = 0
    RG: int = 0
    CG: int = 0
    row_bands: int = 0
    col_bands: int = 0
    NCH: int = 0
    buf: int = 0
    threads: int = 0
    smem: int = 0

    @property
    def issued_macs(self) -> int:
        """Multiply-adds the contraction issues per point: every row and
        column of its bands' thread tiles, zero padding included."""
        return self.row_bands * self.RG * TM * self.col_bands * self.CG * TN

    def layout(self) -> tuple:
        """The contraction's launch as csrc/contract.cu:launch_spread_contract
        reads it."""
        return (TM, TN, self.R, self.PB, self.KC, self.RG, self.CG, self.row_bands,
                self.col_bands, self.NCH, self.buf, self.threads, self.smem)


def _contract_band(dim: int, H: int, C: int, R: int, PB: int, KC: int) -> dict:
    """Thread grid and shared memory of a contraction block. The kernel's
    shared memory: the band's row and column tables (2 (Rpad + Ppad) ints),
    then two chunk buffers of KC points, each [KC][Rpad] X, [KC][Ppad] KR,
    [KC][dim H + 2] windows, [dim][KC] coordinates and [NCH][KC] values,
    rounded up to 16 bytes; the band on its way out (R PB floats, shifted
    by up to 3 for 16-byte stores) reuses it."""
    rows = C * H
    RG, CG = -(-R // TM), -(-PB // TN)
    Rpad, Ppad = RG * TM, CG * TN
    NCH = max((min(r0 + R, rows) - 1) // H - r0 // H + 1 for r0 in range(0, rows, R))
    buf = -(-KC * (Rpad + Ppad + dim * H + 2 + dim + NCH) // 4) * 4
    return {"RG": RG, "CG": CG, "NCH": NCH, "buf": buf,
            "threads": -(-RG * CG // 32) * 32,
            "smem": 4 * max(2 * (Rpad + Ppad) + 2 * buf, R * PB + 4)}


def spread_design(dim: int, H: int, m: int, C: int, *, name: str | None = None,
                  KC: int | None = None, R: int | None = None) -> SpreadDesign:
    """The spread design for tiles of edge ``H`` and windows of 2m+2 cells
    per axis at ``C`` columns: the contraction while (H / L)^dim is at most
    the ``DENSE_RATIO_MAX`` entry for C, else the wide-tile design; ``name``
    forces one. ``KC`` and ``R`` fix the contraction's points per chunk and
    rows per band (None: the defaults above); results do not depend on
    them."""
    L = 2 * m + 2
    ratio = (H / L) ** dim
    if name is None:
        limit = DENSE_RATIO_MAX[max(c for c in DENSE_RATIO_MAX if c <= C)]
        name = "contraction" if ratio <= limit else "wide"
    _require(name in ("contraction", "wide"), f"unknown spread design {name!r}")
    if name == "wide":
        return SpreadDesign("wide", dim, H, C, ratio)
    P, rows = H ** (dim - 1), C * H
    col_bands = -(-P // (TN * MAX_THREADS))
    CG = -(-P // (TN * col_bands))
    PB = min(P, CG * TN)
    col_bands = -(-P // PB)
    if R is None:
        rg_all = -(-rows // TM)
        row_bands = -(-rg_all // max(1, min(BAND_THREADS, MAX_THREADS) // CG))
        R = min(rows, -(-rg_all // row_bands) * TM)
    _require(1 <= R <= rows, f"R must be in [1, {rows}]")
    band = _contract_band(dim, H, C, R, PB, 1)
    _require(band["threads"] <= MAX_THREADS, f"R={R} needs {band['threads']} threads a block")
    if KC is None:
        KC = 16 if R <= 16 else 32
        while KC > 1 and _contract_band(dim, H, C, R, PB, KC)["smem"] > SMEM_TARGET:
            KC //= 2
    _require(KC >= 1, "KC must be at least 1")
    band = _contract_band(dim, H, C, R, PB, KC)
    _require(band["smem"] <= SMEM_MAX,
             f"KC={KC}, R={R} need {band['smem']} bytes of shared memory")
    return SpreadDesign("contraction", dim, H, C, ratio, R, PB, KC,
                        row_bands=-(-rows // R), col_bands=col_bands, **band)


def _row_windows(pos_rows, origin, M: int, m: int, H: int, phi):
    """Window matrices (R, K, dim, H): A[r, k, d, u] = phi(t) with
    t = frac + m - (u - o), o the point's window start relative to its row's
    tile origin, and 0 outside the point's 2m+2 cells. ``pos_rows`` is
    (R, K, dim) float32, ``origin`` (R, dim) int32."""
    L = 2 * m + 2
    scaled = pos_rows * M
    floor_s = torch.floor(scaled)
    frac = scaled - floor_s
    s_mod = torch.remainder(floor_s.to(torch.int32) - m, M)
    o = torch.remainder(s_mod - origin[:, None, :], M)
    u = torch.arange(H, dtype=torch.int32, device=pos_rows.device)
    rel = u - o[..., None]
    t = frac[..., None] + (m - rel).to(frac.dtype)
    return torch.where((rel >= 0) & (rel < L), phi(t), 0.0)


def _row_chunks(S: int, K: int, H: int, dim: int, C: int):
    """Row ranges whose largest intermediate, (R, K, C, H^{dim-1}) or
    (R, C, H^dim) float32, stays under ~256 MB."""
    inner = max(K * C * H ** max(1, dim - 1), C * H**dim) * 4
    R = max(1, min(S, (256 << 20) // inner))
    return [(r0, min(S, r0 + R)) for r0 in range(0, S, R)]


def _chunk_inputs(plan, r0: int, r1: int, phi=None):
    """Windows of rows [r0, r1) (from ``phi``, the window values by
    default) and the mask of their filled slots, (R, K)."""
    K, dim = plan.K, plan.dim
    if phi is None:
        phi = window_value_fn(plan.m, plan.sigma, plan.window)
    pd = plan.slot_pos[:, r0 * K: r1 * K].reshape(dim, r1 - r0, K)
    A = _row_windows(pd.permute(1, 2, 0), plan.origin[r0:r1], plan.M,
                     plan.m, plan.H, phi)
    kmask = torch.arange(K, device=pd.device)[None, :] < plan.row_count[r0:r1, None]
    return A, kmask


def _row_tiles(plan, tiles, tile_index, r0: int, r1: int):
    """The tiles rows [r0, r1) read, (R, C, H, ..., H)."""
    tl = tiles[tile_index[r0:r1].to(torch.int64)]
    return tl.reshape((r1 - r0, tiles.shape[1]) + (plan.H,) * plan.dim)


def _contract_rows(W, tl, dim: int):
    """(R, K, C): each point's sum over its row's tile ``tl`` (R, C, H^dim)
    weighted by prod_d W[:, :, d] (W is (R, K, dim, H))."""
    if dim == 1:
        return torch.einsum("rku,rcu->rkc", W[:, :, 0], tl)
    if dim == 2:
        t1 = torch.einsum("rku,rcuv->rkcv", W[:, :, 0], tl)
        return torch.einsum("rkv,rkcv->rkc", W[:, :, 1], t1)
    t1 = torch.einsum("rku,rcuvw->rkcvw", W[:, :, 0], tl)
    t2 = torch.einsum("rkv,rkcvw->rkcw", W[:, :, 1], t1)
    return torch.einsum("rkw,rkcw->rkc", W[:, :, 2], t2)


def _spread_rows(plan, vals: torch.Tensor, r0: int, r1: int) -> torch.Tensor:
    """Tiles of rows [r0, r1), (R, C * H^dim): each row's points spread into
    its own tile."""
    K, dim, H = plan.K, plan.dim, plan.H
    C = vals.shape[0]
    A, kmask = _chunk_inputs(plan, r0, r1)
    xs = vals[:, r0 * K: r1 * K].reshape(C, r1 - r0, K).permute(1, 2, 0)
    xs = xs * kmask[..., None]  # (R, K, C)
    if dim == 1:
        tiles = torch.einsum("rku,rkc->rcu", A[:, :, 0], xs)
    elif dim == 2:
        t1 = torch.einsum("rkv,rkc->rkcv", A[:, :, 1], xs)
        tiles = torch.einsum("rku,rkcv->rcuv", A[:, :, 0], t1)
    else:
        t1 = torch.einsum("rkw,rkc->rkcw", A[:, :, 2], xs)
        t2 = torch.einsum("rkv,rkcw->rkcvw", A[:, :, 1], t1)
        tiles = torch.einsum("rku,rkcvw->rcuvw", A[:, :, 0], t2)
    return tiles.reshape(r1 - r0, C * H**dim)


def spread_tiles_dense_plain(plan, vals: torch.Tensor, tile_index: torch.Tensor,
                             NT: int) -> torch.Tensor:
    """Plain version of :func:`spread_tiles_dense`, chunked over rows."""
    S, K = plan.slot_pt.shape
    dim, H = plan.dim, plan.H
    C = vals.shape[0]
    out = torch.zeros((NT, C * H**dim), dtype=torch.float32, device=vals.device)
    for r0, r1 in _row_chunks(S, K, H, dim, C):
        out.index_add_(0, tile_index[r0:r1].to(torch.int64),
                       _spread_rows(plan, vals, r0, r1))
    return out.reshape(NT, C, H, H ** (dim - 1))


def spread_tiles_plain(plan, vals: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`spread_tiles`, chunked over rows."""
    S, K = plan.slot_pt.shape
    dim, H = plan.dim, plan.H
    C = vals.shape[0]
    out = torch.empty((S, C * H**dim), dtype=torch.float32, device=vals.device)
    for r0, r1 in _row_chunks(S, K, H, dim, C):
        out[r0:r1] = _spread_rows(plan, vals, r0, r1)
    return out.reshape(S, C, H, H ** (dim - 1))


def gather_points_plain(plan, tiles: torch.Tensor,
                        tile_index: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gather_points`, chunked over rows."""
    S, K = plan.slot_pt.shape
    dim, H = plan.dim, plan.H
    C = tiles.shape[1]
    y = torch.empty((S, C, K), dtype=torch.float32, device=tiles.device)
    for r0, r1 in _row_chunks(S, K, H, dim, C):
        A, kmask = _chunk_inputs(plan, r0, r1)
        yk = _contract_rows(A, _row_tiles(plan, tiles, tile_index, r0, r1), dim)
        y[r0:r1] = (yk * kmask[..., None]).permute(0, 2, 1)
    return y


def pos_grad_plain(plan, tiles: torch.Tensor, w_slot: torch.Tensor,
                   tile_index: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`pos_grad`, chunked over rows: per axis d, a
    gather with the derivative window on axis d, weighted by w and summed
    over the channels."""
    S, K = plan.slot_pt.shape
    dim, H = plan.dim, plan.H
    C = tiles.shape[1]
    pair = window_value_and_deriv_fn(plan.m, plan.sigma, plan.window, M=plan.M)
    out = torch.empty((S, dim, K), dtype=torch.float32, device=tiles.device)
    for r0, r1 in _row_chunks(S, K, H, dim, C):
        A, kmask = _chunk_inputs(plan, r0, r1)
        D, _ = _chunk_inputs(plan, r0, r1, lambda t: pair(t)[1])
        tl = _row_tiles(plan, tiles, tile_index, r0, r1)
        ws = w_slot[:, r0 * K: r1 * K].reshape(C, r1 - r0, K).permute(1, 2, 0)
        ws = ws * kmask[..., None]  # (R, K, C)
        for d in range(dim):
            W = torch.cat([A[:, :, :d], D[:, :, d:d + 1], A[:, :, d + 1:]], dim=2)
            out[r0:r1, d] = (_contract_rows(W, tl, dim) * ws).sum(-1)
    return out


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_plan_tensors(plan, t: torch.Tensor, tile_index: torch.Tensor | None) -> None:
    S = plan.slot_pt.shape[0]
    ints = (("row_count", plan.row_count), ("origin", plan.origin))
    if tile_index is not None:
        ints += (("tile_index", tile_index),)
        _require(tuple(tile_index.shape) == (S,), f"tile_index must be ({S},)")
    for name, a in (("slot_pos", plan.slot_pos),) + ints:
        _require(a.device == t.device, f"{name} is on {a.device}, data on {t.device}")
        _require(a.is_contiguous(), f"{name} must be contiguous")
    _require(plan.slot_pos.dtype == torch.float32, "slot_pos must be float32")
    for name, a in ints:
        _require(a.dtype == torch.int32, f"{name} must be int32")
    _require(tuple(plan.slot_pos.shape) == (plan.dim, S * plan.K),
             "slot_pos must be (dim, S*K)")
    _require(1 <= plan.dim <= 3, "the kernels take dim 1, 2 or 3")
    _require(2 * plan.m + 2 <= _MAX_L, f"the kernels take 2m+2 <= {_MAX_L}")


def _route(t: torch.Tensor) -> bool:
    """True to launch the CUDA kernel, False for the plain version."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _check_tiles(plan, tiles: torch.Tensor, tile_index: torch.Tensor) -> None:
    H, dim = plan.H, plan.dim
    _check_plan_tensors(plan, tiles, tile_index)
    _require(tiles.dtype == torch.float32 and tiles.is_contiguous(),
             "tiles must be contiguous float32")
    _require(tiles.ndim == 4 and tuple(tiles.shape[2:]) == (H, H ** (dim - 1)),
             f"tiles must be (NT, C, {H}, {H ** (dim - 1)})")


def _kernel_args(plan, t: torch.Tensor):
    kind, p0, p1, p2 = window_params(plan.m, plan.sigma, plan.window)
    return (plan.dim, plan.H, plan.M, plan.m, kind, p0, p1, p2,
            t.device.index or 0, torch.cuda.current_stream(t.device).cuda_stream)


def _check_vals(plan, vals: torch.Tensor, tile_index: torch.Tensor | None) -> None:
    S, K = plan.slot_pt.shape
    _check_plan_tensors(plan, vals, tile_index)
    _require(vals.dtype == torch.float32 and vals.is_contiguous(),
             "vals must be contiguous float32")
    _require(vals.ndim == 2 and vals.shape[1] == S * K,
             f"vals must be (C, {S * K})")


def _design_for(plan, C: int, design: SpreadDesign | None) -> SpreadDesign:
    if design is None:
        return spread_design(plan.dim, plan.H, plan.m, C)
    _require((design.dim, design.H, design.C) == (plan.dim, plan.H, C),
             f"the design is for dim={design.dim}, H={design.H}, C={design.C}")
    return design


def _layout(d: SpreadDesign):
    """The contraction's launch as a C int array (keep it alive for the call)."""
    return (ctypes.c_int * len(d.layout()))(*d.layout())


def spread_tiles(plan, vals: torch.Tensor, design: SpreadDesign | None = None) -> torch.Tensor:
    """Slot-ordered values (C, S*K) -> per-row tiles (S, C, H, H^{dim-1}):
    row s's points spread into its own tile (tile origin ``origin[s]``);
    rows with no points give exact zeros. ``design`` (from
    :func:`spread_design` for this geometry) overrides the default."""
    S, K = plan.slot_pt.shape
    C = vals.shape[0]
    _check_vals(plan, vals, None)
    d = _design_for(plan, C, design)
    if not _route(vals):
        return spread_tiles_plain(plan, vals)
    dim, H, M, m, kind, p0, p1, p2, device, stream = _kernel_args(plan, vals)
    out = torch.empty((S, C, H, H ** (dim - 1)), dtype=torch.float32,
                      device=vals.device)
    args = (vals.data_ptr(), plan.slot_pos.data_ptr(), plan.row_count.data_ptr(),
            plan.origin.data_ptr(), out.data_ptr(), S, K, C, dim, H, M, m, kind,
            p0, p1, p2)
    if d.name == "contraction":
        layout = _layout(d)
        check(library().tnt_spread_tiles_contract(*args, ctypes.addressof(layout), device,
                                                  stream))
    else:
        check(library().tnt_spread_tiles(*args, device, stream))
    spread_tiles.launches += 1
    spread_tiles.launches_by_design[d.name] += 1
    return out


spread_tiles.launches = 0
spread_tiles.launches_by_design = {"contraction": 0, "wide": 0}


def spread_tiles_dense(plan, vals: torch.Tensor, tile_index: torch.Tensor,
                       NT: int, design: SpreadDesign | None = None) -> torch.Tensor:
    """Slot-ordered values (C, S*K) -> dense tiles (NT, C, H, H^{dim-1}).

    Rows of one tile accumulate into it; tiles no row visits are exactly 0.
    ``tile_index`` (S,) int32 gives each row's dense tile; each tile's rows
    must be consecutive (plan order, with empty rows pointed at the
    preceding tile). ``design`` as in :func:`spread_tiles`."""
    S, K = plan.slot_pt.shape
    C = vals.shape[0]
    _check_vals(plan, vals, tile_index)
    d = _design_for(plan, C, design)
    if not _route(vals):
        return spread_tiles_dense_plain(plan, vals, tile_index, NT)
    H, dim = plan.H, plan.dim
    out = torch.zeros((NT, C, H, H ** (dim - 1)), dtype=torch.float32,
                      device=vals.device)
    *window, device, stream = _kernel_args(plan, vals)
    args = (vals.data_ptr(), plan.slot_pos.data_ptr(), plan.row_count.data_ptr(),
            plan.origin.data_ptr(), tile_index.data_ptr(), out.data_ptr(),
            S, K, C, NT, *window)
    if d.name == "contraction":
        layout = _layout(d)
        check(library().tnt_spread_tiles_dense_contract(*args, ctypes.addressof(layout),
                                                         device, stream))
    else:
        check(library().tnt_spread_tiles_dense(*args, device, stream))
    spread_tiles_dense.launches += 1
    spread_tiles_dense.launches_by_design[d.name] += 1
    return out


spread_tiles_dense.launches = 0
spread_tiles_dense.launches_by_design = {"contraction": 0, "wide": 0}


def gather_points(plan, tiles: torch.Tensor, tile_index: torch.Tensor) -> torch.Tensor:
    """Dense tiles (NT, C, H, H^{dim-1}) -> slot values (S, C, K); row s
    reads tile ``tile_index[s]``, empty slots are 0."""
    S, K = plan.slot_pt.shape
    _check_tiles(plan, tiles, tile_index)
    NT, C = tiles.shape[:2]
    if not _route(tiles):
        return gather_points_plain(plan, tiles, tile_index)
    y = torch.empty((S, C, K), dtype=torch.float32, device=tiles.device)
    check(library().tnt_gather_points(
        tiles.data_ptr(), plan.slot_pos.data_ptr(), plan.row_count.data_ptr(),
        plan.origin.data_ptr(), tile_index.data_ptr(), y.data_ptr(),
        S, K, C, NT, *_kernel_args(plan, tiles)))
    gather_points.launches += 1
    return y


gather_points.launches = 0


def pos_grad(plan, tiles: torch.Tensor, w_slot: torch.Tensor,
             tile_index: torch.Tensor) -> torch.Tensor:
    """Dense tiles (NT, C, H, H^{dim-1}) and slot-ordered weights (C, S*K)
    -> slot-ordered position cotangent (S, dim, K); row s reads tile
    ``tile_index[s]``, empty slots are 0."""
    S, K = plan.slot_pt.shape
    _check_tiles(plan, tiles, tile_index)
    NT, C = tiles.shape[:2]
    _require(w_slot.device == tiles.device, f"w_slot is on {w_slot.device}, "
             f"tiles on {tiles.device}")
    _require(w_slot.dtype == torch.float32 and w_slot.is_contiguous(),
             "w_slot must be contiguous float32")
    _require(tuple(w_slot.shape) == (C, S * K), f"w_slot must be ({C}, {S * K})")
    if not _route(tiles):
        return pos_grad_plain(plan, tiles, w_slot, tile_index)
    out = torch.empty((S, plan.dim, K), dtype=torch.float32, device=tiles.device)
    dim, H, M, m, kind, p0, p1, p2, device, stream = _kernel_args(plan, tiles)
    check(library().tnt_pos_grad(
        tiles.data_ptr(), w_slot.data_ptr(), plan.slot_pos.data_ptr(),
        plan.row_count.data_ptr(), plan.origin.data_ptr(), tile_index.data_ptr(),
        out.data_ptr(), S, K, C, NT, dim, H, M, m, kind, p0, p1, p2,
        window_deriv_param(plan.m, plan.sigma, plan.window, M=plan.M),
        device, stream))
    pos_grad.launches += 1
    return out


pos_grad.launches = 0
