"""The spread and gather window contractions: CUDA kernels and their plain
PyTorch versions.

For a plan row s of at most K points over one tile (origin o_s, halo edge
H = T + 2m + 1) and window matrices A_d[u, k] = phi(M*x_kd - o_sd - u)
restricted to each point's 2m+2 window cells:

    spread:  tile[u, v, w] += sum_k x[k] A_0[u, k] A_1[v, k] A_2[w, k]
    gather:  y[k] = sum_{u,v,w} A_0[u, k] A_1[v, k] A_2[w, k] tile[u, v, w]

``spread_tiles_dense`` replaces the JAX package's TPU kernel
``ops/pallas/contract.py:spread_tiles_dense_pallas`` (and
its row-batched twin ``spread_tiles_rb_pallas``, which computes the same
function); ``gather_points`` replaces ``gather_points_pallas`` (and
``gather_points_rb_pallas``). The kernels are in ``csrc/contract.cu``; the
design and the bound on the H100 are in the note there.

Each wrapper launches its kernel for CUDA tensors, or raises; it takes the
plain version only for CPU tensors. ``launches`` on each wrapper counts the
kernel launches.
"""

from __future__ import annotations

import torch

from .._build import check, library
from .window import window_params, window_value_fn

__all__ = [
    "spread_tiles_dense",
    "gather_points",
    "spread_tiles_dense_plain",
    "gather_points_plain",
]

_MAX_L = 20  # window cells per axis the kernels hold: 2m + 2 <= 20


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


def _chunk_inputs(plan, r0: int, r1: int):
    K, dim = plan.K, plan.dim
    pd = plan.slot_pos[:, r0 * K: r1 * K].reshape(dim, r1 - r0, K)
    A = _row_windows(pd.permute(1, 2, 0), plan.origin[r0:r1], plan.M,
                     plan.m, plan.H, window_value_fn(plan.m, plan.sigma, plan.window))
    kmask = torch.arange(K, device=pd.device)[None, :] < plan.row_count[r0:r1, None]
    return A, kmask


def spread_tiles_dense_plain(plan, vals: torch.Tensor, tile_index: torch.Tensor,
                             NT: int) -> torch.Tensor:
    """Plain version of :func:`spread_tiles_dense`, chunked over rows."""
    S, K = plan.slot_pt.shape
    dim, H = plan.dim, plan.H
    C = vals.shape[0]
    out = torch.zeros((NT, C * H**dim), dtype=torch.float32, device=vals.device)
    for r0, r1 in _row_chunks(S, K, H, dim, C):
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
        out.index_add_(0, tile_index[r0:r1].to(torch.int64),
                       tiles.reshape(r1 - r0, C * H**dim))
    return out.reshape(NT, C, H, H ** (dim - 1))


def gather_points_plain(plan, tiles: torch.Tensor,
                        tile_index: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gather_points`, chunked over rows."""
    S, K = plan.slot_pt.shape
    dim, H = plan.dim, plan.H
    C = tiles.shape[1]
    y = torch.empty((S, C, K), dtype=torch.float32, device=tiles.device)
    for r0, r1 in _row_chunks(S, K, H, dim, C):
        A, kmask = _chunk_inputs(plan, r0, r1)
        tl = tiles[tile_index[r0:r1].to(torch.int64)]
        tl = tl.reshape((r1 - r0, C) + (H,) * dim)
        if dim == 1:
            yk = torch.einsum("rku,rcu->rkc", A[:, :, 0], tl)
        elif dim == 2:
            t1 = torch.einsum("rku,rcuv->rkcv", A[:, :, 0], tl)
            yk = torch.einsum("rkv,rkcv->rkc", A[:, :, 1], t1)
        else:
            t1 = torch.einsum("rku,rcuvw->rkcvw", A[:, :, 0], tl)
            t2 = torch.einsum("rkv,rkcvw->rkcw", A[:, :, 1], t1)
            yk = torch.einsum("rkw,rkcw->rkc", A[:, :, 2], t2)
        y[r0:r1] = (yk * kmask[..., None]).permute(0, 2, 1)
    return y


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_plan_tensors(plan, t: torch.Tensor, tile_index: torch.Tensor) -> None:
    S = plan.slot_pt.shape[0]
    for name, a in (("slot_pos", plan.slot_pos), ("row_count", plan.row_count),
                    ("origin", plan.origin), ("tile_index", tile_index)):
        _require(a.device == t.device, f"{name} is on {a.device}, data on {t.device}")
        _require(a.is_contiguous(), f"{name} must be contiguous")
    _require(plan.slot_pos.dtype == torch.float32, "slot_pos must be float32")
    for name, a in (("row_count", plan.row_count), ("origin", plan.origin),
                    ("tile_index", tile_index)):
        _require(a.dtype == torch.int32, f"{name} must be int32")
    _require(tuple(tile_index.shape) == (S,), f"tile_index must be ({S},)")
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


def _kernel_args(plan, t: torch.Tensor):
    kind, p0, p1, p2 = window_params(plan.m, plan.sigma, plan.window)
    return (plan.dim, plan.H, plan.M, plan.m, kind, p0, p1, p2,
            t.device.index or 0, torch.cuda.current_stream(t.device).cuda_stream)


def spread_tiles_dense(plan, vals: torch.Tensor, tile_index: torch.Tensor,
                       NT: int) -> torch.Tensor:
    """Slot-ordered values (C, S*K) -> dense tiles (NT, C, H, H^{dim-1}).

    Rows of one tile accumulate into it; tiles no row visits are exactly 0.
    ``tile_index`` (S,) int32 gives each row's dense tile; each tile's rows
    must be consecutive (plan order, with empty rows pointed at the
    preceding tile)."""
    S, K = plan.slot_pt.shape
    C = vals.shape[0]
    _check_plan_tensors(plan, vals, tile_index)
    _require(vals.dtype == torch.float32 and vals.is_contiguous(),
             "vals must be contiguous float32")
    _require(tuple(vals.shape) == (C, S * K), f"vals must be (C, {S * K})")
    if not _route(vals):
        return spread_tiles_dense_plain(plan, vals, tile_index, NT)
    H, dim = plan.H, plan.dim
    out = torch.zeros((NT, C, H, H ** (dim - 1)), dtype=torch.float32,
                      device=vals.device)
    check(library().tnt_spread_tiles_dense(
        vals.data_ptr(), plan.slot_pos.data_ptr(), plan.row_count.data_ptr(),
        plan.origin.data_ptr(), tile_index.data_ptr(), out.data_ptr(),
        S, K, C, NT, *_kernel_args(plan, vals)))
    spread_tiles_dense.launches += 1
    return out


spread_tiles_dense.launches = 0


def gather_points(plan, tiles: torch.Tensor, tile_index: torch.Tensor) -> torch.Tensor:
    """Dense tiles (NT, C, H, H^{dim-1}) -> slot values (S, C, K); row s
    reads tile ``tile_index[s]``, empty slots are 0."""
    S, K = plan.slot_pt.shape
    H, dim = plan.H, plan.dim
    _check_plan_tensors(plan, tiles, tile_index)
    _require(tiles.dtype == torch.float32 and tiles.is_contiguous(),
             "tiles must be contiguous float32")
    _require(tiles.ndim == 4 and tuple(tiles.shape[2:]) == (H, H ** (dim - 1)),
             f"tiles must be (NT, C, {H}, {H ** (dim - 1)})")
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
