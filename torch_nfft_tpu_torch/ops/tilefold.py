"""Dense-tile overlap-add between the halo tiles and the oversampled grid.

Counterpart of ``fold_tiles_to_grid``, ``unfold_grid_to_tiles``,
``row_tile_ids``, ``use_fold`` and ``tile_array_bytes`` of the JAX package's
``ops/tilefold.py``. The JAX fold needs M % T == 0 and H - T <= T and
sends other grids to its windowed XLA engines; this fold takes any M and
T, so the port runs those grids on the dense route too. The memory rule
``use_fold`` decides between this dense route and the flat-grid route of
``ops/binned.py`` (per-row tiles moved onto the grid cell by cell), which
is the counterpart of the JAX package's flat Pallas route and its windowed
fallback. Tile b of an axis covers cells [b*T, b*T + H) mod M,
H = T + 2m + 1, with nb = ceil(M/T) tiles per axis. Folding an axis adds
the tiles onto an extended axis of (nb + J - 1)*T cells in J = ceil(H/T)
tile-wide strided passes, then wraps the cells beyond M back onto the
start: the periodic boundary of the NFFT grid. Unfolding reads the same
cells from the periodically extended grid.

Layouts: the dense tiles are (NT, C, H, H^{dim-1}) with NT = batch_size *
nb^dim, tile contents row-major over (C, H_0, ..., H_{dim-1}); the grid is
channel-first, (batch_size, C, M, ..., M), the layout ``torch.fft`` takes.
The TPU-only compact active slab is not ported: with a full-grid FFT it
gives identical results.

``fold_tiles_to_grid`` and ``unfold_grid_to_tiles`` launch one CUDA kernel
each for CUDA tensors (``csrc/tilefold.cu``: the fold in gather form, each
cell's terms summed in a fixed order, so repeated calls agree bit for bit;
the unfold a copy, bit for bit the plain unfold, that reads the grid
through its strides), or raise; they take the
plain versions (``*_plain``, chains of PyTorch ops) only for CPU tensors.
``fold_tiles_to_slab`` and ``unfold_slab_to_tiles`` do the same for a grid
slab of the grid-sharded transforms (axis 0 unwrapped, with its spill rows
and the halo). ``launches`` on each wrapper counts the kernel launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._build import check, library
from .contract import _require, _route, _stream
from .ragged import fast_divisor

__all__ = ["row_tile_ids", "fold_tiles_to_grid", "unfold_grid_to_tiles",
           "fold_tiles_to_grid_plain", "unfold_grid_to_tiles_plain",
           "fold_tiles_to_slab", "unfold_slab_to_tiles", "fold_tiles_to_slab_plain",
           "unfold_slab_to_tiles_plain", "tile_array_bytes", "use_fold"]

# the JAX package's default memory budget of the dense tile array (a TPU
# figure, kept so that both packages take the same route)
FOLD_BUDGET = 6 << 30


def tiles_per_axis(plan) -> int:
    return -(-plan.M // plan.T)


def tile_array_bytes(plan, C: int, itemsize: int, batch_size: int) -> int:
    """Bytes of the dense tile array (NT, C, H^dim) the dense route builds,
    NT = batch_size * ceil(M/T)^dim over the full grid (the port has no
    compact active slab)."""
    return batch_size * tiles_per_axis(plan) ** plan.dim * C * plan.H**plan.dim * itemsize


def use_fold(plan, C: int, itemsize: int, batch_size: int,
             budget: int = FOLD_BUDGET) -> bool:
    """Whether the dense tile array for C columns fits ``budget``: True for
    the dense route (spread into dense tiles, fold), False for the flat-grid
    route (per-row tiles added onto the grid). The JAX package's rule, with
    no geometry test: this fold takes any M and T."""
    return tile_array_bytes(plan, C, itemsize, batch_size) <= budget


def row_tile_ids(plan) -> torch.Tensor:
    """(S,) int32 dense-tile id per plan row:
    ((batch*nb + t_0)*nb + t_1)*... with t_d = origin_d / T."""
    nb = tiles_per_axis(plan)
    t = torch.div(plan.origin, plan.T, rounding_mode="floor")
    tid = plan.row_batch.to(torch.int32)
    for d in range(plan.dim):
        tid = tid * nb + torch.remainder(t[:, d], nb)
    return tid


def _fold_axis(a: torch.Tensor, ax: int, T: int, M: int) -> torch.Tensor:
    """Overlap-add the adjacent (nb, H) axes (ax, ax+1) onto one M axis."""
    nb, H = a.shape[ax], a.shape[ax + 1]
    J = -(-H // T)
    shape = list(a.shape)
    shape[ax:ax + 2] = [(nb + J - 1) * T]
    ext = a.new_zeros(shape)
    for j in range(J):
        w = min(T, H - j * T)
        dst = ext.narrow(ax, j * T, nb * T).unflatten(ax, (nb, T))
        dst.narrow(ax + 1, 0, w).add_(a.narrow(ax + 1, j * T, w))
    for off in range(M, shape[ax], M):  # periodic wrap
        ln = min(M, shape[ax] - off)
        ext.narrow(ax, 0, ln).add_(ext.narrow(ax, off, ln))
    return ext.narrow(ax, 0, M)


def fold_tiles_to_grid_plain(tiles: torch.Tensor, plan) -> torch.Tensor:
    """Plain version of :func:`fold_tiles_to_grid`: each axis folded in turn
    onto an extended axis, then wrapped."""
    dim, T, H, M, batch_size = plan.dim, plan.T, plan.H, plan.M, plan.batch_size
    nb = tiles_per_axis(plan)
    C = tiles.shape[1]
    a = tiles.reshape((batch_size,) + (nb,) * dim + (C,) + (H,) * dim)
    # (B, C, nb_0, H_0, nb_1, H_1, ...): each tile axis beside its halo axis
    perm = [0, 1 + dim]
    for d in range(dim):
        perm += [1 + d, 2 + dim + d]
    a = a.permute(perm)
    for d in range(dim):
        a = _fold_axis(a, 2 + d, T, M)
    return a.contiguous()


def unfold_grid_to_tiles_plain(g: torch.Tensor, plan) -> torch.Tensor:
    """Plain version of :func:`unfold_grid_to_tiles`: each axis extended
    periodically and cut into overlapping tiles in turn."""
    dim, T, H, M = plan.dim, plan.T, plan.H, plan.M
    nb = tiles_per_axis(plan)
    J = -(-H // T)
    B, C = g.shape[:2]
    a = g
    for d in range(dim):
        ax = 2 + 2 * d
        ext_len = (nb + J - 1) * T
        ext = torch.cat([a] * -(-ext_len // M), dim=ax).narrow(ax, 0, ext_len)
        parts = [ext.narrow(ax, j * T, nb * T).unflatten(ax, (nb, T)) for j in range(J)]
        a = torch.cat(parts, dim=ax + 1).narrow(ax + 1, 0, H)
    # (B, C, nb_0, H_0, nb_1, H_1, ...) -> (B, nb_0, nb_1, ..., C, H_0, ...)
    perm = [0] + [2 + 2 * d for d in range(dim)] + [1] + [3 + 2 * d for d in range(dim)]
    return a.permute(perm).reshape(B * nb**dim, C, H, H ** (dim - 1)).contiguous()


def _geometry(plan) -> tuple:
    """(batch_size, dim, M, T, H, nb) of the plan, the kernels' arguments."""
    return (plan.batch_size, plan.dim, plan.M, plan.T, plan.H, tiles_per_axis(plan))


def fold_tiles_to_grid(tiles: torch.Tensor, plan) -> torch.Tensor:
    """(NT, C, H, H^{dim-1}) dense tiles -> (batch_size, C, M^dim) grid:
    grid cell i of an axis sums every tile cell (t, u) with
    (t*T + u) mod M = i."""
    B, dim, M, T, H, nb = _geometry(plan)
    _require(tiles.dtype == torch.float32 and tiles.is_contiguous(),
             "tiles must be contiguous float32")
    _require(tiles.ndim == 4 and tiles.shape[0] == B * nb**dim
             and tuple(tiles.shape[2:]) == (H, H ** (dim - 1)),
             f"tiles must be ({B * nb**dim}, C, {H}, {H ** (dim - 1)})")
    if not _route(tiles):
        return fold_tiles_to_grid_plain(tiles, plan)
    C = tiles.shape[1]
    out = torch.empty((B, C) + (M,) * dim, dtype=torch.float32, device=tiles.device)
    check(library().tnt_fold_tiles(tiles.data_ptr(), out.data_ptr(), B, C, dim, M, T, H,
                                   nb, *fast_divisor(T), *_stream(tiles)))
    fold_tiles_to_grid.launches += 1
    return out


fold_tiles_to_grid.launches = 0


def unfold_grid_to_tiles(g: torch.Tensor, plan) -> torch.Tensor:
    """(batch_size, C, M^dim) grid -> (NT, C, H, H^{dim-1}) dense tiles:
    tile[b, u] = grid[(b*T + u) mod M] on every axis (the transpose of
    :func:`fold_tiles_to_grid`)."""
    _, dim, M, T, H, nb = _geometry(plan)
    _require(g.dtype == torch.float32, "the grid must be float32")
    _require(g.ndim == 2 + dim and tuple(g.shape[2:]) == (M,) * dim,
             f"the grid must be (B, C) + {(M,) * dim}")
    if not _route(g):
        return unfold_grid_to_tiles_plain(g, plan)
    B, C = g.shape[:2]
    out = torch.empty((B * nb**dim, C, H, H ** (dim - 1)), dtype=torch.float32,
                      device=g.device)
    # the kernel reads the grid through its strides, so a view needs no copy
    strides = g.stride() + (0,) * (3 - dim)
    check(library().tnt_unfold_grid(g.data_ptr(), out.data_ptr(), B, C, dim, M, T, H, nb,
                                    *strides, *fast_divisor(H), *_stream(g)))
    unfold_grid_to_tiles.launches += 1
    return out


unfold_grid_to_tiles.launches = 0


# ---------------------------------------------------------------------------
# A grid slab's fold and unfold (parallel/grid_sharded.py): the slab holds
# nb0 tiles of axis 0 and all nb of every other axis. Axes 1.. wrap as
# above; axis 0 does not: its nb0 tiles fold onto M0 = (nb0 - 1) T + H
# rows, of which the last E = H - T are the spill onto the next slab, and
# its unfold reads rows past nb0 T from the halo, the next slab's first E
# rows.
# ---------------------------------------------------------------------------


class _Axes(NamedTuple):
    """The geometry the plain folds read from a plan, for the tiles of one
    axis-0 tile row: every axis but axis 0."""

    dim: int
    T: int
    H: int
    M: int
    batch_size: int = 1


def _slab_geometry(plan, nb0: int) -> tuple:
    """(dim, M, T, H, nb, E) of a slab of ``nb0`` axis-0 tiles; the tiles
    of the slab are (nb0 * nb^(dim-1), C, H, H^(dim-1))."""
    dim, M, T, H = plan.dim, plan.M, plan.T, plan.H
    _require(dim >= 2, "a slab needs dim >= 2")
    _require(plan.batch_size == 1, "a slab holds one batch member")
    _require(nb0 >= 1 and H >= T, "a slab needs nb0 >= 1 axis-0 tiles and H >= T")
    return dim, M, T, H, tiles_per_axis(plan), H - T


def _check_slab_tiles(tiles: torch.Tensor, plan, nb0: int) -> None:
    dim, _, _, H, nb, _ = _slab_geometry(plan, nb0)
    _require(tiles.dtype == torch.float32 and tiles.is_contiguous(),
             "tiles must be contiguous float32")
    _require(tiles.ndim == 4 and tiles.shape[0] == nb0 * nb ** (dim - 1)
             and tuple(tiles.shape[2:]) == (H, H ** (dim - 1)),
             f"tiles must be ({nb0 * nb ** (dim - 1)}, C, {H}, {H ** (dim - 1)})")


def fold_tiles_to_slab_plain(tiles: torch.Tensor, plan, nb0: int) -> torch.Tensor:
    """Plain version of :func:`fold_tiles_to_slab`, one axis-0 tile row at a
    time: its axes 1.. folded by :func:`fold_tiles_to_grid_plain` (axis 0's
    H cells ride as columns), then added at rows [t T, t T + H)."""
    dim, M, T, H, nb, E = _slab_geometry(plan, nb0)
    C = tiles.shape[1]
    out = tiles.new_zeros((1, C, nb0 * T + E) + (M,) * (dim - 1))
    rows = tiles.reshape(nb0, nb ** (dim - 1), C * H, H ** (dim - 1))
    axes = _Axes(dim - 1, T, H, M)
    for t in range(nb0):
        part = fold_tiles_to_grid_plain(rows[t].reshape(-1, C * H, H, H ** (dim - 2)), axes)
        out[0, :, t * T:t * T + H] += part.reshape((C, H) + (M,) * (dim - 1))
    return out


def unfold_slab_to_tiles_plain(g: torch.Tensor, halo: torch.Tensor, plan,
                               nb0: int) -> torch.Tensor:
    """Plain version of :func:`unfold_slab_to_tiles`: the slab and the halo
    side by side on axis 0, each tile row's H rows cut out and unfolded by
    :func:`unfold_grid_to_tiles_plain` (axis 0's H cells ride as columns)."""
    dim, M, T, H, nb, E = _slab_geometry(plan, nb0)
    ext = torch.cat([g, halo], dim=2)
    C = g.shape[1]
    axes = _Axes(dim - 1, T, H, M)
    out = g.new_empty((nb0, nb ** (dim - 1), C, H ** dim))
    for t in range(nb0):
        part = ext[0, :, t * T:t * T + H]  # (C, H, M, ...)
        part = unfold_grid_to_tiles_plain(part.reshape((1, C * H) + (M,) * (dim - 1)), axes)
        out[t] = part.reshape(nb ** (dim - 1), C, H ** dim)
    return out.reshape(nb0 * nb ** (dim - 1), C, H, H ** (dim - 1))


def fold_tiles_to_slab(tiles: torch.Tensor, plan, nb0: int) -> torch.Tensor:
    """A slab's dense tiles (nb0 * nb^(dim-1), C, H, H^{dim-1}) -> (1, C,
    nb0 T + E, M^(dim-1)): grid cell i of axes 1.. sums every tile cell
    (t, u) with (t T + u) mod M = i, row i of axis 0 those with t T + u = i.
    Rows [nb0 T, nb0 T + E) are the spill onto the next slab."""
    dim, M, T, H, nb, E = _slab_geometry(plan, nb0)
    _check_slab_tiles(tiles, plan, nb0)
    if not _route(tiles):
        return fold_tiles_to_slab_plain(tiles, plan, nb0)
    C = tiles.shape[1]
    out = torch.empty((1, C, nb0 * T + E) + (M,) * (dim - 1), dtype=torch.float32,
                      device=tiles.device)
    check(library().tnt_fold_slab(tiles.data_ptr(), out.data_ptr(), C, dim, M, T, H, nb, nb0,
                                  *fast_divisor(T), *_stream(tiles)))
    fold_tiles_to_slab.launches += 1
    return out


fold_tiles_to_slab.launches = 0


def unfold_slab_to_tiles(g: torch.Tensor, halo: torch.Tensor, plan, nb0: int) -> torch.Tensor:
    """The slab (1, C, nb0 T, M^(dim-1)) and its halo (1, C, E, M^(dim-1)),
    the next slab's first E rows -> the slab's dense tiles (nb0 *
    nb^(dim-1), C, H, H^{dim-1}): tile cell u reads row t T + u of axis 0
    (from the halo past the slab) and cells (t T + u) mod M of the others
    (the transpose of :func:`fold_tiles_to_slab`)."""
    dim, M, T, H, nb, E = _slab_geometry(plan, nb0)
    C = g.shape[1]
    _require(g.dtype == torch.float32 and halo.dtype == torch.float32,
             "the slab and the halo must be float32")
    _require(tuple(g.shape) == (1, C, nb0 * T) + (M,) * (dim - 1),
             f"the slab must be (1, C, {nb0 * T}) + {(M,) * (dim - 1)}")
    _require(tuple(halo.shape) == (1, C, E) + (M,) * (dim - 1),
             f"the halo must be (1, C, {E}) + {(M,) * (dim - 1)}")
    if not _route(g):
        return unfold_slab_to_tiles_plain(g, halo, plan, nb0)
    # the kernel reads the halo through the slab's strides on axes 1..
    if g.stride()[3:] != halo.stride()[3:]:
        g, halo = g.contiguous(), halo.contiguous()
    out = torch.empty((nb0 * nb ** (dim - 1), C, H, H ** (dim - 1)), dtype=torch.float32,
                      device=g.device)
    strides = g.stride()[1:] + (0,) * (3 - dim)
    check(library().tnt_unfold_slab(g.data_ptr(), halo.data_ptr(), out.data_ptr(), C, dim, M,
                                    T, H, nb, nb0, *strides, *halo.stride()[1:3],
                                    *fast_divisor(H), *_stream(g)))
    unfold_slab_to_tiles.launches += 1
    return out


unfold_slab_to_tiles.launches = 0
