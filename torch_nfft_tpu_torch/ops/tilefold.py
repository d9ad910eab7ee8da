"""Dense-tile overlap-add between the halo tiles and the oversampled grid.

Counterpart of ``fold_tiles_to_grid``, ``unfold_grid_to_tiles`` and
``row_tile_ids`` of the JAX package's ``ops/tilefold.py``, and of the
windowed-scatter fallback of its ``ops/binned.py`` for grids
that T does not divide. Tile b of an axis covers cells [b*T, b*T + H) mod M,
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
"""

from __future__ import annotations

import torch

__all__ = ["row_tile_ids", "fold_tiles_to_grid", "unfold_grid_to_tiles"]


def tiles_per_axis(plan) -> int:
    return -(-plan.M // plan.T)


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


def fold_tiles_to_grid(tiles: torch.Tensor, plan) -> torch.Tensor:
    """(NT, C, H, H^{dim-1}) dense tiles -> (batch_size, C, M^dim) grid."""
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


def unfold_grid_to_tiles(g: torch.Tensor, plan) -> torch.Tensor:
    """(batch_size, C, M^dim) grid -> (NT, C, H, H^{dim-1}) dense tiles:
    tile[b, u] = grid[(b*T + u) mod M] on every axis (the transpose of
    :func:`fold_tiles_to_grid`)."""
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
