"""The least time of a kernel's work, counted from the cell's shapes and
points, whatever implements it.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
3.35 TB/s of HBM3, 67 TFLOP/s of float32 outside the tensor cores; the
kernels do float32 arithmetic on the CUDA cores. The least time is the
larger of operations over the float32 peak and bytes over the HBM rate.

Work of one transform of n points in ``dim`` dimensions, C float32
columns, window width L = 2m + 2:

- ``spread``: n * dim * L window values (``WINDOW_FLOPS`` each) and
  n * C * L^dim multiply-adds; reads the points and values once, writes
  once the oversampled grid cells that the points' windows cover;
- ``gather``: the same operations; reads those cells once and the points,
  writes the n * C outputs;
- ``pos_grad``: window values and derivatives (``WINDOW_GRAD_FLOPS``
  each) and two multiply-adds per cell and column (a value and a
  derivative sum on the innermost axis); reads the cells, points and
  weights, writes the n * dim outputs.

Never counted: plan rows, padding, tiles, designs, or work a kernel
issues beyond this.
"""

from __future__ import annotations

import torch

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
WINDOW_FLOPS = 8
WINDOW_GRAD_FLOPS = 12
F32 = 4


def work(kind: str, n: int, C: int, dim: int, L: int, covered: int) -> tuple:
    """(float32 operations, bytes) of one ``kind`` of transform."""
    cells = L**dim
    if kind == "spread":
        return n * (dim * L * WINDOW_FLOPS + 2 * C * cells), F32 * (n * dim + n * C + covered * C)
    if kind == "gather":
        return n * (dim * L * WINDOW_FLOPS + 2 * C * cells), F32 * (covered * C + n * dim + n * C)
    if kind == "pos_grad":
        return (n * (dim * L * WINDOW_GRAD_FLOPS + 4 * C * cells),
                F32 * (covered * C + n * dim + n * C + n * dim))
    raise ValueError(f"unknown kind of work: {kind!r}")


def least_s(flops: float, nbytes: float) -> tuple:
    """(least seconds, "operations" or "bytes": which bound it)."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def covered_cells(grid_points: torch.Tensor, M: int, m: int) -> int:
    """Cells of the periodic M^dim grid that the points' windows cover:
    each point in [-1/2, 1/2)^dim covers the L = 2m + 2 indices per axis
    from floor(M (p + 1/2)) - m, modulo M."""
    dim = grid_points.shape[1]
    L = 2 * m + 2
    idx = torch.floor((grid_points.double() + 0.5) * M).long().remainder(M)
    flat = torch.zeros(M**dim, dtype=torch.bool, device=grid_points.device)
    lin = idx[:, 0]
    for d in range(1, dim):
        lin = lin * M + idx[:, d]
    flat[lin] = True
    occ = flat.view((M,) * dim)
    for d in range(dim):
        base = occ.roll(-m, dims=d)
        out = base.clone()
        for s in range(1, L):
            out |= base.roll(s, dims=d)
        occ = out
    return int(occ.sum())
