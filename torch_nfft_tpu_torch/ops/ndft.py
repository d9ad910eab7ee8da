"""Dense (exact) NDFT oracles, O(n * N^dim): the correctness references.

Counterpart of ``ndft_adjoint`` / ``ndft_forward`` in
the JAX package's ``ops/ndft.py``. float64 inputs compute in complex128,
float32 inputs in complex64.
"""

from __future__ import annotations

import math

import torch

__all__ = ["ndft_adjoint", "ndft_forward"]


def _cdtype(*tensors) -> torch.dtype:
    wide = any(t.dtype in (torch.float64, torch.complex128) for t in tensors)
    return torch.complex128 if wide else torch.complex64


def _centered_grid(N: int, dim: int, dtype, device) -> torch.Tensor:
    """Frequency multi-indices (N, ..., N, dim), k in [-N/2, N/2)."""
    g1 = torch.arange(-(N // 2), N - N // 2, dtype=dtype, device=device)
    grids = torch.meshgrid(*([g1] * dim), indexing="ij")
    return torch.stack(grids, dim=-1)


def _batch_parts(batch, device):
    if batch is None:
        return [slice(None)]
    batch = torch.as_tensor(batch, device=device)
    return [batch == b for b in range(int(batch.max()) + 1)]


def ndft_adjoint(x, pos, batch=None, N: int = 16) -> torch.Tensor:
    """y[b, k, *cols] = sum_{i in batch b} x[i, *cols] exp(+2 pi i k.pos_i),
    shape (batch_size, (N,)*dim, *cols)."""
    x = torch.as_tensor(x)
    pos = torch.as_tensor(pos, device=x.device)
    dim = pos.shape[1]
    cdtype = _cdtype(x, pos)
    x = x.to(cdtype)
    grid = _centered_grid(N, dim, pos.dtype, pos.device)
    out = []
    for part in _batch_parts(batch, pos.device):
        phase = torch.tensordot(grid, pos[part], dims=([-1], [-1]))
        fourier = torch.exp((2j * math.pi) * phase.to(cdtype))
        out.append(torch.tensordot(fourier, x[part], dims=1)[None])
    return torch.cat(out)


def ndft_forward(x, pos, batch=None) -> torch.Tensor:
    """y[i, *cols] = sum_k x[batch_i, k, *cols] exp(-2 pi i k.pos_i),
    shape (n, *cols); ``x`` is (batch_size, (N,)*dim, *cols)."""
    x = torch.as_tensor(x)
    pos = torch.as_tensor(pos, device=x.device)
    n, dim = pos.shape
    cdtype = _cdtype(x, pos)
    x = x.to(cdtype)
    N = x.shape[1]
    grid = _centered_grid(N, dim, pos.dtype, pos.device)
    if batch is None:
        phase = torch.tensordot(pos, grid, dims=([-1], [-1]))
        fourier = torch.exp((-2j * math.pi) * phase.to(cdtype))
        return torch.tensordot(fourier, x[0], dims=dim)
    batch = torch.as_tensor(batch, device=pos.device)
    out = torch.zeros((n,) + tuple(x.shape[1 + dim:]), dtype=cdtype,
                      device=pos.device)
    for b in range(int(batch.max()) + 1):
        sel = batch == b
        phase = torch.tensordot(pos[sel], grid, dims=([-1], [-1]))
        fourier = torch.exp((-2j * math.pi) * phase.to(cdtype))
        out[sel] = torch.tensordot(fourier, x[b], dims=dim)
    return out
