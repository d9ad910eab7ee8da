"""Dense (exact) NDFT oracles, O(n * N^dim), and the dense kernel
matrices: the correctness references.

Counterpart of the JAX package's ``ops/ndft.py``. float64 inputs compute
in complex128 (the real matrices in float64), float32 inputs in complex64.
Each runs on the device of its first tensor input; batched matrices are
block diagonal, one block per batch.
"""

from __future__ import annotations

import math

import torch

__all__ = ["ndft_adjoint", "ndft_forward", "ndft_fastsum", "exact_trigonometric_matrix",
           "exact_gaussian_matrix", "exact_radial_matrix"]


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


def ndft_fastsum(x, coeffs, sources, targets=None, source_batch=None, target_batch=None,
                 batch=None, N=16) -> torch.Tensor:
    """Exact fastsum forward(coeffs * adjoint(x)); real for real x."""
    x = torch.as_tensor(x)
    coeffs = torch.as_tensor(coeffs, device=x.device)
    if targets is None:
        targets, target_batch = sources, source_batch
    if batch is not None:
        source_batch = target_batch = batch
    y = ndft_adjoint(x, sources, source_batch, N=N)
    extra = (None,) * (y.ndim - 1 - coeffs.ndim)
    y = ndft_forward(y * coeffs[(None, ..., *extra)], targets, target_batch)
    return y if x.is_complex() else y.real


def _pairs(sources, targets, source_batch, target_batch, batch, device):
    """(sources, targets, [(source rows, target rows)] per batch) with the
    argument conventions of the dense matrices."""
    sources = torch.as_tensor(sources, device=device)
    if targets is None:
        targets, target_batch = sources, source_batch
    targets = torch.as_tensor(targets, device=sources.device)
    if batch is not None:
        source_batch = target_batch = batch
    if source_batch is None:
        return sources, targets, [(slice(None), slice(None))]
    sb = torch.as_tensor(source_batch, device=sources.device)
    tb = torch.as_tensor(target_batch, device=sources.device)
    return sources, targets, [(sb == b, tb == b) for b in range(int(sb.max()) + 1)]


def _assemble(blocks) -> torch.Tensor:
    return blocks[0] if len(blocks) == 1 else torch.block_diag(*blocks)


def exact_trigonometric_matrix(coeffs, sources, targets=None, source_batch=None,
                               target_batch=None, /, batch=None) -> torch.Tensor:
    """Dense matrix of the truncated trigonometric series,
    mat[t, s] = sum_l coeffs_l exp(2 pi i l.(sources_s - targets_t)):
    separates the NFFT's error from the series truncation."""
    coeffs = torch.as_tensor(coeffs)
    sources, targets, parts = _pairs(sources, targets, source_batch, target_batch, batch,
                                     coeffs.device)
    dim, N = coeffs.ndim, coeffs.shape[0]
    cdtype = _cdtype(coeffs, sources)
    coeffs = coeffs.to(cdtype)
    grid = _centered_grid(N, dim, sources.dtype, sources.device)

    def single(s, t):
        diff = s.reshape(1, -1, dim) - t.reshape(-1, 1, dim)
        phase = torch.tensordot(grid, diff, dims=([-1], [-1]))
        return torch.tensordot(coeffs, torch.exp((2j * math.pi) * phase.to(cdtype)), dims=dim)

    return _assemble([single(sources[ps], targets[pt]) for ps, pt in parts])


def exact_gaussian_matrix(sigma, sources, targets=None, source_batch=None,
                          target_batch=None, batch=None) -> torch.Tensor:
    """Dense Gaussian kernel matrix exp(-||s - t||^2 / sigma^2), rows the
    targets (the squared distance expanded as |t|^2 - 2 t.s + |s|^2)."""
    sources, targets, parts = _pairs(sources, targets, source_batch, target_batch, batch,
                                     None)

    def single(s, t):
        sq = (t * t).sum(1, keepdim=True) - 2 * t @ s.T + (s * s).sum(1, keepdim=True).T
        return torch.exp(-sq / (sigma**2))

    return _assemble([single(sources[ps], targets[pt]) for ps, pt in parts])


def exact_radial_matrix(profile, sources, targets=None, source_batch=None,
                        target_batch=None, batch=None) -> torch.Tensor:
    """Dense radial kernel matrix profile(||s - t||), rows the targets,
    in float64; ``profile`` maps a float64 tensor of distances to kernel
    values."""
    sources, targets, parts = _pairs(sources, targets, source_batch, target_batch, batch,
                                     None)
    sources, targets = sources.to(torch.float64), targets.to(torch.float64)

    def single(s, t):
        diff = t[:, None, :] - s[None, :, :]
        r = torch.sqrt(torch.sum(diff * diff, dim=-1))
        return torch.as_tensor(profile(r), dtype=torch.float64, device=r.device)

    return _assemble([single(sources[ps], targets[pt]) for ps, pt in parts])
