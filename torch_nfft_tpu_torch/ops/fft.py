"""Spectral stage of the NFFT with ``torch.fft`` (cuFFT on the card).

The JAX package builds its DFTs from matmuls (its ``ops/fft.py``)
only because its TPU runtime had no complex dtype and no FFT. Here both
directions are complex-to-complex transforms of the full oversampled grid:

* adjoint: y[k] = sum_j g[j] exp(+2 pi i j.k / M), the unnormalised inverse
  DFT (``ifftn(norm="forward")``), then the centered crop and the rolloff;
* forward: rolloff, zero-padded embed, then g[j] = sum_k y[k]
  exp(-2 pi i j.k / M), the forward DFT (``fftn``).

Grids are channel-first, (batch_size, C, M, ..., M).
"""

from __future__ import annotations

import torch

from .spectral import apply_phi_hat_inv, centered_crop, centered_embed
from .window import DEFAULT_SIGMA, DEFAULT_WINDOW

__all__ = ["spectral_adjoint", "spectral_forward"]


def spectral_adjoint(g: torch.Tensor, dim: int, N: int, m: int,
                     sigma: float = DEFAULT_SIGMA,
                     window: str = DEFAULT_WINDOW) -> torch.Tensor:
    """(B, C, M^dim) real grid -> (B, C, N^dim) complex64 centered band."""
    axes = tuple(range(2, 2 + dim))
    gh = torch.fft.ifftn(g, dim=axes, norm="forward")
    gh = centered_crop(gh, dim, N, spatial_axis0=2)
    return apply_phi_hat_inv(gh, dim, N, m, sigma, spatial_axis0=2, window=window)


def spectral_forward(y: torch.Tensor, dim: int, M: int, m: int,
                     sigma: float = DEFAULT_SIGMA,
                     window: str = DEFAULT_WINDOW) -> torch.Tensor:
    """(B, C, N^dim) complex centered band -> (B, C, M^dim) complex grid."""
    N = y.shape[2]
    y = apply_phi_hat_inv(y, dim, N, m, sigma, spatial_axis0=2, window=window)
    y = centered_embed(y, dim, N, M, spatial_axis0=2)
    return torch.fft.fftn(y, dim=tuple(range(2, 2 + dim)))
