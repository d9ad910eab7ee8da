"""Spectral index maps: centered crop, zero-padded embed, the rolloff and
the fastsum band filter.

Counterpart of the JAX package's ``ops/spectral.py``. Conventions:

* the oversampled grid has M = sigma*N cells per axis; frequency v of the
  unnormalised DFT lives at grid index v mod M (non-negative frequencies at
  the head, negative ones at the tail);
* "centered" arrays have N entries per axis, frequency k at index
  k + N // 2, k in [-(N // 2), N - N // 2): [-N/2, N/2) for an even N, the
  symmetric band for an odd N (the JAX package's pruned DFTs' band).
"""

from __future__ import annotations

import torch

from .window import DEFAULT_SIGMA, DEFAULT_WINDOW, phi_hat_inv_centered

__all__ = ["centered_crop", "centered_embed", "phi_hat_inv_outer", "apply_phi_hat_inv",
           "fastsum_band_filter", "fftshift_nd"]


def centered_crop(g_hat: torch.Tensor, dim: int, N: int,
                  spatial_axis0: int = 1) -> torch.Tensor:
    """The centered N^dim band of an M^dim spectral grid on axes
    [spatial_axis0, spatial_axis0 + dim)."""
    half = N // 2
    for ax in range(spatial_axis0, spatial_axis0 + dim):
        M = g_hat.shape[ax]
        neg = g_hat.narrow(ax, M - half, half)  # k in [-N/2, 0)
        pos = g_hat.narrow(ax, 0, N - half)  # k in [0, N - N/2)
        g_hat = torch.cat([neg, pos], dim=ax)
    return g_hat


def centered_embed(x: torch.Tensor, dim: int, N: int, M: int,
                   spatial_axis0: int = 1) -> torch.Tensor:
    """Zero-pad a centered N^dim spectrum into an M^dim DFT-layout grid
    (inverse index map of :func:`centered_crop`)."""
    half = N // 2
    for ax in range(spatial_axis0, spatial_axis0 + dim):
        n_ax = x.shape[ax]
        head = x.narrow(ax, half, n_ax - half)  # k >= 0
        tail = x.narrow(ax, 0, half)  # k < 0
        pad_shape = list(x.shape)
        pad_shape[ax] = M - n_ax
        zeros = x.new_zeros(pad_shape)
        x = torch.cat([head, zeros, tail], dim=ax)
    return x


def phi_hat_inv_outer(dim: int, N: int, m: int, sigma: float = DEFAULT_SIGMA,
                      dtype=torch.float32, window: str = DEFAULT_WINDOW, *,
                      device=None) -> torch.Tensor:
    """Separable product of the centered inverse window coefficients,
    (N,)*dim: out[i_0, ..., i_{d-1}] = prod_d phi_hat_inv(i_d - N/2)."""
    v = phi_hat_inv_centered(N, m, sigma, window, device=device).to(dtype)
    out = v
    for _ in range(dim - 1):
        out = out[..., None] * v
    return out


def apply_phi_hat_inv(y: torch.Tensor, dim: int, N: int, m: int,
                      sigma: float = DEFAULT_SIGMA, spatial_axis0: int = 1,
                      window: str = DEFAULT_WINDOW) -> torch.Tensor:
    """Multiply centered spectral data by the separable inverse window
    coefficients, one (N,)-vector per spatial axis."""
    v = phi_hat_inv_centered(N, m, sigma, window, device=y.device)
    for ax in range(spatial_axis0, spatial_axis0 + dim):
        shape = [1] * y.ndim
        shape[ax] = N
        y = y * v.reshape(shape)
    return y


def fastsum_band_filter(coeffs: torch.Tensor, N: int, m: int, M: int,
                        sigma: float = DEFAULT_SIGMA,
                        window: str = DEFAULT_WINDOW) -> torch.Tensor:
    """The fastsum's spectral filter on the oversampled grid, (M,)*dim:
    coeffs[k + N/2] * prod_d phi_hat_inv(k_d)^2 at the DFT position k mod M
    of every in-band frequency k, zero outside the band. The square carries
    both window deconvolutions, the spread's and the gather's."""
    dim = coeffs.ndim
    real = coeffs.real.dtype if coeffs.is_complex() else coeffs.dtype
    phi2 = phi_hat_inv_outer(dim, N, m, sigma, real, window, device=coeffs.device) ** 2
    return centered_embed((coeffs * phi2)[None], dim, N, M, spatial_axis0=1)[0]


def fftshift_nd(x: torch.Tensor, dim: int, spatial_axis0: int = 0) -> torch.Tensor:
    """fftshift over ``dim`` axes from ``spatial_axis0`` on (N even: the
    same as ifftshift), index map (i + N/2) mod N per axis."""
    return torch.fft.fftshift(x, dim=tuple(range(spatial_axis0, spatial_axis0 + dim)))
