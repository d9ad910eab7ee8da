"""Trigonometric kernel-coefficient generators.

Counterpart of the JAX package's ``ops/coeffs.py``: analytic Gaussian
coefficients, interpolated coefficients from an FFT of kernel samples on
the N^dim grid of [-1/2, 1/2)^dim, and that grid for user-defined kernels.
Coefficients are centered: frequency l of an axis at index l + N/2.

The boundary-regularised Gaussian (``p >= 0``, ``eps > 0``) replaces the
samples near the period edge by a two-point Hermite polynomial; its small
linear solve runs on the host in float64 NumPy (a copy of the JAX
package's, which the port does not import).

Every generator runs on the CUDA card unless ``device="cpu"`` is given,
and raises when no card is there and no device was asked for.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._device import resolve_device
from .spectral import fftshift_nd

__all__ = [
    "gaussian_analytic_coeffs",
    "gaussian_interpolated_coeffs",
    "interpolation_grid",
    "radial_interpolation_grid",
    "interpolated_kernel_coeffs",
]


def gaussian_analytic_coeffs(sigma, dim=3, N=16, dtype=torch.float32, *,
                             device=None) -> torch.Tensor:
    """Separable analytic Fourier coefficients of exp(-r^2/sigma^2),
    shape (N,)*dim, real:
    prod_d sqrt(pi)*sigma*exp(-sigma^2*pi^2*l_d^2), l_d = i_d - N/2."""
    dev = resolve_device(device)
    l = torch.arange(N, dtype=dtype, device=dev) - N // 2
    v = math.sqrt(math.pi) * sigma * torch.exp(-(sigma**2) * (math.pi**2) * l * l)
    out = v
    for _ in range(dim - 1):
        out = out[..., None] * v
    return out


def interpolation_grid(dim=3, N=16, dtype=torch.float32, *, device=None) -> torch.Tensor:
    """Uniform grid of [-1/2, 1/2)^dim, shape (N,)*dim + (dim,):
    grid[i_0, ..., i_{d-1}, a] = i_a / N - 1/2."""
    g1 = torch.arange(N, dtype=dtype, device=resolve_device(device)) / N - 0.5
    grids = torch.meshgrid(*([g1] * dim), indexing="ij")
    return torch.stack(grids, dim=-1)


def radial_interpolation_grid(dim=3, N=16, dtype=torch.float32, *,
                              device=None) -> torch.Tensor:
    """Euclidean norms of the :func:`interpolation_grid` nodes, (N,)*dim."""
    grid = interpolation_grid(dim, N, dtype, device=device)
    return torch.sqrt(torch.sum(grid * grid, dim=-1))


def _coeffs_from_grid_values(vals: torch.Tensor, dim: int, N: int) -> torch.Tensor:
    """fftshift, unnormalised forward FFT, fftshift, / N^dim (N even makes
    fftshift equal ifftshift). Complex output: complex128 for float64
    samples, else complex64."""
    if not vals.is_complex():
        vals = vals.to(torch.complex128 if vals.dtype == torch.float64 else torch.complex64)
    b_hat = torch.fft.fftn(fftshift_nd(vals, dim), dim=tuple(range(dim)))
    return fftshift_nd(b_hat, dim) / (N**dim)


def interpolated_kernel_coeffs(grid_values, *, device=None) -> torch.Tensor:
    """Coefficients of the trigonometric interpolant of kernel samples on
    :func:`interpolation_grid` (or any function of
    :func:`radial_interpolation_grid`), shape (N,)*dim: complex, frequency l
    at index l + N/2."""
    vals = torch.as_tensor(grid_values, device=resolve_device(device))
    return _coeffs_from_grid_values(vals, vals.ndim, vals.shape[0])


# ---------------------------------------------------------------------------
# Regularised Gaussian samples (two-point Hermite boundary polynomial)
# ---------------------------------------------------------------------------


def _gaussian_radial_derivatives(sigma2: float, r: float, p: int) -> np.ndarray:
    """K^(j)(r) for K(r) = exp(-r^2/sigma2), j = 0..p, in float64:
    K^(j)(r) = exp(-r^2/sigma2) P_j(r) with P_{j+1} = P_j' - (2r/sigma2) P_j."""
    P = np.array([1.0])  # coefficients, lowest degree first
    out = np.empty(p + 1)
    base = math.exp(-(r * r) / sigma2)
    for j in range(p + 1):
        out[j] = base * float(np.polynomial.polynomial.polyval(r, P))
        dP = np.polynomial.polynomial.polyder(P)
        shifted = np.polynomial.polynomial.polymul(np.array([0.0, -2.0 / sigma2]), P)
        ln = max(len(dP), len(shifted))
        P = np.pad(dP, (0, ln - len(dP))) + np.pad(shifted, (0, ln - len(shifted)))
    return out


def _boundary_polynomial(sigma2: float, eps: float, p: int) -> np.ndarray:
    """Monomial coefficients (lowest first) of the degree-2p polynomial T on
    [1/2 - eps, 1/2] with T^(j)(1/2 - eps) = K^(j)(1/2 - eps), j = 0..p,
    and T^(j)(1/2) = 0, j = 1..p (the NFFT-fastsum boundary
    regularisation of Potts and Steidl)."""
    a, b = 0.5 - eps, 0.5
    ncoef = 2 * p + 1
    A = np.zeros((ncoef, ncoef))
    rhs = np.zeros(ncoef)
    ka = _gaussian_radial_derivatives(sigma2, a, p)

    def deriv_row(x, j):
        row = np.zeros(ncoef)
        for c in range(j, ncoef):
            row[c] = math.perm(c, j) * x ** (c - j)
        return row

    for j in range(p + 1):
        A[j] = deriv_row(a, j)
        rhs[j] = ka[j]
    for j in range(1, p + 1):
        A[p + j] = deriv_row(b, j)
    return np.linalg.solve(A, rhs)


def gaussian_interpolated_coeffs(sigma, dim=3, N=16, p=-1, eps=0.0, dtype=torch.float32,
                                 *, device=None) -> torch.Tensor:
    """Interpolated Fourier coefficients of exp(-r^2/sigma^2) sampled on the
    N^dim grid, complex (N,)*dim.

    ``p < 0``: the Gaussian samples everywhere. ``p >= 0`` with ``eps > 0``:
    K(r) for r <= 1/2 - eps, the degree-2p boundary polynomial on
    [1/2 - eps, 1/2] and its edge value T(1/2) for r >= 1/2."""
    sigma = float(sigma)
    sigma2 = sigma * sigma
    grid = interpolation_grid(dim, N, dtype, device=device)
    r2 = torch.sum(grid * grid, dim=-1)
    if p < 0:
        vals = torch.exp(-r2 / sigma2)
    else:
        if eps <= 0.0:
            raise ValueError("Regularized Gaussian coefficients (p >= 0) require eps > 0")
        coefs = _boundary_polynomial(sigma2, float(eps), int(p))
        r = torch.sqrt(r2)
        t_poly = torch.zeros_like(r)
        for c in coefs[::-1]:  # Horner, highest degree first
            t_poly = t_poly * r + float(c)
        t_edge = float(np.polynomial.polynomial.polyval(0.5, coefs))
        vals = torch.where(r2 <= (0.5 - eps) ** 2, torch.exp(-r2 / sigma2), t_poly)
        vals = torch.where(r2 >= 0.25, torch.full_like(vals, t_edge), vals)
    return _coeffs_from_grid_values(vals, dim, N)
