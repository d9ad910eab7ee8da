"""Radial-kernel front ends on the interpolated-coefficients workflow.

Counterpart of the JAX package's ``models/radial.py``: any radial profile
r -> K(r) is sampled on the interpolation grid (float64, on the host),
optionally flattened near the period edge, and turned into trigonometric
coefficients by the port's ``interpolated_kernel_coeffs`` on the device;
each point set then gets the :class:`GramMatrix` or
:class:`AdjacencyMatrix` of :class:`GaussianKernel`, with the same
scaling and shifting. :class:`LaplaceKernel`, :class:`MaternKernel` and
:class:`InverseMultiquadricKernel` are ready-made profiles.

Profiles take and return NumPy float64, as in the JAX package, so a profile
written for it works here unchanged. The boundary regularisation
(``reg_degree >= 0``, ``reg_width > 0``) is the two-point Hermite
polynomial of ``ops/coeffs.py`` with the left end's derivatives estimated
from a local polynomial fit, so it applies to any profile; both steps are
float64 NumPy copies of the JAX package's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._device import resolve_device
from ..ops.coeffs import interpolated_kernel_coeffs
from ..utils.points import scale_points_by_norm, shift_points_by_center
from .matrices import AdjacencyMatrix, GramMatrix

__all__ = ["RadialKernel", "LaplaceKernel", "MaternKernel", "InverseMultiquadricKernel"]


def _local_poly_derivatives(profile, a: float, p: int) -> np.ndarray:
    """profile^(j)(a) for j = 0..p from a least-squares polynomial of
    degree 2p+2 fitted to float64 samples on a small window around a
    (inside r >= 0), differentiated at a."""
    deg = 2 * p + 2
    half = max(2e-2, 1e-3 * max(abs(a), 1.0) * (p + 1))
    lo = max(0.0, a - half)
    xs = np.linspace(lo, a + half, 8 * deg + 9, dtype=np.float64)
    ys = np.asarray(profile(xs), dtype=np.float64)
    coefs = np.polynomial.polynomial.polyfit(xs - a, ys, deg)  # c_j = f^(j)(a) / j!
    return np.array([coefs[j] * math.factorial(j) for j in range(p + 1)])


def _hermite_boundary_polynomial(profile, eps: float, p: int) -> np.ndarray:
    """Monomial coefficients (lowest first) of the degree-2p polynomial T
    on [1/2 - eps, 1/2] with T^(j)(1/2 - eps) = profile^(j)(1/2 - eps),
    j = 0..p, and T^(j)(1/2) = 0, j = 1..p."""
    a, b = 0.5 - eps, 0.5
    ncoef = 2 * p + 1
    A = np.zeros((ncoef, ncoef))
    rhs = np.zeros(ncoef)
    ka = _local_poly_derivatives(profile, a, p)

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


class RadialKernel(torch.nn.Module):
    r"""Fast multiplication with an arbitrary radial kernel K(||s - t||).

    ``profile`` maps NumPy float64 distances to kernel values. The scaling
    follows :class:`GaussianKernel`:

    * a-priori radius (``max_euclidean_norm`` / ``max_infinity_norm``): the
      profile receives distances in the original units of the (shifted)
      points;
    * per-call scaling (no radius): each point set is scaled by its own
      norm and the profile receives distances in that norm-scaled domain.

    ``reg_degree >= 0`` with ``reg_width > 0`` flattens the sampled kernel
    near the period edge (the two-point Hermite polynomial on
    [1/2 - eps, 1/2]). The coefficients are a buffer, computed on
    ``device`` (the card unless ``device="cpu"``); the operators run on
    the coefficients' device."""

    def __init__(self, profile, dim=3, bandwidth=16, cutoff=3, shift_by_center=True,
                 max_euclidean_norm=None, max_infinity_norm=None, reg_degree=-1,
                 reg_width=0.0, *, window="gaussian", device=None, _coeffs=None):
        super().__init__()
        self.profile = profile
        self.dim = dim
        self.bandwidth = bandwidth
        self.cutoff = cutoff
        self.shift_by_center = shift_by_center
        self.reg_degree = reg_degree
        self.reg_width = reg_width
        self.scale_by_norm = None
        self.window = str(window)
        self.factor = 0.25 - 0.5 * reg_width
        if reg_degree < 0:
            radius = max_infinity_norm or max_euclidean_norm
            if radius is None:
                self.scale_by_norm = "infinity"
            else:
                self.factor /= radius
        else:
            radius = max_euclidean_norm
            if radius is None and max_infinity_norm is not None:
                radius = max_infinity_norm * math.sqrt(dim)
            if radius is None:
                self.scale_by_norm = "euclidean"
            else:
                self.factor /= radius
        dev = resolve_device(device)
        if _coeffs is not None:
            coeffs = torch.as_tensor(_coeffs, device=dev)
        else:
            coeffs = interpolated_kernel_coeffs(
                torch.as_tensor(self._samples(), dtype=torch.float32), device=dev)
        self.register_buffer("coeffs", coeffs)

    def _samples(self) -> np.ndarray:
        """float64 kernel samples at the radii of the interpolation grid
        (``radial_interpolation_grid``'s nodes), mapped to the profile's
        domain by ``factor``, flattened near the edge when regularised."""
        N = self.bandwidth
        g1 = np.arange(N, dtype=np.float64) / N - 0.5
        grids = np.meshgrid(*([g1] * self.dim), indexing="ij")
        r = np.sqrt(sum(g * g for g in grids))

        def prof(rr, _p=self.profile, _f=self.factor):
            return _p(np.asarray(rr, dtype=np.float64) / _f)

        p, eps = self.reg_degree, self.reg_width
        if p < 0:
            return np.asarray(prof(r), dtype=np.float64)
        if eps <= 0.0:
            raise ValueError("Regularized radial coefficients (reg_degree >= 0) "
                             "require reg_width > 0")
        coefs = _hermite_boundary_polynomial(prof, float(eps), int(p))
        t_poly = np.polynomial.polynomial.polyval(r, coefs)
        t_edge = float(np.polynomial.polynomial.polyval(0.5, coefs))
        vals = np.asarray(prof(r), dtype=np.float64)
        vals = np.where(r > 0.5 - eps, t_poly, vals)
        return np.where(r >= 0.5, t_edge, vals)

    def gram_matrix(self, sources, targets=None, source_batch=None, target_batch=None,
                    /, batch=None, *, batch_size=None) -> GramMatrix:
        """The Gram matrix of the point set(s), shifted and scaled as the
        kernel's mode says; symmetric when ``targets`` is None."""
        if batch is not None:
            source_batch = target_batch = batch
        symmetric = targets is None
        dev = self.coeffs.device
        if self.shift_by_center:
            sources, targets = shift_points_by_center(
                sources, targets, source_batch, target_batch, num_segments=batch_size,
                device=dev)
        if self.scale_by_norm is not None:
            sources, targets = scale_points_by_norm(
                sources, targets, source_batch, target_batch, factor=self.factor,
                norm=self.scale_by_norm, num_segments=batch_size, device=dev)
        else:
            sources = self.factor * torch.as_tensor(sources, device=dev).to(torch.float32)
            if targets is not None:
                targets = self.factor * torch.as_tensor(targets, device=dev).to(torch.float32)
        return GramMatrix(self.coeffs, sources, targets, source_batch, target_batch,
                          cutoff=self.cutoff, batch_size=batch_size, window=self.window,
                          device=dev, _symmetric=symmetric or None)

    def forward(self, *args, **kwargs) -> GramMatrix:
        return self.gram_matrix(*args, **kwargs)

    def adjacency_matrix(self, sources, batch=None, loop_weight=1, normalization=None,
                         shift=None, degree_threshold=0, *, batch_size=None):
        """The graph adjacency operator of the point set (self-loops of
        weight ``loop_weight``)."""
        return AdjacencyMatrix(self.gram_matrix(sources, batch=batch, batch_size=batch_size),
                               diagonal_offset=loop_weight - 1, normalization=normalization,
                               shift=shift, degree_threshold=degree_threshold)


class _SigmaRadialKernel(RadialKernel):
    """A profile with one width parameter ``sigma``."""

    def __init__(self, sigma, **kwargs):
        self.sigma = float(sigma)
        super().__init__(self._profile, **kwargs)

    def _profile(self, r):
        raise NotImplementedError


class LaplaceKernel(_SigmaRadialKernel):
    r"""Exponential (Laplace) kernel ``K(r) = exp(-r / sigma)``."""

    def _profile(self, r):
        return np.exp(-np.asarray(r, dtype=np.float64) / self.sigma)


class MaternKernel(_SigmaRadialKernel):
    r"""Matern kernel with smoothness ``nu`` in {0.5, 1.5, 2.5}: exp(-r/sigma),
    ``(1 + a) exp(-a)`` with a = sqrt(3) r / sigma, and
    ``(1 + a + a^2/3) exp(-a)`` with a = sqrt(5) r / sigma."""

    def __init__(self, sigma, nu=1.5, **kwargs):
        if nu not in (0.5, 1.5, 2.5):
            raise ValueError("MaternKernel supports nu in {0.5, 1.5, 2.5}")
        self.nu = float(nu)
        super().__init__(sigma, **kwargs)

    def _profile(self, r):
        r = np.asarray(r, dtype=np.float64)
        if self.nu == 0.5:
            return np.exp(-r / self.sigma)
        if self.nu == 1.5:
            a = math.sqrt(3.0) * r / self.sigma
            return (1.0 + a) * np.exp(-a)
        a = math.sqrt(5.0) * r / self.sigma
        return (1.0 + a + a * a / 3.0) * np.exp(-a)


class InverseMultiquadricKernel(_SigmaRadialKernel):
    r"""Inverse multiquadric kernel ``K(r) = 1 / sqrt(1 + (r / sigma)^2)``."""

    def _profile(self, r):
        a = np.asarray(r, dtype=np.float64) / self.sigma
        return 1.0 / np.sqrt(1.0 + a * a)
