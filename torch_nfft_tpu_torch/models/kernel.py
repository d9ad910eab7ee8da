"""The Gaussian kernel front end.

Counterpart of the JAX package's ``models/kernel.py``: the trigonometric
coefficients are computed once, then each point set gets its
:class:`GramMatrix` or :class:`AdjacencyMatrix`. The kernel is an
``nn.Module`` holding the coefficients as a buffer, so ``.to(device)``
moves them, and its operators run on the coefficients' device.
"""

from __future__ import annotations

import math

import torch

from .._device import resolve_device
from ..ops.coeffs import gaussian_analytic_coeffs, gaussian_interpolated_coeffs
from ..utils.points import scale_points_by_norm, shift_points_by_center
from .matrices import AdjacencyMatrix, GramMatrix

__all__ = ["GaussianKernel"]


class GaussianKernel(torch.nn.Module):
    r"""Fast multiplication with the Gaussian kernel exp(-||z||^2 / sigma^2).

    ``kernel = GaussianKernel(sigma, ...)``, ``matrix = kernel(points,
    batch=batch)`` (a :class:`GramMatrix`), ``y = matrix @ x``.

    Two modes:

    * a-priori radius (``max_euclidean_norm`` / ``max_infinity_norm``):
      points are scaled by the fixed factor ``(0.25 - 0.5*reg_width) /
      radius`` and the kernel is exp(-||z||^2 / sigma^2) on the shifted
      points;
    * per-call scaling (no radius): each point set is scaled so its largest
      norm (the infinity norm, or the Euclidean one with ``reg_degree >=
      0``) is ``0.25 - 0.5*reg_width``, the kernel then
      exp(-||z||^2 / (rho^2 sigma^2)) for the set's radius rho.

    The coefficients are interpolated from samples (the default) or
    analytic; ``reg_degree >= 0`` with ``reg_width > 0`` regularises the
    samples at the period edge. They are computed on ``device`` (the card
    unless ``device="cpu"``)."""

    def __init__(self, sigma, dim=3, bandwidth=16, cutoff=3, shift_by_center=True,
                 max_euclidean_norm=None, max_infinity_norm=None, analytic=False,
                 reg_degree=-1, reg_width=0.0, window="gaussian", *, device=None,
                 _coeffs=None):
        super().__init__()
        self.sigma = sigma
        self.dim = dim
        self.bandwidth = bandwidth
        self.cutoff = cutoff
        self.shift_by_center = shift_by_center
        self.analytic = analytic
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
        elif analytic:
            coeffs = gaussian_analytic_coeffs(self.factor * sigma, dim, bandwidth, device=dev)
        else:
            coeffs = gaussian_interpolated_coeffs(self.factor * sigma, dim, bandwidth,
                                                  reg_degree, reg_width, device=dev)
        self.register_buffer("coeffs", coeffs)

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
