"""Matrix-free linear operators on the NFFT fastsum.

Counterpart of the JAX package's ``models/matrices.py``: the Gram matrix of
a trigonometric kernel (``nfft_fastsum``) and the graph adjacency operator
on a symmetric Gram matrix, with the upstream library's two faults fixed
as the JAX package fixes them (``is_symmetric`` compares the sources with
the targets, by identity; ``apply_shift`` reads ``self.shift``).

Each operator lives on one device, the card unless ``device="cpu"`` is
given (a :class:`GaussianKernel`'s operators on the kernel's device), and
its matvecs are differentiable through ``torch.autograd``.
"""

from __future__ import annotations

import warnings

import torch

from .. import trace
from .._device import resolve_device
from ..ops.binned import build_plan, from_slot_order, to_slot_order
from ..ops.nfft import _normalize_batch, nfft_fastsum
from ..ops.planar import nfft_fastsum_real

__all__ = ["AbstractMatrix", "GramMatrix", "AdjacencyMatrix"]


def _cg(A, b: torch.Tensor, *, tol: float = 1e-5, atol: float = 0.0,
        maxiter: int | None = None) -> tuple:
    """Conjugate gradients for A z = b, A symmetric positive definite, from
    z = 0, with the stopping rule of ``jax.scipy.sparse.linalg.cg``: stop
    when ||r||^2 <= max(tol^2 ||b||^2, atol^2) (norms over the whole
    array, every column at once) or after ``maxiter`` steps (default
    10 * b.numel()). Returns (z, steps taken, the recursively updated
    residual's norm over ||b||)."""
    maxiter = 10 * b.numel() if maxiter is None else int(maxiter)
    bb = float(torch.vdot(b.flatten(), b.flatten()).real)
    bound = max(tol * tol * bb, atol * atol)
    z = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    gamma = torch.vdot(r.flatten(), r.flatten()).real
    steps = 0
    while steps < maxiter and float(gamma) > bound:
        Ap = A(p)
        alpha = gamma / torch.vdot(p.flatten(), Ap.flatten()).real
        z = z + alpha * p
        r = r - alpha * Ap
        gamma_new = torch.vdot(r.flatten(), r.flatten()).real
        p = r + (gamma_new / gamma) * p
        gamma = gamma_new
        steps += 1
    return z, steps, (float(gamma) / bb) ** 0.5 if bb else 0.0


class AbstractMatrix:
    """Minimal matrix-free operator interface: ``apply`` and ``@``, the
    transpose, row and column sums and the dense matrix."""

    def __init__(self, shape, device=None):
        self.shape = shape
        self.device = device

    def apply(self, x):
        raise NotImplementedError()

    def __matmul__(self, x):
        return self.apply(x)

    def is_symmetric(self) -> bool:
        return False

    def transpose(self):
        if self.is_symmetric():
            return self
        raise NotImplementedError()

    @property
    def T(self):
        return self.transpose()

    def row_sums(self):
        return self.apply(torch.ones(self.shape[1], dtype=torch.float32, device=self.device))

    def column_sums(self):
        return self.T.row_sums()

    def to_dense(self):
        return self.apply(torch.eye(self.shape[1], dtype=torch.float32, device=self.device))


class GramMatrix(AbstractMatrix):
    """Kernel Gram matrix applied by ``nfft_fastsum``:
    ``(matrix @ x)[t] ~= sum_s K(sources[s] - targets[t]) x[s]``.

    The binned plans of the sources and the targets are built once per
    operator, at its first matvec, and reused (one plan when the operator
    is symmetric). Below ``_PLAN_THRESHOLD`` points it does not plan, as
    the JAX package's operator does not: its matvecs run the engine that
    ``nfft_fastsum``'s ``"auto"`` picks (the one-hot matmul engine at such
    sizes), and only the slot-layout API and ``solve`` plan. The operator
    is symmetric when ``targets`` is None or ``is`` the sources and the
    batch vectors are one object (identity, not equal values).

    ``@`` takes ``nfft_fastsum``'s route: for a real x the spectral round
    trip runs on half spectra (``rfftn``, the filter of the coefficients'
    Hermitian part, ``irfftn``), also with the complex coefficients of
    :class:`GaussianKernel`; for a complex x complex to complex. The
    slot-layout matvec runs on half spectra always (``nfft_fastsum_real``,
    with the coefficients' real part), and so does ``solve`` wherever the
    slot layout is allowed."""

    def __init__(self, coeffs, sources, targets=None, source_batch=None, target_batch=None,
                 /, batch=None, cutoff=3, *, batch_size=None, window="gaussian",
                 device=None, _symmetric=None):
        self._symmetric = ((targets is None or targets is sources) if _symmetric is None
                           else _symmetric)
        if targets is None:
            targets, target_batch = sources, source_batch
        if batch is not None:
            source_batch = target_batch = batch
        dev = resolve_device(device)
        same = targets is sources
        sources = torch.as_tensor(sources, device=dev).to(torch.float32)
        targets = sources if same else torch.as_tensor(targets, device=dev).to(torch.float32)
        super().__init__((targets.shape[0], sources.shape[0]), dev)
        coeffs = torch.as_tensor(coeffs, device=dev)
        self.coeffs = coeffs.to(torch.complex64 if coeffs.is_complex() else torch.float32)
        self.sources = sources
        self.targets = targets
        self.source_batch = source_batch
        self.target_batch = target_batch
        self.cutoff = int(cutoff)
        self.batch_size = batch_size
        self.window = str(window)
        self._plan_cache = None

    # matvecs reuse the point sets, so the plans are built once; small
    # point sets skip planning (the plan-free engines are fast there)
    _PLAN_THRESHOLD = 2048

    def _plans(self, require: bool = False):
        """(source plan, target plan), built from the detached points on
        the first call (``build_plan`` on the host, as the JAX package's
        operator does); (None, None) below ``_PLAN_THRESHOLD`` points
        unless ``require`` (the slot-layout API needs the plans)."""
        cached = self._plan_cache
        if cached is None or (require and cached[0] is None):
            small = max(self.sources.shape[0], self.targets.shape[0]) < self._PLAN_THRESHOLD
            if small and not require:
                self._plan_cache = (None, None)
            else:
                kw = dict(N=self.coeffs.shape[0], m=self.cutoff, batch_size=self.batch_size,
                          window=self.window, device=self.device)
                sp = build_plan(self.sources.detach(), self.source_batch, **kw)
                tp = (sp if self.is_symmetric()
                      else build_plan(self.targets.detach(), self.target_batch, **kw))
                self._plan_cache = (sp, tp)
        return self._plan_cache

    @trace.spanned("GramMatrix.apply")
    def apply(self, x):
        source_plan, target_plan = self._plans()
        return nfft_fastsum(x, self.coeffs, self.sources, self.targets, self.source_batch,
                            self.target_batch, cutoff=self.cutoff, batch_size=self.batch_size,
                            source_plan=source_plan, target_plan=target_plan,
                            window=self.window, device=self.device)

    # -- slot layout: iterated solvers convert once and run every matvec
    # without the two point-order permutations

    def to_slot(self, x):
        """(n_src, C) or (n_src,) user-order values -> (C, S*K) slot vector
        of the source plan."""
        sp, _ = self._plans(require=True)
        x = torch.as_tensor(x, device=self.device).to(torch.float32)
        return to_slot_order(sp, x[:, None] if x.ndim == 1 else x)

    def from_slot(self, v):
        """(C, S_tgt*K) slot vector of the target plan -> (n_tgt, C)."""
        _, tp = self._plans(require=True)
        return from_slot_order(tp, v)

    @trace.spanned("GramMatrix.apply_slot")
    def apply_slot(self, v):
        """The matvec in slot layout: a (C, S_src*K) slot vector of the
        source plan -> (C, S_tgt*K) of the target plan, no permutation
        (``nfft_fastsum_real(slot_io=True)``, with the real part of complex
        coefficients, as the JAX package takes)."""
        sp, tp = self._plans(require=True)
        _, bs = _normalize_batch(self.source_batch, self.batch_size)
        coeffs = self.coeffs.real if self.coeffs.is_complex() else self.coeffs
        return nfft_fastsum_real(v, coeffs, self.sources, self.targets, self.source_batch,
                                 self.target_batch, sp, tp, batch_size=bs,
                                 N=self.coeffs.shape[0], m=self.cutoff, slot_io=True,
                                 window=self.window, device=self.device)

    def solve(self, b, *, reg=0.0, tol=1e-5, maxiter=100):
        """Solve ``(G + reg*I) z = b`` by conjugate gradients (kernel ridge
        regression, interpolation); the operator must be symmetric. The
        iteration runs in slot layout, the permutations paid once at entry
        and exit, except where the slot layout is refused
        (``nfft_fastsum_real``'s ``ValueError``), then in user order."""
        return self._solve(b, reg=reg, tol=tol, maxiter=maxiter)[0]

    def _solve(self, b, *, reg, tol, maxiter) -> tuple:
        """:meth:`solve`'s z with the CG's steps taken and its recursively
        updated residual over ||b||."""
        if not self.is_symmetric():
            raise ValueError("GramMatrix.solve requires a symmetric operator")
        b = torch.as_tensor(b, device=self.device).to(torch.float32)
        squeeze = b.ndim == 1
        b2 = b[:, None] if squeeze else b
        sp, _ = self._plans(require=True)
        out = None
        try:
            z, *info = _cg(lambda u: self.apply_slot(u) + reg * u, to_slot_order(sp, b2),
                           tol=tol, maxiter=maxiter)
            out = (from_slot_order(sp, z), *info)
        except ValueError:
            out = None
        if out is None:
            out = _cg(lambda u: self.apply(u) + reg * u, b2, tol=tol, maxiter=maxiter)
        z, *info = out
        return (z[:, 0] if squeeze else z, *info)

    def is_symmetric(self) -> bool:
        return self._symmetric and self.source_batch is self.target_batch

    def transpose(self):
        if self.is_symmetric():
            return self
        return GramMatrix(self.coeffs, self.targets, self.sources, self.target_batch,
                          self.source_batch, cutoff=self.cutoff, batch_size=self.batch_size,
                          window=self.window, device=self.device)


class AdjacencyMatrix(AbstractMatrix):
    """Graph adjacency operator on a symmetric :class:`GramMatrix`: a
    diagonal (self-loop) offset, degree normalisation ("sym", "left",
    "right", "rw" = "left"), the "laplacian" and "signless" shifts, and a
    ``RuntimeWarning`` when degrees fall under ``degree_threshold`` (those
    nodes get infinite degree). The degree vectors are computed once, from
    the Gram matrix's row sums."""

    _DEGREE_FIELDS = ("d_inv_sqrt", "d_inv", "degrees")

    def __init__(self, gram_matrix, diagonal_offset=0, normalization=None, shift=None,
                 degree_threshold=0):
        if not gram_matrix.is_symmetric():
            raise ValueError("The underlying Gram matrix of an AdjacencyMatrix must be "
                             "symmetric")
        super().__init__(gram_matrix.shape, gram_matrix.device)
        self.gram_matrix = gram_matrix
        self.diagonal_offset = diagonal_offset
        normalization = "none" if normalization is None else normalization.lower()
        self.normalization = normalization
        shift = "none" if shift is None else shift.lower()
        if shift not in ("none", "laplacian", "signless"):
            raise ValueError(f"Unknown AdjacencyMatrix shift type: {shift}")
        self.shift = shift
        self._slot_cache = {}
        if shift == "none" and normalization == "none":
            return
        degrees = gram_matrix.row_sums()
        if diagonal_offset != 0:
            degrees = degrees + diagonal_offset
        if normalization == "none":
            self.degrees = degrees
            return
        negative = degrees < degree_threshold
        num_negative = int(negative.sum())
        if num_negative:
            warnings.warn(
                "AdjacencyMatrix with normalization: {} out of {} node degrees are smaller "
                "than the threshold {:.4g}".format(num_negative, degrees.numel(),
                                                   degree_threshold),
                RuntimeWarning, stacklevel=2)
            degrees = torch.where(negative, torch.full_like(degrees, float("inf")), degrees)
        if normalization == "rw":  # synonym for "left"
            normalization = self.normalization = "left"
        if normalization == "sym":
            self.d_inv_sqrt = torch.rsqrt(degrees)
        elif normalization in ("left", "right"):
            self.d_inv = 1.0 / degrees
        else:
            raise ValueError(f"Unknown AdjacencyMatrix normalization type: {normalization}")

    @staticmethod
    def _bcast(v, x):
        return v[(...,) + (None,) * (x.ndim - 1)]

    def apply_left_normalization(self, x):
        if self.normalization == "sym":
            return self._bcast(self.d_inv_sqrt, x) * x
        if self.normalization == "left":
            return self._bcast(self.d_inv, x) * x
        return x

    def apply_right_normalization(self, x):
        if self.normalization == "sym":
            return self._bcast(self.d_inv_sqrt, x) * x
        if self.normalization == "right":
            return self._bcast(self.d_inv, x) * x
        return x

    def apply_shift(self, x, y):
        if self.shift == "none":
            return y
        if self.normalization == "none":
            x = self._bcast(self.degrees, x) * x
        return x + y if self.shift == "signless" else x - y

    @trace.spanned("AdjacencyMatrix.apply")
    def apply(self, x):
        x = torch.as_tensor(x, device=self.device).to(torch.float32)
        Dx = self.apply_right_normalization(x)
        y = self.gram_matrix @ Dx
        if self.diagonal_offset != 0:
            y = y + self.diagonal_offset * Dx
        return self.apply_shift(x, self.apply_left_normalization(y))

    # -- slot layout: every step but the Gram matvec is diagonal, and a
    # diagonal scaling commutes with the (zero-padded) slot permutation

    def _slot_diag(self, name):
        """The degree vector ``name`` as a (1, S*K) slot vector, cached."""
        if name not in self._slot_cache:
            sp, _ = self.gram_matrix._plans(require=True)
            self._slot_cache[name] = to_slot_order(sp, getattr(self, name)[:, None])
        return self._slot_cache[name]

    def apply_slot(self, v):
        """:meth:`apply` on a (C, S*K) slot vector of the Gram matrix's plan
        (symmetric: source and target layouts coincide)."""
        norm = self.normalization
        if norm == "sym":
            Dx = self._slot_diag("d_inv_sqrt") * v
        elif norm == "right":
            Dx = self._slot_diag("d_inv") * v
        else:
            Dx = v
        y = self.gram_matrix.apply_slot(Dx)
        if self.diagonal_offset != 0:
            y = y + self.diagonal_offset * Dx
        if norm == "sym":
            y = self._slot_diag("d_inv_sqrt") * y
        elif norm == "left":
            y = self._slot_diag("d_inv") * y
        if self.shift == "none":
            return y
        x = self._slot_diag("degrees") * v if norm == "none" else v
        return x + y if self.shift == "signless" else x - y

    def is_symmetric(self) -> bool:
        return self.normalization not in ("left", "right")

    def transpose(self):
        if self.normalization in ("left", "right"):
            transposed = AdjacencyMatrix(self.gram_matrix, self.diagonal_offset)
            transposed.normalization = "right" if self.normalization == "left" else "left"
            transposed.shift = self.shift
            transposed.d_inv = self.d_inv
            return transposed
        return self
