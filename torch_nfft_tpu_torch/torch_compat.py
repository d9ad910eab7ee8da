"""The upstream library's functional and class API on torch tensors, with its
gradient contract, run by this package.

Counterpart of the JAX package's ``torch_compat.py``: every public function
of the upstream library's functional layer (``torch_nfft/nfft.py:31,57,91``,
``coeffs.py:10-27``, ``ndft.py:5-117``) with the same signature, taking and
returning ``torch.Tensor``s, and its operator classes. The transforms are
``torch.autograd.Function``s with the upstream backward pairing: the
adjoint's backward is the forward transform and the other way round, the
fastsum's backward swaps sources and targets (upstream ``nfft.py:23-28,
49-54, 83-88``). Gradients reach the values ``x`` only, as upstream
(``nfft.py:28,54,88``); positions, coefficients and batch vectors are
detached. For gradients in the positions or the coefficients call this
package's own entry points (``torch_nfft_tpu_torch.nfft_adjoint``,
``nfft_forward``, ``nfft_fastsum``), which take them.

Every result lies on the device of the call's tensor inputs (the first
tensor among them; the CPU when none is a tensor), and that device is
passed to the entry points, which run on it: a card tensor runs the CUDA
kernels, a CPU tensor the plain PyTorch versions. The JAX package's layer
copies every tensor to the host and back, because its bridge to JAX goes
through numpy; that copy is how that bridge works, not part of the
contract, and there is none here. A kernel front end builds this package's
kernel, coefficients included, on the device of the point sets it is given,
so that its operators compute what this package's own operators compute.
"""

from __future__ import annotations

import torch

from .models import kernel as _kernel
from .models import matrices as _matrices
from .models import radial as _radial
from .ops import coeffs as _coeffs
from .ops import ndft as _ndft
from .ops import nfft as _nfft

__all__ = [
    "nfft_adjoint",
    "nfft_forward",
    "nfft_fastsum",
    "gaussian_analytic_coeffs",
    "gaussian_interpolated_coeffs",
    "interpolation_grid",
    "radial_interpolation_grid",
    "interpolated_kernel_coeffs",
    "ndft_adjoint",
    "ndft_forward",
    "ndft_fastsum",
    "exact_trigonometric_matrix",
    "exact_gaussian_matrix",
    "GramMatrix",
    "AdjacencyMatrix",
    "GaussianKernel",
    "RadialKernel",
    "LaplaceKernel",
    "MaternKernel",
    "InverseMultiquadricKernel",
]

_CPU = torch.device("cpu")


def _device_of(*args) -> torch.device:
    """The device of the first tensor among ``args``; the CPU if none is."""
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return _CPU


def _detached(t):
    return t.detach() if isinstance(t, torch.Tensor) else t


class _NfftAdjointFunction(torch.autograd.Function):
    """Mirror of the upstream ``NfftAdjointFunction`` (nfft.py:8-28)."""

    @staticmethod
    def forward(ctx, x, pos, batch, bandwidth, cutoff, real_output):
        dev = _device_of(x, pos)
        ctx.pos, ctx.batch = _detached(pos), _detached(batch)
        ctx.cutoff, ctx.device = cutoff, dev
        ctx.real_input = not x.is_complex()
        return _nfft.nfft_adjoint(x, ctx.pos, ctx.batch, bandwidth=bandwidth, cutoff=cutoff,
                                  real_output=real_output, device=dev)

    @staticmethod
    def backward(ctx, dy):
        dx = _nfft.nfft_forward(dy, ctx.pos, ctx.batch, cutoff=ctx.cutoff,
                                real_output=ctx.real_input, device=ctx.device)
        return dx, None, None, None, None, None


def nfft_adjoint(x, pos, batch=None, bandwidth=16, cutoff=3, real_output=False):
    """Upstream-parity adjoint NFFT on torch tensors (nfft.py:31)."""
    return _NfftAdjointFunction.apply(x, pos, batch, bandwidth, cutoff, real_output)


class _NfftForwardFunction(torch.autograd.Function):
    """Mirror of the upstream ``NfftForwardFunction`` (nfft.py:34-54)."""

    @staticmethod
    def forward(ctx, x, pos, batch, cutoff, real_output):
        dev = _device_of(x, pos)
        ctx.pos, ctx.batch = _detached(pos), _detached(batch)
        ctx.cutoff, ctx.device = cutoff, dev
        ctx.bandwidth = x.size(1)
        ctx.real_input = not x.is_complex()
        return _nfft.nfft_forward(x, ctx.pos, ctx.batch, cutoff=cutoff,
                                  real_output=real_output, device=dev)

    @staticmethod
    def backward(ctx, dy):
        dx = _nfft.nfft_adjoint(dy, ctx.pos, ctx.batch, bandwidth=ctx.bandwidth,
                                cutoff=ctx.cutoff, real_output=ctx.real_input,
                                device=ctx.device)
        return dx, None, None, None, None


def nfft_forward(x, pos, batch=None, cutoff=3, real_output=False):
    """Upstream-parity forward NFFT on torch tensors (nfft.py:57)."""
    return _NfftForwardFunction.apply(x, pos, batch, cutoff, real_output)


class _NfftFastsumFunction(torch.autograd.Function):
    """Mirror of the upstream ``NfftFastsumFunction`` (nfft.py:62-88)."""

    @staticmethod
    def forward(ctx, x, coeffs, sources, targets, source_batch, target_batch, cutoff):
        for t, what in (
            (coeffs, "coefficients"),
            (sources, "sources"),
            (targets, "targets"),
            (source_batch, "batches"),
            (target_batch, "batches"),
        ):
            assert not (isinstance(t, torch.Tensor) and t.requires_grad), (
                f"NfftFastsum: Gradient computation w.r.t. {what} is not "
                "possible through torch_compat; use "
                "torch_nfft_tpu_torch.nfft_fastsum for position/coefficient gradients"
            )
        dev = _device_of(x, sources)
        ctx.args = (coeffs, sources, targets, source_batch, target_batch)
        ctx.cutoff, ctx.device = cutoff, dev
        return _nfft.nfft_fastsum(x, *ctx.args, cutoff=cutoff, device=dev)

    @staticmethod
    def backward(ctx, dy):
        coeffs, sources, targets, source_batch, target_batch = ctx.args
        dx = _nfft.nfft_fastsum(dy, coeffs, targets, sources, target_batch, source_batch,
                                cutoff=ctx.cutoff, device=ctx.device)
        return dx, None, None, None, None, None, None


def nfft_fastsum(x, coeffs, sources, targets=None, source_batch=None,
                 target_batch=None, /, batch=None, cutoff=3):
    """Upstream-parity fast kernel summation on torch tensors (nfft.py:91);
    arg normalization mirrors nfft.py:171-177."""
    if targets is None:
        targets = sources
        target_batch = source_batch
    if batch is not None:
        source_batch = batch
        target_batch = batch
    return _NfftFastsumFunction.apply(
        x, coeffs, sources, targets, source_batch, target_batch, cutoff
    )


def gaussian_analytic_coeffs(sigma, dim=3, N=16):
    """Upstream coeffs.py:10, on the CPU."""
    return _coeffs.gaussian_analytic_coeffs(sigma, dim=dim, N=N, device=_CPU)


def gaussian_interpolated_coeffs(sigma, dim=3, N=16, p=-1, eps=0.0):
    """Upstream coeffs.py:14, on the CPU."""
    return _coeffs.gaussian_interpolated_coeffs(sigma, dim=dim, N=N, p=p, eps=eps,
                                                device=_CPU)


def interpolation_grid(dim=3, N=16):
    """Upstream coeffs.py:18, on the CPU."""
    return _coeffs.interpolation_grid(dim=dim, N=N, device=_CPU)


def radial_interpolation_grid(dim=3, N=16):
    """Upstream coeffs.py:22, on the CPU."""
    return _coeffs.radial_interpolation_grid(dim=dim, N=N, device=_CPU)


def interpolated_kernel_coeffs(grid_values):
    """Upstream coeffs.py:26, on the device of ``grid_values``."""
    return _coeffs.interpolated_kernel_coeffs(grid_values, device=_device_of(grid_values))


def ndft_adjoint(x, pos, batch=None, N=16):
    """Dense oracle, upstream ndft.py:4 (no autograd)."""
    with torch.no_grad():
        return _ndft.ndft_adjoint(_detached(x), _detached(pos), batch, N=N)


def ndft_forward(x, pos, batch=None):
    """Dense oracle, upstream ndft.py:26 (no autograd)."""
    with torch.no_grad():
        return _ndft.ndft_forward(_detached(x), _detached(pos), batch)


def ndft_fastsum(x, coeffs, sources, targets=None, source_batch=None,
                 target_batch=None, batch=None, N=16):
    """Dense oracle, upstream ndft.py:48 (no autograd)."""
    with torch.no_grad():
        return _ndft.ndft_fastsum(_detached(x), coeffs, sources, targets, source_batch,
                                  target_batch, batch=batch, N=N)


def exact_trigonometric_matrix(coeffs, sources, targets=None,
                               source_batch=None, target_batch=None, /,
                               batch=None):
    """Dense oracle, upstream ndft.py:66."""
    return _ndft.exact_trigonometric_matrix(coeffs, sources, targets, source_batch,
                                            target_batch, batch=batch)


def exact_gaussian_matrix(sigma, sources, targets=None, source_batch=None,
                          target_batch=None, batch=None):
    """Dense oracle, upstream ndft.py:98."""
    return _ndft.exact_gaussian_matrix(sigma, sources, targets, source_batch, target_batch,
                                       batch=batch)


# ---------------------------------------------------------------------------
# Class layer: GramMatrix / AdjacencyMatrix / kernels over this package's
# operators (models/), which own the math: plans built once per operator,
# degrees with the negative-degree warning, the upstream library's two fixed
# faults (is_symmetric, apply_shift). The layer adds the upstream autograd
# contract: every operator is linear, so the backward of ``A @ x`` is
# ``A.T @ dy`` (upstream matrices.py:5-175, kernel.py:69-126).
# ---------------------------------------------------------------------------


class _OperatorMatvec(torch.autograd.Function):
    """Autograd through a matvec with a linear operator: x only."""

    @staticmethod
    def forward(ctx, x, op, op_T):
        ctx.op_T = op_T
        return op.apply(x)

    @staticmethod
    def backward(ctx, dy):
        return ctx.op_T.apply(dy), None, None


class _TorchMatrix:
    """Torch-facing mirror of the upstream AbstractMatrix (matrices.py:5-37),
    delegating to one of this package's operators held in ``_op``."""

    def __init__(self, op):
        self._op = op
        self._op_T = None  # the transposed operator, built once (its plans too)
        self.shape = tuple(op.shape)
        self.device = op.device

    def _transposed(self):
        if self._op_T is None:
            self._op_T = self._op.T
        return self._op_T

    def apply(self, x):
        return _OperatorMatvec.apply(x, self._op, self._transposed())

    def __matmul__(self, x):
        return self.apply(x)

    def is_symmetric(self):
        return self._op.is_symmetric()

    def transpose(self):
        if self.is_symmetric():
            return self
        # a generic transposed view (matvec + sums); subclass-specific
        # attributes (sources/targets, ...) live on the original operator
        return _TorchMatrix(self._transposed())

    @property
    def T(self):
        return self.transpose()

    def row_sums(self):
        return self.apply(torch.ones(self.shape[1], device=self.device))

    def column_sums(self):
        return self.T.row_sums()

    def to_dense(self):
        return self.apply(torch.eye(self.shape[1], device=self.device))


class GramMatrix(_TorchMatrix):
    """Upstream-parity lazy Gram matrix on torch tensors (matrices.py:40-70).

    ``(matrix @ x)[t] ~= sum_s K(sources[s] - targets[t]) x[s]`` by the
    fastsum, on the device of ``sources``; matvecs carry torch autograd
    (the backward applies the transposed operator, sources and targets
    swapped — nfft.py:82-88)."""

    def __init__(self, coeffs, sources, targets=None, source_batch=None,
                 target_batch=None, /, batch=None, cutoff=3):
        # torch-identity symmetry, like the C++ sources.is_same(targets)
        # (core_cuda.cu:552); the upstream Python check is the known
        # always-True fault (matrices.py:65).
        if targets is sources:
            targets = None
            target_batch = source_batch
        op = _matrices.GramMatrix(
            _detached(coeffs), _detached(sources), _detached(targets), source_batch,
            target_batch, batch=batch, cutoff=cutoff, device=_device_of(sources),
        )
        self._adopt(op, coeffs, sources, targets, source_batch, target_batch, None, cutoff)

    def _adopt(self, op, coeffs, sources, targets, source_batch, target_batch, batch,
               cutoff):
        """Wrap ``op`` with the upstream attributes."""
        _TorchMatrix.__init__(self, op)
        self.coeffs = coeffs
        self.sources = sources
        self.targets = sources if targets is None else targets
        self.source_batch = batch if batch is not None else source_batch
        self.target_batch = batch if batch is not None else (
            target_batch if targets is not None else source_batch)
        self.cutoff = cutoff


class AdjacencyMatrix(_TorchMatrix):
    """Upstream-parity graph adjacency operator (matrices.py:74-175):
    diagonal (self-loop) offset, "sym"/"left"/"right"/"rw" degree
    normalization, Laplacian / signless shift, degree threshold warning."""

    def __init__(self, gram_matrix, diagonal_offset=0, normalization=None,
                 shift=None, degree_threshold=0):
        if not isinstance(gram_matrix, GramMatrix):
            raise TypeError(
                "AdjacencyMatrix expects a torch_compat.GramMatrix; build one "
                "via GramMatrix(...) or GaussianKernel(...).gram_matrix(...)"
            )
        op = _matrices.AdjacencyMatrix(
            gram_matrix._op, diagonal_offset=diagonal_offset,
            normalization=normalization, shift=shift,
            degree_threshold=degree_threshold,
        )
        super().__init__(op)
        self.gram_matrix = gram_matrix
        self.diagonal_offset = diagonal_offset
        self.normalization = op.normalization
        self.shift = op.shift


class _KernelFrontend:
    """Shared torch front end over one of this package's kernels, producing
    :class:`GramMatrix` / :class:`AdjacencyMatrix`. The kernel is built on
    the device of the first point set it is given, and once more on each
    other device it is given points on, its coefficients computed there as
    this package computes them; its attributes (``coeffs``, ``cutoff``,
    ``factor``, ...) are those of the first kernel built, and reading one
    before any point set builds the kernel on the CPU."""

    _ATTRS = ("coeffs", "cutoff", "shift_by_center", "scale_by_norm", "factor", "sigma",
              "nu", "profile")

    def _adopt(self, factory, *args, **kwargs):
        self._build = lambda dev: factory(*args, **kwargs, device=dev)
        self._kernels = {}

    def _kernel_on(self, dev: torch.device):
        if dev not in self._kernels:
            self._kernels[dev] = self._build(dev)
        return self._kernels[dev]

    def __getattr__(self, name):
        if name not in _KernelFrontend._ATTRS or "_kernels" not in self.__dict__:
            raise AttributeError(name)
        first = next(iter(self._kernels.values())) if self._kernels else self._kernel_on(_CPU)
        return getattr(first, name)

    def gram_matrix(self, sources, targets=None, source_batch=None,
                    target_batch=None, /, batch=None):
        """kernel.py:99-116 on torch tensors; returns a torch GramMatrix on
        the device of ``sources``."""
        if targets is sources:
            targets = None
            target_batch = source_batch
        kernel = self._kernel_on(_device_of(sources))
        op = kernel.gram_matrix(_detached(sources), _detached(targets), source_batch,
                                target_batch, batch=batch)
        out = GramMatrix.__new__(GramMatrix)
        out._adopt(op, kernel.coeffs, sources, targets, source_batch, target_batch, batch,
                   kernel.cutoff)
        return out

    def __call__(self, *args, **kwargs):
        return self.gram_matrix(*args, **kwargs)

    def adjacency_matrix(self, sources, batch=None, loop_weight=1,
                         normalization=None, shift=None, degree_threshold=0):
        """kernel.py:123-126 on torch tensors."""
        return AdjacencyMatrix(
            self.gram_matrix(sources, batch=batch),
            diagonal_offset=loop_weight - 1, normalization=normalization,
            shift=shift, degree_threshold=degree_threshold,
        )


class GaussianKernel(_KernelFrontend):
    """Upstream-parity Gaussian kernel front end (kernel.py:69-126) on torch
    tensors: coefficients computed once, a GramMatrix / AdjacencyMatrix per
    point set, with both scaling modes (a-priori radius vs per-call
    scale-by-norm) and center shifting."""

    def __init__(self, sigma, dim=3, bandwidth=16, cutoff=3,
                 shift_by_center=True, max_euclidean_norm=None,
                 max_infinity_norm=None, analytic=False, reg_degree=-1,
                 reg_width=0.0, window="gaussian"):
        self._adopt(
            _kernel.GaussianKernel, sigma, dim=dim, bandwidth=bandwidth, cutoff=cutoff,
            shift_by_center=shift_by_center, max_euclidean_norm=max_euclidean_norm,
            max_infinity_norm=max_infinity_norm, analytic=analytic,
            reg_degree=reg_degree, reg_width=reg_width, window=window,
        )


class RadialKernel(_KernelFrontend):
    """Any radial profile on torch tensors (models/radial.py): the same
    operator surface as GaussianKernel."""

    _factory = _radial.RadialKernel

    def __init__(self, *args, **kwargs):
        self._adopt(type(self)._factory, *args, **kwargs)


class LaplaceKernel(RadialKernel):
    """exp(-r / sigma) on torch tensors."""

    _factory = _radial.LaplaceKernel


class MaternKernel(RadialKernel):
    """Matern kernel (nu in {0.5, 1.5, 2.5}) on torch tensors."""

    _factory = _radial.MaternKernel


class InverseMultiquadricKernel(RadialKernel):
    """1 / sqrt(1 + (r/sigma)^2) on torch tensors."""

    _factory = _radial.InverseMultiquadricKernel
