"""The PyTorch port's compatibility layer (``torch_nfft_tpu_torch.torch_compat``)
against the JAX package's (``torch_nfft_tpu.torch_compat``).

(a) Every one of the 20 names runs in both layers on the same seeded torch
tensors: outputs and ``x.grad`` agree to 1e-5 of the largest reference
entry. (b) The 16 cases of tests/test_torch_compat.py (the upstream
library's test suite driven through the layer) run on the port's layer with
their own oracle bars and finite-difference tolerances. (c) The gradient
contract: positions get no gradient, the fastsum refuses tensors other than
x that require grad, and results lie on the device of the inputs.
"""

import numpy as np
import pytest
import torch

import torch_nfft_tpu as tn
from torch_nfft_tpu import torch_compat as jc
from torch_nfft_tpu_torch import torch_compat as tc
from torch_nfft_tpu_torch.utils.points import scale_points_by_norm, shift_points_by_center


@pytest.fixture
def rng():
    return np.random.default_rng(3)


def _points(rng, n, dim):
    pos = torch.tensor((rng.random((n, dim)) - 0.5).astype(np.float32))
    pos /= 4 * pos.abs().max()
    return pos


def _normal(rng, *shape):
    return torch.tensor(rng.standard_normal(shape).astype(np.float32))


def assert_close(got, ref, frac=1e-5):
    """Same shape; max |got - ref| <= frac * max |ref|."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert float(np.abs(got - ref).max()) <= frac * float(np.abs(ref).max())


def test_same_names_as_the_jax_layer():
    assert tc.__all__ == jc.__all__
    assert all(callable(getattr(tc, name)) for name in tc.__all__)


# ---------------------------------------------------------------------------
# (a) each name in both layers
# ---------------------------------------------------------------------------


def _transform(mod, name, rng):
    """A seeded call of transform ``name`` of ``mod`` and ``x.grad`` of the
    sum of its squared magnitudes."""
    pos = _points(rng, 300, 2)
    batch = torch.arange(3).repeat_interleave(100)
    coeffs = tn.gaussian_analytic_coeffs(0.3, dim=2, N=16)
    if name == "nfft_adjoint":
        x = _normal(rng, 300, 2).requires_grad_()
        y = mod.nfft_adjoint(x, pos, batch, bandwidth=16, cutoff=4)
    elif name == "nfft_adjoint_complex":
        x = torch.complex(_normal(rng, 300, 2), _normal(rng, 300, 2)).requires_grad_()
        y = mod.nfft_adjoint(x, pos, bandwidth=16, cutoff=4, real_output=True)
    elif name == "nfft_forward":
        x = _normal(rng, 3, 16, 16, 2).requires_grad_()
        y = mod.nfft_forward(x, pos, batch, cutoff=4)
    elif name == "nfft_forward_complex":
        x = torch.complex(_normal(rng, 1, 16, 16), _normal(rng, 1, 16, 16)).requires_grad_()
        y = mod.nfft_forward(x, pos, cutoff=4)
    elif name == "nfft_fastsum":
        x = _normal(rng, 300, 2).requires_grad_()
        y = mod.nfft_fastsum(x, torch.from_numpy(np.array(coeffs)), pos, batch=batch,
                             cutoff=4)
    else:  # asymmetric: the backward swaps sources and targets
        x = _normal(rng, 300, 1).requires_grad_()
        y = mod.nfft_fastsum(x, torch.from_numpy(np.array(coeffs)), pos, _points(rng, 200, 2),
                             cutoff=4)
    (y.abs() ** 2).sum().backward()
    return y.detach(), x.grad


@pytest.mark.parametrize("name", ["nfft_adjoint", "nfft_adjoint_complex", "nfft_forward",
                                  "nfft_forward_complex", "nfft_fastsum",
                                  "nfft_fastsum_asymmetric"])
def test_transforms_and_gradients_match_the_jax_layer(name):
    """The three transforms, real and complex, batched and asymmetric: the
    output and x.grad of both layers."""
    ref_y, ref_g = _transform(jc, name, np.random.default_rng(5))
    got_y, got_g = _transform(tc, name, np.random.default_rng(5))
    assert got_y.dtype == ref_y.dtype and got_g.dtype == ref_g.dtype
    assert_close(got_y, ref_y)
    assert_close(got_g, ref_g)


_HELPERS = {
    "gaussian_analytic_coeffs": lambda m, rng: m.gaussian_analytic_coeffs(0.2, dim=2, N=16),
    "gaussian_interpolated_coeffs": lambda m, rng: m.gaussian_interpolated_coeffs(
        0.2, dim=2, N=16, p=2, eps=0.05),
    "interpolation_grid": lambda m, rng: m.interpolation_grid(dim=3, N=8),
    "radial_interpolation_grid": lambda m, rng: m.radial_interpolation_grid(dim=2, N=16),
    "interpolated_kernel_coeffs": lambda m, rng: m.interpolated_kernel_coeffs(
        torch.exp(-(m.radial_interpolation_grid(dim=2, N=16) / 0.2) ** 2)),
    "ndft_adjoint": lambda m, rng: m.ndft_adjoint(
        _normal(rng, 60, 2), _points(rng, 60, 2), torch.arange(2).repeat_interleave(30), N=8),
    "ndft_forward": lambda m, rng: m.ndft_forward(
        _normal(rng, 2, 8, 8, 3), _points(rng, 60, 2), torch.arange(2).repeat_interleave(30)),
    "ndft_fastsum": lambda m, rng: m.ndft_fastsum(
        _normal(rng, 60, 2), m.gaussian_analytic_coeffs(0.3, dim=2, N=8), _points(rng, 60, 2),
        _points(rng, 40, 2), N=8),
    "exact_trigonometric_matrix": lambda m, rng: m.exact_trigonometric_matrix(
        m.gaussian_analytic_coeffs(0.3, dim=2, N=8), _points(rng, 50, 2),
        batch=torch.arange(2).repeat_interleave(25)),
    "exact_gaussian_matrix": lambda m, rng: m.exact_gaussian_matrix(
        0.3, _points(rng, 50, 2), _points(rng, 30, 2)),
}


@pytest.mark.parametrize("name", list(_HELPERS))
def test_coefficient_helpers_and_oracles_match_the_jax_layer(name):
    """The coefficient helpers and the dense oracles of both layers on the
    same seeded inputs: CPU tensors of the same dtype and values."""
    ref = _HELPERS[name](jc, np.random.default_rng(7))
    got = _HELPERS[name](tc, np.random.default_rng(7))
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    assert_close(got, ref)


def _kernel_call(mod, name, rng):
    """A seeded operator of ``mod``: its matvec on two columns, x.grad of
    the squared sum, its dense transpose and its coefficients."""
    pos = _points(rng, 80, 2)
    if name == "GramMatrix":
        coeffs = mod.gaussian_analytic_coeffs(0.4, dim=2, N=16)
        A = mod.GramMatrix(coeffs, pos, _points(rng, 60, 2), cutoff=4)
    elif name == "AdjacencyMatrix":
        k = mod.GaussianKernel(0.8, dim=2, bandwidth=16, cutoff=4, analytic=True,
                               max_infinity_norm=1.0)
        A = mod.AdjacencyMatrix(k(pos), diagonal_offset=0.5, normalization="rw",
                                shift="signless")
    elif name == "GaussianKernel":
        A = mod.GaussianKernel(0.5, dim=2, bandwidth=16, cutoff=4)(
            pos, batch=torch.arange(2).repeat_interleave(40))
    elif name == "RadialKernel":
        A = mod.RadialKernel(lambda r: np.exp(-r * r / 0.3), dim=2, bandwidth=16, cutoff=4)(pos)
    elif name == "LaplaceKernel":
        A = mod.LaplaceKernel(sigma=0.7, dim=2, bandwidth=16, cutoff=4).adjacency_matrix(
            pos, normalization="sym")
    elif name == "MaternKernel":
        A = mod.MaternKernel(sigma=0.7, nu=2.5, dim=2, bandwidth=16, cutoff=4)(
            pos, _points(rng, 50, 2))
    else:
        A = mod.InverseMultiquadricKernel(sigma=0.5, dim=2, bandwidth=16, cutoff=4)(pos)
    x = _normal(rng, A.shape[1], 2).requires_grad_()
    y = A @ x
    (y ** 2).sum().backward()
    coeffs = getattr(A, "coeffs", None)
    return (y.detach(), x.grad, A.T.to_dense(), A.row_sums(), A.is_symmetric(),
            None if coeffs is None else torch.as_tensor(coeffs))


@pytest.mark.parametrize("name", ["GramMatrix", "AdjacencyMatrix", "GaussianKernel",
                                  "RadialKernel", "LaplaceKernel", "MaternKernel",
                                  "InverseMultiquadricKernel"])
def test_operators_match_the_jax_layer(name):
    """The operator classes and kernel front ends of both layers: the
    matvec, x.grad through it, the dense transpose, the row sums, the
    symmetry flag and the coefficients."""
    ref = _kernel_call(jc, name, np.random.default_rng(9))
    got = _kernel_call(tc, name, np.random.default_rng(9))
    for g, r in zip(got[:4], ref[:4]):
        assert_close(g.detach(), r.detach())
    assert got[4] == ref[4]
    if ref[5] is not None:
        assert_close(got[5], ref[5])


# ---------------------------------------------------------------------------
# (b) tests/test_torch_compat.py on the port's layer
# ---------------------------------------------------------------------------


def _oracle_case(rng, case):
    """(the layer's result, the dense oracle's) for one oracle case."""
    if case == "adjoint":  # test_adjoint.py:21-49: batched 2D adjoint
        n_per, b, c, N, m = 300, 3, 4, 16, 4
        pos = _points(rng, n_per * b, 2)
        batch = torch.arange(b).repeat_interleave(n_per)
        x = _normal(rng, n_per * b, c)
        y = tc.nfft_adjoint(x, pos, batch, bandwidth=N, cutoff=m)
        ref = tc.ndft_adjoint(x, pos, batch, N=N)
        assert y.shape == ref.shape == (b, N, N, c)
        return y, ref
    if case == "forward":  # test_forward.py:21-43
        pos = _points(rng, 40, 2)
        x = _normal(rng, 1, 16, 16, 2)
        return tc.nfft_forward(x, pos, cutoff=4), tc.ndft_forward(x, pos)
    pos = _points(rng, 50, 2)  # complex x through the layer
    x = torch.tensor((rng.standard_normal((50, 1)) + 1j * rng.standard_normal((50, 1)))
                     .astype(np.complex64))
    return tc.nfft_adjoint(x, pos, bandwidth=16, cutoff=4), tc.ndft_adjoint(x, pos, N=16)


@pytest.mark.parametrize("case", ["adjoint", "forward", "complex_adjoint"])
def test_transforms_match_oracle(rng, case):
    """The upstream oracle tests: rel-L2 against the dense NDFT < 1e-3."""
    y, ref = _oracle_case(rng, case)
    rel = torch.linalg.norm(y - ref) / torch.linalg.norm(ref)
    assert float(rel) < 1e-3


def _fd_case(rng, case):
    """(loss function of x, x, the entry to perturb) of one
    finite-difference case."""
    if case == "adjoint":  # test_grad.py:23-46
        pos = _points(rng, 25, 2)
        return (lambda x: tc.nfft_adjoint(x, pos, bandwidth=8, cutoff=4).abs().sum(),
                _normal(rng, 25, 1), [(0, 0), (7, 0), (19, 0)])
    if case == "forward":  # test_grad.py:50-73
        pos = _points(rng, 30, 2)
        return (lambda x: tc.nfft_forward(x, pos, cutoff=4).abs().sum(),
                _normal(rng, 1, 8, 8, 1), [(0, 3, 5, 0)])
    if case == "fastsum":  # nfft.py:83-88: the backward is the transposed fastsum
        pos = _points(rng, 30, 2)
        coeffs = tc.gaussian_analytic_coeffs(1.0, dim=2, N=8)
        return (lambda x: (tc.nfft_fastsum(x, coeffs, pos, cutoff=3) ** 2).sum(),
                _normal(rng, 30, 1), [(4, 0)])
    pos = _points(rng, 25, 2)  # the class matvec: backward = A^T dy
    matrix = tc.GaussianKernel(0.8, dim=2, bandwidth=8, cutoff=3, analytic=True,
                               max_infinity_norm=1.0)(pos)
    return lambda x: ((matrix @ x) ** 2).sum(), _normal(rng, 25, 1), [(11, 0)]


@pytest.mark.parametrize("case", ["adjoint", "forward", "fastsum", "matvec"])
def test_grad_matches_fd(rng, case):
    """Finite differences through torch autograd, the upstream bar:
    |fd - grad| < 5e-2 max(1, |fd|) at eps 1e-3."""
    loss_of, x, entries = _fd_case(rng, case)
    x.requires_grad_(True)
    loss = loss_of(x)
    loss.backward()
    assert x.grad is not None and x.grad.shape == x.shape
    eps = 1e-3
    for idx in entries:
        xp = x.detach().clone()
        xp[idx] += eps
        fd = (float(loss_of(xp)) - float(loss)) / eps
        assert abs(fd - float(x.grad[idx])) < 5e-2 * max(1.0, abs(fd))


def test_fastsum_vs_exact_matrices(rng):
    """test_fastsum.py:20-46: the dense fastsum matrix against the exact
    Gaussian matrix and the trigonometric truncation oracle."""
    n, dim, N, m, sigma = 60, 2, 8, 3, 0.2
    pos = _points(rng, n, dim)
    coeffs = tc.gaussian_analytic_coeffs(sigma, dim=dim, N=N)
    dense = tc.nfft_fastsum(torch.eye(n), coeffs, pos, cutoff=m)
    exact_trig = tc.exact_trigonometric_matrix(coeffs, pos)
    exact_gauss = tc.exact_gaussian_matrix(sigma, pos)
    assert float((dense - exact_trig).abs().max()) < 5e-3
    assert float((exact_trig - exact_gauss.to(exact_trig.dtype)).abs().max()) < 5e-2


def test_fastsum_rejects_point_grads(rng):
    pos = _points(rng, 20, 2)
    pos.requires_grad_(True)
    coeffs = tc.gaussian_analytic_coeffs(1.0, dim=2, N=8)
    with pytest.raises(AssertionError, match="sources"):
        tc.nfft_fastsum(torch.zeros((20, 1)), coeffs, pos, cutoff=3)


def test_coeff_helpers_roundtrip():
    """interpolated_kernel_coeffs of Gaussian samples ~ the analytic
    coefficients (sigma small enough for the Gaussian to fit the box)."""
    dim, N, sigma = 2, 16, 0.15
    grid = tc.interpolation_grid(dim=dim, N=N)
    r2 = (grid ** 2).sum(-1)
    interp = tc.interpolated_kernel_coeffs(torch.exp(-r2 / sigma**2))
    analytic = tc.gaussian_analytic_coeffs(sigma, dim=dim, N=N)
    assert torch.allclose(interp.real.to(torch.float32), analytic, atol=1e-5, rtol=0)
    assert torch.allclose(tc.radial_interpolation_grid(dim=dim, N=N), r2.sqrt(), atol=1e-6)


def test_gaussian_kernel_to_dense_matches_exact(rng):
    """test_kernel.py:22-54: GaussianKernel end to end, batched, both
    scaling modes, to_dense against the exact Gaussian matrix."""
    n_per, b, dim, N, m = 15, 2, 2, 16, 4
    n = n_per * b
    diameter = 10.0
    pos = torch.tensor((diameter * (rng.random((n, dim)) - 0.5)).astype(np.float32))
    batch = torch.arange(b).repeat_interleave(n_per)

    kernel = tc.GaussianKernel(diameter, dim=dim, bandwidth=N, cutoff=m,
                               shift_by_center=True, max_infinity_norm=diameter / 2)
    matrix = kernel(pos, batch=batch)
    assert isinstance(matrix, tc.GramMatrix)
    assert matrix.is_symmetric()
    exact = tc.exact_gaussian_matrix(diameter, pos, batch=batch)
    assert float((matrix.to_dense() - exact).abs().max() / exact.abs().max()) < 5e-2

    kernel = tc.GaussianKernel(1.0, dim=dim, bandwidth=N, cutoff=m)
    dense = kernel(pos, batch=batch).to_dense()
    shifted = shift_points_by_center(pos, batch=batch, device="cpu")[0]
    scaled = scale_points_by_norm(shifted, batch=batch, norm="infinity", device="cpu")[0]
    exact = tc.exact_gaussian_matrix(1.0, scaled.numpy(), batch=batch)
    assert float((dense - exact).abs().max() / exact.abs().max()) < 5e-2


def test_gram_matrix_class_symmetry_and_transpose(rng):
    n, dim, N = 25, 2, 8
    src = _points(rng, n, dim)
    tgt = _points(rng, n + 5, dim)
    coeffs = tc.gaussian_analytic_coeffs(0.7, dim=dim, N=N)
    assert tc.GramMatrix(coeffs, src, src).is_symmetric()  # same tensor
    asym = tc.GramMatrix(coeffs, src, tgt)
    assert not asym.is_symmetric()
    assert asym.shape == (n + 5, n)
    dense = asym.to_dense()
    assert torch.allclose(asym.T.to_dense(), dense.T, atol=1e-5)
    assert torch.allclose(asym.column_sums(), dense.sum(0), atol=1e-4)


def test_adjacency_matrix_class_pipeline(rng):
    """The sym-normalised Laplacian matvec against the dense computation
    from the Gram matrix's to_dense (upstream matrices.py:74-175, the
    apply_shift fault fixed)."""
    n = 30
    pos = _points(rng, n, 2)
    kernel = tc.GaussianKernel(0.8, dim=2, bandwidth=8, cutoff=3, analytic=True,
                               max_infinity_norm=1.0)
    adj = kernel.adjacency_matrix(pos, loop_weight=2.0, normalization="sym",
                                  shift="laplacian")
    a_dense = kernel(pos).to_dense().double() + torch.eye(n).double()
    dinv = a_dense.sum(1).rsqrt()
    lap = torch.eye(n).double() - dinv[:, None] * a_dense * dinv[None, :]
    x = _normal(rng, n, 2)
    assert float(((adj @ x) - (lap @ x.double()).to(torch.float32)).abs().max()) < 1e-4
    assert adj.is_symmetric()


def test_adjacency_left_normalization_transpose(rng):
    n = 24
    pos = _points(rng, n, 2)
    kernel = tc.GaussianKernel(0.8, dim=2, bandwidth=8, cutoff=3, analytic=True,
                               max_infinity_norm=1.0)
    adj = kernel.adjacency_matrix(pos, normalization="rw")
    assert not adj.is_symmetric()
    dense = adj.to_dense()
    assert torch.allclose(adj.T.to_dense(), dense.T, atol=1e-5)
    assert torch.allclose(dense.sum(1), torch.ones(n), atol=1e-4)  # rows of a walk sum to 1


def test_radial_kernels_match_the_jax_kernels(rng):
    """The layer's radial front ends give the dense operators of the JAX
    package's RadialKernel family."""
    pos_np = ((rng.random((40, 2)) * 2 - 1) * 3.0).astype(np.float32)
    for tc_cls, tn_cls, kwargs in [
        (tc.LaplaceKernel, tn.LaplaceKernel, dict(sigma=1.0)),
        (tc.MaternKernel, tn.MaternKernel, dict(sigma=1.0, nu=1.5)),
        (tc.InverseMultiquadricKernel, tn.InverseMultiquadricKernel, dict(sigma=1.0)),
    ]:
        A_t = tc_cls(dim=2, bandwidth=16, cutoff=4, **kwargs)(torch.tensor(pos_np)).to_dense()
        A_j = np.asarray(tn_cls(dim=2, bandwidth=16, cutoff=4, **kwargs)(pos_np).to_dense())
        assert isinstance(A_t, torch.Tensor)
        assert np.abs(A_t.numpy() - A_j).max() < 1e-6


def test_radial_custom_profile_and_matvec_autograd(rng):
    pos = torch.tensor((rng.random((30, 2)) * 2 - 1).astype(np.float32))
    mat = tc.RadialKernel(lambda r: np.exp(-r * r), dim=2, bandwidth=16, cutoff=4)(pos)
    x = torch.tensor(rng.standard_normal((30,)).astype(np.float32), requires_grad=True)
    (mat @ x).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


# ---------------------------------------------------------------------------
# (c) the gradient contract and the device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["adjoint", "forward", "gram"])
def test_positions_get_no_gradient(rng, entry):
    """Gradients reach x only: a position tensor that requires grad keeps
    ``grad`` None, as upstream, and x.grad is what it is without it."""
    pos = _points(rng, 40, 2)
    grads = []
    for p in (pos.clone().requires_grad_(), pos):
        if entry == "forward":
            x = _normal(np.random.default_rng(0), 1, 8, 8, 1).requires_grad_()
            y = tc.nfft_forward(x, p, cutoff=3)
        elif entry == "adjoint":
            x = _normal(np.random.default_rng(0), 40, 1).requires_grad_()
            y = tc.nfft_adjoint(x, p, bandwidth=8, cutoff=3)
        else:
            x = _normal(np.random.default_rng(0), 40, 1).requires_grad_()
            y = tc.GaussianKernel(0.5, dim=2, bandwidth=8, cutoff=3)(p) @ x
        (y.abs() ** 2).sum().backward()
        assert p.grad is None
        grads.append(x.grad)
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("what", ["coefficients", "targets", "batches"])
def test_fastsum_refuses_other_gradients(rng, what):
    """The fastsum's assertion (upstream nfft.py:66-73) for every input but
    x, with the upstream message and this package's pointer."""
    pos = _points(rng, 20, 2)
    coeffs = tc.gaussian_analytic_coeffs(1.0, dim=2, N=8)
    targets, batch = None, None
    if what == "coefficients":
        coeffs = coeffs.clone().requires_grad_()
    elif what == "targets":
        targets = _points(rng, 10, 2).requires_grad_()
    else:
        batch = torch.zeros(20).requires_grad_()
    with pytest.raises(AssertionError, match=f"w.r.t. {what} is not possible through "
                       "torch_compat; use torch_nfft_tpu_torch.nfft_fastsum"):
        tc.nfft_fastsum(torch.zeros((20, 1)), coeffs, pos, targets, batch=batch, cutoff=3)


def test_results_lie_on_the_input_device(rng):
    """CPU tensors give CPU results without a card and without a device
    argument; the row sums and the dense matrix are built there too."""
    pos = _points(rng, 30, 2)
    x = _normal(rng, 30, 1)
    for y in (tc.nfft_adjoint(x, pos, bandwidth=8), tc.nfft_forward(
            _normal(rng, 1, 8, 8, 1), pos), tc.nfft_fastsum(
            x, tc.gaussian_analytic_coeffs(0.5, dim=2, N=8), pos)):
        assert y.device.type == "cpu"
    G = tc.GaussianKernel(0.5, dim=2, bandwidth=8)(pos)
    assert G.device.type == "cpu"
    assert G.row_sums().device.type == G.to_dense().device.type == "cpu"


def test_kernel_front_end_builds_on_the_points_device(rng):
    """A kernel front end builds no kernel until it is given points (or its
    attributes are read), then this package's kernel on the points' device:
    its coefficients, attributes and Gram matvec are those of the package's
    own kernel, bit for bit."""
    from torch_nfft_tpu_torch.models import radial

    kw = dict(sigma=0.7, nu=2.5, dim=2, bandwidth=16, cutoff=4)
    k = tc.MaternKernel(**kw)
    assert not k._kernels
    pos, x = _points(rng, 300, 2), _normal(rng, 300, 2)
    y = k(pos) @ x
    assert list(k._kernels) == [torch.device("cpu")]
    own = radial.MaternKernel(**kw, device="cpu")
    assert torch.equal(k.coeffs, own.coeffs) and torch.equal(y, own(pos) @ x)
    assert (k.cutoff, k.factor, k.nu, k.scale_by_norm) == (4, own.factor, 2.5,
                                                           own.scale_by_norm)
    fresh = tc.GaussianKernel(0.5, dim=2, bandwidth=8)
    assert fresh.coeffs.device.type == "cpu" and list(fresh._kernels) == [torch.device("cpu")]
    with pytest.raises(AttributeError):
        fresh.nu
