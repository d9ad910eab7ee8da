"""PyTorch port vs JAX package: the radial kernels (``RadialKernel``,
``LaplaceKernel``, ``MaternKernel``, ``InverseMultiquadricKernel``), their
coefficients, Gram and adjacency operators, and radial kernels carried
across with ``operator_from_numpy`` (the cases of tests/test_radial.py).

Coefficients and matvecs agree to 1e-5 of the largest entry; against the
dense oracles the port meets the JAX tests' own bars.
"""

import numpy as np
import pytest
import torch
from helpers import max_err

import torch_nfft_tpu as tn
import torch_nfft_tpu_torch as tp

REL = 1e-5


def assert_close(got, ref, rel=REL):
    """max |got - ref| <= rel * max |ref|."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= rel * float(np.abs(ref).max())


def _points(rng, n=60, dim=2, spread=3.0, batches=1):
    pts = ((rng.random((n * batches, dim)) * 2 - 1) * spread).astype(np.float32)
    batch = None if batches <= 1 else (np.arange(n * batches) // n).astype(np.int32)
    return pts, batch


def _gauss(r):
    return np.exp(-np.asarray(r, dtype=np.float64) ** 2)


KERNELS = {
    # name: (JAX factory, port factory) of (keywords) -> kernel
    "radial": (lambda **kw: tn.RadialKernel(_gauss, **kw),
               lambda **kw: tp.RadialKernel(_gauss, **kw)),
    "laplace": (lambda **kw: tn.LaplaceKernel(0.8, **kw),
                lambda **kw: tp.LaplaceKernel(0.8, **kw)),
    "matern0.5": (lambda **kw: tn.MaternKernel(1.0, nu=0.5, **kw),
                  lambda **kw: tp.MaternKernel(1.0, nu=0.5, **kw)),
    "matern1.5": (lambda **kw: tn.MaternKernel(1.0, nu=1.5, **kw),
                  lambda **kw: tp.MaternKernel(1.0, nu=1.5, **kw)),
    "matern2.5": (lambda **kw: tn.MaternKernel(1.0, nu=2.5, **kw),
                  lambda **kw: tp.MaternKernel(1.0, nu=2.5, **kw)),
    "imq": (lambda **kw: tn.InverseMultiquadricKernel(1.0, **kw),
            lambda **kw: tp.InverseMultiquadricKernel(1.0, **kw)),
}
MODES = {
    "scale_by_norm": {},
    "apriori": {"max_infinity_norm": 3.5},
    "regularized": {"reg_degree": 2, "reg_width": 0.125},
    "regularized_apriori": {"reg_degree": 1, "reg_width": 0.1, "max_euclidean_norm": 4.5},
}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", list(KERNELS))
def test_coefficients_and_matvec_match_jax(rng, name, mode):
    """The coefficients (float64 samples, the Hermite flattening, the
    interpolation FFT) and the Gram matrix's matvec, each class with and
    without regularisation, per-call and a-priori scaling."""
    jf, pf = KERNELS[name]
    kw = dict(dim=2, bandwidth=16, cutoff=4, **MODES[mode])
    jk, pk = jf(**kw), pf(device="cpu", **kw)
    assert (pk.scale_by_norm, pk.factor) == (jk.scale_by_norm, jk.factor)
    assert isinstance(pk, torch.nn.Module) and pk.coeffs.dtype == torch.complex64
    assert_close(pk.coeffs.numpy(), jk.coeffs)
    pos, _ = _points(rng)
    x = rng.standard_normal((len(pos), 2)).astype(np.float32)
    assert_close((pk(pos) @ x).numpy(), jk(pos) @ x)


@pytest.mark.parametrize("dim", [1, 3])
def test_other_dims_match_jax(rng, dim):
    jk = tn.MaternKernel(0.7, nu=2.5, dim=dim, bandwidth=16 if dim == 1 else 8, cutoff=3)
    pk = tp.MaternKernel(0.7, nu=2.5, dim=dim, bandwidth=16 if dim == 1 else 8, cutoff=3,
                         device="cpu")
    assert_close(pk.coeffs.numpy(), jk.coeffs)
    pos, _ = _points(rng, 80, dim)
    x = rng.standard_normal((80, 1)).astype(np.float32)
    assert_close((pk(pos) @ x).numpy(), jk(pos) @ x)


def _norm_scaled_oracle(kernel, pos, batch=None):
    """The dense profile matrix on the shifted, norm-scaled points (the
    port's utilities and oracle; the profile takes NumPy, the oracle
    tensors)."""
    src, _ = tp.shift_points_by_center(pos, None, batch, batch, device="cpu")
    src, _ = tp.scale_points_by_norm(src, None, batch, batch, factor=1.0,
                                     norm=kernel.scale_by_norm, device="cpu")
    return tp.exact_radial_matrix(lambda r: torch.from_numpy(kernel.profile(r.numpy())),
                                  src, batch=batch).numpy()


@pytest.mark.parametrize("nu,tol", [(0.5, 5e-2), (1.5, 2e-2), (2.5, 2e-2)])
def test_matern_against_the_dense_profile(rng, nu, tol):
    kernel = tp.MaternKernel(1.0, nu=nu, dim=2, bandwidth=16, cutoff=4, device="cpu")
    pos, _ = _points(rng)
    assert max_err(kernel(pos).to_dense().numpy(), _norm_scaled_oracle(kernel, pos)) < tol


def test_nfft_error_isolated_from_truncation(rng):
    """Against the dense trigonometric matrix of the same coefficients the
    port's machinery is near exact (1e-4, the JAX test's bar)."""
    kernel = tp.MaternKernel(1.0, nu=1.5, dim=2, bandwidth=16, cutoff=4, device="cpu")
    pos, _ = _points(rng)
    A = kernel(pos).to_dense().numpy()
    src, _ = tp.shift_points_by_center(pos, device="cpu")
    src, _ = tp.scale_points_by_norm(src, factor=kernel.factor, norm=kernel.scale_by_norm,
                                     device="cpu")
    A_trig = tp.exact_trigonometric_matrix(kernel.coeffs, src).real.numpy()
    assert max_err(A, A_trig) < 1e-4


def test_apriori_radius_mode_original_units(rng):
    pos, _ = _points(rng, 60, 2, spread=2.0)
    radius = float(np.abs(pos - pos.mean(0)).max()) * 1.01
    kernel = tp.MaternKernel(2.0, nu=1.5, dim=2, bandwidth=32, cutoff=4,
                             max_infinity_norm=radius, device="cpu")
    A = kernel(pos).to_dense().numpy()
    src, _ = tp.shift_points_by_center(pos, device="cpu")
    A_exact = tp.exact_radial_matrix(lambda r: torch.from_numpy(kernel.profile(r.numpy())),
                                     src).numpy()
    assert max_err(A, A_exact) < 2e-2


def test_batched_block_diagonal_matches_jax(rng):
    jk = tn.LaplaceKernel(1.0, dim=2, bandwidth=32, cutoff=4)
    pk = tp.LaplaceKernel(1.0, dim=2, bandwidth=32, cutoff=4, device="cpu")
    pos, batch = _points(rng, 40, 2, batches=2)
    A = pk(pos, batch=batch).to_dense().numpy()
    assert_close(A, jk(pos, batch=batch).to_dense())
    assert np.abs(A[:40, 40:]).max() == 0.0
    assert max_err(A, _norm_scaled_oracle(pk, pos, batch)) < 5e-2


@pytest.mark.parametrize("normalization", ["sym", None])
def test_adjacency_matches_jax(rng, normalization):
    jk = tn.MaternKernel(1.0, nu=1.5, dim=2, bandwidth=16, cutoff=4)
    pk = tp.MaternKernel(1.0, nu=1.5, dim=2, bandwidth=16, cutoff=4, device="cpu")
    pos, _ = _points(rng, 50, 2)
    x = rng.standard_normal((50, 2)).astype(np.float32)
    ja = jk.adjacency_matrix(pos, loop_weight=0, normalization=normalization)
    pa = pk.adjacency_matrix(pos, loop_weight=0, normalization=normalization)
    assert_close((pa @ x).numpy(), ja @ x)


def test_matern_rejects_unsupported_nu():
    with pytest.raises(ValueError, match="nu"):
        tp.MaternKernel(1.0, nu=1.0, device="cpu")


def test_regularized_requires_width():
    with pytest.raises(ValueError, match="reg_width"):
        tp.LaplaceKernel(1.0, dim=2, bandwidth=16, reg_degree=2, reg_width=0.0,
                         max_euclidean_norm=1.0, device="cpu")


def test_slot_path_with_complex_coefficients(rng):
    """apply_slot and solve with the interpolated (complex) coefficients
    match the user-order matvec, as in the JAX package (from 2048 points
    the operator plans for its matvecs too)."""
    kernel = tp.MaternKernel(0.8, nu=1.5, dim=2, bandwidth=16, cutoff=3, device="cpu")
    jk = tn.MaternKernel(0.8, nu=1.5, dim=2, bandwidth=16, cutoff=3)
    pos, _ = _points(rng, 70, 2)
    G = kernel(pos)
    v = rng.standard_normal(70).astype(np.float32)
    want = (G @ v).numpy()
    assert_close(want, jk(pos) @ v)
    got = G.from_slot(G.apply_slot(G.to_slot(v))).numpy()[:, 0]
    assert_close(got, want, 2e-5)
    z = G.solve(v, reg=1e-1)
    resid = (G @ z).numpy() + 1e-1 * z.numpy() - v
    assert np.linalg.norm(resid) / np.linalg.norm(v) < 1e-4


def _numpy_pair(obj):
    """``tree_flatten()`` of a JAX object with its leaves as numpy arrays;
    an adjacency's Gram child as its own (children, aux) pair and its
    degree vectors by name."""
    if isinstance(obj, tn.AdjacencyMatrix):
        gram = _numpy_pair(obj.gram_matrix)
        arrays = {name: np.asarray(getattr(obj, name))
                  for name in tp.AdjacencyMatrix._DEGREE_FIELDS if hasattr(obj, name)}
        return (gram, arrays), (obj.shape, obj.diagonal_offset, obj.normalization, obj.shift)
    children, aux = obj.tree_flatten()
    return tuple(None if c is None else np.asarray(c) for c in children), aux


@pytest.mark.parametrize("case", ["radial", "laplace", "matern", "imq", "gram", "adjacency"])
def test_operator_from_numpy_carries_radial_kernels(rng, case):
    """A JAX radial kernel, its Gram operator and its adjacency operator,
    carried across from their tree_flatten() leaves: the port's object of
    the same class, coefficients taken as given, the same matvec."""
    kw = dict(dim=2, bandwidth=16, cutoff=4)
    jk = {"radial": lambda: tn.RadialKernel(_gauss, max_infinity_norm=3.5, **kw),
          "laplace": lambda: tn.LaplaceKernel(0.8, **kw),
          "imq": lambda: tn.InverseMultiquadricKernel(1.2, reg_degree=1, reg_width=0.1, **kw),
          }.get(case, lambda: tn.MaternKernel(1.0, nu=2.5, **kw))()
    pos, _ = _points(rng, 40, 2)
    x = rng.standard_normal((40, 2)).astype(np.float32)
    jobj = {"gram": lambda: jk(pos),
            "adjacency": lambda: jk.adjacency_matrix(pos, normalization="sym")}.get(
        case, lambda: jk)()
    obj = tp.operator_from_numpy(*_numpy_pair(jobj), device="cpu")
    if case in ("gram", "adjacency"):
        assert_close((obj @ x).numpy(), jobj @ x)
        return
    assert type(obj).__name__ == type(jk).__name__
    assert (obj.factor, obj.scale_by_norm) == (jk.factor, jk.scale_by_norm)
    assert np.array_equal(obj.coeffs.numpy(), np.asarray(jk.coeffs))
    for name in ("sigma", "nu"):
        assert getattr(obj, name, None) == getattr(jk, name, None)
    assert_close((obj(pos) @ x).numpy(), jk(pos) @ x)
    assert_close(obj.profile(np.linspace(0, 2, 9)), jk.profile(np.linspace(0, 2, 9)))


def test_exports_and_signatures_hold_to_jax():
    """The kernels are exported under the JAX package's names; their
    leading parameters and the operator methods' are JAX's (and
    torch_compat's)."""
    import inspect

    from torch_nfft_tpu import torch_compat
    from torch_nfft_tpu.models import radial as jradial

    for name in ("RadialKernel", "LaplaceKernel", "MaternKernel",
                 "InverseMultiquadricKernel"):
        assert name in tp.__all__ and name in tn.__all__
        assert hasattr(torch_compat, name)
    def public(fn):  # the port adds device=; both take a private _coeffs=
        return [(p.name, p.default, p.kind) for p in inspect.signature(fn).parameters.values()
                if not p.name.startswith("_") and p.name != "device"]

    assert public(tp.RadialKernel.__init__) == public(jradial.RadialKernel.__init__)
    for cls in ("MaternKernel", "_SigmaRadialKernel"):
        ref = list(inspect.signature(getattr(jradial, cls).__init__).parameters)
        got = list(inspect.signature(getattr(tp.models.radial, cls).__init__).parameters)
        assert got == ref, cls
    for meth in ("gram_matrix", "adjacency_matrix"):
        ref = list(inspect.signature(getattr(jradial.RadialKernel, meth)).parameters)
        got = list(inspect.signature(getattr(tp.RadialKernel, meth)).parameters)
        assert got[:len(ref)] == ref, meth
