"""PyTorch port vs JAX package: the Gaussian kernel, the Gram and adjacency
operators, the point utilities, and operators carried across with
``operator_from_numpy`` (the cases of tests/test_kernel.py and
tests/test_matrices.py).

Both packages' operators skip planning below 2048 points (the one-hot
matmul engine then runs). Their matvecs agree to 1e-5 of the output's
largest entry, and the port meets the JAX tests' own bars against the
dense oracles.
"""

import inspect
import warnings

import jax
import numpy as np
import pytest
import torch
from _torch_port import rel_l2
from helpers import make_points

import torch_nfft_tpu as tn
import torch_nfft_tpu_torch as tp
from torch_nfft_tpu import torch_compat

REL = 1e-5


def assert_close(got, ref, rel=REL):
    """max |got - ref| <= rel * max |ref|."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= rel * float(np.abs(ref).max())


def _prep_points(rng, n, dim, spread=3.0, batches=1):
    pts = ((rng.random((n * batches, dim)) * 2 - 1) * spread).astype(np.float32)
    batch = None if batches <= 1 else (np.arange(n * batches) // n).astype(np.int32)
    return pts, batch


def _expected_dense(kernel, pos, batch=None):
    """The dense Gaussian matrix on the kernel's shifted (and, per call,
    scaled) points, from the port's own utilities and oracle."""
    src, _ = tp.shift_points_by_center(pos, None, batch, batch, device="cpu")
    if kernel.scale_by_norm is not None:
        src, _ = tp.scale_points_by_norm(src, None, batch, batch, factor=1.0,
                                         norm=kernel.scale_by_norm, device="cpu")
    return tp.exact_gaussian_matrix(kernel.sigma, src, batch=batch).numpy()


KERNEL_MODES = {
    # name: (GaussianKernel keywords, bar against the dense Gaussian)
    "scale_by_norm": ({}, 5e-3),
    "analytic": ({"analytic": True}, 3e-2),
    "regularized": ({"reg_degree": 2, "reg_width": 0.125}, 2e-2),
}


@pytest.mark.parametrize("mode", list(KERNEL_MODES))
def test_kernel_modes_match_jax(rng, mode):
    kw, bar = KERNEL_MODES[mode]
    jk = tn.GaussianKernel(sigma=1.0, dim=2, bandwidth=16, cutoff=4, **kw)
    pk = tp.GaussianKernel(sigma=1.0, dim=2, bandwidth=16, cutoff=4, device="cpu", **kw)
    assert pk.scale_by_norm == jk.scale_by_norm and pk.factor == jk.factor
    assert_close(pk.coeffs.numpy(), jk.coeffs)
    pos, _ = _prep_points(rng, 50, 2)
    A = pk(pos).to_dense()
    assert A.dtype == torch.float32
    assert_close(A.numpy(), jk(pos).to_dense())
    if mode == "regularized":
        src, _ = tp.shift_points_by_center(pos, device="cpu")
        src, _ = tp.scale_points_by_norm(src, factor=1.0, norm="euclidean", device="cpu")
        A_exp = tp.exact_gaussian_matrix(1.0, src).numpy()
    else:
        A_exp = _expected_dense(pk, pos)
    assert np.abs(A.numpy() - A_exp).max() < bar


def test_kernel_apriori_radius_mode(rng):
    pos, _ = _prep_points(rng, 60, 2, spread=2.0)
    radius = float(np.abs(pos - pos.mean(0)).max()) * 1.01
    kw = dict(sigma=1.0, dim=2, bandwidth=16, cutoff=4, max_infinity_norm=radius)
    pk = tp.GaussianKernel(device="cpu", **kw)
    A = pk(pos).to_dense().numpy()
    assert_close(A, tn.GaussianKernel(**kw)(pos).to_dense())
    src, _ = tp.shift_points_by_center(pos, device="cpu")
    assert np.abs(A - tp.exact_gaussian_matrix(1.0, src).numpy()).max() < 5e-3


def test_kernel_batched(rng):
    jk = tn.GaussianKernel(sigma=1.0, dim=2, bandwidth=16, cutoff=4)
    pk = tp.GaussianKernel(sigma=1.0, dim=2, bandwidth=16, cutoff=4, device="cpu")
    pos, batch = _prep_points(rng, 30, 2, batches=2)
    A = pk(pos, batch=batch).to_dense().numpy()
    assert A.shape == (60, 60)
    assert np.abs(A[:30, 30:]).max() < 1e-5
    assert_close(A, jk(pos, batch=batch).to_dense())
    assert np.abs(A - _expected_dense(pk, pos, batch)).max() < 5e-3


def test_kernel_with_an_empty_batch_stays_finite(rng):
    """A batch with no points gets a NaN center and an infinite scale, as
    in the JAX package; no point reads them, so the operator is finite and
    equals the operators of the non-empty batches alone."""
    pk = tp.GaussianKernel(sigma=1.0, dim=2, bandwidth=16, cutoff=4, device="cpu")
    pos, _ = _prep_points(rng, 40, 2)
    batch = np.repeat(np.array([0, 2], np.int32), 20)
    x = rng.standard_normal((40, 2)).astype(np.float32)
    G = pk(pos, batch=batch, batch_size=3)
    y = G @ x
    assert bool(torch.isfinite(y).all())
    assert bool(torch.isfinite(G.sources).all())
    for b in (0, 2):
        sel = batch == b
        assert_close(y[torch.from_numpy(sel)].numpy(), (pk(pos[sel]) @ x[sel]).numpy())


def test_kernel_is_a_module_with_its_coefficients_as_a_buffer():
    pk = tp.GaussianKernel(sigma=0.5, dim=1, bandwidth=16, device="cpu")
    assert isinstance(pk, torch.nn.Module)
    assert "coeffs" in dict(pk.named_buffers())
    assert pk.to("cpu").coeffs.device.type == "cpu"


def test_adjacency_matrix_from_kernel(rng):
    kw = dict(sigma=1.0, dim=2, bandwidth=16, cutoff=4)
    pk = tp.GaussianKernel(device="cpu", **kw)
    pos, _ = _prep_points(rng, 40, 2)
    x = rng.random(40, dtype=np.float32)
    y = (pk.adjacency_matrix(pos, loop_weight=2, normalization="sym") @ x).numpy()
    assert y.shape == (40,)
    assert_close(y, tn.GaussianKernel(**kw).adjacency_matrix(
        pos, loop_weight=2, normalization="sym") @ x)
    A = _expected_dense(pk, pos) + np.eye(40)
    dinv = 1 / np.sqrt(A.sum(1))
    y_exp = dinv * (A @ (dinv * x))
    assert np.abs(y - y_exp).max() / np.abs(y_exp).max() < 2e-2


@pytest.mark.parametrize("batched", [False, True])
def test_point_utilities_match_jax(rng, batched):
    pos, batch = _prep_points(rng, 30, 3, batches=3 if batched else 1)
    tgt, tbatch = _prep_points(rng, 20, 3, batches=3 if batched else 1)
    kw = dict(device="cpu")
    assert_close(tp.compute_points_center(pos, tgt, batch, tbatch, **kw).numpy(),
                 tn.compute_points_center(pos, tgt, batch, tbatch))
    for norm in ("euclidean", "infinity"):
        assert_close(tp.compute_points_radius(pos, tgt, batch, tbatch, norm=norm, **kw).numpy(),
                     tn.compute_points_radius(pos, tgt, batch, tbatch, norm=norm))
        got = tp.scale_points_by_norm(pos, tgt, batch, tbatch, factor=0.25, norm=norm, **kw)
        ref = tn.scale_points_by_norm(pos, tgt, batch, tbatch, factor=0.25, norm=norm)
        for a, b in zip(got, ref):
            assert_close(a.numpy(), b)
    got = tp.shift_points_by_center(pos, tgt, batch, tbatch, **kw)
    ref = tn.shift_points_by_center(pos, tgt, batch, tbatch)
    for a, b in zip(got, ref):
        assert_close(a.numpy(), b)
    with pytest.raises(ValueError, match="unknown norm"):
        tp.compute_points_radius(pos, norm="l1", **kw)


def test_point_utilities_are_differentiable(rng):
    pos, batch = _prep_points(rng, 20, 2, batches=2)
    p = torch.from_numpy(pos).requires_grad_()
    src, _ = tp.shift_points_by_center(p, None, batch, device="cpu")
    src, _ = tp.scale_points_by_norm(src, None, batch, factor=0.25, norm="infinity",
                                     device="cpu")
    src.square().sum().backward()
    ref = jax.grad(lambda q: (tn.scale_points_by_norm(
        tn.shift_points_by_center(q, None, batch)[0], None, batch, factor=0.25,
        norm="infinity")[0] ** 2).sum())(pos)
    assert_close(p.grad.numpy(), ref)


# ---------------------------------------------------------------------------
# GramMatrix and AdjacencyMatrix (tests/test_matrices.py)
# ---------------------------------------------------------------------------


def _gram(rng, n=50, dim=2, targets=False):
    pos, _ = make_points(rng, n, dim)
    coeffs = np.array(tn.gaussian_analytic_coeffs(0.3, dim=dim, N=16))
    tgt = make_points(rng, n // 2, dim)[0] if targets else None
    jax_op = tn.GramMatrix(coeffs, pos, tgt, cutoff=4)
    return tp.GramMatrix(coeffs, pos, tgt, cutoff=4, device="cpu"), jax_op, pos, tgt


def test_gram_symmetric_detection_is_by_identity(rng):
    sym, jsym, pos, _ = _gram(rng)
    assert sym.is_symmetric() and jsym.is_symmetric()
    asym, jasym, _, _ = _gram(rng, targets=True)
    assert not asym.is_symmetric() and not jasym.is_symmetric()
    coeffs = sym.coeffs
    assert tp.GramMatrix(coeffs, pos, pos, cutoff=4, device="cpu").is_symmetric()
    copy = tp.GramMatrix(coeffs, pos, pos.copy(), cutoff=4, device="cpu")
    assert not copy.is_symmetric()  # equal values, another object
    sp, tp_ = copy._plans(require=True)  # small operators plan for the slot API only
    assert tp_ is not sp
    assert sym._plans(require=True)[1] is sym._plans()[0]  # symmetric: one plan
    assert sym.T is sym and copy.T is not copy


def test_gram_transpose_roundtrip(rng):
    mat, jmat, pos, tgt = _gram(rng, targets=True)
    matT = mat.T
    assert matT.shape == (mat.shape[1], mat.shape[0])
    x = rng.random(mat.shape[1], dtype=np.float32)
    y = (mat @ x).numpy()
    assert_close(y, jmat @ x)
    y0 = rng.random(mat.shape[0], dtype=np.float32)
    lhs, rhs = float(y0 @ y), float((matT @ y0).numpy() @ x)
    assert abs(lhs - rhs) / abs(lhs) < 1e-4
    assert_close((matT @ y0).numpy(), jmat.T @ y0)


def test_gram_to_dense_matches_jax_and_trigonometric(rng):
    mat, jmat, pos, _ = _gram(rng)
    A = mat.to_dense().numpy()
    assert_close(A, jmat.to_dense())
    A_ref = tp.exact_trigonometric_matrix(mat.coeffs, torch.from_numpy(pos)).real.numpy()
    assert np.abs(A - A_ref).max() < 1e-3


def test_gram_row_and_column_sums(rng):
    mat, jmat, _, _ = _gram(rng, targets=True)
    A = mat.to_dense().numpy()
    assert_close(mat.row_sums().numpy(), jmat.row_sums())
    assert_close(mat.column_sums().numpy(), jmat.column_sums())
    np.testing.assert_allclose(mat.row_sums().numpy(), A.sum(1), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(mat.column_sums().numpy(), A.sum(0), rtol=1e-3, atol=1e-4)


def test_adjacency_requires_symmetric(rng):
    asym, _, _, _ = _gram(rng, targets=True)
    with pytest.raises(ValueError, match="symmetric"):
        tp.AdjacencyMatrix(asym)


@pytest.mark.parametrize("normalization", [None, "sym", "left", "right", "rw"])
def test_adjacency_normalizations(rng, normalization):
    gram, jgram, _, _ = _gram(rng)
    adj = tp.AdjacencyMatrix(gram, diagonal_offset=1, normalization=normalization)
    jadj = tn.AdjacencyMatrix(jgram, diagonal_offset=1, normalization=normalization)
    assert adj.normalization == jadj.normalization
    n = gram.shape[0]
    x = rng.random(n, dtype=np.float32)
    y = (adj @ x).numpy()
    assert_close(y, jadj @ x)
    A = gram.to_dense().numpy() + np.eye(n)
    deg = A.sum(1)
    if normalization is None:
        y_exp = A @ x
    elif normalization == "sym":
        d = 1 / np.sqrt(deg)
        y_exp = d * (A @ (d * x))
    elif normalization in ("left", "rw"):
        y_exp = (A @ x) / deg
    else:
        y_exp = A @ (x / deg)
    assert np.abs(y - y_exp).max() / np.abs(y_exp).max() < 1e-3


@pytest.mark.parametrize("shift", ["laplacian", "signless"])
def test_adjacency_shifts(rng, shift):
    gram, jgram, _, _ = _gram(rng)
    adj = tp.AdjacencyMatrix(gram, normalization="sym", shift=shift)
    n = gram.shape[0]
    x = rng.random(n, dtype=np.float32)
    y = (adj @ x).numpy()
    assert_close(y, tn.AdjacencyMatrix(jgram, normalization="sym", shift=shift) @ x)
    A = gram.to_dense().numpy()
    d = 1 / np.sqrt(A.sum(1))
    norm_y = d * (A @ (d * x))
    y_exp = x + norm_y if shift == "signless" else x - norm_y
    assert np.abs(y - y_exp).max() / np.abs(y_exp).max() < 1e-3


def test_adjacency_unnormalized_laplacian(rng):
    gram, jgram, _, _ = _gram(rng)
    adj = tp.AdjacencyMatrix(gram, shift="laplacian")
    n = gram.shape[0]
    x = rng.random(n, dtype=np.float32)
    y = (adj @ x).numpy()
    assert_close(y, tn.AdjacencyMatrix(jgram, shift="laplacian") @ x)
    A = gram.to_dense().numpy()
    y_exp = A.sum(1) * x - A @ x
    assert np.abs(y - y_exp).max() / np.abs(y_exp).max() < 1e-3


def test_adjacency_degree_threshold_warning(rng):
    gram, _, _, _ = _gram(rng, n=30)
    with pytest.warns(RuntimeWarning, match="threshold"):
        adj = tp.AdjacencyMatrix(gram, normalization="sym", degree_threshold=1e9)
    assert bool((adj.d_inv_sqrt == 0).all())  # every degree set to inf
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tp.AdjacencyMatrix(gram, normalization="sym")


def test_adjacency_transpose_left_right(rng):
    gram, jgram, _, _ = _gram(rng)
    adj = tp.AdjacencyMatrix(gram, normalization="left")
    assert not adj.is_symmetric()
    adjT = adj.T
    assert adjT.normalization == "right"
    n = gram.shape[0]
    x = rng.random(n, dtype=np.float32)
    y0 = rng.random(n, dtype=np.float32)
    lhs = float(y0 @ (adj @ x).numpy())
    rhs = float((adjT @ y0).numpy() @ x)
    assert abs(lhs - rhs) / abs(lhs) < 1e-4
    assert_close((adjT @ y0).numpy(), tn.AdjacencyMatrix(jgram, normalization="left").T @ y0)


def _gram_planned(rng, n=3000, dim=2, C=2):
    """A Gram matrix large enough that the JAX package plans too."""
    pos, _ = make_points(rng, n, dim)
    coeffs = np.array(tn.gaussian_analytic_coeffs(0.3, dim=dim, N=16))
    x = rng.random((n, C), dtype=np.float32)
    return (tp.GramMatrix(coeffs, pos, cutoff=4, device="cpu"),
            tn.GramMatrix(coeffs, pos, cutoff=4), x)


def test_gram_apply_slot_matches_apply_and_jax(rng):
    gram, jgram, x = _gram_planned(rng)
    y = (gram @ x).numpy()
    assert_close(y, jgram @ x)
    v = gram.to_slot(x)
    assert tuple(v.shape) == (2, gram._plans()[0].S * gram._plans()[0].K)
    assert_close(gram.from_slot(gram.apply_slot(v)).numpy(), y)
    assert_close(jgram.from_slot(jgram.apply_slot(jgram.to_slot(x))), y)


def test_gram_solve_kernel_ridge(rng):
    """(G + reg I) z = b by CG in slot layout: against JAX's CG and a dense
    solve, and the JAX test's residual bar."""
    gram, jgram, _ = _gram_planned(rng, C=1)
    n = gram.shape[0]
    b = rng.random(n, dtype=np.float32)
    reg = 0.5
    z = gram.solve(b, reg=reg, tol=1e-6, maxiter=200)
    assert tuple(z.shape) == (n,)
    assert_close(z.numpy(), jgram.solve(b, reg=reg, tol=1e-6, maxiter=200))
    resid = (gram @ z).numpy() + reg * z.numpy() - b
    assert np.linalg.norm(resid) / np.linalg.norm(b) < 1e-4
    A = gram.to_dense().double().numpy() + reg * np.eye(n)
    assert rel_l2(z.numpy(), np.linalg.solve(A, b.astype(np.float64))) < 1e-4


def test_gram_solve_falls_back_to_user_order(rng, monkeypatch):
    """Where the slot layout is refused the CG runs in user order, as in
    the JAX package, to the same solution."""
    gram, _, _ = _gram_planned(rng, n=2500, C=1)
    b = rng.random(gram.shape[0], dtype=np.float32)
    z_slot = gram.solve(b, reg=0.5, tol=1e-6, maxiter=200)
    monkeypatch.setattr("torch_nfft_tpu_torch.ops.planar.slot_io_ok", lambda *a: False)
    with pytest.raises(ValueError, match="slot_io"):
        gram.apply_slot(gram.to_slot(b))
    z_user = gram.solve(b, reg=0.5, tol=1e-6, maxiter=200)
    assert_close(z_user.numpy(), z_slot.numpy(), rel=1e-4)


def test_gram_solve_requires_symmetric(rng):
    asym, _, _, _ = _gram(rng, targets=True)
    with pytest.raises(ValueError, match="symmetric"):
        asym.solve(np.ones(asym.shape[0], np.float32))


@pytest.mark.parametrize(
    "normalization,shift",
    [(None, None), ("sym", None), ("left", None), ("right", None),
     (None, "laplacian"), ("sym", "signless")],
)
def test_adjacency_apply_slot_matches(rng, normalization, shift):
    gram, jgram, x = _gram_planned(rng)
    adj = tp.AdjacencyMatrix(gram, diagonal_offset=1, normalization=normalization,
                             shift=shift)
    y = (adj @ x).numpy()
    assert_close(y, tn.AdjacencyMatrix(jgram, diagonal_offset=1,
                                       normalization=normalization, shift=shift) @ x)
    assert_close(gram.from_slot(adj.apply_slot(gram.to_slot(x))).numpy(), y)


# ---------------------------------------------------------------------------
# Carry-across and the public surface
# ---------------------------------------------------------------------------


def _numpy_pair(obj):
    children, aux = obj.tree_flatten()
    if isinstance(obj, tn.AdjacencyMatrix):
        gram, arrays = children
        return (_numpy_pair(gram), {k: np.asarray(v) for k, v in arrays.items()}), aux
    return tuple(None if c is None else np.asarray(c) for c in children), aux


@pytest.mark.parametrize("case", ["kernel", "gram", "gram batched", "gram asymmetric",
                                  "adjacency sym", "adjacency left laplacian",
                                  "adjacency signless"])
def test_operator_from_numpy_matches_jax(rng, case):
    pos, batch = _prep_points(rng, 40, 2, batches=2 if case == "gram batched" else 1)
    x = rng.standard_normal((len(pos), 2)).astype(np.float32)
    jk = tn.GaussianKernel(sigma=1.0, dim=2, bandwidth=16, cutoff=4,
                           max_infinity_norm=3.5 if case == "kernel" else None)
    if case == "kernel":
        jobj = jk
    elif case.startswith("gram"):
        tgt = _prep_points(rng, 30, 2)[0] if case == "gram asymmetric" else None
        jobj = jk(pos, tgt, batch=batch)
    else:
        norm, shift = {"adjacency sym": ("sym", None),
                       "adjacency left laplacian": ("left", "laplacian"),
                       "adjacency signless": (None, "signless")}[case]
        jobj = jk.adjacency_matrix(pos, loop_weight=2, normalization=norm, shift=shift)
    obj = tp.operator_from_numpy(*_numpy_pair(jobj), device="cpu")
    if case == "kernel":
        assert isinstance(obj, tp.GaussianKernel)
        assert obj.factor == jk.factor and obj.scale_by_norm == jk.scale_by_norm
        assert np.array_equal(obj.coeffs.numpy(), np.asarray(jk.coeffs))
        obj, jobj = obj(pos), jk(pos)
    assert obj.is_symmetric() == jobj.is_symmetric()
    assert_close((obj @ x).numpy(), jobj @ x)
    if case.startswith("adjacency"):
        for name in tp.AdjacencyMatrix._DEGREE_FIELDS:
            if hasattr(jobj, name):  # taken as given
                assert np.array_equal(getattr(obj, name).numpy(), np.asarray(getattr(jobj, name)))


def test_signatures_hold_to_torch_compat():
    """Where the port and torch_compat share a public name, the port takes
    the same leading parameters, in order, with the same defaults."""
    for name in ("nfft_fastsum", "gaussian_analytic_coeffs", "gaussian_interpolated_coeffs",
                 "interpolation_grid", "radial_interpolation_grid", "ndft_fastsum",
                 "exact_trigonometric_matrix", "exact_gaussian_matrix", "GramMatrix",
                 "AdjacencyMatrix", "GaussianKernel"):
        ref = list(inspect.signature(getattr(torch_compat, name)).parameters.values())
        got = list(inspect.signature(getattr(tp, name)).parameters.values())
        for r, g in zip(ref, got):
            assert (g.name, g.default, g.kind) == (r.name, r.default, r.kind), name
        assert len(got) >= len(ref), name
    for meth in ("gram_matrix", "adjacency_matrix"):
        ref = list(inspect.signature(getattr(torch_compat.GaussianKernel, meth)).parameters)
        got = list(inspect.signature(getattr(tp.GaussianKernel, meth)).parameters)
        assert got[:len(ref)] == ref, meth
