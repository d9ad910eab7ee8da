"""PyTorch port vs JAX package: the Lanczos eigensolver (``lanczos``,
``eigsh_operator``) and ``accuracy_check`` (the cases of
tests/test_solve.py).

``lanczos`` is held to the JAX package's on a shared start vector: alphas,
betas and basis at 1e-5 of their largest entries, the breakdown of a
rank-deficient operator (zero betas, zero basis rows) in the same steps.
``eigsh_operator`` starts from the port's own generator, so its
eigenvalues are held to the dense spectrum and to the JAX package's at the
JAX test's bar (1e-3 relative). ``accuracy_check`` reads the same
subsample as the JAX package's and agrees within 10%.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers import make_points

import torch_nfft_tpu as tn
import torch_nfft_tpu_torch as tp


def assert_close(got, ref, frac=1e-5):
    """max |got - ref| <= frac * max |ref|."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= frac * float(np.abs(ref).max())


def _sym(rng, n=40):
    A = rng.standard_normal((n, n)).astype(np.float32)
    return (A + A.T) / 2


@pytest.mark.parametrize("k", [12, 40])
def test_lanczos_matches_jax_on_a_shared_start(rng, k):
    """Alphas, betas and the basis on an explicit symmetric matrix; at
    k = n the tridiagonal's extreme eigenvalues are the matrix's."""
    A = _sym(rng)
    v0 = rng.standard_normal(40).astype(np.float32)
    Aj, At = jnp.asarray(A), torch.from_numpy(A)
    ja, jb, jV = tn.lanczos(lambda v: Aj @ v, jnp.asarray(v0), k)
    pa, pb, pV = tp.lanczos(lambda v: At @ v, torch.from_numpy(v0), k)
    assert pa.shape == (k,) and pb.shape == (k - 1,) and pV.shape == (k, 40)
    if k == 12:  # long runs drift apart in float32 rounding, as any two would
        assert_close(pa.numpy(), ja)
        assert_close(pb.numpy(), jb)
        assert_close(pV.numpy(), jV)
    tri = np.diag(pa.numpy()) + np.diag(pb.numpy(), 1) + np.diag(pb.numpy(), -1)
    got = np.sort(np.linalg.eigvalsh(tri))
    want = np.sort(np.linalg.eigvalsh(A))
    if k == 40:
        np.testing.assert_allclose(got[-3:], want[-3:], rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(got[:3], want[:3], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("shape", [(40,), (20, 2)])
def test_lanczos_breakdown_matches_jax(rng, shape):
    """A rank-5 operator (five nonzero eigenvalues, exact in float32): once
    the Krylov space is spent the betas and the basis rows are exactly
    zero, in the same steps as the JAX package's, and the tridiagonal
    holds the operator's nonzero spectrum."""
    d = np.zeros(40, np.float32)
    d[:5] = [3.0, 2.5, 2.0, 1.5, 1.0]
    d = d[rng.permutation(40)].reshape(shape)
    v0 = rng.standard_normal(shape).astype(np.float32)
    dj, dt = jnp.asarray(d), torch.from_numpy(d)
    ja, jb, jV = tn.lanczos(lambda v: dj * v, jnp.asarray(v0), 12)
    pa, pb, pV = tp.lanczos(lambda v: dt * v, torch.from_numpy(v0), 12)
    jb, jV = np.asarray(jb), np.asarray(jV)
    dead_j = np.flatnonzero(jb == 0)
    dead_p = np.flatnonzero(pb.numpy() == 0)
    assert dead_p.size and np.array_equal(dead_p, dead_j)
    rows_j = np.flatnonzero(np.abs(jV).reshape(12, -1).max(1) == 0)
    rows_p = np.flatnonzero(pV.abs().reshape(12, -1).amax(1).numpy() == 0)
    assert rows_p.size and np.array_equal(rows_p, rows_j)
    assert_close(pa.numpy(), ja)
    assert_close(pb.numpy(), jb)
    assert_close(pV.numpy(), jV)
    tri = np.diag(pa.numpy()) + np.diag(pb.numpy(), 1) + np.diag(pb.numpy(), -1)
    top = np.sort(np.linalg.eigvalsh(tri))[-5:]
    np.testing.assert_allclose(top, [1.0, 1.5, 2.0, 2.5, 3.0], rtol=1e-4)


def _gram_pair(rng, n=2500, dim=2):
    pos, _ = make_points(rng, n, dim)
    coeffs = np.asarray(tn.gaussian_analytic_coeffs(0.3, dim=dim, N=16))
    return tn.GramMatrix(coeffs, pos, cutoff=4), tp.GramMatrix(coeffs, pos, cutoff=4,
                                                               device="cpu")


def test_eigsh_gram_top_eigs(rng):
    """Top eigenpairs of the Gram operator in slot order: the dense
    spectrum's and the JAX package's eigenvalues (1e-3 relative), Ritz
    residuals under 1e-2, and user order giving the same values."""
    jG, G = _gram_pair(rng)
    k = 3
    w, Y = tp.eigsh_operator(G, k, num_iters=40)
    assert w.shape == (k,) and Y.shape == (2500, k)
    dense = G.to_dense().numpy().astype(np.float64)
    want = np.sort(np.linalg.eigvalsh((dense + dense.T) / 2))[-k:]
    np.testing.assert_allclose(w.numpy(), want, rtol=1e-3)
    jw, _ = tn.eigsh_operator(jG, k, num_iters=40)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-3)
    for j in range(k):
        y = Y[:, j]
        resid = torch.linalg.vector_norm(G @ y - w[j] * y)
        assert float(resid) / abs(float(w[j])) < 1e-2
    wu, _ = tp.eigsh_operator(G, k, num_iters=40, use_slot=False)
    np.testing.assert_allclose(wu.numpy(), w.numpy(), rtol=1e-4)


def test_eigsh_adjacency_laplacian(rng):
    """The normalised Laplacian of the Gaussian graph has a cluster of
    eigenvalues at 1 (the Gram is numerically low rank): Lanczos finds it
    within the [0, 2] bound, as the JAX package's does."""
    jG, G = _gram_pair(rng)
    adj = tp.AdjacencyMatrix(G, normalization="sym", shift="laplacian")
    w, Y = tp.eigsh_operator(adj, 2, num_iters=40)
    assert float(w[-1]) <= 2.0 + 1e-3
    np.testing.assert_allclose(w.numpy(), [1.0, 1.0], atol=1e-3)
    jw, _ = tn.eigsh_operator(tn.AdjacencyMatrix(jG, normalization="sym", shift="laplacian"),
                              2, num_iters=40)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-3)
    for j in range(2):
        y = Y[:, j]
        assert float(torch.linalg.vector_norm(adj @ y - y) / torch.linalg.vector_norm(y)) < 5e-2


def test_eigsh_small_operator_plans_for_the_slot_order(rng):
    """Below the plan threshold the solver still plans the operator and
    runs in slot order: the seeded start is reproducible and the top
    eigenvalues are the dense ones."""
    pos, _ = make_points(rng, 300, 2)
    G = tp.GaussianKernel(0.5, dim=2, bandwidth=16, cutoff=4, device="cpu")(pos)
    assert G._plans()[0] is None
    w1, _ = tp.eigsh_operator(G, 2, num_iters=30, seed=3)
    assert G._plans()[0] is not None
    w2, _ = tp.eigsh_operator(G, 2, num_iters=30, seed=3)
    assert torch.equal(w1, w2)
    dense = G.to_dense().numpy().astype(np.float64)
    want = np.sort(np.linalg.eigvalsh((dense + dense.T) / 2))[-2:]
    np.testing.assert_allclose(w1.numpy(), want, rtol=1e-3)


def test_eigsh_requires_a_symmetric_operator(rng):
    pos, _ = make_points(rng, 50, 2)
    G = tp.GaussianKernel(0.5, dim=2, bandwidth=16, device="cpu")(pos, pos[:30])
    with pytest.raises(ValueError, match="symmetric"):
        tp.eigsh_operator(G, 2)


@pytest.mark.parametrize("dim,N,m,window", [(1, 32, 4, "gaussian"), (2, 16, 2, "es"),
                                            (3, 8, 2, "kb"), (2, 16, 3, "gaussian")])
def test_accuracy_check_matches_jax(rng, dim, N, m, window):
    """The same subsample and values as the JAX package's check: the two
    errors within 10% of each other (for windows whose error stands above
    the JAX oracle's float32 rounding, ~7e-7); a tensor of points gives
    the same."""
    pos = (rng.random((3000, dim), dtype=np.float32) - 0.5) / 2
    ref = tn.accuracy_check(pos, N, m, window=window, seed=5)
    got = tp.accuracy_check(pos, N, m, window=window, seed=5, device="cpu")
    assert abs(got - ref) <= 0.1 * ref
    assert tp.accuracy_check(torch.from_numpy(pos), N, m, window=window, seed=5,
                             device="cpu") == got


def test_solver_exports_hold_to_jax():
    import inspect

    from torch_nfft_tpu.utils import diagnostics as jdiag
    from torch_nfft_tpu.utils import solve as jsolve

    for name, ref in (("lanczos", jsolve.lanczos), ("eigsh_operator", jsolve.eigsh_operator),
                      ("accuracy_check", jdiag.accuracy_check)):
        assert name in tp.__all__ and name in tn.__all__
        want = [(p.name, p.default, p.kind) for p in inspect.signature(ref).parameters.values()]
        got = [(p.name, p.default, p.kind)
               for p in inspect.signature(getattr(tp, name)).parameters.values()]
        assert got[:len(want)] == want, name
