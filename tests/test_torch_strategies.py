"""PyTorch port vs JAX package: the plan-free spread and gather engines
(scatter and one-hot matmul), the "auto" rule that picks an engine or a
plan, and the strategies on the entry points (the cases of
tests/test_strategies.py).

Both packages' engines are plain array code, differentiated by autograd
and ``jax.grad``. Outputs agree to 1e-5 of the output's largest entry,
gradients to 5e-5; the engines agree with each other and with the binned
engine at the same bar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers import make_points

import torch_nfft_tpu as tn
import torch_nfft_tpu_torch as tp
from torch_nfft_tpu.ops import nfft as jnfft
from torch_nfft_tpu.ops import spread_gather as jsg
from torch_nfft_tpu.ops import window as jwindow
from torch_nfft_tpu_torch.ops import spread_gather as psg
from torch_nfft_tpu_torch.ops import window as pwindow

ENGINES = ("scatter", "matmul")


def assert_close(got, ref, frac=1e-5):
    """max |got - ref| <= frac * max |ref|."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert float(np.abs(got - ref).max()) <= frac * float(np.abs(ref).max())


def _flat(g):
    """The port's grid (B, C, M^dim) -> JAX's flat (B*M^dim, C)."""
    g = np.asarray(g)
    return np.moveaxis(g, 1, -1).reshape(-1, g.shape[1])


def _points(rng, n, dim, batches):
    pos, batch = make_points(rng, n, dim, batches)
    if batch is None:
        batch = np.zeros(len(pos), np.int32)
    return pos, batch


@pytest.mark.parametrize("window", ["gaussian", "es", "kb"])
@pytest.mark.parametrize("dim,N,m,sigma", [(1, 32, 4, 2.0), (3, 16, 2, 1.625)])
def test_window_values_match_jax(rng, dim, N, m, sigma, window):
    """compute_shifts, compute_psi and compute_psi_and_dpsi, which the
    engines' weights come from, against the JAX package's (points across
    the whole box, so the shifts wrap)."""
    pos = (rng.random((300, dim), dtype=np.float32) - 0.5)
    js = jwindow.compute_shifts(jnp.asarray(pos), N, m, sigma)
    ps = pwindow.compute_shifts(torch.from_numpy(pos), N, m, sigma)
    assert ps.dtype == torch.int32 and np.array_equal(ps.numpy(), np.asarray(js))
    assert_close(pwindow.compute_psi(torch.from_numpy(pos), ps, N, m, sigma, window).numpy(),
                 jwindow.compute_psi(jnp.asarray(pos), js, N, m, sigma, window))
    jv, jd = jwindow.compute_psi_and_dpsi(jnp.asarray(pos), js, N, m, sigma, window)
    pv, pd = pwindow.compute_psi_and_dpsi(torch.from_numpy(pos), ps, N, m, sigma, window)
    assert_close(pv.numpy(), jv)
    assert_close(pd.numpy(), jd, 5e-5)


SPREADS = [(1, 32, 4, 1), (1, 16, 3, 3), (2, 16, 4, 2), (3, 8, 2, 2)]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("dim,N,m,batches", SPREADS)
def test_spread_engines_match_jax(rng, dim, N, m, batches, engine):
    pos, batch = _points(rng, 64, dim, batches)
    x = rng.random((len(pos), 3), dtype=np.float32)
    fn = {"scatter": lambda *a: jsg._spread_scatter(*a, None),
          "matmul": jsg._spread_matmul}[engine]
    ref = fn(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(batch), batches, N, m, 2.0)
    got = psg.spread(torch.from_numpy(x), torch.from_numpy(pos), batch, batches, N, m,
                     strategy=engine)
    M = 2 * N
    assert got.shape == (batches, 3) + (M,) * dim
    assert_close(_flat(got.numpy()), ref)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("dim,N,m,batches", [(1, 32, 4, 1), (2, 16, 4, 2), (3, 8, 2, 2)])
def test_gather_engines_match_jax(rng, dim, N, m, batches, engine):
    pos, batch = _points(rng, 64, dim, batches)
    M = 2 * N
    g = (rng.random((batches * M**dim, 2)) + 1j * rng.random((batches * M**dim, 2))).astype(
        np.complex64)
    if engine == "scatter":
        ref = jsg._gather_scatter(jnp.asarray(g), jnp.asarray(pos), jnp.asarray(batch), N, m,
                                  2.0, None)
    else:
        ref = jsg._gather_matmul(jnp.asarray(g), jnp.asarray(pos), jnp.asarray(batch),
                                 batches, N, m, 2.0)
    grid = np.moveaxis(g.reshape((batches,) + (M,) * dim + (2,)), -1, 1).copy()
    got = psg.gather(torch.from_numpy(grid), torch.from_numpy(pos), batch, batches, N, m,
                     strategy=engine)
    assert_close(got.numpy(), ref)


@pytest.mark.parametrize("chunk", [None, 37])
def test_chunked_engines_equal_unchunked(rng, chunk):
    """The scatter engine over chunks of 37 points and in one piece: the
    same result, and JAX's chunked result."""
    dim, N, m, n = 2, 16, 4, 200
    pos, batch = _points(rng, n, dim, 1)
    x = rng.random((n, 2), dtype=np.float32)
    ref = jsg._spread_scatter(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(batch), 1, N, m,
                              2.0, chunk)
    got = psg.spread(torch.from_numpy(x), torch.from_numpy(pos), batch, 1, N, m,
                     strategy="scatter", point_chunk=chunk)
    assert_close(_flat(got.numpy()), ref)
    one = psg.spread(torch.from_numpy(x), torch.from_numpy(pos), batch, 1, N, m,
                     strategy="scatter")
    assert_close(got.numpy(), one.numpy())
    y_ref = jsg._gather_scatter(ref, jnp.asarray(pos), jnp.asarray(batch), N, m, 2.0, chunk)
    y = psg.gather(got, torch.from_numpy(pos), batch, 1, N, m, strategy="scatter",
                   point_chunk=chunk)
    assert_close(y.numpy(), y_ref)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("dim,N,m,window", [(1, 32, 3, "gaussian"), (2, 16, 3, "es"),
                                            (3, 8, 2, "kb")])
def test_engine_gradients_match_jax(rng, dim, N, m, window, engine):
    """x.grad and pos.grad of <spread(x, pos), G> and g.grad and pos.grad
    of <gather(g, pos), w> against jax.grad, 5e-5 of the largest entry."""
    batches, C = 2, 2
    pos, batch = _points(rng, 60, dim, batches)
    n, M = len(pos), 2 * N
    x = rng.standard_normal((n, C)).astype(np.float32)
    G = rng.standard_normal((batches * M**dim, C)).astype(np.float32)
    w = rng.standard_normal((n, C)).astype(np.float32)
    jb = jnp.asarray(batch)

    def jloss(x_, p_, g_):
        g = jsg.spread(x_, p_, jb, batches, N, m, strategy=engine, window=window)
        y = jsg.gather(g_, p_, jb, batches, N, m, strategy=engine, window=window)
        return jnp.sum(g * jnp.asarray(G)) + jnp.sum(y * jnp.asarray(w))

    refs = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(pos),
                                              jnp.asarray(G))
    xl = torch.from_numpy(x).requires_grad_()
    pl = torch.from_numpy(pos).requires_grad_()
    grid = torch.from_numpy(np.moveaxis(G.reshape((batches,) + (M,) * dim + (C,)), -1, 1)
                            .copy()).requires_grad_()
    g = psg.spread(xl, pl, batch, batches, N, m, strategy=engine, window=window)
    y = psg.gather(grid, pl, batch, batches, N, m, strategy=engine, window=window)
    ((g * grid.detach()).sum() + (y * torch.from_numpy(w)).sum()).backward()
    assert_close(xl.grad.numpy(), refs[0], 5e-5)
    assert_close(pl.grad.numpy(), refs[1], 5e-5)
    assert_close(_flat(grid.grad.numpy()), refs[2], 5e-5)


@pytest.mark.parametrize("strategy", ["scatter", "matmul", "auto"])
def test_strategy_threads_through_the_entry_points(rng, strategy):
    """nfft_adjoint, nfft_forward and nfft_fastsum with each strategy and
    no plan: the JAX package's result, and the binned engine's."""
    pos, batch = _points(rng, 50, 2, 2)
    x = rng.standard_normal((len(pos), 2)).astype(np.float32)
    kw = dict(m=4, window="es")
    ref = tn.nfft_adjoint(x, pos, batch, bandwidth=16, strategy=strategy, **kw)
    got = tp.nfft_adjoint(x, pos, batch, bandwidth=16, strategy=strategy, device="cpu", **kw)
    assert_close(got.numpy(), ref)
    binned = tp.nfft_adjoint(x, pos, batch, bandwidth=16, strategy="binned", device="cpu",
                             **kw)
    assert_close(got.numpy(), binned.numpy())
    s = (rng.standard_normal((2, 16, 16, 2)) + 1j * rng.standard_normal((2, 16, 16, 2))
         ).astype(np.complex64)
    ref = tn.nfft_forward(s, pos, batch, strategy=strategy, **kw)
    got = tp.nfft_forward(s, pos, batch, strategy=strategy, device="cpu", **kw)
    assert_close(got.numpy(), ref)
    coeffs = np.asarray(tn.gaussian_analytic_coeffs(0.3, dim=2, N=16))
    ref = tn.nfft_fastsum(x, coeffs, pos, batch=batch, cutoff=4, strategy=strategy)
    got = tp.nfft_fastsum(x, coeffs, pos, batch=batch, cutoff=4, strategy=strategy,
                          device="cpu")
    assert_close(got.numpy(), ref)


# (n, dim, N, C): both sides of 4096 points and of 2^24 one-hot entries
AUTO = [
    (4000, 3, 32, 1),    # few points: no plan; one-hot 16.6M -> matmul
    (4000, 3, 64, 1),    # few points: no plan; one-hot 66M -> scatter
    (4096, 3, 32, 1),    # 17.0M one-hot entries: plan
    (5000, 2, 64, 4),    # 2.1M one-hot entries: no plan, matmul
    (5000, 3, 16, 2),    # 10.4M: matmul
    (5000, 3, 32, 2),    # 41M: plan
    (6000, 1, 512, 8),   # 6.2M: matmul
]


@pytest.mark.parametrize("n,dim,N,C", AUTO)
def test_auto_choice_matches_jax(rng, n, dim, N, C):
    """plan_or_engine's choice is _maybe_build_plan's: a plan exactly where
    JAX builds one, else the engine its _pick_strategy takes."""
    pos = (rng.random((n, dim), dtype=np.float32) - 0.5) / 2
    plan, strategy = jnfft._maybe_build_plan("auto", None, pos, None, N, 2, 2.0, 1, C=C)
    got = psg.plan_or_engine("auto", n, dim, 1, 2 * N, C)
    if plan is not None:
        assert got == "binned"
    else:
        assert got == jsg._pick_strategy(strategy, n, dim, 1, 2 * N, C) != "binned"
    for explicit in ("binned", "scatter", "matmul"):
        assert psg.plan_or_engine(explicit, n, dim, 1, 2 * N, C) == explicit


@pytest.mark.parametrize("n", [1500, 2500])
def test_gram_matrix_below_and_above_the_plan_threshold(rng, n):
    """Below 2048 points neither package's operator plans (its matvec runs
    the matmul engine), from 2048 on both do; the slot API always plans.
    The matvecs match the JAX package's."""
    pos, _ = make_points(rng, n, 2)
    x = rng.standard_normal((n, 2)).astype(np.float32)
    coeffs = np.asarray(tn.gaussian_analytic_coeffs(0.3, dim=2, N=16))
    jG = tn.GramMatrix(coeffs, pos, cutoff=4)
    pG = tp.GramMatrix(coeffs, pos, cutoff=4, device="cpu")
    assert_close((pG @ x).numpy(), jG @ x)
    planned = n >= pG._PLAN_THRESHOLD
    assert (pG._plans()[0] is not None) == planned == (jG._plans()[0] is not None)
    y = pG.from_slot(pG.apply_slot(pG.to_slot(x)))
    assert pG._plans()[0] is not None
    assert_close(y.numpy(), jG @ x)


def _entry_call(pkg, entry, x, pos, *, N, m, strategy, coeffs=None, **kw):
    """One of the three entry points of ``pkg`` (the JAX package or the
    port) on values ``x`` (a spectrum for the forward) at ``pos``."""
    if entry == "adjoint":
        return pkg.nfft_adjoint(x, pos, bandwidth=N, cutoff=m, strategy=strategy, **kw)
    if entry == "forward":
        return pkg.nfft_forward(x, pos, cutoff=m, strategy=strategy, **kw)
    return pkg.nfft_fastsum(x, coeffs, pos, cutoff=m, strategy=strategy, **kw)


def _assert_same_empty_or_zero(got, ref):
    """The port's result has JAX's shape and dtype, and its values."""
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape, (tuple(got.shape), ref.shape)
    assert got.numpy().dtype == ref.dtype, (got.dtype, ref.dtype)
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("strategy", ["auto", "scatter", "matmul", "binned"])
@pytest.mark.parametrize("entry", ["adjoint", "forward", "fastsum"])
def test_zero_points_match_jax(entry, strategy):
    """No points at all (n = 0, 2D, N = 8, m = 3): the adjoint is a zero
    (1, 8, 8) grid, the forward and the fastsum empty (0,) vectors, with
    JAX's dtypes, on every plan-free strategy. On "binned" JAX raises
    (a division by the empty plan's size); the port returns the same
    zeros, a documented superset."""
    pos = np.zeros((0, 2), np.float32)
    x = np.zeros((1, 8, 8), np.complex64) if entry == "forward" else np.zeros((0,), np.complex64)
    coeffs = np.asarray(tn.gaussian_analytic_coeffs(0.1, dim=2, N=8))
    kw = dict(N=8, m=3, coeffs=coeffs)
    got = _entry_call(tp, entry, x, pos, strategy=strategy, device="cpu", **kw)
    if strategy == "binned":
        with pytest.raises(ZeroDivisionError):
            _entry_call(tn, entry, x, pos, strategy=strategy, **kw)
        ref = {"adjoint": np.zeros((1, 8, 8), np.complex64)}.get(
            entry, np.zeros((0,), np.complex64))
    else:
        ref = _entry_call(tn, entry, x, pos, strategy=strategy, **kw)
    _assert_same_empty_or_zero(got, ref)


@pytest.mark.parametrize("strategy", ["auto", "binned", "matmul"])
@pytest.mark.parametrize("entry", ["adjoint", "forward", "fastsum"])
def test_zero_columns_match_jax(rng, entry, strategy):
    """No columns (x of shape (300, 0) at 300 3D points, N = 8, m = 2): JAX
    returns a (1, 8, 8, 8, 0) complex64 grid, a (300, 0) complex64 forward
    and a (300, 0) float32 fastsum; so does the port, before any FFT or
    contraction runs."""
    pos = (rng.random((300, 3), dtype=np.float32) - 0.5) / 4
    x = (np.zeros((1, 8, 8, 8, 0), np.complex64) if entry == "forward"
         else np.zeros((300, 0), np.float32))
    coeffs = np.asarray(tn.gaussian_analytic_coeffs(0.1, dim=3, N=8))
    kw = dict(N=8, m=2, strategy=strategy, coeffs=coeffs)
    ref = _entry_call(tn, entry, x, pos, **kw)
    _assert_same_empty_or_zero(_entry_call(tp, entry, x, pos, device="cpu", **kw), ref)


@pytest.mark.parametrize("strategy", ["auto", "matmul"])
def test_zero_columns_planar_match_jax(rng, strategy):
    """The planar adjoint and forward at C = 0 give JAX's empty planes."""
    pos = (rng.random((300, 3), dtype=np.float32) - 0.5) / 4
    x = np.zeros((300, 0), np.float32)
    s = np.zeros((1, 8, 8, 8, 0), np.float32)
    kw = dict(batch_size=1, m=2, strategy=strategy)
    for ref, got in (
            (tn.nfft_adjoint_planar(x, pos, None, N=8, **kw),
             tp.nfft_adjoint_planar(x, pos, None, N=8, device="cpu", **kw)),
            (tn.nfft_forward_planar(s, s, pos, None, dim=3, **kw),
             tp.nfft_forward_planar(s, s, pos, None, dim=3, device="cpu", **kw)),
            (tn.nfft_forward_planar(s, None, pos, None, dim=3, real_output=True, **kw)[:1],
             tp.nfft_forward_planar(s, None, pos, None, dim=3, real_output=True, device="cpu",
                                    **kw)[:1])):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _assert_same_empty_or_zero(g, r)
