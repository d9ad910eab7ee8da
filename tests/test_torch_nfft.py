"""PyTorch port vs JAX package: the public ``nfft_adjoint`` / ``nfft_forward``
on the binned strategy (and once on each plan-free one), their gradients
and their loud errors.

The same plan (built by JAX, carried across with ``plan_from_numpy``) runs
in both packages; JAX runs ``strategy="binned"`` with that plan. Outputs
agree to rel-L2 3e-5, the bar of the planar transforms
(tests/test_torch_pair.py): the port's spectral stage is a C2C FFT.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import points, port_plan, rel_l2

import torch_nfft_tpu as tn
import torch_nfft_tpu_torch as tp
from torch_nfft_tpu.ops import binned as jbinned

REL = 3e-5


def _case(rng, dim=2, N=16, B=2, m=3, sigma=2.0, window="es", n=250):
    pos, batch = points(rng, n, dim, B)
    jplan = jbinned.build_plan(pos, batch, N=N, m=m, sigma=sigma, batch_size=B, K=128,
                               window=window)
    kw = dict(m=m, sigma=sigma, window=window, strategy="binned")
    return pos, batch, jplan, port_plan(jplan), kw


def _values(rng, shape, complex_):
    v = rng.standard_normal(shape).astype(np.float32)
    if complex_:
        v = (v + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return v


@pytest.mark.parametrize("real_output", [False, True])
@pytest.mark.parametrize("complex_", [False, True])
def test_adjoint_forward_match_jax(rng, complex_, real_output):
    """Real and complex x, trailing columns (n, 2, 3), both output kinds."""
    pos, batch, jplan, plan, kw = _case(rng)
    B, N, n = 2, 16, len(pos)
    x = _values(rng, (n, 2, 3), complex_)
    ref = tn.nfft_adjoint(jnp.asarray(x), pos, batch, N=N, plan=jplan,
                          real_output=real_output, **kw)
    got = tp.nfft_adjoint(x, pos, batch, N=N, plan=plan, real_output=real_output,
                          device="cpu", **kw)
    assert got.shape == (B, N, N, 2, 3) and got.is_complex() == (not real_output)
    assert rel_l2(got.numpy(), np.asarray(ref)) <= REL

    s = _values(rng, (B, N, N, 2, 3), complex_)
    ref = tn.nfft_forward(jnp.asarray(s), pos, batch, plan=jplan,
                          real_output=real_output, **kw)
    got = tp.nfft_forward(s, pos, batch, plan=plan, real_output=real_output,
                          device="cpu", **kw)
    assert got.shape == (n, 2, 3) and got.is_complex() == (not real_output)
    assert rel_l2(got.numpy(), np.asarray(ref)) <= REL


def test_adjoint_at_m10_matches_jax_on_the_cpu(rng):
    """m = 10: 22 window cells per axis, past what the card's kernels hold
    (contract.MAX_L); the CPU's plain versions take any m, as JAX does.
    1D, N=32, sigma=2, gaussian, n=100: JAX's binned adjoint is ~8e-7 from
    the NDFT."""
    N, n = 32, 100
    pos, batch, jplan, plan, kw = _case(rng, dim=1, N=N, B=1, m=10, window="gaussian", n=n)
    x = _values(rng, (n, 1), False)
    ref = tn.nfft_adjoint(jnp.asarray(x), pos, batch, N=N, plan=jplan, **kw)
    oracle = tp.ndft_adjoint(torch.from_numpy(x), torch.from_numpy(pos), N=N)
    for p in (plan, None):  # JAX's plan carried across, and the port's own
        got = tp.nfft_adjoint(x, pos, batch, N=N, plan=p, device="cpu", **kw)
        assert rel_l2(got.numpy(), np.asarray(ref)) <= REL
        assert rel_l2(got.numpy(), oracle.numpy()) <= 1e-5


@pytest.mark.parametrize("with_batch_size", [False, True])
def test_batch_vector_with_and_without_batch_size(rng, with_batch_size):
    """batch_size inferred as batch[-1] + 1, or given; the positional
    bandwidth/cutoff and their aliases N/m agree; no trailing columns."""
    pos, batch, jplan, plan, kw = _case(rng, dim=3, N=8, m=2, sigma=1.625, window="kb")
    x = _values(rng, (len(pos),), False)
    extra = dict(batch_size=2) if with_batch_size else {}
    ref = tn.nfft_adjoint(jnp.asarray(x), pos, batch, 8, plan=jplan, **extra, **kw)
    got = tp.nfft_adjoint(x, pos, batch, 8, plan=plan, device="cpu", **extra, **kw)
    assert got.shape == (2, 8, 8, 8) and rel_l2(got.numpy(), np.asarray(ref)) <= REL
    kw2 = {k: v for k, v in kw.items() if k != "m"}
    alias = tp.nfft_adjoint(x, pos, batch, bandwidth=8, cutoff=2, plan=plan, device="cpu",
                            **extra, **kw2)
    assert torch.equal(alias, got)

    s = np.array(ref)
    ref_f = tn.nfft_forward(jnp.asarray(s), pos, batch, plan=jplan, **extra, **kw)
    got_f = tp.nfft_forward(s, pos, batch, plan=plan, device="cpu", **extra, **kw)
    assert got_f.shape == (len(pos),)
    assert rel_l2(got_f.numpy(), np.asarray(ref_f)) <= REL


def test_plan_none_builds_one_per_call(rng):
    """Without a plan (and one batch, gaussian window by default) each call
    plans its points; the result matches JAX's binned strategy."""
    pos, _ = points(rng, 300, 2)
    x = _values(rng, (300, 2), True)
    ref = tn.nfft_adjoint(jnp.asarray(x), pos, N=16, m=3, strategy="binned")
    got = tp.nfft_adjoint(x, pos, N=16, m=3, device="cpu")
    assert rel_l2(got.numpy(), np.asarray(ref)) <= REL


@pytest.mark.parametrize("op", ["adjoint", "forward"])
def test_complex_input_gradients(rng, op):
    """x.grad of a real loss of a complex input is the conjugate of
    jax.grad's: JAX returns the conjugate of PyTorch's convention
    (d/d conj(x) against d/dx). Position gradients agree as they are."""
    pos, batch, jplan, plan, kw = _case(rng)
    n, B, N = len(pos), 2, 16
    if op == "adjoint":
        x = _values(rng, (n, 2), True)
        w = rng.standard_normal((B, N, N, 2)).astype(np.float32)

        def jfn(a, p):
            return tn.nfft_adjoint(a, p, batch, N=N, plan=jplan, **kw)

        def pfn(a, p):
            return tp.nfft_adjoint(a, p, batch, N=N, plan=plan, device="cpu", **kw)
    else:
        x = _values(rng, (B, N, N, 2), True)
        w = rng.standard_normal((n, 2)).astype(np.float32)

        def jfn(a, p):
            return tn.nfft_forward(a, p, batch, plan=jplan, **kw)

        def pfn(a, p):
            return tp.nfft_forward(a, p, batch, plan=plan, device="cpu", **kw)

    rx, rp = jax.grad(lambda a, p: jnp.sum(jnp.abs(jfn(a, p)) ** 2 * w), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(pos))
    xt = torch.from_numpy(x).requires_grad_()
    pt = torch.from_numpy(pos).requires_grad_()
    (pfn(xt, pt).abs() ** 2 * torch.from_numpy(w)).sum().backward()
    assert rel_l2(xt.grad.numpy(), np.conj(np.asarray(rx))) <= REL
    rp = np.asarray(rp)
    assert np.abs(pt.grad.numpy() - rp).max() <= 5e-5 * np.abs(rp).max()


def test_plan_mismatch_raises(rng):
    pos, batch, jplan, plan, kw = _case(rng)
    x = _values(rng, (len(pos), 1), False)
    for bad in (dict(window="gaussian"), dict(m=2), dict(sigma=1.5), dict(N=8)):
        args = {**kw, "N": 16, **bad}
        with pytest.raises(ValueError, match="plan"):
            tp.nfft_adjoint(x, pos, batch, plan=plan, device="cpu", **args)
    with pytest.raises(ValueError, match="plan"):
        tp.nfft_adjoint(x[:-1], pos[:-1], batch[:-1], N=16, plan=plan, device="cpu", **kw)
    with pytest.raises(ValueError, match="batch_size"):
        tp.nfft_adjoint(x, pos, batch, N=16, plan=plan, batch_size=3, device="cpu", **kw)
    with pytest.raises(ValueError, match="batch_size"):
        tp.nfft_forward(np.zeros((3, 16, 16, 1), np.float32), pos, batch, plan=plan,
                        device="cpu", **kw)


@pytest.mark.parametrize("strategy", ["scatter", "matmul"])
def test_unported_strategies_raise(rng, strategy):
    """The strategies this test once found unported now run: each gives
    the JAX package's adjoint and forward (no plan in either package), and
    an unknown strategy still raises."""
    pos, batch = points(rng, 150, 2, 2)
    kw = dict(m=3, sigma=2.0, window="es", strategy=strategy)
    x = _values(rng, (150, 2), True)
    ref = tn.nfft_adjoint(jnp.asarray(x), pos, batch, N=16, **kw)
    got = tp.nfft_adjoint(x, pos, batch, N=16, device="cpu", **kw)
    assert rel_l2(got.numpy(), np.asarray(ref)) <= REL
    s = _values(rng, (2, 16, 16, 2), True)
    ref = tn.nfft_forward(jnp.asarray(s), pos, batch, **kw)
    got = tp.nfft_forward(s, pos, batch, device="cpu", **kw)
    assert rel_l2(got.numpy(), np.asarray(ref)) <= REL
    with pytest.raises(ValueError, match="unknown strategy"):
        tp.nfft_adjoint(x, pos, N=8, m=2, strategy="fast", device="cpu")


def test_entry_points_raise_without_a_card(rng, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pos, _ = points(rng, 50, 2)
    x = _values(rng, (50, 1), False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.nfft_adjoint(x, pos, N=8, m=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.nfft_forward(np.zeros((1, 8, 8, 1), np.float32), pos, m=2)


def test_plan_for_other_points_raises(rng):
    """ROADMAP.md C1: a host plan carries the bin-id fingerprint of its
    points. NumPy positions that bin differently raise in both packages; the
    plan's own points still give JAX's result."""
    A, _ = points(rng, 200, 2)
    B, _ = points(rng, 200, 2)
    jplan = jbinned.build_plan(A, N=16, m=3, sigma=2, window="es", K=128)
    plan = port_plan(jplan)
    assert plan.pos_fp == jplan.pos_fp is not None
    kw = dict(m=3, sigma=2.0, window="es")
    x = _values(rng, (200, 2), True)
    s = _values(rng, (1, 16, 16, 2), True)
    for pkg, p, xa, sa, extra in ((tn, jplan, jnp.asarray(x), jnp.asarray(s), {}),
                                  (tp, plan, x, s, dict(device="cpu"))):
        with pytest.raises(ValueError, match="fingerprint"):
            pkg.nfft_adjoint(xa, B, N=16, plan=p, **kw, **extra)
        with pytest.raises(ValueError, match="fingerprint"):
            pkg.nfft_forward(sa, B, plan=p, **kw, **extra)
    ref = tn.nfft_adjoint(jnp.asarray(x), A, N=16, plan=jplan, **kw)
    got = tp.nfft_adjoint(x, A, N=16, plan=plan, device="cpu", **kw)
    assert rel_l2(got.numpy(), np.asarray(ref)) <= REL
    ref = tn.nfft_forward(jnp.asarray(s), A, plan=jplan, **kw)
    got = tp.nfft_forward(s, A, plan=plan, device="cpu", **kw)
    assert rel_l2(got.numpy(), np.asarray(ref)) <= REL
