"""PyTorch port vs JAX package: the fastsum, its real and slot-layout
variants, the dense oracles, and the fastsum's gradients.

The cases of tests/test_fastsum.py run through both packages: the port's
binned engine agrees with the JAX package (its scatter/matmul engines at
these sizes, or the same plan carried across) to 1e-5 of the output's
largest entry, and meets the JAX tests' own bars against the oracles.
Gradients in x, the coefficients, the sources and the targets are held
against ``jax.grad`` on the cases of tests/test_grad.py, at 5e-5 of the
reference's largest entry (the bar of tests/test_torch_grad.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import port_plan, rel_l2
from helpers import make_points, max_err, rel_err

import torch_nfft_tpu as tn
import torch_nfft_tpu_torch as tp
from torch_nfft_tpu.ops import binned as jbinned
from torch_nfft_tpu.ops import planar as jplanar
from torch_nfft_tpu_torch import trace
from torch_nfft_tpu_torch.ops import binned as pbinned
from torch_nfft_tpu_torch.ops import nfft as pnfft
from torch_nfft_tpu_torch.ops.planar import (fastsum_spectral_stages, fastsum_stages,
                                             slot_io_ok)

REL = 1e-5


def assert_close(got, ref, rel=REL):
    """max |got - ref| <= rel * max |ref|."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= rel * float(np.abs(ref).max())


def _gauss_dense(pos_s, pos_t, sigma):
    d2 = ((pos_t[:, None, :] - pos_s[None, :, :]) ** 2).sum(-1)
    return np.exp(-d2 / sigma**2)


@pytest.mark.parametrize("kind", ["analytic", "interpolated"])
def test_fastsum_coeffs_against_jax_and_oracles(rng, kind):
    n, dim, sigma, N, m = 200, 2, 0.2, 8, 3
    pos, _ = make_points(rng, n, dim)
    if kind == "analytic":
        pos /= np.abs(pos).max() * 4 / 0.95
        coeffs = tn.gaussian_analytic_coeffs(sigma, dim=dim, N=N)
        pcoeffs = tp.gaussian_analytic_coeffs(sigma, dim=dim, N=N, device="cpu")
    else:
        coeffs = tn.gaussian_interpolated_coeffs(sigma, dim=dim, N=N, p=-1)
        pcoeffs = tp.gaussian_interpolated_coeffs(sigma, dim=dim, N=N, p=-1, device="cpu")
    eye = np.eye(n, dtype=np.float32)
    A = tp.nfft_fastsum(eye, pcoeffs, pos, cutoff=m, device="cpu")
    assert A.dtype == torch.float32
    assert_close(A.numpy(), tn.nfft_fastsum(eye, coeffs, pos, cutoff=m))
    A_trig = tp.exact_trigonometric_matrix(pcoeffs, torch.from_numpy(pos)).real
    assert max_err(A.numpy(), A_trig.numpy()) < 5e-4
    assert max_err(A.numpy(), _gauss_dense(pos, pos, sigma)) < 5e-3


def test_fastsum_matches_ndft_fastsum(rng):
    n, dim, N, m = 150, 2, 16, 4
    pos, _ = make_points(rng, n, dim)
    x = rng.random((n, 3), dtype=np.float32)
    coeffs = tn.gaussian_analytic_coeffs(0.3, dim=dim, N=N)
    y = tp.nfft_fastsum(x, np.asarray(coeffs), pos, cutoff=m, device="cpu")
    assert_close(y.numpy(), tn.nfft_fastsum(x, coeffs, pos, cutoff=m))
    y_ref = tp.ndft_fastsum(torch.from_numpy(x), np.asarray(coeffs), pos, N=N)
    assert rel_err(y.numpy(), y_ref.numpy()) < 1e-3


def test_fastsum_asymmetric_targets(rng):
    dim, N, m = 2, 16, 4
    src, _ = make_points(rng, 120, dim)
    tgt, _ = make_points(rng, 80, dim)
    x = rng.random((120, 2), dtype=np.float32)
    coeffs = tn.gaussian_analytic_coeffs(0.3, dim=dim, N=N)
    y = tp.nfft_fastsum(x, np.asarray(coeffs), src, tgt, cutoff=m, device="cpu")
    assert tuple(y.shape) == (80, 2)
    assert_close(y.numpy(), tn.nfft_fastsum(x, coeffs, src, tgt, cutoff=m))
    y_ref = tp.ndft_fastsum(torch.from_numpy(x), np.asarray(coeffs), src, tgt, N=N)
    assert rel_err(y.numpy(), y_ref.numpy()) < 1e-3


def test_fastsum_batched(rng):
    dim, N, m, b, n = 2, 16, 4, 3, 60
    pos, batch = make_points(rng, n, dim, batches=b)
    x = rng.random((n * b, 2), dtype=np.float32)
    coeffs = np.asarray(tn.gaussian_analytic_coeffs(0.3, dim=dim, N=N))
    y = tp.nfft_fastsum(x, coeffs, pos, batch=batch, cutoff=m, device="cpu")
    assert_close(y.numpy(), tn.nfft_fastsum(x, coeffs, pos, batch=batch, cutoff=m))
    y_ref = tp.ndft_fastsum(torch.from_numpy(x), coeffs, pos, batch=batch, N=N)
    assert rel_err(y.numpy(), y_ref.numpy()) < 1e-3
    # block diagonal: batch 0's output depends on batch 0's x only
    x2 = x.copy()
    x2[n:] += 1.0
    y2 = tp.nfft_fastsum(x2, coeffs, pos, batch=batch, cutoff=m, device="cpu")
    np.testing.assert_allclose(y[:n].numpy(), y2[:n].numpy(), atol=1e-5)


def test_fastsum_complex_input_and_coeffs(rng):
    dim, N, m, n = 1, 32, 4, 100
    pos, _ = make_points(rng, n, dim)
    x = (rng.random((n, 2)) + 1j * rng.random((n, 2))).astype(np.complex64)
    r = tp.radial_interpolation_grid(dim=dim, N=N, device="cpu")
    coeffs = tp.interpolated_kernel_coeffs(torch.exp(-(r**2) / 0.1), device="cpu")
    rj = np.asarray(tn.radial_interpolation_grid(dim=dim, N=N))
    jcoeffs = tn.interpolated_kernel_coeffs(np.exp(-(rj**2) / 0.1))
    y = tp.nfft_fastsum(x, coeffs, pos, cutoff=m, device="cpu")
    assert y.dtype == torch.complex64
    assert_close(y.numpy(), tn.nfft_fastsum(x, jcoeffs, pos, cutoff=m))
    y_ref = tp.ndft_fastsum(torch.from_numpy(x), coeffs, pos, N=N)
    assert rel_err(y.numpy(), y_ref.numpy()) < 1e-3
    # real x with the complex coefficients: real output, as JAX's .real
    yr = tp.nfft_fastsum(x.real.copy(), coeffs, pos, cutoff=m, device="cpu")
    assert yr.dtype == torch.float32
    assert_close(yr.numpy(), tn.nfft_fastsum(x.real.copy(), jcoeffs, pos, cutoff=m))


def test_fastsum_checks_its_arguments(rng):
    pos, _ = make_points(rng, 40, 2)
    x = rng.random((40, 1), dtype=np.float32)
    with pytest.raises(ValueError, match="2-dimensional"):
        tp.nfft_fastsum(x, np.ones((8,), np.float32), pos, device="cpu")
    with pytest.raises(ValueError, match="equal size"):
        tp.nfft_fastsum(x, np.ones((8, 4), np.float32), pos, device="cpu")
    with pytest.raises(ValueError, match="batch size"):
        tp.nfft_fastsum(x, np.ones((8, 8), np.float32), pos, pos,
                        np.zeros(40, np.int32), np.repeat([0, 1], 20).astype(np.int32),
                        device="cpu")


def _real_case(rng, n=200, dim=2, N=16, m=4, C=2, K=128, T=None):
    pos, _ = make_points(rng, n, dim, scale="box")
    x = rng.standard_normal((n, C)).astype(np.float32)
    coeffs = np.asarray(tn.gaussian_analytic_coeffs(0.25, dim=dim, N=N))
    jplan = jbinned.build_plan(pos, None, N=N, m=m, K=K, T=T)
    batch = np.zeros(n, np.int32)
    return pos, batch, x, coeffs, jplan, port_plan(jplan)


def test_fastsum_real_user_and_slot_order_match_jax(rng):
    pos, batch, x, coeffs, jplan, plan = _real_case(rng)
    kw = dict(batch_size=1, N=16, m=4)
    jp, jb = jnp.asarray(pos), jnp.asarray(batch)
    ref = jplanar.nfft_fastsum_real(jnp.asarray(x), jnp.asarray(coeffs), jp, jp, jb, jb,
                                    jplan, jplan, **kw)
    got = tp.nfft_fastsum_real(x, coeffs, pos, pos, batch, batch, plan, plan, device="cpu",
                               **kw)
    assert got.dtype == torch.float32
    assert_close(got.numpy(), ref)
    # slot order on the same plan: the slot vectors themselves agree
    v = tp.to_slot_order(plan, torch.from_numpy(x))
    vj = jbinned.to_slot_order(jplan, jnp.asarray(x))
    assert_close(v.numpy(), vj)
    refs = jplanar.nfft_fastsum_real(vj, jnp.asarray(coeffs), jp, jp, jb, jb, jplan, jplan,
                                     slot_io=True, **kw)
    gots = tp.nfft_fastsum_real(v, coeffs, pos, pos, batch, batch, plan, plan, slot_io=True,
                                device="cpu", **kw)
    assert tuple(gots.shape) == (2, plan.S * plan.K)
    assert_close(gots.numpy(), refs)
    assert_close(tp.from_slot_order(plan, gots).numpy(), ref)


@pytest.mark.parametrize("which", ["no plan", "tiles that do not partition the grid"])
def test_fastsum_real_slot_io_refused_where_jax_refuses(rng, which):
    T = 12 if which != "no plan" else None  # M = 32 is no multiple of 12
    pos, batch, x, coeffs, jplan, plan = _real_case(rng, T=T)
    kw = dict(batch_size=1, N=16, m=4, slot_io=True)
    if which == "no plan":
        jplan = plan = None
    v = np.zeros((2, 128), np.float32)
    assert not slot_io_ok(plan, 2, 1)
    jp, jb = jnp.asarray(pos), jnp.asarray(batch)
    with pytest.raises(ValueError, match="slot_io"):
        jplanar.nfft_fastsum_real(jnp.asarray(v), jnp.asarray(coeffs), jp, jp, jb, jb,
                                  jplan, jplan, **kw)
    with pytest.raises(ValueError, match="slot_io"):
        tp.nfft_fastsum_real(v, coeffs, pos, pos, batch, batch, plan, plan, device="cpu",
                             **kw)


def test_fastsum_slot_vector_is_the_same_on_the_flat_route(rng, monkeypatch):
    """The flat-grid route (per-row tiles) takes and gives the same slot
    vectors as the dense route, in both directions and in user order."""
    pos, batch, x, coeffs, jplan, plan = _real_case(rng)
    kw = dict(batch_size=1, N=16, m=4, device="cpu")
    v = tp.to_slot_order(plan, torch.from_numpy(x))
    dense_s = tp.nfft_fastsum_real(v, coeffs, pos, pos, batch, batch, plan, plan,
                                   slot_io=True, **kw)
    dense_u = tp.nfft_fastsum(x, coeffs, pos, source_plan=plan, cutoff=4, device="cpu")
    monkeypatch.setattr(pbinned, "use_fold", lambda *a, **k: False)
    flat_s = tp.nfft_fastsum_real(v, coeffs, pos, pos, batch, batch, plan, plan,
                                  slot_io=True, **kw)
    flat_u = tp.nfft_fastsum(x, coeffs, pos, source_plan=plan, cutoff=4, device="cpu")
    assert_close(flat_s.numpy(), dense_s.numpy())
    assert_close(flat_u.numpy(), dense_u.numpy())


def test_fastsum_runs_its_stages_in_order(rng):
    """The stages chip_smoke.py times one by one are the fastsum's own: on
    half spectra for nfft_fastsum of real x with real coefficients (so for
    GramMatrix.apply) and for nfft_fastsum_real, complex to complex for
    nfft_fastsum of complex x."""
    pos, batch, x, coeffs, jplan, plan = _real_case(rng)
    half = ["rfftn", "filter", "irfftn"]
    for spectral, want in (
            (half, tp.nfft_fastsum(x, coeffs, pos, source_plan=plan, cutoff=4, device="cpu")),
            (half, tp.nfft_fastsum_real(x, coeffs, pos, pos, None, None, plan, plan,
                                        batch_size=1, N=16, m=4, device="cpu"))):
        stages = fastsum_stages(plan, plan, torch.from_numpy(coeffs), m=4, sigma=2.0,
                                window="gaussian", C=2)
        assert [name for name, _ in stages] == [
            "slot_values", "spread kernel", "fold", *spectral, "unfold", "gather kernel",
            "unslot_values"]
        v = torch.from_numpy(x)
        for _, fn in stages:
            v = fn(v)
        assert torch.equal(v, want)
    # complex x: its real and imaginary planes (4 columns) through the C2C stages
    xc = (x + 1j * rng.standard_normal(x.shape)).astype(np.complex64)
    want = tp.nfft_fastsum(xc, coeffs, pos, source_plan=plan, cutoff=4, device="cpu")
    route = pbinned.tile_route(plan, 4)
    stages = (route.spreading
              + fastsum_spectral_stages(torch.from_numpy(coeffs), dim=2, N=16, M=plan.M, m=4,
                                        sigma=2.0, window="gaussian", complex_x=True,
                                        hermitian=False)
              + route.gathering)
    assert [name for name, _ in stages] == [
        "slot_values", "spread kernel", "fold", "ifftn", "filter", "fftn", "unfold",
        "gather kernel", "unslot_values"]
    v = torch.from_numpy(np.concatenate([xc.real, xc.imag], axis=1))
    for _, fn in stages:
        v = fn(v)
    assert torch.equal(torch.complex(v[:, :2], v[:, 2:]), want)


def test_slot_spread_and_gather_are_transposes(rng):
    """<spread_slot(v), g> == <v, gather_slot(g)>, and autograd of each is
    the other."""
    pos, batch, x, coeffs, jplan, plan = _real_case(rng)
    v = tp.to_slot_order(plan, torch.from_numpy(x)).requires_grad_()
    g = torch.randn((1, 2) + (plan.M,) * plan.dim, generator=torch.Generator().manual_seed(3))
    g.requires_grad_()
    a = (pbinned.spread_binned_slot(plan, v) * g).sum()
    b = (v * pbinned.gather_binned_slot(plan, g)).sum()
    assert abs(float(a.detach()) - float(b.detach())) <= 1e-5 * abs(float(a.detach()))
    dv, = torch.autograd.grad(a, v)
    dg, = torch.autograd.grad(b, g)
    assert torch.equal(dv, pbinned.gather_binned_slot(plan, g.detach()))
    assert torch.equal(dg, pbinned.spread_binned_slot(plan, v.detach()))


def test_oracles_match_jax(rng):
    from torch_nfft_tpu.ops import ndft as jndft

    dim, N = 2, 8
    pos, batch = make_points(rng, 40, dim, batches=2)
    tgt, _ = make_points(rng, 80, dim)
    x = rng.standard_normal((80, 2)).astype(np.float32)
    coeffs = np.asarray(tn.gaussian_interpolated_coeffs(0.3, dim=dim, N=N))
    got = tp.ndft_fastsum(torch.from_numpy(x), coeffs, pos, tgt, batch, batch, N=N)
    assert got.dtype == torch.float32
    assert_close(got.numpy(), jndft.ndft_fastsum(x, coeffs, pos, tgt, batch, batch, N=N))
    for b in (None, batch):
        assert_close(tp.exact_trigonometric_matrix(coeffs, pos, None, b).numpy(),
                     jndft.exact_trigonometric_matrix(coeffs, pos, None, b))
        assert_close(tp.exact_gaussian_matrix(0.3, pos, tgt if b is None else None, b).numpy(),
                     jndft.exact_gaussian_matrix(0.3, pos, tgt if b is None else None, b))
        got = tp.exact_radial_matrix(lambda r: 1.0 / (1.0 + r * r), pos, None, b)
        assert got.dtype == torch.float64  # JAX's is float32 without x64
        assert_close(got.numpy(), jndft.exact_radial_matrix(
            lambda r: 1.0 / (1.0 + r * r), pos, None, b))
    asym = tp.exact_trigonometric_matrix(coeffs, pos, tgt)
    assert tuple(asym.shape) == (80, 80)
    assert_close(asym.numpy(), jndft.exact_trigonometric_matrix(coeffs, pos, tgt))


# ---------------------------------------------------------------------------
# The route rule: a real x on half spectra (real or complex coefficients),
# a complex x complex to complex
# ---------------------------------------------------------------------------


def _routes():
    c = trace.counters()
    return c["fastsum_route.half"], c["fastsum_route.c2c"]


def _c2c_stages(*args, **kwargs):
    """``fastsum_spectral_stages`` held to complex to complex."""
    return fastsum_spectral_stages(*args, **{**kwargs, "hermitian": False})


def _coeffs(rng, N, dim, kind):
    """Coefficients that are not even, float32 or complex64."""
    c = rng.standard_normal((N,) * dim)
    if kind == "complex":
        c = c + 1j * rng.standard_normal((N,) * dim)
    return c.astype(np.complex64 if kind == "complex" else np.float32)


@pytest.mark.parametrize("strategy", ["binned", "scatter"])
@pytest.mark.parametrize("dim,N", [(1, 32), (2, 16), (3, 8)])
def test_fastsum_real_x_runs_half_spectra_and_matches_jax(rng, dim, N, strategy):
    """Real x and real coefficients that are not even: nfft_fastsum takes
    the half-spectrum route and agrees with JAX's nfft_fastsum (its C2C
    round trip's real part)."""
    n, m = 300, 3
    pos, _ = make_points(rng, n, dim, scale="box")
    x = rng.standard_normal((n, 2)).astype(np.float32)
    c = _coeffs(rng, N, dim, "real")
    before = _routes()
    y = tp.nfft_fastsum(x, c, pos, cutoff=m, strategy=strategy, device="cpu")
    assert _routes() == (before[0] + 1, before[1])
    assert y.dtype == torch.float32
    assert_close(y.numpy(), tn.nfft_fastsum(x, c, pos, cutoff=m, strategy=strategy))


@pytest.mark.parametrize("kind", ["real", "complex"])
@pytest.mark.parametrize("wrt", ["x", "coeffs", "sources", "targets"])
@pytest.mark.parametrize("dim,N", [(2, 16), (3, 8)])
def test_fastsum_half_route_gradients_match_c2c(rng, monkeypatch, dim, N, wrt, kind):
    """For a real x, the half-spectrum route's output and its gradients in
    x, the coefficients (real or complex, not even) and the points equal
    those through the C2C stages: the same function of all three."""
    src, _ = make_points(rng, 120, dim, scale="box")
    tgt, _ = make_points(rng, 90, dim, scale="box")
    inputs = dict(x=rng.standard_normal((120, 2)).astype(np.float32),
                  coeffs=_coeffs(rng, N, dim, kind), sources=src, targets=tgt)

    def run():
        args = {k: torch.from_numpy(v.copy()) for k, v in inputs.items()}
        args[wrt].requires_grad_()
        y = tp.nfft_fastsum(args["x"], args["coeffs"], args["sources"], args["targets"],
                            cutoff=3, strategy="binned", device="cpu")
        (y**2).sum().backward()
        return y.detach().numpy(), args[wrt].grad.numpy()

    before = _routes()
    y_half, g_half = run()
    assert _routes() == (before[0] + 1, before[1])
    monkeypatch.setattr(pnfft, "fastsum_spectral_stages", _c2c_stages)
    y_c2c, g_c2c = run()
    assert_close(y_half, y_c2c)
    assert_close(g_half, g_c2c)


@pytest.mark.parametrize("which", ["complex x", "complex x and coefficients",
                                   "complex coefficients"])
def test_fastsum_route_follows_the_dtype_of_x(rng, which):
    """A complex x keeps the C2C route, with real or complex
    coefficients; a real x with complex coefficients takes half spectra.
    Each agrees with JAX's result."""
    n, dim, N, m = 200, 2, 16, 3
    pos, _ = make_points(rng, n, dim, scale="box")
    x = rng.standard_normal((n, 2)).astype(np.float32)
    c = _coeffs(rng, N, dim, "real" if which == "complex x" else "complex")
    if which != "complex coefficients":
        x = (x + 1j * rng.standard_normal(x.shape)).astype(np.complex64)
    before = _routes()
    y = tp.nfft_fastsum(x, c, pos, cutoff=m, strategy="binned", device="cpu")
    half = which == "complex coefficients"
    assert _routes() == (before[0] + half, before[1] + (not half))
    assert y.dtype == (torch.float32 if half else torch.complex64)
    assert_close(y.numpy(), tn.nfft_fastsum(x, c, pos, cutoff=m, strategy="binned"))


# ---------------------------------------------------------------------------
# Gradients against jax.grad (tests/test_grad.py:60, 158, 187, 236)
# ---------------------------------------------------------------------------

GRAD = 5e-5


def test_fastsum_grad_x_matches_jax(rng):
    n, dim, b, c, N, m = 5, 2, 2, 3, 16, 3
    pos, batch = make_points(rng, n, dim, batches=b)
    x0 = rng.random((n * b, c), dtype=np.float32)
    coeffs = tn.gaussian_interpolated_coeffs(0.2, dim, N)
    ref = jax.grad(lambda x: jnp.abs(tn.nfft_fastsum(x, coeffs, pos, batch=batch,
                                                     cutoff=m)).sum())(jnp.asarray(x0))
    x = torch.from_numpy(x0).requires_grad_()
    tp.nfft_fastsum(x, np.asarray(coeffs), pos, batch=batch, cutoff=m,
                    device="cpu").abs().sum().backward()
    assert_close(x.grad.numpy(), ref, rel=GRAD)


@pytest.mark.parametrize("side", ["sources", "targets", "both (targets is sources)"])
def test_fastsum_position_gradients_match_jax(rng, side):
    n, dim, N, m = 6, 2, 16, 4
    src0, _ = make_points(rng, n, dim)
    tgt0, _ = make_points(rng, n, dim)
    x0 = rng.random((n, 1), dtype=np.float32)
    coeffs = tn.gaussian_analytic_coeffs(0.25, dim=dim, N=N)
    kw = dict(cutoff=m)

    def jloss(p):
        if side == "sources":
            y = tn.nfft_fastsum(jnp.asarray(x0), coeffs, p, jnp.asarray(tgt0), **kw)
        elif side == "targets":
            y = tn.nfft_fastsum(jnp.asarray(x0), coeffs, jnp.asarray(src0), p, **kw)
        else:
            y = tn.nfft_fastsum(jnp.asarray(x0), coeffs, p, **kw)
        return jnp.sum(y**2)

    p0 = tgt0 if side == "targets" else src0
    ref = jax.grad(jloss)(jnp.asarray(p0))
    p = torch.from_numpy(p0.copy()).requires_grad_()
    c = np.asarray(coeffs)
    if side == "sources":
        y = tp.nfft_fastsum(x0, c, p, tgt0, device="cpu", **kw)
    elif side == "targets":
        y = tp.nfft_fastsum(x0, c, src0, p, device="cpu", **kw)
    else:
        y = tp.nfft_fastsum(x0, c, p, device="cpu", **kw)
    (y**2).sum().backward()
    assert_close(p.grad.numpy(), ref, rel=GRAD)


def test_fastsum_coeffs_gradients_match_jax(rng):
    n, dim, N, m = 8, 2, 8, 3
    pos, _ = make_points(rng, n, dim)
    x0 = rng.random((n, 1), dtype=np.float32)
    c0 = np.asarray(tn.gaussian_analytic_coeffs(0.25, dim=dim, N=N))
    ref = jax.grad(lambda c: jnp.sum(tn.nfft_fastsum(jnp.asarray(x0), c, jnp.asarray(pos),
                                                     cutoff=m) ** 2))(jnp.asarray(c0))
    c = torch.from_numpy(c0.copy()).requires_grad_()
    (tp.nfft_fastsum(x0, c, pos, cutoff=m, device="cpu") ** 2).sum().backward()
    assert_close(c.grad.numpy(), ref, rel=GRAD)


def test_fastsum_real_gradients_match_jax(rng):
    n, dim, N, m = 6, 2, 8, 3
    pos, _ = make_points(rng, n, dim)
    x0 = rng.random((n, 1), dtype=np.float32)
    coeffs = tn.gaussian_analytic_coeffs(0.25, dim=dim, N=N)
    p, b = jnp.asarray(pos), jnp.zeros((n,), jnp.int32)
    ref = jax.grad(lambda x: jnp.sum(jplanar.nfft_fastsum_real(
        x, coeffs, p, p, b, b, batch_size=1, N=N, m=m) ** 2))(jnp.asarray(x0))
    x = torch.from_numpy(x0.copy()).requires_grad_()
    bt = np.zeros(n, np.int32)
    y = tp.nfft_fastsum_real(x, np.asarray(coeffs), pos, pos, bt, bt, batch_size=1, N=N, m=m,
                             device="cpu")
    (y**2).sum().backward()
    assert_close(x.grad.numpy(), ref, rel=GRAD)
    assert rel_l2(x.grad.numpy(), np.asarray(ref)) <= 3e-5
