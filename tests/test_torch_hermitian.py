"""PyTorch port vs JAX package: the spectral stage on half spectra
(``rfftn``/``irfftn``) for real grids and real outputs, against the port's
complex-to-complex formulation and the JAX package's pruned DFTs and
Hermitian pipelines (the cases of tests/test_hermitian.py).

The port halves the last axis where the JAX package halves axis 0, so the
half spectra themselves are not compared: what they give is. Outputs agree
to 1e-5 of the output's largest entry, gradients to 5e-5; dims 1-3, N even
and odd, the gaussian, es and kb windows, and the asymmetric band's -N/2
edge planes set on purpose. For an odd N the JAX package's planar
pipelines take their full-spectrum path (its band is symmetric), which
the port's half path must still give.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import points, port_plan, rel_l2

import torch_nfft_tpu_torch as tp
from torch_nfft_tpu.ops import binned as jbinned
from torch_nfft_tpu.ops import fft as jfft
from torch_nfft_tpu.ops import planar as jplanar
from torch_nfft_tpu_torch.ops import fft as pfft
from torch_nfft_tpu_torch.ops.spectral import fastsum_band_filter


def assert_close(got, ref, frac=1e-5):
    """max |got - ref| <= frac * max |ref|."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert float(np.abs(got - ref).max()) <= frac * float(np.abs(ref).max())


GRIDS = [
    # dim, N, M, window
    (1, 16, 32, "gaussian"),
    (1, 15, 30, "es"),
    (2, 16, 32, "es"),
    (2, 9, 18, "kb"),
    (2, 8, 13, "gaussian"),
    (3, 8, 16, "kb"),
    (3, 7, 14, "gaussian"),
    (3, 16, 26, "es"),
]


def _to_jax_layout(g, dim):
    """The port's grid (B, C, M^dim) -> JAX's DFT layout (B, L_1, ...,
    L_{dim-1}, C, L_0)."""
    return np.ascontiguousarray(np.transpose(g, [0] + list(range(3, 2 + dim)) + [1, 2]))


def _from_jax_layout(g, dim):
    return np.ascontiguousarray(np.transpose(g, [0, dim, dim + 1] + list(range(1, dim))))


def _grid(rng, dim, M, B=2, C=2):
    return rng.standard_normal((B, C) + (M,) * dim).astype(np.float32)


@pytest.mark.parametrize("dim,N,M,window", GRIDS)
def test_adjoint_half_matches_full_and_jax(rng, dim, N, M, window):
    """The half spectrum, mirrored onto the band, is the C2C adjoint and
    the JAX package's pruned adjoint."""
    m, sigma = 3, M / N
    g = _grid(rng, dim, M)
    half = pfft.spectral_adjoint_half(torch.from_numpy(g), dim, N, m, sigma, window)
    assert half.shape == (2, 2) + (2 * (N // 2) + 1,) * (dim - 1) + (N // 2 + 1,)
    got = pfft.half_spectrum_to_full(half, dim, N).numpy()
    full = pfft.spectral_adjoint(torch.from_numpy(g), dim, N, m, sigma, window).numpy()
    assert_close(got, full)
    jr, ji = jfft.spectral_adjoint_pruned_dft(jnp.asarray(_to_jax_layout(g, dim)), None, dim,
                                              N, m, sigma, M=M, window=window)
    assert_close(np.moveaxis(got, 1, -1), np.asarray(jr) + 1j * np.asarray(ji))


@pytest.mark.parametrize("dim,N,M,window", GRIDS)
def test_forward_half_matches_full_pair(rng, dim, N, M, window):
    """Round trip: the real-output forward of an adjoint's half spectrum,
    through the band's Hermitian filter, is the C2C forward's real plane
    and the JAX package's real-only pruned forward of the full band."""
    m, sigma = 3, M / N
    g = _grid(rng, dim, M)
    half = pfft.spectral_adjoint_half(torch.from_numpy(g), dim, N, m, sigma, window)
    w = pfft.band_filter_half(dim, N)
    assert (w is None) == (N % 2 == 1)
    got = pfft.spectral_forward_half(half if w is None else half * w, dim, N, M, m, sigma,
                                     window).numpy()
    full = pfft.spectral_adjoint(torch.from_numpy(g), dim, N, m, sigma, window)
    assert_close(got, pfft.spectral_forward(full, dim, M, m, sigma, window).real.numpy())
    jr, ji = jfft.spectral_adjoint_pruned_dft(jnp.asarray(_to_jax_layout(g, dim)), None, dim,
                                              N, m, sigma, M=M, window=window)
    ref, _ = jfft.spectral_forward_pruned_dft(jr, ji, dim, M, m, sigma, real_only=True,
                                              window=window)
    assert_close(got, _from_jax_layout(np.asarray(ref), dim))
    if N % 2 == 0:  # the JAX package's own half path
        hr, hi = jfft.spectral_adjoint_half_dft(jnp.asarray(_to_jax_layout(g, dim)), dim, N,
                                                m, sigma, M=M, window=window)
        ref, _ = jfft.spectral_forward_half_dft(hr, hi, dim, M, m, sigma, window=window)
        assert_close(got, _from_jax_layout(np.asarray(ref), dim))


@pytest.mark.parametrize("even", [True, False])
@pytest.mark.parametrize("dim,N,M,window", [g for g in GRIDS if g[1] <= 9 or g[0] < 3])
def test_filtered_pair_matches_full(rng, dim, N, M, window, even):
    """Fastsum-style chain: adjoint, filter, real-output forward. The half
    path's filter is the coefficients' Hermitian part: it gives the C2C
    chain for any coefficients; for even real ones also the JAX package's
    half path (``full_filter_to_half``, exact for even filters only)."""
    m, sigma = 2, M / N
    g = _grid(rng, dim, M)
    k = np.arange(N) - N // 2
    if even:
        c1 = np.exp(-0.13 * k.astype(np.float64) ** 2)
        c = c1
        for _ in range(dim - 1):
            c = np.multiply.outer(c, c1)
        c = c.astype(np.float32)
    else:
        c = (rng.standard_normal((N,) * dim) + 1j * rng.standard_normal((N,) * dim)).astype(
            np.complex64)
    ct = torch.from_numpy(c)
    half = pfft.spectral_adjoint_half(torch.from_numpy(g), dim, N, m, sigma, window)
    got = pfft.spectral_forward_half(half * pfft.full_to_half(ct, dim, N), dim, N, M, m,
                                     sigma, window).numpy()
    axes = tuple(range(2, 2 + dim))
    gh = torch.fft.ifftn(torch.from_numpy(g), dim=axes, norm="forward")
    ref = torch.fft.fftn(gh * fastsum_band_filter(ct, N, m, M, sigma, window), dim=axes).real
    assert_close(got, ref.numpy())
    if even and N % 2 == 0:
        gj = jnp.asarray(_to_jax_layout(g, dim))
        hr, hi = jfft.spectral_adjoint_half_dft(gj, dim, N, m, sigma, M=M, window=window)
        ch = jfft.full_filter_to_half(jnp.asarray(c), dim, N)[None, ..., None]
        ref, _ = jfft.spectral_forward_half_dft(hr * ch, hi * ch, dim, M, m, sigma,
                                                window=window)
        assert_close(got, _from_jax_layout(np.asarray(ref), dim))


# ---------------------------------------------------------------------------
# The planar entry points
# ---------------------------------------------------------------------------

CASES = [
    # dim, N, B, C, m, sigma, window
    (1, 32, 1, 2, 3, 2.0, "gaussian"),
    (1, 31, 2, 1, 3, 2.0, "kb"),
    (2, 16, 2, 2, 3, 2.0, "es"),
    (2, 15, 1, 2, 3, 2.0, "gaussian"),
    (3, 8, 2, 2, 2, 1.625, "kb"),
    (3, 9, 1, 1, 2, 2.0, "es"),
    (3, 16, 1, 1, 2, 1.625, "es"),
]


def _case(rng, dim, N, B, C, m, sigma, window, n=400):
    pos, batch = points(rng, n, dim, B)
    x = rng.standard_normal((n, C)).astype(np.float32)
    jplan = jbinned.build_plan(pos, batch, N=N, m=m, sigma=sigma, batch_size=B, K=128,
                               window=window)
    kw = dict(batch_size=B, m=m, sigma=sigma, window=window)
    return pos, batch, x, jplan, port_plan(jplan), kw


@pytest.mark.parametrize("planned", [True, False])
@pytest.mark.parametrize("dim,N,B,C,m,sigma,window", CASES)
def test_pair_and_adjoint_match_jax(rng, dim, N, B, C, m, sigma, window, planned):
    """nfft_pair_planar and nfft_adjoint_planar on half spectra against the
    JAX package's, on one carried plan (binned) or without a plan (the
    "auto" engines of both)."""
    pos, batch, x, jplan, plan, kw = _case(rng, dim, N, B, C, m, sigma, window)
    jargs = (jnp.asarray(x), jnp.asarray(pos), jnp.asarray(batch), jplan if planned else None)
    pargs = (x, pos, batch, plan if planned else None)
    ref = jplanar.nfft_pair_planar(*jargs, N=N, **kw)
    got = tp.nfft_pair_planar(*pargs, N=N, device="cpu", **kw)
    assert got.shape == (len(x), C) and got.dtype == torch.float32
    assert_close(got.numpy(), ref)
    jr, ji = jplanar.nfft_adjoint_planar(*jargs, N=N, **kw)
    yr, yi = tp.nfft_adjoint_planar(*pargs, N=N, device="cpu", **kw)
    assert_close(yr.numpy() + 1j * yi.numpy(), np.asarray(jr) + 1j * np.asarray(ji))


@pytest.mark.parametrize("dim,N,B,C,m,sigma,window", CASES)
def test_forward_real_output_with_edge_planes_set(rng, dim, N, B, C, m, sigma, window):
    """The real-output forward of a spectrum that is zero but for its
    -N/2 edge planes (the planes without a +N/2 partner), and of a random
    one: the JAX package's, and the port's two-plane (C2C) forward's real
    plane."""
    pos, batch, x, jplan, plan, kw = _case(rng, dim, N, B, C, m, sigma, window)
    shape = (B,) + (N,) * dim + (C,)
    edges = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    for part in edges:
        for ax in range(1, 1 + dim):
            idx = [slice(None)] * len(shape)
            idx[ax] = 0  # k = -N/2 (for an odd N the band's lowest frequency)
            part[tuple(idx)] = rng.standard_normal(part[tuple(idx)].shape)
    dense = tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    for xr, xi in (edges, dense):
        ref, _ = jplanar.nfft_forward_planar(jnp.asarray(xr), jnp.asarray(xi),
                                             jnp.asarray(pos), jnp.asarray(batch), jplan,
                                             dim=dim, real_output=True, **kw)
        got, none = tp.nfft_forward_planar(xr, xi, pos, batch, plan, dim=dim,
                                           real_output=True, device="cpu", **kw)
        assert none is None
        assert_close(got.numpy(), ref)
        both, _ = tp.nfft_forward_planar(xr, xi, pos, batch, plan, dim=dim, device="cpu",
                                         **kw)
        assert_close(got.numpy(), both.numpy())


@pytest.mark.parametrize("slot_io", [False, True])
@pytest.mark.parametrize("dim,N,window", [(2, 16, "gaussian"), (2, 15, "es"),
                                          (3, 8, "kb"), (3, 9, "gaussian")])
def test_fastsum_real_matches_jax(rng, dim, N, window, slot_io):
    """nfft_fastsum_real on half spectra (Gaussian coefficients, even)
    against the JAX package's, in user and slot order (where both refuse
    the slot order, tiles that do not partition the grid, both raise)."""
    n, m = 400, 3
    pos, batch = points(rng, n, dim)
    x = rng.standard_normal((n, 2)).astype(np.float32)
    coeffs = np.asarray(tp.gaussian_analytic_coeffs(0.3, dim, N, device="cpu"))
    jplan = jbinned.build_plan(pos, batch, N=N, m=m, batch_size=1, K=128, window=window)
    plan = port_plan(jplan)
    kw = dict(batch_size=1, N=N, m=m, window=window)
    jp, jb = jnp.asarray(pos), jnp.asarray(batch)
    ref = jplanar.nfft_fastsum_real(jnp.asarray(x), jnp.asarray(coeffs), jp, jp, jb, jb,
                                    jplan, jplan, **kw)
    if slot_io and (2 * N) % plan.T:
        with pytest.raises(ValueError, match="slot_io"):
            jplanar.nfft_fastsum_real(jnp.asarray(x).T, jnp.asarray(coeffs), jp, jp, jb, jb,
                                      jplan, jplan, slot_io=True, **kw)
        with pytest.raises(ValueError, match="slot_io"):
            tp.nfft_fastsum_real(x.T, coeffs, pos, pos, batch, batch, plan, plan,
                                 slot_io=True, device="cpu", **kw)
        return
    if slot_io:
        v = tp.to_slot_order(plan, torch.from_numpy(x))
        got = tp.nfft_fastsum_real(v, coeffs, pos, pos, batch, batch, plan, plan,
                                   slot_io=True, device="cpu", **kw)
        got = tp.from_slot_order(plan, got)
    else:
        got = tp.nfft_fastsum_real(x, coeffs, pos, pos, batch, batch, plan, plan,
                                   device="cpu", **kw)
    assert_close(got.numpy(), ref)


def test_fastsum_real_takes_any_coefficients(rng):
    """Non-even complex coefficients: the Hermitian filter gives the real
    part of the C2C fastsum (nfft_fastsum's), also on the asymmetric band."""
    n, dim, N, m = 300, 2, 16, 3
    pos, _ = points(rng, n, dim)
    x = rng.standard_normal((n, 2)).astype(np.float32)
    c = (rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))).astype(np.complex64)
    got = tp.nfft_fastsum_real(x, c, pos, pos, batch_size=1, N=N, m=m, device="cpu")
    ref = tp.nfft_fastsum(x, c, pos, cutoff=m, device="cpu")
    assert_close(got.numpy(), ref.numpy())


@pytest.mark.parametrize("dim,N", [(2, 16), (2, 15), (3, 8)])
def test_pair_planar_gradients(rng, dim, N):
    """x.grad and pos.grad of <pair(x, pos), w> through rfftn/irfftn
    against jax.grad of the JAX package's pair (its Hermitian path for an
    even N), on one carried plan: 5e-5 of the largest entry."""
    n, B, C, m = 300, 1, 2, 3
    pos, batch = points(rng, n, dim, B)
    x = rng.standard_normal((n, C)).astype(np.float32)
    w = rng.standard_normal((n, C)).astype(np.float32)
    jplan = jbinned.build_plan(pos, batch, N=N, m=m, batch_size=B, K=128)
    plan = port_plan(jplan)

    def loss(x_, p_):
        z = jplanar.nfft_pair_planar(x_, p_, jnp.asarray(batch), jplan, batch_size=B, N=N,
                                     m=m)
        return jnp.sum(z * jnp.asarray(w))

    gx, gp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(pos))
    xl = torch.from_numpy(x).requires_grad_()
    pl = torch.from_numpy(pos).requires_grad_()
    z = tp.nfft_pair_planar(xl, pl, batch, plan, batch_size=B, N=N, m=m, device="cpu")
    (z * torch.from_numpy(w)).sum().backward()
    assert_close(xl.grad.numpy(), gx, 5e-5)
    assert_close(pl.grad.numpy(), gp, 5e-5)


@pytest.mark.parametrize("strategy", ["binned", "matmul"])
def test_complex_entry_points_take_an_odd_N(rng, strategy):
    """ROADMAP.md C6: at an odd N the complex entry points crop and embed
    the symmetric band (JAX's own fail there, as its planar pipelines do
    not); the adjoint and forward of complex values against the port's
    NDFT oracles at the JAX gate's bar."""
    n, dim, N = 300, 2, 15
    pos, batch = points(rng, n, dim, 2)
    x = (rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))).astype(np.complex64)
    kw = dict(m=4, sigma=2.0, strategy=strategy, device="cpu")
    y = tp.nfft_adjoint(x, pos, batch, N=N, **kw)
    ref = tp.ndft_adjoint(torch.from_numpy(x).to(torch.complex128),
                          torch.from_numpy(pos).double(), batch, N=N)
    assert y.shape == (2, N, N, 2) and rel_l2(y.numpy(), ref.numpy()) < 1e-3
    s = (rng.standard_normal((2, N, N, 2)) + 1j * rng.standard_normal((2, N, N, 2))).astype(
        np.complex64)
    z = tp.nfft_forward(s, pos, batch, **kw)
    ref = tp.ndft_forward(torch.from_numpy(s).to(torch.complex128),
                          torch.from_numpy(pos).double(), batch)
    assert z.shape == (n, 2) and rel_l2(z.numpy(), ref.numpy()) < 1e-3
