"""PyTorch port vs JAX package: windows, spectral index maps and plans.

Inputs come from a numpy seed and reach both packages as numpy arrays; JAX
runs on the CPU. Window values are held to rtol 1e-6 with an absolute
floor of 1e-6 of the window's peak: both evaluate the same float32
expressions, but XLA fuses 1 - t^2/(m+1)^2 into one multiply-add, which
moves s = sqrt(...) by an ulp, and exp(beta*s) (beta up to ~18) turns that
ulp into ~1e-6 of the value (measured: 1.02e-6 kb at m=2, 1.2e-6 es at m=3
on values of 0.06-0.8 of the peak).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import points, port_plan

import torch_nfft_tpu_torch as tp
from torch_nfft_tpu.ops import binned as jbinned
from torch_nfft_tpu.ops import spectral as jspectral
from torch_nfft_tpu.ops import window as jwindow
from torch_nfft_tpu_torch.ops import binned as pbinned
from torch_nfft_tpu_torch.ops import spectral as pspectral
from torch_nfft_tpu_torch.ops import window as pwindow


@pytest.mark.parametrize("window", ["gaussian", "es", "kb"])
@pytest.mark.parametrize("m,sigma", [(2, 1.625), (3, 2.0), (4, 1.25)])
def test_window_values_match(window, m, sigma):
    t = np.linspace(-(m + 1.5), m + 1.5, 4001, dtype=np.float32)
    ref = np.asarray(jwindow.window_value_fn(m, sigma, window)(jnp.asarray(t)))
    got = pwindow.window_value_fn(m, sigma, window)(torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * ref.max())


@pytest.mark.parametrize("window", ["gaussian", "es", "kb"])
@pytest.mark.parametrize("N,m,sigma", [(16, 2, 1.625), (32, 3, 2.0), (24, 4, 1.25)])
def test_phi_hat_inv_matches(window, N, m, sigma):
    ref = jwindow.phi_hat_inv_np(N, m, sigma, window)
    np.testing.assert_allclose(pwindow.phi_hat_inv_np(N, m, sigma, window), ref,
                               rtol=1e-6, atol=0)
    ref32 = np.asarray(jwindow.phi_hat_inv_centered(N, m, sigma, window=window))
    got32 = pwindow.phi_hat_inv_centered(N, m, sigma, window).numpy()
    np.testing.assert_allclose(got32, ref32, rtol=1e-6, atol=0)


@pytest.mark.parametrize("m,sigma", [(2, 1.625), (3, 2.0)])
def test_window_scalars_match(m, sigma):
    assert pwindow.es_beta(m, sigma) == jwindow.es_beta(m, sigma)
    assert pwindow.kb_beta(m, sigma) == jwindow.kb_beta(m, sigma)
    assert pwindow.window_inv_b(m, sigma) == jwindow.window_inv_b(m, sigma)
    for dim in (1, 2, 3):
        np.testing.assert_array_equal(
            pwindow.window_index_offsets(dim, m).numpy(),
            np.asarray(jwindow.window_index_offsets(dim, m)))


def test_unknown_window_raises():
    with pytest.raises(ValueError, match="unknown window"):
        pwindow.window_value_fn(2, 2.0, "hann")


@pytest.mark.parametrize("dim,N,M", [(2, 16, 32), (3, 8, 13)])
def test_crop_embed_rolloff_match(rng, dim, N, M):
    shape = (2,) + (M,) * dim + (3,)
    g = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    ref = np.asarray(jspectral.centered_crop(jnp.asarray(g), dim, N, 1))
    got = pspectral.centered_crop(torch.from_numpy(g), dim, N, 1).numpy()
    np.testing.assert_array_equal(got, ref)
    ref = np.asarray(jspectral.centered_embed(jnp.asarray(ref), dim, N, M, 1))
    got = pspectral.centered_embed(torch.from_numpy(got), dim, N, M, 1).numpy()
    np.testing.assert_array_equal(got, ref)
    y = g[(slice(None),) + (slice(0, N),) * dim]
    ref = np.asarray(jspectral.apply_phi_hat_inv(jnp.asarray(y), dim, N, 2, 1.625, 1, window="es"))
    got = pspectral.apply_phi_hat_inv(torch.from_numpy(y), dim, N, 2, 1.625, 1, window="es").numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_default_tile_and_choose_K_match(rng):
    for dim in (1, 2, 3):
        for m in (1, 2, 3, 4):
            for M in (8, 13, 16, 26, 32, 52, 104, 208, 416):
                assert pbinned.default_tile(dim, m, M) == jbinned.default_tile(dim, m, M)
    for _ in range(20):
        cnt = rng.integers(1, 3000, size=int(rng.integers(1, 400))).astype(np.int64)
        n = int(cnt.sum())
        assert pbinned._choose_K(cnt, n) == jbinned._choose_K(cnt, n)


def _per_row_sets(slot_pt, row_count):
    return [sorted(r[:c].tolist()) for r, c in zip(np.asarray(slot_pt), np.asarray(row_count))]


def _assert_plan_matches(p, j, pos):
    assert (p.T, p.K, p.S, p.n, p.dim, p.M, p.H) == (j.T, j.K, j.slot_pt.shape[0], j.n, j.dim, j.M, j.H)
    assert p.active == j.active
    np.testing.assert_array_equal(p.origin.numpy(), np.asarray(j.origin))
    np.testing.assert_array_equal(p.row_batch.numpy(), np.asarray(j.row_batch))
    np.testing.assert_array_equal(p.row_count.numpy(), np.asarray(j.row_count))
    assert _per_row_sets(p.slot_pt, p.row_count) == _per_row_sets(j.slot_pt, j.row_count)
    # every point sits in one filled slot, and slot_pos holds its coordinates
    fk = p.fill_keys.numpy()
    assert np.array_equal(np.sort(fk), np.arange(p.S * p.K))
    slot_pt = p.slot_pt.numpy().reshape(-1)
    np.testing.assert_array_equal(slot_pt[fk[: p.n]], np.arange(p.n))
    np.testing.assert_array_equal(p.slot_pos.numpy().T, pos[slot_pt])


@pytest.mark.parametrize(
    "dim,N,n,B,K,full_box",
    [
        (1, 16, 200, 1, None, False),
        (2, 16, 200, 2, 128, True),
        (3, 8, 200, 2, 128, False),
        (3, 8, 300, 1, 8, True),  # multi-row tiles
        (3, 32, 200, 1, None, False),  # sparse: the density probe picks T=32
        (3, 32, 40000, 1, None, False),  # dense: the density probe picks T=8
    ],
)
def test_device_plan_matches_jax(rng, dim, N, n, B, K, full_box):
    pos, batch = points(rng, n, dim, B, full_box)
    sigma = 2.0
    j = jbinned.build_plan(pos, batch, N=N, m=2, sigma=sigma, batch_size=B, K=K, window="es")
    p = tp.build_plan_device(pos, batch, N=N, m=2, sigma=sigma, batch_size=B, K=K,
                             window="es", device="cpu")
    _assert_plan_matches(p, j, pos)
    if N == 32:
        assert p.T == (8 if n > 1000 else 32)


def test_device_plan_equals_jax_device_plan(rng):
    """build_plan_device sorts stably by the same keys in both packages, so
    the slot tables agree exactly, empty slots included."""
    pos, batch = points(rng, 500, 3, 2)
    j = jbinned.build_plan_device(pos, batch, N=8, m=3, batch_size=2, K=64)
    p = tp.build_plan_device(pos, batch, N=8, m=3, batch_size=2, K=64, device="cpu")
    for name in ("slot_pt", "slot_pos", "origin", "row_batch", "fill_keys", "row_count"):
        np.testing.assert_array_equal(getattr(p, name).numpy(), np.asarray(getattr(j, name)))


def test_plan_from_numpy_round_trips(rng):
    pos, batch = points(rng, 200, 3, 2)
    p = tp.build_plan_device(pos, batch, N=8, m=3, batch_size=2, K=128, device="cpu")
    arrays, statics = tp.plan_to_numpy(p)
    q = tp.plan_from_numpy(arrays, **statics, device="cpu")
    for name in arrays:
        assert torch.equal(getattr(p, name), getattr(q, name))
        assert getattr(q, name).dtype == getattr(p, name).dtype
    for name in statics:
        assert getattr(p, name) == getattr(q, name)


def test_plan_from_numpy_carries_jax_plan(rng):
    pos, batch = points(rng, 200, 2, 2)
    j = jbinned.build_plan(pos, batch, N=16, m=3, batch_size=2, K=128)
    p = port_plan(j)
    _assert_plan_matches(p, j, pos)
    np.testing.assert_array_equal(p.fill_keys.numpy(), np.asarray(j.fill_keys))


def test_plan_from_numpy_rejects_bad_arrays(rng):
    pos, batch = points(rng, 200, 2)
    p = tp.build_plan_device(pos, batch, N=16, m=3, K=128, device="cpu")
    arrays, statics = tp.plan_to_numpy(p)
    with pytest.raises(ValueError, match="origin has shape"):
        tp.plan_from_numpy({**arrays, "origin": arrays["origin"][:, :1]}, **statics, device="cpu")
    del arrays["fill_keys"]
    with pytest.raises(KeyError, match="fill_keys"):
        tp.plan_from_numpy(arrays, **statics, device="cpu")
