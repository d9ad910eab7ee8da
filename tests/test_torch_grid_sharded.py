"""The port's grid-sharded transforms against the JAX package's.

Each world size P in (2, 4) runs every case once, in one world of P gloo
ranks (``_torch_parallel_ranks.run_world``; the ranks import no JAX),
on the port's own layout and on JAX's layout carried across
(``grid_layout_from_numpy``), so that both packages run the same plans.
The results are held to JAX's grid-sharded transforms on a mesh of P of
the 8 virtual devices and to the single-device planar transforms, at the
sizes and the 2e-4 bar of ``tests/test_parallel.py``. The card's kernels
against their plain versions at a slab's local tile space are
``tests/test_torch_cuda.py``'s (JAX's Pallas-engine parity case).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_nfft_tpu as tn
import torch_nfft_tpu_torch as tp
from _torch_parallel_ranks import run_world
from torch_nfft_tpu import parallel as jpar
from torch_nfft_tpu.ops.planar import nfft_adjoint_planar, nfft_fastsum_real, nfft_forward_planar

WORLDS = (2, 4)
ADJ = [(2, 64, 4, 16), (3, 32, 3, 8), (3, 64, 4, 16)]
FWD = [(2, 64, 4, 16, False), (3, 32, 3, 8, True)]
TOL = dict(rtol=2e-4, atol=2e-4)


def _pos(rng, n, dim):
    pos = (rng.random((n, dim)) - 0.5).astype(np.float32)
    return pos / (4 * np.abs(pos).max())


def _carry(jl):
    arrays = {k: np.asarray(getattr(jl.plans, k)) for k in tp.convert.PLAN_ARRAYS}
    statics = {k: getattr(jl.plans, k) for k in
               ("n", "dim", "N", "m", "sigma", "T", "K", "batch_size", "window", "active")}
    return dict(plans=(arrays, statics), pos_stack=np.asarray(jl.pos_stack),
                point_index=np.asarray(jl.point_index),
                statics={k: getattr(jl, k) for k in
                         ("n", "n_shards", "dim", "N", "m", "sigma", "T", "A0_loc", "window")})


def _case(P, pos, N, m, T, window="gaussian", **arrays):
    jl = jpar.build_grid_sharded_layout(pos, n_shards=P, N=N, m=m, T=T, window=window)
    return dict(pos=pos, N=N, m=m, T=T, window=window, jlay=_carry(jl), **arrays)


def _inputs(P: int) -> dict:
    rng = np.random.default_rng(200 + P)
    inp = {}
    for i, (dim, N, m, T) in enumerate(ADJ):
        inp[f"adjoint{i}"] = _case(P, _pos(rng, 3000, dim), N, m, T,
                                   x=rng.standard_normal((3000, 2)).astype(np.float32))
    for i, (dim, N, m, T, real) in enumerate(FWD):
        shape = (1,) + (N,) * dim + (2,)
        inp[f"forward{i}"] = _case(P, _pos(rng, 2500, dim), N, m, T, real=real,
                                   xr=rng.standard_normal(shape).astype(np.float32),
                                   xi=rng.standard_normal(shape).astype(np.float32))
    pos = _pos(rng, 1200, 2)
    inp["roundtrip"] = _case(P, pos, 64, 4, 16,
                             x=rng.standard_normal((1200, 1)).astype(np.float32))
    pos = _pos(rng, 400, 2)
    pos[:, 0] = -np.abs(pos[:, 0])  # the first half of axis 0: empty slabs
    inp["empty"] = _case(P, pos, 64, 4, 16, x=rng.standard_normal((400, 1)).astype(np.float32))
    inp["fastsum2"] = _case(P, _pos(rng, 1500, 2), 64, 4, 16,
                            x=rng.standard_normal((1500, 2)).astype(np.float32),
                            coeffs=np.asarray(tn.gaussian_analytic_coeffs(0.3, dim=2, N=64)))
    inp["fastsum3"] = _case(P, _pos(rng, 1200, 3), 32, 3, 8, window="es",
                            x=rng.standard_normal((1200, 2)).astype(np.float32),
                            coeffs=np.asarray(tn.gaussian_analytic_coeffs(0.3, dim=3, N=32)))
    inp["grad"] = _case(P, _pos(rng, 800, 2), 64, 4, 16,
                        x=rng.standard_normal((800, 1)).astype(np.float32),
                        sr=rng.standard_normal((1, 64, 64, 1)).astype(np.float32),
                        si=rng.standard_normal((1, 64, 64, 1)).astype(np.float32),
                        coeffs=np.asarray(tn.gaussian_analytic_coeffs(0.3, dim=2, N=64)))
    inp["spectral"] = dict(N=8, m=3, sigma=2.0, M=16,
                           g=rng.standard_normal((2, 2, 16, 16, 16)).astype(np.float32),
                           xr=rng.standard_normal((2, 2, 8, 8, 8)).astype(np.float32),
                           xi=rng.standard_normal((2, 2, 8, 8, 8)).astype(np.float32))
    return inp


@pytest.fixture(scope="module", params=WORLDS, ids=lambda P: f"P{P}")
def world(request, tmp_path_factory):
    P = request.param
    inp = _inputs(P)
    outs = run_world(P, "grid_sharded", inp, tmp_path_factory.mktemp(f"grid{P}"))
    return P, inp, outs[0], outs


def _gmesh(P):
    return jpar.make_mesh({"grid": P}, devices=jax.devices()[:P])


def _zb(n):
    return jnp.zeros((n,), jnp.int32)


def test_every_rank_returns_the_global_result(world):
    P, _, out, outs = world
    for r in range(1, P):
        for key in out:
            a, b = out[key], outs[r][key]
            flat_a = jax.tree_util.tree_leaves(a)
            flat_b = jax.tree_util.tree_leaves(b)
            assert all(np.array_equal(u, v) for u, v in zip(flat_a, flat_b)), key


def test_layout_matches_jax(world):
    """The port's layout equals JAX's: slab packing and every plan array."""
    P, inp, out, _ = world
    pos_stack, point_index, arrays, A0_loc, T = out["layout"]
    j = inp["adjoint0"]["jlay"]
    np.testing.assert_array_equal(pos_stack, j["pos_stack"])
    np.testing.assert_array_equal(point_index, j["point_index"])
    for k, a in j["plans"][0].items():
        np.testing.assert_array_equal(arrays[k], a, err_msg=k)
    assert (A0_loc, T) == (j["statics"]["A0_loc"], j["statics"]["T"])


@pytest.mark.parametrize("i", range(len(ADJ)), ids=[f"{d}-{N}-{m}-{T}" for d, N, m, T in ADJ])
def test_grid_sharded_adjoint_matches(world, i):
    P, inp, out, _ = world
    c = inp[f"adjoint{i}"]
    n, dim = c["pos"].shape
    rr, ri = nfft_adjoint_planar(jnp.asarray(c["x"]), jnp.asarray(c["pos"]), _zb(n),
                                 batch_size=1, N=c["N"], m=c["m"])
    for yr, yi in out[f"adjoint{i}"]:
        np.testing.assert_allclose(yr, np.asarray(rr), **TOL)
        np.testing.assert_allclose(yi, np.asarray(ri), **TOL)
    if i == 0:
        lay = jpar.build_grid_sharded_layout(c["pos"], n_shards=P, N=c["N"], m=c["m"],
                                             T=c["T"])
        jr, ji = jpar.nfft_adjoint_grid_sharded(c["x"], lay, _gmesh(P))
        np.testing.assert_allclose(out[f"adjoint{i}"][0][0], np.asarray(jr), **TOL)
        np.testing.assert_allclose(out[f"adjoint{i}"][0][1], np.asarray(ji), **TOL)


@pytest.mark.parametrize("i", range(len(FWD)),
                         ids=[f"{d}-{N}-{m}-{T}-{r}" for d, N, m, T, r in FWD])
def test_grid_sharded_forward_matches(world, i):
    P, inp, out, _ = world
    c = inp[f"forward{i}"]
    n, dim = c["pos"].shape
    rr, ri = nfft_forward_planar(jnp.asarray(c["xr"]), jnp.asarray(c["xi"]),
                                 jnp.asarray(c["pos"]), _zb(n), batch_size=1, dim=dim, m=c["m"])
    for yr, yi in out[f"forward{i}"]:
        np.testing.assert_allclose(yr, np.asarray(rr), **TOL)
        if c["real"]:
            assert yi is None
        else:
            np.testing.assert_allclose(yi, np.asarray(ri), **TOL)
    if i == 0:
        lay = jpar.build_grid_sharded_layout(c["pos"], n_shards=P, N=c["N"], m=c["m"],
                                             T=c["T"])
        jr, ji = jpar.nfft_forward_grid_sharded(jnp.asarray(c["xr"]), jnp.asarray(c["xi"]),
                                                lay, _gmesh(P))
        np.testing.assert_allclose(out[f"forward{i}"][0][0], np.asarray(jr), **TOL)
        np.testing.assert_allclose(out[f"forward{i}"][0][1], np.asarray(ji), **TOL)


def test_grid_sharded_roundtrip_vs_oracle(world):
    P, inp, out, _ = world
    c = inp["roundtrip"]
    spec = tn.ndft_adjoint(c["x"], c["pos"], N=c["N"])
    ref = np.asarray(tn.ndft_forward(np.asarray(spec), c["pos"])).real
    rel = np.linalg.norm(out["roundtrip"] - ref) / np.linalg.norm(ref)
    assert rel < 5e-4, rel


def test_grid_sharded_layout_validation(rng):
    pos1d = (rng.random((100, 1)) - 0.5).astype(np.float32) / 2
    with pytest.raises(ValueError, match="dim >= 2"):
        tp.parallel.build_grid_sharded_layout(pos1d, n_shards=4, N=32, m=3, device="cpu")
    pos2d = (rng.random((100, 2)) - 0.5).astype(np.float32) / 2
    with pytest.raises(ValueError, match="not divisible"):
        tp.parallel.build_grid_sharded_layout(pos2d, n_shards=8, N=32, m=4, T=32, device="cpu")
    with pytest.raises(ValueError, match="window halo"):
        tp.parallel.build_grid_sharded_layout(pos2d, n_shards=4, N=16, m=4, T=8, device="cpu")
    with pytest.raises(ValueError, match="divisible by the tile size"):
        tp.parallel.build_grid_sharded_layout(pos2d, n_shards=2, N=24, m=2, T=20, device="cpu")


def test_grid_sharded_empty_shard(world):
    """Slabs with no points take a filler point of weight 0."""
    P, inp, out, _ = world
    c = inp["empty"]
    n = c["pos"].shape[0]
    assert (c["jlay"]["point_index"] == n).all(axis=1).any()  # an empty slab
    rr, ri = nfft_adjoint_planar(jnp.asarray(c["x"]), jnp.asarray(c["pos"]), _zb(n),
                                 batch_size=1, N=c["N"], m=c["m"])
    for yr, yi in out["empty"]:
        np.testing.assert_allclose(yr, np.asarray(rr), **TOL)
        np.testing.assert_allclose(yi, np.asarray(ri), **TOL)


@pytest.mark.parametrize("key", ["fastsum2", "fastsum3"])
def test_grid_sharded_fastsum_matches(world, key):
    P, inp, out, _ = world
    c = inp[key]
    n = c["pos"].shape[0]
    p = jnp.asarray(c["pos"])
    ref = nfft_fastsum_real(jnp.asarray(c["x"]), jnp.asarray(c["coeffs"]), p, p, _zb(n), _zb(n),
                            batch_size=1, N=c["N"], m=c["m"], window=c["window"])
    for y in out[key]:
        np.testing.assert_allclose(y, np.asarray(ref), **TOL)
    if key == "fastsum2":
        lay = jpar.build_grid_sharded_layout(c["pos"], n_shards=P, N=c["N"], m=c["m"],
                                             T=c["T"])
        jy = jpar.nfft_fastsum_grid_sharded(c["x"], c["coeffs"], lay, _gmesh(P))
        np.testing.assert_allclose(out[key][0], np.asarray(jy), **TOL)


@pytest.mark.parametrize("which", ["adjoint", "forward", "fastsum"])
def test_grid_sharded_value_gradients(world, which):
    """Every rank's backward through the ring shifts and the spectrum's
    all-reduce equals jax.grad of the single-device planar transform."""
    P, inp, out, _ = world
    c = inp["grad"]
    n = c["pos"].shape[0]
    p, zb = jnp.asarray(c["pos"]), _zb(n)
    g_adj, g_r, g_i, g_fs = out["grad"]
    if which == "adjoint":
        def f(x):
            yr, yi = nfft_adjoint_planar(x, p, zb, batch_size=1, N=c["N"], m=c["m"])
            return jnp.sum(yr ** 2 + yi ** 2)
        refs, gots = [jax.grad(f)(jnp.asarray(c["x"]))], [g_adj]
    elif which == "forward":
        def f(xr, xi):
            yr, yi = nfft_forward_planar(xr, xi, p, zb, batch_size=1, dim=2, m=c["m"])
            return jnp.sum(yr ** 2 + yi ** 2)
        refs = jax.grad(f, argnums=(0, 1))(jnp.asarray(c["sr"]), jnp.asarray(c["si"]))
        gots = [g_r, g_i]
    else:
        def f(x):
            return jnp.sum(nfft_fastsum_real(x, jnp.asarray(c["coeffs"]), p, p, zb, zb,
                                             batch_size=1, N=c["N"], m=c["m"]) ** 2)
        refs, gots = [jax.grad(f)(jnp.asarray(c["x"]))], [g_fs]
    for got, ref in zip(gots, refs):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, atol=2e-4 * float(np.abs(ref).max()))


def test_grid_sharded0_spectral_matches_unsharded(world):
    """The axis-0-sharded pruned DFT pair (port layout (B, C, M0, M1, M2))
    against JAX's single-device pruned DFTs (layout (B, M1, M2, C, M0))."""
    from torch_nfft_tpu.ops.fft import spectral_adjoint_pruned_dft, spectral_forward_pruned_dft

    P, inp, out, _ = world
    c = inp["spectral"]
    yr_p, yi_p, gr_p, gi_p = out["spectral"]
    g_j = jnp.asarray(c["g"].transpose(0, 3, 4, 1, 2))
    yr, yi = spectral_adjoint_pruned_dft(g_j, None, 3, c["N"], c["m"], c["sigma"], M=c["M"])
    to_port = (0, 4, 1, 2, 3)
    np.testing.assert_allclose(yr_p, np.asarray(yr).transpose(to_port), rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(yi_p, np.asarray(yi).transpose(to_port), rtol=2e-4, atol=2e-3)
    er, ei = spectral_forward_pruned_dft(jnp.asarray(c["xr"].transpose(0, 2, 3, 4, 1)),
                                         jnp.asarray(c["xi"].transpose(0, 2, 3, 4, 1)),
                                         3, c["M"], c["m"], c["sigma"])
    dft_to_port = (0, 3, 4, 1, 2)
    np.testing.assert_allclose(gr_p, np.asarray(er).transpose(dft_to_port), rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(gi_p, np.asarray(ei).transpose(dft_to_port), rtol=2e-4, atol=2e-3)
