"""The port's mesh, point-sharded transforms and sharded train step against
the JAX package's ``parallel`` package.

Each world size P in (2, 4) runs every case once, in one world of P gloo
ranks spawned by ``_torch_parallel_ranks.run_world`` (the ranks import no
JAX); JAX runs the same inputs on a mesh of P of the 8 virtual devices,
at the sizes and tolerances of ``tests/test_parallel.py``. Every rank must
return the same global result. Gradients are taken through the
collectives by every rank's backward of a loss on the global output and
held to ``jax.grad`` of the JAX package's global (unsharded) function: a
misplaced all-reduce shows as a factor of P.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec

import torch_nfft_tpu as tn
import torch_nfft_tpu_torch as tp
from _torch_parallel_ranks import run_world
from torch_nfft_tpu import parallel as jpar

WORLDS = (2, 4)


def _points(rng, n, dim, batch_size):
    pos = (rng.random((n, dim)) - 0.5).astype(np.float32)
    pos /= 4 * np.abs(pos).max()
    batch = np.sort(rng.integers(0, batch_size, n)).astype(np.int32)
    batch[:batch_size] = np.arange(batch_size)
    return pos, np.sort(batch)


def _carry(jplans):
    """A JAX stacked plan as the (arrays, statics) pair plan_from_numpy takes."""
    arrays = {k: np.asarray(getattr(jplans, k)) for k in tp.convert.PLAN_ARRAYS}
    statics = {k: getattr(jplans, k) for k in
               ("n", "dim", "N", "m", "sigma", "T", "K", "batch_size", "window", "active")}
    return arrays, statics


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _inputs(P: int) -> dict:
    rng = np.random.default_rng(100 + P)
    inp = {}
    for dim in (1, 2):
        n, N, m, B, C = 64, 8, 3, 2, 3
        pos, batch = _points(rng, n, dim, B)
        inp[f"adjoint{dim}"] = dict(pos=pos, batch=batch, N=N, m=m, B=B,
                                    x=rng.standard_normal((n, C)).astype(np.float32))
        pos, batch = _points(rng, n, dim, B)
        inp[f"forward{dim}"] = dict(pos=pos, batch=batch, N=N, m=m, B=B,
                                    x=_cplx(rng, (B,) + (N,) * dim + (C,)))
    n, N, m, B, C, dim = 64, 8, 3, 2, 2, 2
    pos, batch = _points(rng, n, dim, B)
    inp["fastsum"] = dict(pos=pos, batch=batch, N=N, m=m, B=B,
                          x=rng.standard_normal((n, C)).astype(np.float32),
                          coeffs=np.asarray(tn.gaussian_analytic_coeffs(0.25, dim=dim, N=N)))
    pos, batch = _points(rng, 32, dim, 1)
    inp["fastsum_cols"] = dict(pos=pos, batch=batch, N=N, m=m,
                               x=rng.standard_normal((32, 4)).astype(np.float32),
                               coeffs=inp["fastsum"]["coeffs"])
    pos = (rng.random((61, 2)) - 0.5).astype(np.float32) / 4
    inp["pad"] = dict(pos=pos, x=rng.standard_normal((61, 2)).astype(np.float32),
                      batch=np.zeros((61,), np.int32), N=8, m=3)
    for name in ("adjoint_plans", "forward_plans", "fastsum_plans"):
        n = 128
        pos, batch = _points(rng, n, dim, B)
        jplans = jpar.build_sharded_plans(pos, batch, n_shards=P, N=N, m=m, batch_size=B)
        x = (_cplx(rng, (B, N, N, C)) if name == "forward_plans"
             else rng.standard_normal((n, C)).astype(np.float32))
        inp[name] = dict(pos=pos, batch=batch, N=N, m=m, B=B, x=x, plans=_carry(jplans),
                         coeffs=inp["fastsum"]["coeffs"])
    pos, batch = _points(rng, 64, dim, 1)
    inp["grad_plans"] = dict(
        pos=pos, batch=batch, N=N, m=m, x=rng.standard_normal((64, 1)).astype(np.float32),
        coeffs=np.asarray(tn.gaussian_analytic_coeffs(0.3, dim=dim, N=N)),
        plans=_carry(jpar.build_sharded_plans(pos, batch, n_shards=P, N=N, m=m,
                                              batch_size=1)))
    pos, batch = _points(rng, 64, dim, B)
    inp["grad"] = dict(
        pos=pos, batch=batch, N=N, m=m, B=B, x=rng.standard_normal((64, C)).astype(np.float32),
        spec=rng.standard_normal((B, N, N, C)).astype(np.float32)
        + 1j * rng.standard_normal((B, N, N, C)).astype(np.float32),
        w_adj=rng.standard_normal((B, N, N, C)).astype(np.float32),
        coeffs=inp["grad_plans"]["coeffs"],
        plans=_carry(jpar.build_sharded_plans(pos, batch, n_shards=P, N=N, m=m,
                                              batch_size=B)))
    inp["grad"]["spec"] = inp["grad"]["spec"].astype(np.complex64)
    for name, lr in (("train", 0.02), ("adam", 5e-2), ("planar", 0.05)):
        Bt, nt = 4, 16
        inp[name] = dict(
            B=Bt, n=nt, m=3, lr=lr,
            coeffs=np.asarray(tn.gaussian_analytic_coeffs(0.3, dim=2, N=8)),
            pos=(rng.random((Bt, nt, 2)) - 0.5).astype(np.float32) / 4,
            y=rng.standard_normal((Bt, nt, 2)).astype(np.float32),
            w0=rng.standard_normal((Bt, nt, 2)).astype(np.float32))
    inp["spectral"] = dict(N=8, m=3, sigma=2.0, M=16,
                           g=rng.standard_normal((2, 2, 16, 16, 16)).astype(np.float32),
                           xr=rng.standard_normal((2, 2, 8, 8, 8)).astype(np.float32),
                           xi=rng.standard_normal((2, 2, 8, 8, 8)).astype(np.float32))
    pos, batch = _points(rng, 64, 2, 1)
    inp["errors"] = dict(pos=pos, batch=batch, N=8, m=2,
                         x=rng.standard_normal((64, 1)).astype(np.float32),
                         spec=_cplx(rng, (1, 8, 8, 1)),
                         coeffs=np.asarray(tn.gaussian_analytic_coeffs(0.3, dim=2, N=8)))
    inp["sets"] = dict(n=40, N=16, m=3,
                       pos=(rng.random((P, 40, 2)) - 0.5).astype(np.float32) / 4,
                       x=rng.standard_normal((P, 40, 1)).astype(np.float32))
    return inp


@pytest.fixture(scope="module", params=WORLDS, ids=lambda P: f"P{P}")
def world(request, tmp_path_factory):
    P = request.param
    inp = _inputs(P)
    outs = run_world(P, "point_sharded", inp, tmp_path_factory.mktemp(f"points{P}"))
    return P, inp, outs[0], outs


def _jmesh(axes: dict):
    return jpar.make_mesh(axes, devices=jax.devices()[: int(np.prod(list(axes.values())))])


def _same(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(u, v) for u, v in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def test_every_rank_returns_the_global_result(world):
    P, _, out, outs = world
    for r in range(1, P):
        for key, value in out.items():
            assert _same(value, outs[r][key]), f"rank {r} differs from rank 0 on {key}"


def test_mesh_helper(world):
    P, _, out, _ = world
    shape, shape2d, names, bad_fixed, two_minus = out["mesh"]
    assert tuple(shape) == (P,)
    assert tuple(shape2d) == (2, P // 2) and tuple(names) == ("data", "points")
    assert bad_fixed and two_minus
    with pytest.raises(RuntimeError, match="process group"):
        tp.parallel.make_mesh(device_type="cpu")


@pytest.mark.parametrize("dim", [1, 2])
def test_adjoint_sharded_matches(world, dim):
    P, inp, out, _ = world
    c = inp[f"adjoint{dim}"]
    ref = jpar.nfft_adjoint_sharded(c["x"], c["pos"], c["batch"], bandwidth=c["N"],
                                    cutoff=c["m"], mesh=_jmesh({"points": P}),
                                    batch_size=c["B"])
    np.testing.assert_allclose(out[f"adjoint{dim}"], np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dim", [1, 2])
def test_forward_sharded_matches(world, dim):
    P, inp, out, _ = world
    c = inp[f"forward{dim}"]
    ref = jpar.nfft_forward_sharded(c["x"], c["pos"], c["batch"], cutoff=c["m"],
                                    mesh=_jmesh({"points": P}), batch_size=c["B"])
    np.testing.assert_allclose(out[f"forward{dim}"], np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_fastsum_sharded_matches(world):
    P, inp, out, _ = world
    c = inp["fastsum"]
    ref = jpar.nfft_fastsum_sharded(c["x"], c["coeffs"], c["pos"], batch=c["batch"],
                                    cutoff=c["m"], mesh=_jmesh({"points": P}),
                                    batch_size=c["B"])
    np.testing.assert_allclose(out["fastsum"], np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_fastsum_sharded_cols_axis(world):
    P, inp, out, _ = world
    c = inp["fastsum_cols"]
    ref = jpar.nfft_fastsum_sharded(c["x"], c["coeffs"], c["pos"], batch=c["batch"],
                                    cutoff=c["m"], mesh=_jmesh({"data": 2, "points": P // 2}),
                                    cols_axis="data", batch_size=1)
    np.testing.assert_allclose(out["fastsum_cols"], np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_pad_points_roundtrip(world):
    P, inp, out, _ = world
    c = inp["pad"]
    shape, n_valid, got = out["pad"]
    assert shape[0] % P == 0 and n_valid == 61
    ref = tn.nfft_adjoint(c["x"], c["pos"], c["batch"], bandwidth=c["N"], cutoff=c["m"],
                          batch_size=1)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-6)
    pos_j, x_j, b_j, _ = jpar.pad_points(c["pos"], c["x"], c["batch"], multiple=P)
    pos_t, x_t, b_t, n_t = tp.parallel.pad_points(torch.as_tensor(c["pos"]),
                                                  torch.as_tensor(c["x"]),
                                                  torch.as_tensor(c["batch"]), multiple=P)
    assert n_t == 61
    for a, b in ((pos_t, pos_j), (x_t, x_j), (b_t, b_j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", ["adjoint_plans", "forward_plans", "fastsum_plans"])
def test_sharded_with_plans_matches(world, name):
    """JAX's stacked plans carried across and the port's own
    build_sharded_plans both run the binned engine per rank."""
    P, inp, out, _ = world
    c = inp[name]
    jplans = jpar.build_sharded_plans(c["pos"], c["batch"], n_shards=P, N=c["N"], m=c["m"],
                                      batch_size=c["B"])
    mesh = _jmesh({"points": P})
    if name == "adjoint_plans":
        ref = jpar.nfft_adjoint_sharded(c["x"], c["pos"], c["batch"], bandwidth=c["N"],
                                        cutoff=c["m"], mesh=mesh, batch_size=c["B"],
                                        plans=jplans)
    elif name == "forward_plans":
        ref = jpar.nfft_forward_sharded(c["x"], c["pos"], c["batch"], cutoff=c["m"],
                                        mesh=mesh, batch_size=c["B"], plans=jplans)
    else:
        ref = jpar.nfft_fastsum_sharded(c["x"], c["coeffs"], c["pos"], batch=c["batch"],
                                        cutoff=c["m"], mesh=mesh, batch_size=c["B"],
                                        source_plans=jplans, target_plans=jplans)
    got, got_own = out[name]
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_own, np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_build_sharded_plans_matches_jax(world):
    P, inp, _, _ = world
    c = inp["fastsum_plans"]
    jplans = jpar.build_sharded_plans(c["pos"], c["batch"], n_shards=P, N=c["N"], m=c["m"],
                                      batch_size=c["B"])
    plans = tp.parallel.build_sharded_plans(c["pos"], c["batch"], n_shards=P, N=c["N"],
                                            m=c["m"], batch_size=c["B"], device="cpu")
    arrays, statics = _carry(jplans)
    for k, a in arrays.items():
        np.testing.assert_array_equal(getattr(plans, k).numpy(), a, err_msg=k)
    for k, v in statics.items():
        assert getattr(plans, k) == v, k


def test_sharded_plans_gradient_flows(world):
    """x-gradient through the planned sharded fastsum (all-reduce and its
    transpose) against jax.grad of the global fastsum."""
    P, inp, out, _ = world
    c = inp["grad_plans"]

    def loss_ref(x):
        return jnp.sum(tn.nfft_fastsum(x, c["coeffs"], c["pos"], batch=c["batch"],
                                       cutoff=c["m"]) ** 2)

    g_ref = np.asarray(jax.grad(loss_ref)(jnp.asarray(c["x"])))
    np.testing.assert_allclose(out["grad_plans"], g_ref, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("which", ["adjoint", "forward", "fastsum", "adjoint_pos"])
def test_gradient_through_collectives(world, which):
    """Each rank's backward of a loss on the replicated output (adjoint) or
    on the sum of squares of the global output (forward, fastsum) equals
    jax.grad of the global function; adjoint_pos differentiates the points
    through the planned adjoint (B5's backward)."""
    P, inp, out, _ = world
    c = inp["grad"]
    kw = dict(cutoff=c["m"], batch_size=c["B"])
    g_adj, g_fwd, g_fs, g_pos = out["grad"]
    w = jnp.asarray(c["w_adj"])
    if which == "adjoint":
        def f(x):
            y = tn.nfft_adjoint(x, c["pos"], c["batch"], bandwidth=c["N"], **kw)
            return jnp.sum(w * y.real + y.imag ** 2)
        ref, got = jax.grad(f)(jnp.asarray(c["x"])), g_adj
    elif which == "forward":
        def f(xr, xi):
            y = tn.nfft_forward(xr + 1j * xi, c["pos"], c["batch"], **kw)
            return jnp.sum(jnp.abs(y) ** 2)
        gr, gi = jax.grad(f, argnums=(0, 1))(jnp.asarray(c["spec"].real),
                                            jnp.asarray(c["spec"].imag))
        ref, got = np.asarray(gr) + 1j * np.asarray(gi), g_fwd
    elif which == "fastsum":
        def f(x):
            return jnp.sum(tn.nfft_fastsum(x, c["coeffs"], c["pos"], batch=c["batch"],
                                           **kw) ** 2)
        ref, got = jax.grad(f)(jnp.asarray(c["x"])), g_fs
    else:
        def f(p):
            y = tn.nfft_adjoint(c["x"], p, c["batch"], bandwidth=c["N"],
                                strategy="binned", **kw)
            return jnp.sum(w * y.real + y.imag ** 2)
        ref, got = jax.grad(f)(jnp.asarray(c["pos"])), g_pos
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4 * max(1.0, np.abs(ref).max()))


def _single_grad(c):
    B, n, C = c["B"], c["n"], c["y"].shape[-1]

    def single_loss(w):
        wf = w.reshape(B * n, C)
        posf = jnp.asarray(c["pos"]).reshape(B * n, 2)
        bvec = jnp.repeat(jnp.arange(B, dtype=jnp.int32), n)
        pred = tn.nfft_fastsum(wf, c["coeffs"], posf, batch=bvec, cutoff=c["m"],
                               batch_size=B)
        return jnp.mean((pred.reshape(B, n, C) - jnp.asarray(c["y"])) ** 2) * C

    return single_loss


def test_train_step_runs_and_descends(world):
    P, inp, out, _ = world
    c = inp["train"]
    losses, w1 = out["train"]
    assert losses[-1] < losses[0]
    g_single = jax.grad(_single_grad(c))(jnp.zeros(c["y"].shape, jnp.float32))
    np.testing.assert_allclose(-w1 / c["lr"], np.asarray(g_single), rtol=1e-4, atol=1e-6)
    mesh = _jmesh({"data": 2, "points": P // 2})
    step, sh = jpar.make_fastsum_train_step(mesh, c["coeffs"], batch_size=c["B"],
                                            n_per_set=c["n"], cutoff=c["m"],
                                            learning_rate=c["lr"])
    w_j, loss_j = step(jax.device_put(jnp.zeros(c["y"].shape), sh[0]),
                       jax.device_put(jnp.asarray(c["pos"]), sh[1]),
                       jax.device_put(jnp.asarray(c["y"]), sh[2]))
    np.testing.assert_allclose(losses[0], float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(w1, np.asarray(w_j), rtol=1e-4, atol=1e-6)


def test_train_step_with_adam(world):
    """torch.optim.Adam in place of optax.adam: the same losses."""
    import optax

    P, inp, out, _ = world
    c = inp["adam"]
    mesh = _jmesh({"data": 2, "points": P // 2})
    opt = optax.adam(c["lr"])
    step, sh = jpar.make_fastsum_train_step(mesh, c["coeffs"], batch_size=c["B"],
                                            n_per_set=c["n"], cutoff=c["m"], optimizer=opt)
    w = jax.device_put(jnp.zeros(c["y"].shape), sh[0])
    pos = jax.device_put(jnp.asarray(c["pos"]), sh[1])
    y = jax.device_put(jnp.asarray(c["y"]), sh[2])
    state = opt.init(w)
    ref = []
    for _ in range(9):
        w, loss, state = step(w, pos, y, state)
        ref.append(float(loss))
    assert out["adam"][-1] < out["adam"][0]
    np.testing.assert_allclose(out["adam"], ref, rtol=1e-4)


def test_train_step_planar_matches_complex(world):
    """The step with the complex pipelines off (the Hermitian round trip)
    gives the complex step's loss and update, and JAX's."""
    P, inp, out, _ = world
    c = inp["planar"]
    (w_p, loss_p), (w_c, loss_c) = out["planar"]
    assert abs(loss_p - loss_c) < 1e-5 * max(1.0, abs(loss_c))
    np.testing.assert_allclose(w_p, w_c, rtol=1e-5, atol=1e-6)
    mesh = _jmesh({"data": 2, "points": P // 2})
    step, sh = jpar.make_fastsum_train_step(mesh, c["coeffs"], batch_size=c["B"],
                                            n_per_set=c["n"], cutoff=c["m"],
                                            learning_rate=c["lr"])
    w_j, loss_j = step(jax.device_put(jnp.asarray(c["w0"]), sh[0]),
                       jax.device_put(jnp.asarray(c["pos"]), sh[1]),
                       jax.device_put(jnp.asarray(c["y"]), sh[2]))
    np.testing.assert_allclose(w_c, np.asarray(w_j), rtol=1e-4, atol=1e-6)
    assert abs(loss_c - float(loss_j)) < 1e-5 * max(1.0, abs(loss_c))


def test_grid_axis1_spectral_matches_jax(world):
    """The axis-1-sharded pruned DFT pair (port layout (B, C, M0, M1, M2))
    against JAX's on a mesh of P (its layout (B, M1, M2, C, M0))."""
    from torch_nfft_tpu.parallel.sharded import (
        spectral_adjoint_pruned_dft_sharded,
        spectral_forward_pruned_dft_sharded,
    )

    P, inp, out, _ = world
    c = inp["spectral"]
    mesh = Mesh(np.asarray(jax.devices()[:P]), ("grid",))
    N, m, s, M = c["N"], c["m"], c["sigma"], c["M"]
    g_j = jnp.asarray(c["g"].transpose(0, 3, 4, 1, 2))
    yr, yi = jax.jit(jax.shard_map(
        lambda g: spectral_adjoint_pruned_dft_sharded(g, None, 3, N, m, s, "grid", M),
        mesh=mesh, in_specs=(PartitionSpec(None, "grid"),),
        out_specs=(PartitionSpec(), PartitionSpec())))(g_j)
    to_port = (0, 4, 1, 2, 3)  # (B, N, N, N, C) -> (B, C, N, N, N)
    got_r, got_i, fr, fi = out["spectral"]
    np.testing.assert_allclose(got_r, np.asarray(yr).transpose(to_port), rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(got_i, np.asarray(yi).transpose(to_port), rtol=2e-4, atol=2e-3)
    xr = jnp.asarray(c["xr"].transpose(0, 2, 3, 4, 1))
    xi = jnp.asarray(c["xi"].transpose(0, 2, 3, 4, 1))
    er, ei = jax.jit(jax.shard_map(
        lambda a, b: spectral_forward_pruned_dft_sharded(a, b, 3, M, m, s, "grid", P),
        mesh=mesh, in_specs=(PartitionSpec(), PartitionSpec()),
        out_specs=(PartitionSpec(None, "grid"), PartitionSpec(None, "grid"))))(xr, xi)
    dft_to_port = (0, 3, 4, 1, 2)  # (B, M1, M2, C, M0) -> (B, C, M0, M1, M2)
    np.testing.assert_allclose(fr, np.asarray(er).transpose(dft_to_port), rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(fi, np.asarray(ei).transpose(dft_to_port), rtol=2e-4, atol=2e-3)


def test_sharded_plan_window_mismatch_fails_loudly(world):
    P, inp, out, _ = world
    assert out["errors"] == [True] * 4
    c = inp["errors"]
    sp = tp.build_plan(c["pos"], c["batch"], N=c["N"], m=c["m"], batch_size=1, device="cpu")
    with pytest.raises(ValueError, match="window"):
        tp.parallel.sharded.fastsum_local(
            torch.as_tensor(c["x"]), torch.as_tensor(c["pos"]), torch.as_tensor(c["batch"]),
            torch.as_tensor(c["pos"]), torch.as_tensor(c["batch"]), c["coeffs"],
            batch_size=1, N=c["N"], m=c["m"], window="es", source_plan=sp, device="cpu")


def test_independent_sets_one_per_rank(world):
    """Independent point sets, one a rank, no collective: each rank's pair
    equals JAX's per-member planar pair (rtol 1e-5)."""
    from torch_nfft_tpu.ops.planar import nfft_adjoint_planar, nfft_forward_planar

    P, inp, out, _ = world
    c = inp["sets"]
    zb = jnp.zeros((c["n"],), jnp.int32)
    for b in range(P):
        yr, yi = nfft_adjoint_planar(jnp.asarray(c["x"][b]),
                                                   jnp.asarray(c["pos"][b]), zb,
                                                   batch_size=1, N=c["N"], m=c["m"])
        zr, _ = nfft_forward_planar(yr, yi, jnp.asarray(c["pos"][b]), zb,
                                                  batch_size=1, dim=2, m=c["m"],
                                                  real_output=True)
        np.testing.assert_allclose(out["sets"][b], np.asarray(zr), rtol=1e-5, atol=1e-5)


def test_entry_points_raise_without_a_card():
    """No card and no device asked for: the builders and the mesh raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    pos = np.zeros((8, 2), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.parallel.build_sharded_plans(pos, n_shards=2, N=8, m=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.parallel.build_grid_sharded_layout(pos, n_shards=2, N=16, m=2, T=8)


def test_parallel_exports_the_jax_names():
    assert "parallel" in tp.__all__
    assert tp.parallel.__all__ == jpar.__all__
    for name in jpar.__all__:
        assert callable(getattr(tp.parallel, name)), name
