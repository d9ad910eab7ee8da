"""PyTorch port vs JAX package: the flat-grid route (per-row tiles, B7
``spread_tiles_pallas``) and the memory rule that chooses it.

The same plan (built by JAX, carried across with ``plan_from_numpy``) runs
in both packages, at the sizes of the JAX package's interpret tests (n=200,
N=8, m=3, K=128; tests/test_binned.py:121-123). The port's ``spread_tiles``
(its plain version on the CPU) is held against the TPU kernel in interpret
mode, and the port's flat spread and gather against the JAX windowed XLA
engines and against the JAX flat Pallas route (``binned.use_fold`` patched
to False), at rtol/atol 1e-5: the bar the JAX package holds its own engines
to (tests/test_binned.py:129-133). Gradients meet rel-L2 3e-5 (x) and
max-abs 5e-5 of the reference's largest entry (pos), as in
tests/test_torch_grad.py; entry points meet rel-L2 3e-5 against JAX and
1e-5 against the port's dense route (the two routes sum the same float32
products in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import points, port_plan, rel_l2

import torch_nfft_tpu as tn
import torch_nfft_tpu_torch as tp
from torch_nfft_tpu.ops import binned as jbinned
from torch_nfft_tpu.ops import planar as jplanar
from torch_nfft_tpu.ops import tilefold as jtilefold
from torch_nfft_tpu.ops.pallas import contract as jcontract
from torch_nfft_tpu_torch.ops import binned as pbinned
from torch_nfft_tpu_torch.ops import contract as pcontract
from torch_nfft_tpu_torch.ops import tilefold as ptilefold
from torch_nfft_tpu_torch.ops.planar import pair_stages

TOL = dict(rtol=1e-5, atol=1e-5)
REL = 3e-5
CASES = [(dim, B, C) for dim in (1, 2, 3) for B in (1, 2) for C in (1, 2)]
FLAT = ["slot_values", "spread tiles kernel", "tiles to grid", "rfftn", "irfftn",
        "grid to tiles", "gather kernel", "unslot_values"]
DENSE = ["slot_values", "spread kernel", "fold", "rfftn", "irfftn", "unfold",
         "gather kernel", "unslot_values"]


@pytest.fixture(autouse=True)
def _highest_precision(monkeypatch):
    # the JAX kernels' f32-exact mode (their bf16 modes trade accuracy away)
    monkeypatch.setenv("TORCH_NFFT_TPU_KERNEL_PRECISION", "highest")
    monkeypatch.setenv("TORCH_NFFT_TPU_FUSED_BWD", "1")


def _never_fold(*args, **kwargs):
    return False


def _setup(rng, dim, B, C, N=8, m=3, sigma=2.0, window="gaussian", n=200):
    pos, batch = points(rng, n, dim, B)
    jplan = jbinned.build_plan(pos, batch, N=N, m=m, sigma=sigma, batch_size=B, K=128,
                               window=window)
    x = rng.standard_normal((n, C)).astype(np.float32)
    return pos, batch, x, jplan, port_plan(jplan)


def _grid_to_port(g_flat, plan, C):
    """JAX's flat grid (B*M^dim, C) -> the port's (B, C, M^dim)."""
    shape = (plan.batch_size,) + (plan.M,) * plan.dim + (C,)
    return np.moveaxis(np.asarray(g_flat).reshape(shape), -1, 1).copy()


@pytest.mark.parametrize("dim,B,C", CASES)
def test_spread_tiles_match_b7(rng, dim, B, C):
    pos, batch, x, jplan, plan = _setup(rng, dim, B, C)
    ref = jcontract.spread_tiles_pallas(jplan, jnp.asarray(x), jnp.asarray(pos), C=C)
    vals = pbinned.slot_values(plan, torch.from_numpy(x))
    got = pcontract.spread_tiles(plan, vals)
    assert got.shape == (plan.S, C, plan.H, plan.H ** (dim - 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_spread_tiles_empty_row_is_zero(rng):
    """A padded row (row_count 0) gives an exact zero tile; the others are
    the plan's own tiles."""
    pos, batch, x, jplan, plan = _setup(rng, 3, 2, 2)
    arrays, statics = tp.plan_to_numpy(plan)
    S, K = plan.S, plan.K
    arrays["row_count"] = np.concatenate([arrays["row_count"], [0]]).astype(np.int32)
    arrays["slot_pt"] = np.concatenate([arrays["slot_pt"], np.zeros((1, K), np.int32)])
    arrays["origin"] = np.concatenate([arrays["origin"], [[8, 0, 8]]]).astype(np.int32)
    arrays["row_batch"] = np.concatenate([arrays["row_batch"], [1]]).astype(np.int32)
    arrays["slot_pos"] = np.concatenate([arrays["slot_pos"], np.full((3, K), 0.1, np.float32)], 1)
    arrays["fill_keys"] = np.concatenate([arrays["fill_keys"],
                                          np.arange(S * K, (S + 1) * K, dtype=np.int32)])
    statics.update(order=None, row_start=None)  # host fields of the unpadded rows
    padded = tp.plan_from_numpy(arrays, **statics, device="cpu")
    vals = pbinned.slot_values(padded, torch.from_numpy(x))
    got = pcontract.spread_tiles(padded, vals)
    assert torch.equal(got[S], torch.zeros_like(got[S]))
    ref = pcontract.spread_tiles(plan, pbinned.slot_values(plan, torch.from_numpy(x)))
    assert torch.equal(got[:S], ref)
    assert torch.equal(
        pbinned.run_stages(pbinned.TileRoute(padded, "flat").spreading, torch.from_numpy(x)),
        pbinned.run_stages(pbinned.TileRoute(plan, "flat").spreading, torch.from_numpy(x)))


@pytest.mark.parametrize("engine", ["windowed", "pallas"])
@pytest.mark.parametrize("dim,B,C", CASES)
def test_flat_spread_gather_match_jax(rng, monkeypatch, engine, dim, B, C):
    """The port's flat stages against the JAX windowed XLA engines and the
    JAX flat Pallas route (B7 + scatter onto the extended grid; the gather
    reading per-row tiles through B2)."""
    pos, batch, x, jplan, plan = _setup(rng, dim, B, C)
    M = plan.M
    g = rng.standard_normal((B * M**dim, C)).astype(np.float32)
    jx, jpos, jg = jnp.asarray(x), jnp.asarray(pos), jnp.asarray(g)
    if engine == "windowed":
        ref_g = jbinned._spread_xla_windowed(jplan, jx, jpos, B)
        ref_y = jbinned._gather_xla_windowed(jplan, jg, jpos)
    else:
        monkeypatch.setattr(jbinned, "use_fold", _never_fold)
        ref_g = jbinned._spread_pallas(jplan, jx, jpos, B)
        ref_y = jbinned._gather_pallas(jplan, jg, jpos)
    flat = pbinned.TileRoute(plan, "flat")
    got_g = pbinned.run_stages(flat.spreading, torch.from_numpy(x))
    np.testing.assert_allclose(got_g.numpy(), _grid_to_port(ref_g, plan, C), **TOL)
    got_y = pbinned.run_stages(flat.gathering,
                               torch.from_numpy(_grid_to_port(g, plan, C)))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(ref_y), **TOL)


def _assert_close_to_max(got, ref, frac=5e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= frac * max(1e-6, float(np.abs(ref).max()))


@pytest.mark.parametrize("dim,B,C", [(1, 1, 1), (1, 2, 2), (2, 1, 2), (2, 2, 1),
                                     (3, 1, 1), (3, 2, 2)])
def test_flat_grads_match_jax(rng, monkeypatch, dim, B, C):
    """x/pos gradients of <spread, g> and g/pos gradients of <gather, y> on
    the flat route of both packages (JAX's fused backward: gather + B5 on
    per-row tiles, spread + B5 on per-row tiles of the primal grid)."""
    pos, batch, x, jplan, plan = _setup(rng, dim, B, C)
    monkeypatch.setattr(jbinned, "use_fold", _never_fold)
    monkeypatch.setattr(pbinned, "use_fold", _never_fold)
    M = plan.M
    g = rng.standard_normal((B * M**dim, C)).astype(np.float32)
    jx, jpos, jg = jnp.asarray(x), jnp.asarray(pos), jnp.asarray(g)

    def spread(a, b):
        return jbinned._spread_pallas_cv(B, jplan, a, b)

    def gather(a, b):
        return jbinned._gather_pallas_cv(jplan, a, b)

    rx, rp = jax.grad(lambda a, b: jnp.vdot(spread(a, b), jg), argnums=(0, 1))(jx, jpos)
    xt = torch.from_numpy(x).requires_grad_()
    pt = torch.from_numpy(pos).requires_grad_()
    gt = torch.from_numpy(_grid_to_port(g, plan, C))
    (tp.spread_binned(plan, xt, pt) * gt).sum().backward()
    assert rel_l2(xt.grad.numpy(), np.asarray(rx)) <= REL
    _assert_close_to_max(pt.grad.numpy(), rp)

    rg, rp = jax.grad(lambda a, b: jnp.vdot(gather(a, b), jx), argnums=(0, 1))(jg, jpos)
    pt.grad = None
    gt.requires_grad_()
    (tp.gather_binned(plan, gt, pt) * torch.from_numpy(x)).sum().backward()
    assert rel_l2(gt.grad.numpy(), _grid_to_port(rg, plan, C)) <= REL
    _assert_close_to_max(pt.grad.numpy(), rp)


@pytest.mark.parametrize("dim,N,m,sigma,T", [(1, 32, 3, 2.0, None), (2, 16, 3, 2.0, None),
                                             (3, 8, 3, 2.0, None), (3, 16, 4, 2.0, None),
                                             (3, 32, 2, 2.0, 8)])
@pytest.mark.parametrize("B,C", [(1, 1), (2, 3)])
def test_use_fold_matches_jax(rng, dim, N, m, sigma, T, B, C):
    """Same bytes and the same verdict as the JAX rule, on grids that T
    divides (the JAX geometry test, which the port's fold does not need,
    passes on all of them), at the default budget, at the array's own size
    and one byte below it, and at 16 bytes (tests/test_tilefold.py:68-72)."""
    pos, batch = points(rng, 300, dim, B)
    jplan = jbinned.build_plan(pos, batch, N=N, m=m, sigma=sigma, batch_size=B, T=T)
    plan = port_plan(jplan)
    assert jtilefold.fold_geometry_ok(jplan)
    size = ptilefold.tile_array_bytes(plan, C, 4, B)
    assert size == jtilefold.tile_array_bytes(jplan, C, 4, B)
    assert ptilefold.use_fold(plan, C, 4, B) == jtilefold.use_fold(jplan, C, 4, B)
    for budget in (16, size - 1, size):
        assert ptilefold.use_fold(plan, C, 4, B, budget) == \
            jtilefold.use_fold(jplan, C, 4, B, budget) == (size <= budget)


def test_use_fold_takes_any_geometry(rng):
    """Where T does not divide M the JAX rule refuses its fold; the port's
    fold covers the grid, so only the bytes decide (ROADMAP.md ground
    rules)."""
    pos, batch = points(rng, 300, 3, 1)
    jplan = jbinned.build_plan(pos, batch, N=16, m=2, sigma=1.625, batch_size=1)
    plan = port_plan(jplan)
    assert plan.M % plan.T != 0 and not jtilefold.use_fold(jplan, 1, 4, 1)
    size = ptilefold.tile_array_bytes(plan, 1, 4, 1)
    assert size == plan.NT * plan.H**3 * 4
    assert ptilefold.use_fold(plan, 1, 4, 1) and not ptilefold.use_fold(plan, 1, 4, 1, size - 1)


def _entry(name, lib, x, pos, batch, plan, N, kw):
    """Run one public entry point of ``lib`` (tn or tp) on real x (n, C)."""
    B, dim = kw["batch_size"], pos.shape[1]
    extra = {} if lib is tn else {"device": "cpu"}
    if name == "adjoint":
        return lib.nfft_adjoint(jnp.asarray(x) if lib is tn else x, pos, batch, N=N, plan=plan,
                                strategy="binned", m=kw["m"],
                                sigma=kw["sigma"], window=kw["window"], **extra)
    if name == "forward":
        s = np.random.default_rng(3).standard_normal((B,) + (N,) * dim + x.shape[1:])
        s = (s + 1j * s[..., ::-1]).astype(np.complex64)
        return lib.nfft_forward(jnp.asarray(s) if lib is tn else s, pos, batch, plan=plan,
                                strategy="binned", m=kw["m"], sigma=kw["sigma"],
                                window=kw["window"], **extra)
    if lib is tn:
        return jplanar.nfft_pair_planar(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(batch),
                                        plan, N=N, **kw)
    return tp.nfft_pair_planar(x, pos, batch, plan, N=N, device="cpu", **kw)


@pytest.mark.parametrize("name", ["adjoint", "forward", "pair"])
@pytest.mark.parametrize("dim,N", [(2, 16), (3, 8)])
def test_entry_points_on_the_flat_route(rng, monkeypatch, name, dim, N):
    B, C, m, sigma, window = 2, 2, 3, 2.0, "es"
    pos, batch, x, jplan, plan = _setup(rng, dim, B, C, N=N, m=m, sigma=sigma, window=window)
    kw = dict(batch_size=B, m=m, sigma=sigma, window=window)
    ref = np.asarray(_entry(name, tn, x, pos, batch, jplan, N, kw))
    dense = _entry(name, tp, x, pos, batch, plan, N, kw).numpy()
    launches = pcontract.spread_tiles.launches
    monkeypatch.setattr(pbinned, "use_fold", _never_fold)
    flat = _entry(name, tp, x, pos, batch, plan, N, kw).numpy()
    assert pcontract.spread_tiles.launches == launches  # the plain version on the CPU
    assert rel_l2(flat, ref) <= REL
    assert rel_l2(flat, dense) <= 1e-5


def test_pair_stages_follow_the_budget(rng, monkeypatch):
    """With a budget between the C=1 and C=2 dense arrays, pair_stages
    names the dense stages for one column and the flat stages for two,
    and the flat stages run in order to nfft_pair_planar's own result."""
    B, dim, N, m, sigma, window = 2, 3, 8, 2, 1.625, "kb"
    pos, batch, x, jplan, plan = _setup(rng, dim, B, 2, N=N, m=m, sigma=sigma, window=window)
    budget = ptilefold.tile_array_bytes(plan, 1, 4, B)
    monkeypatch.setattr(pbinned, "use_fold", functools.partial(ptilefold.use_fold, budget=budget))
    kw = dict(N=N, m=m, sigma=sigma, window=window)
    assert [name for name, _ in pair_stages(plan, C=1, **kw)] == DENSE
    stages = pair_stages(plan, C=2, **kw)
    assert [name for name, _ in stages] == FLAT
    got = pbinned.run_stages(stages, torch.from_numpy(x))
    want = tp.nfft_pair_planar(x, pos, batch, plan, batch_size=B, device="cpu", **kw)
    assert torch.equal(got, want)
    dense = pbinned.run_stages(pair_stages(plan, C=1, **kw), torch.from_numpy(x[:, :1]))
    assert rel_l2(want[:, :1].numpy(), dense.numpy()) <= 1e-5
