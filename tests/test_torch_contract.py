"""PyTorch port vs JAX package: the spread/gather contractions, the tile
fold, the slot permutations and the binned spread/gather.

The same plan runs in both packages (built by JAX, carried across with
``plan_from_numpy``). The port's plain versions — what its wrappers run on
CPU tensors — are held against the TPU kernels B1 (spread_tiles_dense_pallas),
B2 (gather_points_pallas) and B6 (their row-batched twins), run in
interpret mode, and against the XLA engines, at rtol/atol 1e-5: the bar the
JAX package holds its own Pallas and XLA engines to
(tests/test_binned.py:129-133).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import points, port_plan, rel_l2

from torch_nfft_tpu.ops import binned as jbinned
from torch_nfft_tpu.ops import tilefold as jtilefold
from torch_nfft_tpu.ops.pallas import contract as jcontract
from torch_nfft_tpu_torch.ops import binned as pbinned
from torch_nfft_tpu_torch.ops import contract as pcontract
from torch_nfft_tpu_torch.ops import tilefold as ptilefold

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _highest_precision(monkeypatch):
    # the JAX kernels' f32-exact mode (their bf16 modes trade accuracy away)
    monkeypatch.setenv("TORCH_NFFT_TPU_KERNEL_PRECISION", "highest")


def _setup(rng, dim, N, B, C, window, m=3, n=200):
    pos, batch = points(rng, n, dim, B)
    jplan = jbinned.build_plan(pos, batch, N=N, m=m, batch_size=B, K=128, window=window)
    x = rng.standard_normal((n, C)).astype(np.float32)
    return pos, x, jplan, port_plan(jplan)


CASES = [(2, 16, 2, 1, "gaussian"), (3, 8, 2, 2, "es")]


@pytest.mark.parametrize("engine", ["B1", "B6", "xla"])
@pytest.mark.parametrize("dim,N,B,C,window", CASES)
def test_spread_tiles_match_jax(rng, engine, dim, N, B, C, window):
    pos, x, jplan, plan = _setup(rng, dim, N, B, C, window)
    H, NT = plan.H, plan.NT
    jx, jpos = jnp.asarray(x), jnp.asarray(pos)
    jtid = jtilefold.row_tile_ids(jplan)
    if engine == "B1":
        ref = jcontract.spread_tiles_dense_pallas(jplan, jx, jpos, C=C, tile_index=jtid, NT=NT)
    elif engine == "B6":
        rows = jcontract.spread_tiles_rb_pallas(jplan, jx, jpos, C=C, R=4)
        ref = jbinned._dense_from_rowtiles(jplan, rows, jtid, NT)
    else:
        ref = jbinned._dense_tiles_xla(jplan, jx, jpos, B)
    ref = np.asarray(ref).reshape(NT, C, H, H ** (dim - 1))

    vals = pbinned.slot_values(plan, torch.from_numpy(x))
    tid = pbinned.dense_tile_ids(plan)
    got = pcontract.spread_tiles_dense(plan, vals, tid, NT)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    np.testing.assert_array_equal(
        pcontract.spread_tiles_dense_plain(plan, vals, tid, NT).numpy(), got.numpy())


@pytest.mark.parametrize("engine", ["B2", "B6", "xla"])
@pytest.mark.parametrize("dim,N,B,C,window", CASES)
def test_gather_points_match_jax(rng, engine, dim, N, B, C, window):
    pos, x, jplan, plan = _setup(rng, dim, N, B, C, window)
    H, NT, S, K = plan.H, plan.NT, plan.S, plan.K
    tiles = rng.standard_normal((NT, C, H, H ** (dim - 1))).astype(np.float32)
    jt = jnp.asarray(tiles)
    jtid = jtilefold.row_tile_ids(jplan)
    got = pcontract.gather_points(plan, torch.from_numpy(tiles), ptilefold.row_tile_ids(plan))
    if engine == "xla":  # per-point values in user order
        ref = jbinned._points_from_tiles_xla(jplan, jt, jnp.asarray(pos))
        got = pbinned.unslot_values(plan, got.transpose(1, 2).reshape(S * K, C))
    elif engine == "B2":
        ref = jcontract.gather_points_pallas(jplan, jt, None, C=C, tile_index=jtid)
    else:
        S_pad = -(-S // 4) * 4
        rows = jnp.take(jt, jnp.pad(jtid, (0, S_pad - S)), axis=0)
        ref = jcontract.gather_points_rb_pallas(jplan, rows, C=C, R=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("dim,N,m,sigma", [(1, 32, 2, 2.0), (2, 16, 3, 2.0),
                                           (3, 8, 3, 2.0), (3, 16, 2, 1.625)])
def test_fold_unfold_match_jax(rng, dim, N, m, sigma):
    """Fold/unfold against the JAX fold (M % T == 0) and, where T does not
    divide M (3D N=16 sigma=1.625: M=26), against the JAX windowed engines
    through spread/gather."""
    B, C = 2, 2
    pos, x, jplan, plan = _setup(rng, dim, N, B, C, "es", m=m)
    M = plan.M
    g = rng.standard_normal((B, C) + (M,) * dim).astype(np.float32)
    if jtilefold.fold_geometry_ok(jplan):
        H, NT = plan.H, plan.NT
        tiles = rng.standard_normal((NT, C, H, H ** (dim - 1))).astype(np.float32)
        ref = jtilefold.fold_tiles_to_grid(jnp.asarray(tiles.reshape(NT, -1)), jplan, B, C)
        ref = np.moveaxis(np.asarray(ref).reshape((B,) + (M,) * dim + (C,)), -1, 1)
        got = ptilefold.fold_tiles_to_grid(torch.from_numpy(tiles), plan)
        np.testing.assert_allclose(got.numpy(), ref, **TOL)
        g_flat = jnp.asarray(np.moveaxis(g, 1, -1).reshape(-1, C))
        ref = np.asarray(jtilefold.unfold_grid_to_tiles(g_flat, jplan, B))
        got = ptilefold.unfold_grid_to_tiles(torch.from_numpy(g), plan)
        np.testing.assert_array_equal(got.numpy(), ref.reshape(got.shape))
    else:
        assert M % plan.T != 0
        ref = jbinned._spread_xla_windowed(jplan, jnp.asarray(x), jnp.asarray(pos), B)
        ref = np.moveaxis(np.asarray(ref).reshape((B,) + (M,) * dim + (C,)), -1, 1)
        got = pbinned.spread_binned(plan, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), ref, **TOL)
        g_flat = jnp.asarray(np.moveaxis(g, 1, -1).reshape(-1, C))
        ref = jbinned._gather_xla_windowed(jplan, g_flat, jnp.asarray(pos))
        got = pbinned.gather_binned(plan, torch.from_numpy(g))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("dim,N,B,C", [(1, 16, 1, 1), (2, 16, 2, 2), (3, 8, 2, 3)])
def test_binned_spread_gather_match_jax(rng, dim, N, B, C):
    pos, x, jplan, plan = _setup(rng, dim, N, B, C, "es")
    M = plan.M
    ref = jbinned.spread_binned(jplan, jnp.asarray(x), jnp.asarray(pos), batch_size=B)
    ref = np.moveaxis(np.asarray(ref).reshape((B,) + (M,) * dim + (C,)), -1, 1)
    got = pbinned.spread_binned(plan, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)

    g = rng.standard_normal((B, C) + (M,) * dim).astype(np.float32)
    g_flat = jnp.asarray(np.moveaxis(g, 1, -1).reshape(-1, C))
    ref = jbinned.gather_binned(jplan, g_flat, jnp.asarray(pos))
    got = pbinned.gather_binned(plan, torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert rel_l2(got.numpy(), np.asarray(ref)) < 1e-6


def test_slot_permutations_match_jax(rng):
    pos, x, jplan, plan = _setup(rng, 3, 8, 2, 3, "es")
    ref = np.asarray(jbinned.to_slot_order(jplan, jnp.asarray(x)))
    got = pbinned.slot_values(plan, torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), ref)
    back = pbinned.unslot_values(plan, got.T)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jbinned.from_slot_order(jplan, jnp.asarray(ref))))


def test_empty_rows_join_the_preceding_tile(rng):
    """Rows with row_count == 0 (as plan stacks pad them) keep each tile's
    rows one run and add nothing."""
    pos, x, jplan, plan = _setup(rng, 3, 8, 2, 1, "es")
    vals = pbinned.slot_values(plan, torch.from_numpy(x))
    ref = pcontract.spread_tiles_dense(plan, vals, pbinned.dense_tile_ids(plan), plan.NT)
    arrays = {k: np.asarray(getattr(jplan, k)) for k in ("slot_pt", "slot_pos", "origin",
                                                          "row_batch", "fill_keys", "row_count")}
    K, S = plan.K, plan.S
    pad = {  # two empty rows with origin 0, appended after the real ones
        "slot_pt": np.zeros((2, K), np.int32), "origin": np.zeros((2, 3), np.int32),
        "row_batch": np.zeros(2, np.int32), "row_count": np.zeros(2, np.int32),
    }
    padded = {k: np.concatenate([arrays[k], pad[k]]) if k in pad else arrays[k] for k in arrays}
    padded["slot_pos"] = np.concatenate([arrays["slot_pos"], np.zeros((3, 2 * K), np.float32)], 1)
    padded["fill_keys"] = np.concatenate([arrays["fill_keys"], np.arange(S * K, (S + 2) * K)])
    import torch_nfft_tpu_torch as tp

    p2 = tp.plan_from_numpy(padded, n=plan.n, dim=3, N=8, m=3, sigma=2.0, T=plan.T,
                            K=K, batch_size=2, window="es", device="cpu")
    tid = pbinned.dense_tile_ids(p2)
    assert torch.equal(tid[-2:], tid[S - 1].repeat(2))
    got = pcontract.spread_tiles_dense(p2, pbinned.slot_values(p2, torch.from_numpy(x)), tid, p2.NT)
    assert torch.equal(got, ref)


def test_wrappers_check_inputs(rng):
    pos, x, jplan, plan = _setup(rng, 2, 16, 1, 1, "es")
    vals = pbinned.slot_values(plan, torch.from_numpy(x))
    tid = pbinned.dense_tile_ids(plan)
    with pytest.raises(ValueError, match="float32"):
        pcontract.spread_tiles_dense(plan, vals.double(), tid, plan.NT)
    with pytest.raises(ValueError, match="vals must be"):
        pcontract.spread_tiles_dense(plan, vals[:, :-1].contiguous(), tid, plan.NT)
    with pytest.raises(ValueError, match="int32"):
        pcontract.spread_tiles_dense(plan, vals, tid.long(), plan.NT)
    with pytest.raises(ValueError, match="tile_index must be"):
        pcontract.spread_tiles_dense(plan, vals, tid[:-1], plan.NT)
    tiles = torch.zeros((plan.NT, 1, plan.H, plan.H))
    with pytest.raises(ValueError, match="contiguous"):
        pcontract.gather_points(plan, tiles.transpose(2, 3), tid)
    with pytest.raises(ValueError, match="tiles must be"):
        pcontract.gather_points(plan, tiles[..., :-1].contiguous(), tid)
    with pytest.raises(ValueError, match="is on cpu, data on meta"):
        pcontract.gather_points(plan, tiles.to("meta"), tid)


def test_cpu_route_launches_no_kernel(rng):
    pos, x, jplan, plan = _setup(rng, 2, 16, 1, 1, "es")
    before = (pcontract.spread_tiles_dense.launches, pcontract.gather_points.launches)
    g = pbinned.spread_binned(plan, torch.from_numpy(x))
    pbinned.gather_binned(plan, g)
    assert (pcontract.spread_tiles_dense.launches, pcontract.gather_points.launches) == before


def test_binned_checks_shapes(rng):
    pos, x, jplan, plan = _setup(rng, 2, 16, 2, 1, "es")
    with pytest.raises(ValueError, match="points"):
        pbinned.spread_binned(plan, torch.from_numpy(x[:-1]))
    g = torch.zeros((1, 1, plan.M, plan.M))  # batch 1, the plan has 2
    with pytest.raises(ValueError, match="the grid has shape"):
        pbinned.gather_binned(plan, g)
