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

import types

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


# (dim, M, T, H, slabs): the grid-sharded layouts' geometries (M % T == 0,
# H - T <= T), one and several tile rows a slab
SLAB_CASES = [(2, 32, 8, 13, 2), (2, 64, 16, 25, 4), (3, 16, 4, 7, 2), (3, 32, 8, 13, 4),
              (3, 64, 16, 25, 2)]


@pytest.mark.parametrize("dim,M,T,H,P", SLAB_CASES)
def test_slab_fold_unfold_plain_match_the_whole_grid(dim, M, T, H, P):
    """A grid slab's plain fold and unfold against the whole grid's plain
    fold cut into P slabs: a slab's fold plus the spill of the slab before
    it is that slab of the whole fold, and its unfold from its rows and the
    next slab's first E rows (the halo) is its tiles of the whole unfold."""
    plan = types.SimpleNamespace(dim=dim, M=M, T=T, H=H, batch_size=1)
    nb, C, E = M // T, 2, H - T
    nb0 = nb // P
    L0 = nb0 * T
    gen = torch.Generator().manual_seed(100 * dim + M + P)
    tiles = torch.randn((nb**dim, C, H, H ** (dim - 1)), generator=gen)
    whole = ptilefold.fold_tiles_to_grid_plain(tiles, plan)
    per = tiles.reshape((P, -1) + tiles.shape[1:])
    ext = [ptilefold.fold_tiles_to_slab(per[p].contiguous(), plan, nb0) for p in range(P)]
    for p in range(P):
        assert ext[p].shape == (1, C, L0 + E) + (M,) * (dim - 1)
        slab = ext[p][:, :, :L0].clone()
        slab[:, :, :E] += ext[(p - 1) % P][:, :, L0:]
        torch.testing.assert_close(slab, whole[:, :, p * L0:(p + 1) * L0], **TOL)
    g = torch.randn((1, C) + (M,) * dim, generator=gen)
    want = ptilefold.unfold_grid_to_tiles_plain(g, plan).reshape(per.shape)
    for p in range(P):
        nxt = (p + 1) % P * L0
        got = ptilefold.unfold_slab_to_tiles(g[:, :, p * L0:(p + 1) * L0],
                                             g[:, :, nxt:nxt + E], plan, nb0)
        assert torch.equal(got, want[p])


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


@pytest.mark.parametrize("m,device,raises", [
    (9, "cuda", False), (10, "cuda", True), (0, "cuda", False), (10, "cpu", False),
])
def test_check_window_width(m, device, raises):
    """The card's kernels hold 2m + 2 <= MAX_L = 20 window cells; the CPU
    any m. The entry points call this before any plan or launch."""
    if raises:
        with pytest.raises(ValueError, match="2m\\+2 <= 20"):
            pcontract.check_window_width(m, device)
    else:
        pcontract.check_window_width(m, device)


@pytest.mark.parametrize("C,H,dim,staged,Cp,tile", [
    (1, 13, 3, True, 1, 4 * 2200),  # the headline's tile, as it lies (+3, to 16 bytes)
    (8, 13, 3, True, 8, 4 * 8 * 13**3),  # cell-major, 70.3 KB
    (3, 13, 3, True, 4, 4 * 4 * 13**3),  # columns padded to 4
    (16, 25, 3, False, 16, 0),  # 1 MB: read from global memory
    (1, 39, 3, False, 1, 0),  # 237 KB
])
def test_points_layout_stages_what_fits(C, H, dim, staged, Cp, tile):
    K = 1024
    lay = pcontract.points_layout("gather_points", dim, H, C, K, sort=staged)
    # a sorted lane order takes K + 32 ints after the tile
    assert (lay.staged, lay.sorted, lay.Cp) == (staged, staged, Cp)
    assert lay.smem == (tile + 4 * (K + 32) if staged else 0)
    assert lay.threads <= pcontract.POINTS_THREADS
    for name in pcontract.POINTS_LAYOUT:
        assert pcontract.points_layout(name, dim, H, C, K).staged == staged
    if staged:
        assert not pcontract.points_layout("pos_grad", dim, H, C, K, staged=False).staged
        assert pcontract.points_layout("pos_grad", dim, H, C, K, sort=False).smem == tile
    else:
        with pytest.raises(ValueError, match="exceeds shared memory"):
            pcontract.points_layout("gather_points", dim, H, C, K, staged=True)
        with pytest.raises(ValueError, match="only a staged tile"):
            pcontract.points_layout("gather_points", dim, H, C, K, sort=True)


def test_points_layout_drops_the_order_that_does_not_fit():
    """A tile that fits shared memory only without the lanes' order (38^3
    floats fit, 8192 + 32 more ints do not) is staged unsorted."""
    lay = pcontract.points_layout("gather_points", 3, 38, 1, 8192)
    assert lay.staged and not lay.sorted and lay.smem == 4 * -(-(38**3 + 3) // 4) * 4


@pytest.mark.parametrize("kw,match", [
    (dict(kernel="spread"), "unknown kernel"), (dict(threads=100), "threads must be"),
    (dict(threads=512), "threads must be"), (dict(threads=0), "threads must be"),
    (dict(threads=288), "threads must be"),
])
def test_points_layout_rejects_what_the_kernel_cannot_launch(kw, match):
    with pytest.raises(ValueError, match=match):
        kernel = kw.pop("kernel", "gather_points")
        pcontract.points_layout(kernel, 3, 13, 1, 1024, **kw)


def test_cpu_route_launches_no_kernel(rng):
    pos, x, jplan, plan = _setup(rng, 2, 16, 1, 1, "es")
    wrappers = (pcontract.spread_tiles_dense, pcontract.gather_points,
                ptilefold.fold_tiles_to_grid, ptilefold.unfold_grid_to_tiles)
    before = [w.launches for w in wrappers]
    g = pbinned.spread_binned(plan, torch.from_numpy(x))
    pbinned.gather_binned(plan, g)
    assert [w.launches for w in wrappers] == before


_FOLD_PLAN = types.SimpleNamespace(dim=2, M=12, T=4, H=7, batch_size=1)  # nb = 3, NT = 9


@pytest.mark.parametrize("case", ["tiles dtype", "tiles shape", "tiles strides",
                                  "grid dtype", "grid shape", "grid rank"])
def test_fold_unfold_check_inputs(case):
    """The wrappers refuse what the kernels do not take, on every device:
    float32 only, the plan's shapes, contiguous tiles (the unfold reads the
    grid through its strides, so any grid layout goes)."""
    tiles, grid = torch.zeros((9, 2, 7, 7)), torch.zeros((1, 2, 12, 12))
    fold, unfold = ptilefold.fold_tiles_to_grid, ptilefold.unfold_grid_to_tiles
    fn, arg, match = {
        "tiles dtype": (fold, tiles.double(), "float32"),
        "tiles shape": (fold, tiles[:8], r"\(9, C, 7, 7\)"),
        "tiles strides": (fold, tiles.transpose(2, 3), "contiguous"),
        "grid dtype": (unfold, grid.double(), "float32"),
        "grid shape": (unfold, torch.zeros((1, 2, 12, 11)), r"\(B, C\) \+ \(12, 12\)"),
        "grid rank": (unfold, torch.zeros((2, 12, 12)), r"\(B, C\) \+ \(12, 12\)"),
    }[case]
    with pytest.raises(ValueError, match=match):
        fn(arg, _FOLD_PLAN)
    # the same arrays, well formed, go through the plain versions, and so
    # does a transposed grid
    assert fold(tiles, _FOLD_PLAN).shape == grid.shape
    assert unfold(grid, _FOLD_PLAN).shape == tiles.shape
    assert unfold(grid.transpose(2, 3), _FOLD_PLAN).shape == tiles.shape


def test_binned_checks_shapes(rng):
    pos, x, jplan, plan = _setup(rng, 2, 16, 2, 1, "es")
    with pytest.raises(ValueError, match="points"):
        pbinned.spread_binned(plan, torch.from_numpy(x[:-1]))
    g = torch.zeros((1, 1, plan.M, plan.M))  # batch 1, the plan has 2
    with pytest.raises(ValueError, match="the grid has shape"):
        pbinned.gather_binned(plan, g)


# The spread's design, bands and chunks (ops/contract.py:spread_design), the
# pure-Python half of the CUDA launch: which design a geometry takes, and
# bands of rows and columns that cover the tile matrix OUT (C*H rows,
# H^{dim-1} columns) exactly, in blocks the kernel can launch.


@pytest.mark.parametrize("dim,T,m,C,design", [
    (3, 8, 2, 1, "contraction"),  # the 3D headline: (13 / 6)^3 = 10.2
    (3, 8, 2, 8, "contraction"),
    (3, 16, 2, 1, "wide"),  # (21 / 6)^3 = 43
    (3, 16, 2, 8, "contraction"),
    (2, 32, 2, 1, "wide"),  # (37 / 6)^2 = 38
    (2, 32, 2, 8, "contraction"),
    (3, 32, 3, 1, "wide"),  # (39 / 8)^3 = 116
    (3, 32, 3, 8, "wide"),
    (1, 64, 2, 1, "contraction"),  # 69 / 6 = 11.5
    (1, 64, 2, 8, "contraction"),
])
def test_spread_design_by_geometry(dim, T, m, C, design):
    H, L = T + 2 * m + 1, 2 * m + 2
    d = pcontract.spread_design(dim, H, m, C)
    assert d.name == design
    assert (d.dim, d.H, d.C) == (dim, H, C)
    assert d.ratio == pytest.approx((H / L) ** dim)


def test_spread_design_limit_grows_with_the_columns():
    """The limit for C is the entry of the largest key at or under C, and
    never falls as C grows; the forced names override it."""
    keys = sorted(pcontract.DENSE_RATIO_MAX)
    assert keys[0] == 1
    limits = [pcontract.DENSE_RATIO_MAX[k] for k in keys]
    assert limits == sorted(limits)
    for C in range(1, 2 * keys[-1] + 1):
        limit = pcontract.DENSE_RATIO_MAX[max(k for k in keys if k <= C)]
        for H in range(7, 60):
            ratio = (H / 6) ** 3
            want = "contraction" if ratio <= limit else "wide"
            assert pcontract.spread_design(3, H, 2, C).name == want, (C, H)
    assert pcontract.spread_design(3, 13, 2, 1, name="wide").name == "wide"
    assert pcontract.spread_design(3, 59, 2, 1, name="contraction").name == "contraction"
    with pytest.raises(ValueError, match="unknown spread design"):
        pcontract.spread_design(3, 13, 2, 1, name="sparse")


@pytest.mark.parametrize("KC,R", [(None, None), (8, None), (32, 8), (5, 13)])
@pytest.mark.parametrize("C", [1, 3, 8, 16])
@pytest.mark.parametrize("dim,H,m", [(3, 13, 2), (1, 69, 2), (2, 14, 3), (3, 25, 4)])
def test_spread_bands_cover_the_tile(dim, H, m, C, KC, R):
    d = pcontract.spread_design(dim, H, m, C, name="contraction", KC=KC, R=R)
    rows, P = C * H, H ** (dim - 1)
    row_bands = [(r0, min(r0 + d.R, rows)) for r0 in range(0, rows, d.R)]
    col_bands = [(p0, min(p0 + d.PB, P)) for p0 in range(0, P, d.PB)]
    assert (len(row_bands), len(col_bands)) == (d.row_bands, d.col_bands)
    covered = np.zeros((rows, P), np.int32)
    for r0, r1 in row_bands:
        for p0, p1 in col_bands:
            covered[r0:r1, p0:p1] += 1
    assert (covered == 1).all()  # every output in exactly one band
    assert d.KC == (KC or d.KC) and d.KC >= 1 and d.R == (R or d.R)
    # one thread a TM x TN tile of the band, whole warps, within the limits
    TM, TN = pcontract.TM, pcontract.TN
    assert (d.RG, d.CG) == (-(-d.R // TM), -(-d.PB // TN))
    need = d.RG * d.CG
    assert d.threads % 32 == 0 and need <= d.threads < need + 32
    assert d.threads <= pcontract.MAX_THREADS and d.smem <= pcontract.SMEM_MAX
    if R is None:
        assert d.threads <= max(pcontract.BAND_THREADS, 32 * -(-d.CG // 32))
    # the channels a band touches, the chunk buffers and the band's way out
    # fit the shared memory, and the launch carries the layout whole
    nch = max(len(range(r0 // H, (min(r0 + d.R, rows) - 1) // H + 1)) for r0 in range(0, rows, d.R))
    assert d.NCH == nch and d.buf % 4 == 0
    assert d.buf >= d.KC * (d.RG * TM + d.CG * TN + dim * H + 2 + dim + d.NCH)
    assert d.smem >= 4 * max(2 * (d.RG * TM + d.CG * TN) + 2 * d.buf, d.R * d.PB + 4)
    assert d.layout() == (TM, TN, d.R, d.PB, d.KC, d.RG, d.CG, d.row_bands, d.col_bands,
                          d.NCH, d.buf, d.threads, d.smem)
    assert d.issued_macs == d.row_bands * d.RG * TM * d.col_bands * d.CG * TN >= rows * P


def test_spread_design_defaults_at_the_headline():
    """C = 1: one band of 13 rows, 16 points a chunk; C = 8: two bands of 56
    and 48 rows, 32 points a chunk (8 x 8 outputs a thread)."""
    d1 = pcontract.spread_design(3, 13, 2, 1)
    d8 = pcontract.spread_design(3, 13, 2, 8)
    assert (d1.R, d1.row_bands, d1.KC, d1.threads) == (13, 1, 16, 64)
    assert (d8.R, d8.row_bands, d8.KC, d8.threads) == (56, 2, 32, 160)
    assert (d1.PB, d1.col_bands) == (d8.PB, d8.col_bands) == (169, 1)
    # per point: 16 x 176 multiply-adds at C = 1, 2 x 56 x 176 at C = 8
    assert (d1.issued_macs, d8.issued_macs) == (16 * 176, 112 * 176)


@pytest.mark.parametrize("dim,H,m,C,KC,R,match", [
    (3, 13, 2, 1, None, 14, "R must be"),
    (3, 13, 2, 1, 0, None, "KC"),
    (3, 25, 4, 16, None, 56, "threads a block"),
    (3, 13, 2, 8, 512, None, "shared memory"),
])
def test_spread_design_rejects_what_the_kernel_cannot_launch(dim, H, m, C, KC, R, match):
    with pytest.raises(ValueError, match=match):
        pcontract.spread_design(dim, H, m, C, name="contraction", KC=KC, R=R)


def test_spread_rejects_a_design_for_another_geometry(rng):
    """On either device: the design's layout is the kernel's launch."""
    pos, x, jplan, plan = _setup(rng, 3, 8, 2, 2, "es")
    vals = pbinned.slot_values(plan, torch.from_numpy(x))
    other = pcontract.spread_design(3, plan.H + 1, plan.m, vals.shape[0])
    with pytest.raises(ValueError, match="the design is for"):
        pcontract.spread_tiles(plan, vals, design=other)


def test_cpu_route_counts_no_design(rng, monkeypatch):
    """The CPU route runs the plain versions: no launch, under either design."""
    pos, x, jplan, plan = _setup(rng, 3, 8, 2, 2, "es")
    vals = pbinned.slot_values(plan, torch.from_numpy(x))
    tid = pbinned.dense_tile_ids(plan)
    for ratio in (float("inf"), 0.0):
        monkeypatch.setattr(pcontract, "DENSE_RATIO_MAX", {1: ratio})
        before = [dict(f.launches_by_design) for f in (pcontract.spread_tiles_dense,
                                                       pcontract.spread_tiles)]
        a = pcontract.spread_tiles_dense(plan, vals, tid, plan.NT)
        b = pcontract.spread_tiles(plan, vals)
        assert torch.equal(a, pcontract.spread_tiles_dense_plain(plan, vals, tid, plan.NT))
        assert torch.equal(b, pcontract.spread_tiles_plain(plan, vals))
        assert before == [f.launches_by_design for f in (pcontract.spread_tiles_dense,
                                                         pcontract.spread_tiles)]
