"""Card-only tests of the PyTorch port: the CUDA kernels against their plain
PyTorch versions, and the entry points and their gradients on the card.

Marked ``cuda``; each test skips (inside the ``card`` fixture) where no CUDA
card is present. This file imports neither JAX nor the JAX package, so it
also runs on a machine with the card and without JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

Kernel and plain version agree to rel-L2 1e-5: they sum the same float32
products in another order (the spread's wide-tile design in the order of its
atomics). The spread's contraction design sums each output over the points
in slot order, so two launches, and launches with other chunk and band
sizes, give the same bits.
The permutation kernels (ragged rows, Benes network) and the bitonic sort
move words and agree with their plain versions bit for bit.
Gradients on the card agree with the same call on the CPU (the plain
versions) to rel-L2 3e-5, the bar of the transforms against JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch
from _torch_port import points

import torch_nfft_tpu_torch as tp
from torch_nfft_tpu_torch import _build, _native
from torch_nfft_tpu_torch.ops import benes, binned, bitonic, contract, ragged
from torch_nfft_tpu_torch.ops.tilefold import row_tile_ids, unfold_grid_to_tiles

KERNELS = ("spread_tiles_dense", "gather_points", "pos_grad")
DESIGNS = ("contraction", "wide")

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return tp.resolve_device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _rel(a, b):
    return float(torch.linalg.vector_norm((a - b).double()) / torch.linalg.vector_norm(b.double()))


def _force_design(monkeypatch, design):
    """Make every spread take ``design`` (None: the threshold decides)."""
    if design is not None:
        ratio = float("inf") if design == "contraction" else 0.0
        monkeypatch.setattr(contract, "DENSE_RATIO_MAX", {1: ratio})


class _Designs:
    """Counts the launches of ``wrapper`` per design inside a with block."""

    def __init__(self, wrapper):
        self.wrapper = wrapper

    def __enter__(self):
        self.before = dict(self.wrapper.launches_by_design)
        return self

    def __exit__(self, *exc):
        self.ran = {k: v - self.before[k] for k, v in self.wrapper.launches_by_design.items()}
        return False


def _kernels_vs_plain(rng, dev, dim, N, m, sigma, window, n, B, C, K=None, T=None, blob=False,
                      design=None):
    pos, batch = points(rng, n, dim, B)
    if blob:  # crowd the points into a few tiles: many rows per tile
        pos *= 0.1
    plan = tp.build_plan_device(pos, batch, N=N, m=m, sigma=sigma, batch_size=B, K=K,
                                T=T, window=window, device=dev)
    x = torch.from_numpy(rng.standard_normal((n, C)).astype(np.float32)).to(dev)
    vals = binned.slot_values(plan, x)
    tid = binned.dense_tile_ids(plan)
    with _Designs(contract.spread_tiles_dense) as ran:
        got = contract.spread_tiles_dense(plan, vals, tid, plan.NT)
    if design is not None:
        assert ran.ran[design] == 1
    ref = contract.spread_tiles_dense_plain(plan, vals, tid, plan.NT)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= 1e-5
    visited = torch.zeros(plan.NT, dtype=torch.bool, device=dev)
    visited[tid.long()] = True
    assert bool((got[~visited] == 0).all())  # tiles no row visits stay 0

    g = torch.randn((B, C) + (plan.M,) * dim, device=dev)
    tiles = unfold_grid_to_tiles(g, plan)
    tid = row_tile_ids(plan)
    got = contract.gather_points(plan, tiles, tid)
    ref = contract.gather_points_plain(plan, tiles, tid)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= 1e-5
    return plan


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize(
    "dim,N,m,sigma,window,n,B,C",
    [
        (1, 64, 2, 2.0, "gaussian", 3000, 1, 1),
        (2, 32, 3, 2.0, "es", 5000, 2, 2),
        (3, 16, 2, 1.625, "es", 20000, 1, 1),
        (3, 32, 4, 1.25, "kb", 20000, 2, 3),
        (3, 16, 2, 1.625, "es", 20000, 1, 8),
    ],
)
def test_kernels_match_plain(card, rng, monkeypatch, dim, N, m, sigma, window, n, B, C, design):
    _force_design(monkeypatch, design)
    _kernels_vs_plain(rng, card, dim, N, m, sigma, window, n, B, C, design=design)


def test_kernels_multirow_tiles(card, rng):
    plan = _kernels_vs_plain(rng, card, 3, 16, 2, 2.0, "es", 20000, 1, 2, K=128, blob=True)
    tid = row_tile_ids(plan)
    assert int(torch.unique(tid).numel()) < plan.S  # some tile has several rows


def test_spread_tile_beyond_shared_memory(card, rng):
    """T=32, m=3: a 39^3-cell tile (237 KB per channel) exceeds a block's
    shared memory, so the spread accumulates straight in global memory; its
    window ratio (39/8)^3 = 116 takes the wide-tile design."""
    plan = _kernels_vs_plain(rng, card, 3, 32, 3, 2.0, "es", 4000, 1, 1, T=32, design="wide")
    assert plan.H**3 * 4 > 232448


def _headline_like(rng, dev, C, n=40000, K=None):
    """A 3D plan binned like the headline (T=8, m=2, es, sigma=1.625: H=13)
    and slot values of C columns."""
    pos, batch = points(rng, n, 3, 1)
    plan = tp.build_plan_device(pos, batch, N=32, m=2, sigma=1.625, batch_size=1, T=8, K=K,
                                window="es", device=dev)
    x = torch.from_numpy(rng.standard_normal((n, C)).astype(np.float32)).to(dev)
    return plan, binned.slot_values(plan, x)


@pytest.mark.parametrize("C", [1, 8])
def test_headline_like_spreads_take_the_contraction(card, rng, C):
    """3D, T=8, m=2 (the headline's tiles): both spreads run the contraction
    design and agree with their plain versions."""
    plan, vals = _headline_like(rng, card, C)
    assert plan.H == 13
    tid = binned.dense_tile_ids(plan)
    with _Designs(contract.spread_tiles_dense) as dense, _Designs(contract.spread_tiles) as rows:
        got_d = contract.spread_tiles_dense(plan, vals, tid, plan.NT)
        got_r = contract.spread_tiles(plan, vals)
    assert dense.ran == rows.ran == {"contraction": 1, "wide": 0}
    assert _rel(got_d, contract.spread_tiles_dense_plain(plan, vals, tid, plan.NT)) <= 1e-5
    assert _rel(got_r, contract.spread_tiles_plain(plan, vals)) <= 1e-5


@pytest.mark.parametrize("C", [1, 8])
def test_contraction_spreads_repeat_bit_for_bit(card, rng, C):
    """Two launches on the same input give the same bits, and so do
    launches with other chunk and band sizes."""
    plan, vals = _headline_like(rng, card, C, K=128)
    tid = binned.dense_tile_ids(plan)
    runs = {
        "dense": lambda: contract.spread_tiles_dense(plan, vals, tid, plan.NT),
        "rows": lambda: contract.spread_tiles(plan, vals),
    }
    want = {k: f() for k, f in runs.items()}
    for k, f in runs.items():
        assert torch.equal(f(), want[k])
    for KC, R in ((8, 8), (64, None), (5, 13)):
        d = contract.spread_design(3, plan.H, plan.m, C, KC=KC, R=R)
        assert d.name == "contraction"
        assert torch.equal(contract.spread_tiles_dense(plan, vals, tid, plan.NT, design=d),
                           want["dense"]), (KC, R)
        assert torch.equal(contract.spread_tiles(plan, vals, design=d), want["rows"]), (KC, R)


def test_entry_points_run_on_the_card_by_default(card, rng):
    pos, batch = points(rng, 5000, 3, 2)
    x = rng.standard_normal((5000, 2)).astype(np.float32)
    kw = dict(batch_size=2, N=16, m=2, sigma=1.625, window="es")
    s0, g0 = contract.spread_tiles_dense.launches, contract.gather_points.launches
    z = tp.nfft_pair_planar(x, pos, batch, **kw)
    assert z.device.type == "cuda" and z.shape == (5000, 2)
    assert contract.spread_tiles_dense.launches == s0 + 1
    assert contract.gather_points.launches == g0 + 1
    z_cpu = tp.nfft_pair_planar(x, pos, batch, device="cpu", **kw)
    assert _rel(z.cpu(), z_cpu) <= 1e-5


def test_build_is_plain_nvcc_for_sm90a(card):
    res = _build.build()
    assert res.path.is_file() and "sm_90a" in " ".join(_build.NVCC_FLAGS)
    for src in _build.CSRC.glob("*.cu"):
        assert "torch/extension.h" not in src.read_text()


def _with_empty_row(plan, dev):
    """The plan with one empty row (row_count 0, origin 0) appended, as plan
    stacks pad them."""
    arrays, statics = tp.plan_to_numpy(plan)
    S, K, dim = plan.S, plan.K, plan.dim
    pad = {"slot_pt": np.zeros((1, K), np.int32), "origin": np.zeros((1, dim), np.int32),
           "row_batch": np.zeros(1, np.int32), "row_count": np.zeros(1, np.int32),
           "slot_pos": np.zeros((dim, K), np.float32),
           "fill_keys": np.arange(S * K, (S + 1) * K, dtype=np.int32)}
    ax = {"slot_pos": 1}
    arrays = {k: np.concatenate([v, pad[k]], axis=ax.get(k, 0)) for k, v in arrays.items()}
    return tp.plan_from_numpy(arrays, **statics, device=dev)


@pytest.mark.parametrize("dim,N,m,sigma,window,n", [
    (1, 64, 2, 2.0, "gaussian", 3000),
    (2, 32, 3, 2.0, "es", 5000),
    (3, 16, 2, 1.625, "es", 20000),
    (3, 16, 4, 1.25, "kb", 8000),
    (2, 16, 2, 2.0, "kb", 4000),
])
@pytest.mark.parametrize("C", [1, 3])
def test_pos_grad_matches_plain(card, rng, dim, N, m, sigma, window, n, C):
    B = 2
    pos, batch = points(rng, n, dim, B)
    plan = tp.build_plan_device(pos, batch, N=N, m=m, sigma=sigma, batch_size=B,
                                window=window, device=card)
    plan = _with_empty_row(plan, card)
    tiles = unfold_grid_to_tiles(torch.randn((B, C) + (plan.M,) * dim, device=card), plan)
    w = torch.randn((C, plan.S * plan.K), device=card)
    tid = row_tile_ids(plan)
    got = contract.pos_grad(plan, tiles, w, tid)
    ref = contract.pos_grad_plain(plan, tiles, w, tid)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= 1e-5
    assert bool((got[-1] == 0).all())  # the empty row
    kmask = torch.arange(plan.K, device=card)[None, :] < plan.row_count[:, None]
    assert bool((got.transpose(1, 2)[~kmask] == 0).all())  # padded slots


def _loss_grads(fn, x, pos, w, dev):
    """x.grad and pos.grad of <fn(x, pos), w> with x, pos as leaves on dev."""
    xl = torch.as_tensor(x, device=dev).clone().requires_grad_()
    pl = torch.as_tensor(pos, device=dev).clone().requires_grad_()
    out = fn(xl, pl, dev)
    out = torch.view_as_real(out) if out.is_complex() else out
    (out * torch.as_tensor(w, device=dev)).sum().backward()
    return xl.grad.cpu(), pl.grad.cpu()


@pytest.mark.parametrize("entry", ["pair", "adjoint"])
def test_gradients_on_the_card_match_the_cpu(card, rng, entry):
    n, dim, N, B = 6000, 3, 16, 2
    pos, batch = points(rng, n, dim, B)
    x = rng.standard_normal((n, 2)).astype(np.float32)
    kw = dict(batch_size=B, m=2, sigma=1.625, window="es")
    if entry == "pair":
        w = rng.standard_normal((n, 2)).astype(np.float32)

        def fn(a, p, d):
            return tp.nfft_pair_planar(a, p, batch, N=N, device=d, **kw)
    else:
        w = rng.standard_normal((B,) + (N,) * dim + (2, 2)).astype(np.float32)

        def fn(a, p, d):
            return tp.nfft_adjoint(a, p, batch, N=N, device=d, **kw)
    gx, gp = _loss_grads(fn, x, pos, w, card)
    rx, rp = _loss_grads(fn, x, pos, w, "cpu")
    assert _rel(gx, rx) <= 3e-5 and _rel(gp, rp) <= 3e-5


def test_training_step_launches_each_kernel_twice(card, rng):
    n = 5000
    pos, _ = points(rng, n, 3)
    x = torch.from_numpy(rng.standard_normal((n, 1)).astype(np.float32)).to(card)
    p = torch.from_numpy(pos).to(card)
    x.requires_grad_()
    p.requires_grad_()
    before = {k: getattr(contract, k).launches for k in KERNELS}
    z = tp.nfft_pair_planar(x, p, None, batch_size=1, N=16, m=2, sigma=1.625, window="es")
    (z * torch.randn_like(z)).sum().backward()
    torch.cuda.synchronize()
    assert {k: getattr(contract, k).launches - before[k] for k in KERNELS} == dict.fromkeys(
        KERNELS, 2)
    assert x.grad.shape == (n, 1) and p.grad.shape == (n, 3)


# ---------------------------------------------------------------------------
# The permutation kernels: ragged row passes and the Benes network. They move
# 32-bit words, so kernel and plain version agree bit for bit.
# ---------------------------------------------------------------------------

PERMUTE = ("expand_rows", "compact_rows", "benes_outer", "benes_local")


def _permute_launches():
    return {"expand_rows": ragged.expand_rows.launches,
            "compact_rows": ragged.compact_rows.launches,
            "benes_outer": benes.benes_outer.launches,
            "benes_local": benes.benes_local.launches}


def _payload(rng, shape, dtype, dev):
    if dtype == torch.int32:
        a = rng.integers(-(1 << 30), 1 << 30, size=shape).astype(np.int32)
    else:
        a = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(dev)


def _benes_kernels_vs_plain(x, tables, s):
    """Each outer pass, the local pass and the whole network (its launches
    as the schedule says), both directions, bit for bit."""
    q = tables.q
    entry, exit_ = benes.outer_passes(q, min(s, q))
    for reverse in (False, True):
        before = _permute_launches()
        got = benes.apply_benes_(x.clone(), tables, reverse, s)
        after = _permute_launches()
        assert torch.equal(got, benes.apply_benes_plain(x, tables, reverse))
        assert after["benes_outer"] - before["benes_outer"] == len(entry) + len(exit_)
        assert after["benes_local"] - before["benes_local"] == 1
        local = benes.benes_local(x.clone(), tables, s, reverse)
        assert torch.equal(local, benes.benes_local_plain(x, tables, s, reverse))
        for js in entry + exit_:
            out = benes.benes_outer(x.clone(), tables, js, reverse)
            assert torch.equal(out, benes.benes_outer_plain(x, tables, js, reverse)), js


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("dq", [-2, 0, 3])
def test_benes_kernels_match_plain(card, rng, dq, C, dtype):
    """q below, at and above the local block 2^s on a routed permutation:
    every outer pass, the local pass and the whole network, both
    directions, and the network is the permutation."""
    s = benes.LOCAL_LOG2
    q = s + dq
    perm = rng.permutation(1 << q).astype(np.int32)
    tables = benes.tables_from_pair_bits(_native.benes_route(perm), 1 << q, device=card)
    x = _payload(rng, (C, 1 << q), dtype, card)
    _benes_kernels_vs_plain(x, tables, s)
    want = torch.empty_like(x)
    want[:, torch.from_numpy(perm).long().to(card)] = x
    assert torch.equal(benes.apply_benes(x, tables), want)
    assert torch.equal(benes.apply_benes(want, tables, reverse=True), x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("q,s", [(15, 15), (16, 15), (18, 9), (20, 9), (12, 6)])
def test_benes_outer_passes_match_plain(card, rng, q, s, C, dtype):
    """q - s of 0, 1, 9 and 11 (two outer passes per side), and the
    smallest local block, on random pair bits (any bits make a network)."""
    words = rng.integers(0, 1 << 32, size=(2 * q - 1, (1 << q) // 64), dtype=np.uint64)
    tables = benes.tables_from_pair_bits(words.astype(np.uint32), 1 << q, device=card)
    _benes_kernels_vs_plain(_payload(rng, (C, 1 << q), dtype, card), tables, s)


def _ragged_rows(rng, K):
    """Counts of S rows of at most K lanes, S not a multiple of the row
    group R: runs of empty rows at both ends and across group boundaries,
    and rows starting at every residue mod 4."""
    R = ragged.rows_per_group(K)
    S = max(3 * R + 5, 41)
    counts = rng.integers(0, K + 1, size=S).astype(np.int32)
    counts[rng.integers(0, S, size=S // 5)] = rng.integers(1, 4, size=S // 5)
    counts[:3] = counts[-3:] = 0
    for b in range(R, S, 2 * R):  # every other group boundary
        counts[max(0, b - 2):b + 2] = 0
    rs = np.concatenate([[0], np.cumsum(counts)[:-1]])
    assert set(rs[counts > 0] % 4) == {0, 1, 2, 3} and S % R
    return counts


def _ragged_check(got, ref, name, before):
    assert torch.equal(got, ref), name
    assert _permute_launches()[name] == before[name] + 1, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("C", [1, 3, 8])
@pytest.mark.parametrize("K", [8, 128, 1024])
def test_ragged_kernels_match_plain(card, rng, K, C, dtype):
    """expand_rows and compact_rows bit for bit against their plain
    versions, one launch each: row groups cut mid-run of empty rows, rows
    at every residue mod 4; expansion from a stream with spare tail, with
    none, and from a misaligned view; compaction
    of contiguous rows, of unslot_values's transposed (S*K, C) slot array,
    of rows with other strides, and of a misaligned view, with the default
    size and with a zero tail over several tail blocks."""
    counts = _ragged_rows(rng, K)
    S, n = counts.size, int(counts.sum())
    cnt = torch.from_numpy(counts).to(card)
    rs = ragged.row_start_from_counts(cnt)
    big = _payload(rng, (C, n + 3 * K + 1), dtype, card)
    for stream in (big, big[:, :n].contiguous(), big[:, 1:n + 2]):
        before = _permute_launches()
        got = ragged.expand_rows(stream, rs, cnt, K)
        _ragged_check(got, ragged.expand_rows_plain(stream, rs, cnt, K), "expand_rows",
                      before)
        assert bool((got[:, counts == 0] == 0).all())
    flat = _payload(rng, (S * K + 1, C), dtype, card)
    layouts = {
        "contiguous": torch.empty((C, S, K), dtype=dtype, device=card).copy_(
            flat[1:].T.reshape(C, S, K)),
        "slot array": flat[:-1].T.reshape(C, S, K),
        "strided": flat[:-1].reshape(C, K, S).permute(0, 2, 1),
        "misaligned": flat.T.contiguous().reshape(-1)[1:C * S * K + 1].reshape(C, S, K),
    }
    assert ragged.compact_layout(layouts["contiguous"]) == "rows"
    assert ragged.compact_layout(layouts["slot array"]) == ("slab" if C > 1 else "rows")
    assert ragged.compact_layout(layouts["strided"]) == "strided"
    assert ragged.compact_layout(layouts["misaligned"]) == "strided"
    for label, padded in layouts.items():
        for size in (None, n + 2 * 8192 + 5):
            before = _permute_launches()
            out = ragged.compact_rows(padded, rs, cnt, n, size=size)
            ref = ragged.compact_rows_plain(padded, rs, cnt, n, out.shape[1])
            _ragged_check(out, ref, "compact_rows", before)
            assert bool((out[:, n:] == 0).all()), label


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("K", [8, 1024])
def test_ragged_kernels_empty_plan(card, rng, K, C):
    """A plan whose rows are all empty: expansion gives zeros, compaction
    only the zero tail."""
    cnt = torch.zeros(ragged.rows_per_group(K) * 2 + 1, dtype=torch.int32, device=card)
    rs = ragged.row_start_from_counts(cnt)
    S = cnt.shape[0]
    stream = _payload(rng, (C, 16), torch.float32, card)
    got = ragged.expand_rows(stream, rs, cnt, K)
    assert got.shape == (C, S, K) and bool((got == 0).all())
    padded = _payload(rng, (C, S, K), torch.float32, card)
    for size in (0, 5, 9000):
        out = ragged.compact_rows(padded, rs, cnt, 0, size=size)
        assert out.shape == (C, size) and bool((out == 0).all())


def test_benes_slot_values_at_k1024_equal_the_sort_route(card, rng):
    """A plan of 1024 lanes a row (the headline's K): the Benes route's
    slot_values and unslot_values equal the sort route's bit for bit at 1,
    3 and 8 columns (unslot_values's slot array is the slab layout at
    C > 1), and the ragged kernels ran."""
    n = 60000
    pos, _ = points(rng, n, 3)
    plan = tp.build_plan(pos, N=16, m=2, sigma=1.625, window="es", K=1024)
    plan_b = plan.with_benes_tables()
    plan_s = dataclasses.replace(plan_b, benes=None)
    assert plan_b.K == 1024 and plan_b.benes.compact
    for C in (1, 3, 8):
        x = _payload(rng, (n, C), torch.float32, card)
        slots = _payload(rng, (plan.S * plan.K, C), torch.float32, card)
        before = _permute_launches()
        got = binned.slot_values(plan_b, x)
        back = binned.unslot_values(plan_b, slots)
        after = _permute_launches()
        assert torch.equal(got, binned.slot_values(plan_s, x))
        assert torch.equal(back, binned.unslot_values(plan_s, slots))
        assert torch.equal(binned.unslot_values(plan_b, got.T.contiguous()), x)
        assert after["expand_rows"] == before["expand_rows"] + 1
        assert after["compact_rows"] == before["compact_rows"] + 1


@pytest.mark.parametrize("compact", [True, False])
def test_benes_pair_on_the_card_matches_the_sort_pair(card, rng, compact):
    """A device plan with an empty row, upgraded with Benes tables from the
    host positions: slot_values is bit for bit the sort route's, and the
    pair agrees with the sort route's to rel-L2 1e-6 (the spread kernel's
    atomics reorder float sums). The network is deeper than the local
    block, so both Benes kernels run."""
    n, B = 40000, 2
    pos, batch = points(rng, n, 3, B)
    x = rng.standard_normal((n, 2)).astype(np.float32)
    kw = dict(batch_size=B, N=16, m=2, sigma=1.625, window="es")
    plan = _with_empty_row(tp.build_plan_device(pos, batch, device=card, **kw), card)
    plan_b = plan.with_benes_tables(compact=compact, pos=pos, batch=batch)
    assert plan_b.benes.q > benes.LOCAL_LOG2
    xt = torch.from_numpy(x).to(card)
    assert torch.equal(binned.slot_values(plan_b, xt), binned.slot_values(plan, xt))
    before = _permute_launches()
    z_b = tp.nfft_pair_planar(x, pos, batch, plan_b, **kw)
    after = _permute_launches()
    z = tp.nfft_pair_planar(x, pos, batch, plan, **kw)
    assert _rel(z_b, z) <= 1e-6
    used = ("benes_outer", "benes_local") + (("expand_rows", "compact_rows") if compact else ())
    for name in used:
        assert after[name] > before[name], name


# pos.grad of the two routes' training steps: this test's tiles (T = 16)
# take the spread's wide-tile design, whose float atomics reorder its sums
# on every run, so two runs of one route differ by rel-L2 up to 1.2e-6 (30
# runs on an H100, tools/probe_route_noise.py)
POS_GRAD_ROUTES = 3e-6


def test_benes_training_step_launches_every_kernel(card, rng):
    """The Benes route realises the sort route's permutation exactly
    (slot_values and unslot_values bit for bit), launches every kernel in a
    training step, and its gradients agree with the sort route's: x.grad
    to 1e-6, pos.grad to the spread's own run-to-run noise."""
    n = 40000
    pos, _ = points(rng, n, 3)
    plan = tp.build_plan(pos, N=16, m=2, sigma=1.625, window="es").with_benes_tables()
    plan_s = dataclasses.replace(plan, benes=None)
    assert plan.device == card and plan.benes.q > benes.LOCAL_LOG2
    x = torch.from_numpy(rng.standard_normal((n, 1)).astype(np.float32)).to(card)
    slots = torch.from_numpy(rng.standard_normal((plan.S * plan.K, 2)).astype(np.float32))
    slots = slots.to(card)
    assert torch.equal(binned.slot_values(plan, x), binned.slot_values(plan_s, x))
    assert torch.equal(binned.unslot_values(plan, slots), binned.unslot_values(plan_s, slots))
    p = torch.from_numpy(pos).to(card)
    x.requires_grad_()
    p.requires_grad_()
    before = {**{k: getattr(contract, k).launches for k in KERNELS}, **_permute_launches()}
    z = tp.nfft_pair_planar(x, p, None, plan, batch_size=1, N=16, m=2, sigma=1.625,
                            window="es")
    (z * torch.ones_like(z)).sum().backward()
    torch.cuda.synchronize()
    after = {**{k: getattr(contract, k).launches for k in KERNELS}, **_permute_launches()}
    assert all(after[k] > before[k] for k in KERNELS + PERMUTE), (before, after)
    gx, gp = x.grad.clone(), p.grad.clone()
    x.grad = p.grad = None
    z = tp.nfft_pair_planar(x, p, None, plan_s, batch_size=1, N=16, m=2, sigma=1.625,
                            window="es")
    (z * torch.ones_like(z)).sum().backward()
    assert _rel(gx, x.grad) <= 1e-6 and _rel(gp, p.grad) <= POS_GRAD_ROUTES


# ---------------------------------------------------------------------------
# The flat-grid route: per-row tiles (spread_tiles), the tile moves, and the
# route's pair and gradients against the dense route's.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("dim,N,m,sigma,window,n,T", [
    (1, 64, 2, 2.0, "gaussian", 3000, None),
    (2, 32, 3, 2.0, "es", 5000, None),
    (3, 16, 2, 1.625, "es", 20000, None),
    (3, 16, 4, 1.25, "kb", 8000, None),
    (3, 32, 3, 2.0, "es", 4000, 32),  # 39^3 cells: global atomics in the wide design
])
@pytest.mark.parametrize("C", [1, 3, 8])
def test_spread_tiles_match_plain(card, rng, monkeypatch, dim, N, m, sigma, window, n, T, C,
                                  design):
    _force_design(monkeypatch, design)
    B = 2
    pos, batch = points(rng, n, dim, B)
    plan = tp.build_plan_device(pos, batch, N=N, m=m, sigma=sigma, batch_size=B,
                                window=window, T=T, device=card)
    plan = _with_empty_row(plan, card)
    vals = torch.randn((C, plan.S * plan.K), device=card)
    before = contract.spread_tiles.launches
    with _Designs(contract.spread_tiles) as ran:
        got = contract.spread_tiles(plan, vals)
    ref = contract.spread_tiles_plain(plan, vals)
    torch.cuda.synchronize()
    assert contract.spread_tiles.launches == before + 1
    assert ran.ran[design] == 1
    assert _rel(got, ref) <= 1e-5
    assert bool((got[-1] == 0).all())  # the empty row


def _never_fold(*args, **kwargs):
    return False


def test_flat_route_matches_the_dense_route(card, rng, monkeypatch):
    """The pair and a training step forced onto the flat route: within
    rel-L2 1e-5 of the dense route (float sums in another order), with
    spread_tiles, gather_points and pos_grad launched twice per step and
    the dense spread never."""
    n, B = 20000, 2
    pos, batch = points(rng, n, 3, B)
    x = rng.standard_normal((n, 2)).astype(np.float32)
    w = rng.standard_normal((n, 2)).astype(np.float32)
    kw = dict(batch_size=B, N=16, m=2, sigma=1.625, window="es")
    plan = tp.build_plan(pos, batch, **{k: kw[k] for k in ("N", "m", "sigma", "window")},
                         batch_size=B)

    def step():
        xl = torch.from_numpy(x).to(card).requires_grad_()
        pl = torch.from_numpy(pos).to(card).requires_grad_()
        z = tp.nfft_pair_planar(xl, pl, batch, plan, **kw)
        (z * torch.from_numpy(w).to(card)).sum().backward()
        return z.detach(), xl.grad, pl.grad

    dense = step()
    monkeypatch.setattr(binned, "use_fold", _never_fold)
    names = KERNELS + ("spread_tiles",)
    before = {k: getattr(contract, k).launches for k in names}
    flat = step()
    torch.cuda.synchronize()
    launches = {k: getattr(contract, k).launches - before[k] for k in names}
    assert launches == {"spread_tiles_dense": 0, "gather_points": 2, "pos_grad": 2,
                        "spread_tiles": 2}
    for a, b in zip(flat, dense):
        assert _rel(a, b) <= 1e-5


# ---------------------------------------------------------------------------
# The bitonic sort: three kernels, bit for bit against the plain network.
# ---------------------------------------------------------------------------


BITONIC = ("bitonic_local_sort", "bitonic_cross_round", "bitonic_local_merge")


def _sort_keys(rng, Q, ties):
    """A permutation, or many ties among small keys and the int32 extremes."""
    if not ties:
        return rng.permutation(Q).astype(np.int32)
    i32 = np.iinfo(np.int32)
    ext = np.array([i32.min, i32.min + 1, -1, 0, 1, i32.max - 1, i32.max], np.int64)
    return np.where(rng.random(Q) < 0.5, rng.choice(ext, Q),
                    rng.integers(-40, 40, Q)).astype(np.int32)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("dq", [-1, 0, 1, 2, 3, 8])
def test_bitonic_kernels_match_plain(card, rng, dq, dtype, ties):
    """q below, at and above the block 2^b (2^20 at b = 12): each kernel on its
    own and the whole sort, against the plain network, with the launches
    the schedule says."""
    b = bitonic.LOCAL_LOG2
    q = b + dq
    Q = 1 << q
    k = torch.from_numpy(_sort_keys(rng, Q, ties)).to(card)
    v = _payload(rng, (Q,), dtype, card)
    before = {n: getattr(bitonic, n).launches for n in BITONIC}
    got = bitonic.sort_pairs(k, v)
    used = {n: getattr(bitonic, n).launches - before[n] for n in BITONIC}
    want = bitonic.sort_pairs_plain(k, v)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[0], torch.sort(k).values)
    bb = min(q, b)
    rounds = range(bb + 1, q + 1)
    assert used == {"bitonic_local_sort": 1,
                    "bitonic_cross_round": sum(len(bitonic.cross_passes(jj, bb))
                                               for jj in rounds),
                    "bitonic_local_merge": q - bb}
    ks, vs = bitonic.bitonic_local_sort(k.clone(), v.clone(), bb)
    kp, vp = bitonic.bitonic_local_sort_plain(k, v, bb)
    assert torch.equal(ks, kp) and torch.equal(vs, vp)
    for jj in rounds:
        for d_hi, d_lo in bitonic.cross_passes(jj, bb):
            kc, vc = bitonic.bitonic_cross_round(ks.clone(), vs.clone(), jj, d_hi, d_lo)
            kp, vp = bitonic.bitonic_cross_round_plain(ks, vs, jj, d_hi, d_lo)
            assert torch.equal(kc, kp) and torch.equal(vc, vp), (jj, d_hi, d_lo)
            ks, vs = kc, vc
        km, vm = bitonic.bitonic_local_merge(ks.clone(), vs.clone(), jj, bb)
        kp, vp = bitonic.bitonic_local_merge_plain(ks, vs, jj, bb)
        assert torch.equal(km, kp) and torch.equal(vm, vp), jj
        ks, vs = km, vm
    if not ties:
        out = bitonic.apply_permutation(k, v)
        assert torch.equal(out, torch.empty_like(v).index_copy_(0, k.long(), v))


@pytest.mark.parametrize("b", [8, 9, 14])
def test_bitonic_block_sizes(card, rng, b, monkeypatch):
    """The local kernels at the smallest block, the first with 16 words per
    thread and the largest (128 KB), and a cross tile of 2^10: the sort is
    the plain network's, ties included."""
    monkeypatch.setattr(bitonic, "LOCAL_LOG2", b)
    monkeypatch.setattr(bitonic, "CROSS_LOG2", 10)
    Q = 1 << 17
    k = torch.from_numpy(_sort_keys(rng, Q, True)).to(card)
    v = _payload(rng, (Q,), torch.int32, card)
    got = bitonic.sort_pairs(k, v)
    want = bitonic.sort_pairs_plain(k, v)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
