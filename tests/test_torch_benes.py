"""PyTorch port vs JAX package: the Benes network, the ragged row passes,
the plan's Benes tables and the transforms on the Benes route.

The permutation kernels' plain versions (``apply_benes_plain``,
``expand_rows_plain``, ``compact_rows_plain``) equal the JAX package's TPU
kernels run in interpret mode exactly, at the sizes of tests/test_benes.py
and tests/test_ragged.py. A transform on a Benes plan is bitwise equal to
the same transform on the sort plan (both realise the same permutation),
and agrees with JAX's Benes-plan transform to rel-L2 3e-5, the bar of the
transforms (tests/test_torch_pair.py).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import points, port_plan, rel_l2

import torch_nfft_tpu as tn
import torch_nfft_tpu_torch as tp
from torch_nfft_tpu import native as jnative
from torch_nfft_tpu.ops import binned as jbinned
from torch_nfft_tpu.ops.pallas import benes as jbenes
from torch_nfft_tpu.ops.pallas import ragged as jragged
from torch_nfft_tpu_torch import _native
from torch_nfft_tpu_torch.ops import benes, ragged
from torch_nfft_tpu_torch.ops.binned import slot_values, unslot_values

REL = 3e-5


def _perm_tables(q, seed):
    perm = np.random.default_rng(seed).permutation(1 << q).astype(np.int32)
    bits = _native.benes_route(perm)
    return perm, bits, benes.tables_from_pair_bits(bits, 1 << q)


def _scatter(perm, x):
    out = np.empty_like(x)
    out[..., perm] = x
    return out


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q", [6, 8, 11, 14])
def test_router_matches_jax_and_realises_the_permutation(q):
    perm = np.random.default_rng(q).permutation(1 << q).astype(np.int32)
    bits = _native.benes_route(perm)
    np.testing.assert_array_equal(bits, jnative.benes_route(perm))
    masks = benes.unpack_pair_bits_np(bits, q)
    np.testing.assert_array_equal(masks, jbenes.unpack_pair_bits_np(bits, q))
    np.testing.assert_array_equal(masks, benes.route_benes_np(perm))
    x = np.random.default_rng(0).standard_normal(1 << q).astype(np.float32)
    np.testing.assert_array_equal(benes.apply_benes_np(masks, x), _scatter(perm, x))


def test_router_rejects_bad_lengths():
    with pytest.raises(ValueError, match="power-of-two"):
        _native.benes_route(np.arange(100))
    with pytest.raises(ValueError, match="power-of-two"):
        _native.benes_route(np.arange(32))


# ---------------------------------------------------------------------------
# B4: the network
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("q,b", [(9, 9), (11, 9), (12, 10), (13, 9)])
def test_apply_benes_matches_jax(q, b, dtype):
    """apply_benes_plain (the CPU route of apply_benes), forward and reverse,
    against JAX's apply_benes in interpret mode on the same routing."""
    perm, bits, tables = _perm_tables(q, q * 13 + b)
    cw, lw = jbenes.pack_masks(jbenes.unpack_pair_bits_np(bits, q), q, b)
    rng = np.random.default_rng(q)
    if dtype is np.float32:
        x = rng.standard_normal(1 << q).astype(np.float32)
    else:
        x = rng.integers(-(1 << 30), 1 << 30, 1 << q).astype(np.int32)
    jfwd = np.asarray(jbenes.apply_benes(jnp.asarray(x), jnp.asarray(cw), jnp.asarray(lw),
                                         block_log2=b, interpret=True))
    jrev = np.asarray(jbenes.apply_benes(jnp.asarray(x), jnp.asarray(cw), jnp.asarray(lw),
                                         block_log2=b, reverse=True, interpret=True))
    xt = torch.from_numpy(x)
    fwd = benes.apply_benes_plain(xt, tables)
    rev = benes.apply_benes_plain(xt, tables, reverse=True)
    np.testing.assert_array_equal(fwd.numpy(), jfwd)
    np.testing.assert_array_equal(rev.numpy(), jrev)
    np.testing.assert_array_equal(fwd.numpy(), _scatter(perm, x))
    assert torch.equal(benes.apply_benes(xt, tables), fwd)
    assert torch.equal(benes.apply_benes_plain(fwd, tables, reverse=True), xt)


def _card_schedule(x, tables, s, reverse):
    """The card's schedule (each side's outer passes, the middle through the
    local pass) on the wrappers' CPU routes."""
    entry, exit_ = benes.outer_passes(tables.q, min(s, tables.q))
    v = x
    for js in entry:
        v = benes.benes_outer(v, tables, js, reverse)
    v = benes.benes_local(v, tables, s, reverse)
    for js in exit_:
        v = benes.benes_outer(v, tables, js, reverse)
    return v


@pytest.mark.parametrize("s", [7, 11, 13])
def test_stage_and_local_split_the_network(s):
    """The card's schedule gives the whole network, for the local block
    below, at and above the size."""
    q = 11
    perm, _, tables = _perm_tables(q, 40 + s)
    x = torch.from_numpy(np.random.default_rng(s).standard_normal((3, 1 << q))
                         .astype(np.float32))
    for reverse in (False, True):
        v = _card_schedule(x, tables, s, reverse)
        assert torch.equal(v, benes.apply_benes_plain(x, tables, reverse))
    np.testing.assert_array_equal(benes.apply_benes_plain(x, tables).numpy(),
                                  _scatter(perm, x.numpy()))


@functools.lru_cache(maxsize=None)
def _jax_network(q, dtype, C):
    """A routed network of 2^q, C columns of values and JAX's apply_benes of
    each column (interpret mode), forward and reverse."""
    perm, bits, tables = _perm_tables(q, 77)
    cw, lw = jbenes.pack_masks(jbenes.unpack_pair_bits_np(bits, q), q, 9)
    rng = np.random.default_rng(C)
    if dtype is np.float32:
        x = rng.standard_normal((C, 1 << q)).astype(np.float32)
    else:
        x = rng.integers(-(1 << 30), 1 << 30, (C, 1 << q)).astype(np.int32)
    want = {rev: np.stack([np.asarray(jbenes.apply_benes(
        jnp.asarray(col), jnp.asarray(cw), jnp.asarray(lw), block_log2=9, reverse=rev,
        interpret=True)) for col in x]) for rev in (False, True)}
    return tables, x, want


@pytest.mark.parametrize("outer_log2", [7, 14])
@pytest.mark.parametrize("s", [6, 8, 10, 11, 13])
@pytest.mark.parametrize("C,dtype", [(1, np.float32), (3, np.int32)])
def test_outer_local_split_matches_jax(monkeypatch, s, outer_log2, C, dtype):
    """The outer/local split with q - s of 5, 3, 1, 0 and below 0 at q = 11,
    one pass per side or passes of at most two stages: JAX's apply_benes
    bit for bit, forward and reverse, and each outer pass is its stages
    composed."""
    monkeypatch.setattr(benes, "OUTER_LOG2", outer_log2)
    tables, x, want = _jax_network(11, dtype, C)
    xt = torch.from_numpy(x)
    for reverse in (False, True):
        got = _card_schedule(xt, tables, s, reverse)
        np.testing.assert_array_equal(got.numpy(), want[reverse])
        assert torch.equal(benes.apply_benes_(xt.clone(), tables, reverse, s), got)
    q = tables.q
    ds = benes.stage_distances(q)
    entry, exit_ = benes.outer_passes(q, min(s, q))
    assert [j for js in entry for j in js] == list(range(q - min(s, q)))
    assert all(len(js) <= outer_log2 - 5 for js in entry + exit_)
    for js in entry + exit_:
        for reverse in (False, True):
            v = xt
            for j in js:
                v = benes.benes_stage_plain(v, tables.bits[2 * q - 2 - j if reverse else j],
                                            ds[j])
            assert torch.equal(benes.benes_outer_plain(xt, tables, js, reverse), v)


# ---------------------------------------------------------------------------
# B3 / B3': the ragged passes
# ---------------------------------------------------------------------------


def _layout(rng, S, K, empty_rows=False):
    counts = rng.integers(1, K + 1, size=S).astype(np.int32)
    if empty_rows:
        counts[rng.integers(0, S, size=max(1, S // 4))] = 0
    rs = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    return counts, rs, int(counts.sum())


@pytest.mark.parametrize("S,K", [(7, 128), (23, 256), (4, 128)])
def test_ragged_passes_match_jax(S, K):
    rng = np.random.default_rng(0)
    counts, rs, n = _layout(rng, S, K)
    nb_in = (n - 1) // K + 2
    stream = rng.standard_normal(nb_in * K).astype(np.float32)
    want = np.asarray(jragged.expand_rows(jnp.asarray(stream), jnp.asarray(rs),
                                          jnp.asarray(counts), K=K, interpret=True))
    rs_t, cnt_t = torch.from_numpy(rs), torch.from_numpy(counts)
    got = ragged.expand_rows(torch.from_numpy(stream), rs_t, cnt_t, K)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ragged.expand_rows_plain(
        torch.from_numpy(stream)[None], rs_t, cnt_t, K)[0].numpy(), want)

    padded = rng.standard_normal((S, K)).astype(np.float32)
    want = np.asarray(jragged.compact_rows(jnp.asarray(padded), jnp.asarray(rs),
                                           jnp.asarray(counts), n, interpret=True))
    got = ragged.compact_rows(torch.from_numpy(padded), rs_t, cnt_t, n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ragged.compact_rows_plain(
        torch.from_numpy(padded)[None], rs_t, cnt_t, n, want.size)[0].numpy(), want)


@pytest.mark.parametrize("empty_rows", [False, True])
def test_ragged_roundtrip_adjoint_and_columns(empty_rows):
    """Round trip and <expand(c), y> = <c, compact(y)> (tests/test_ragged.py),
    three columns at once, int32 payloads, and rows with no points."""
    rng = np.random.default_rng(2)
    S, K = 17, 128
    counts, rs, n = _layout(rng, S, K, empty_rows)
    rs_t, cnt_t = torch.from_numpy(rs), torch.from_numpy(counts)
    assert torch.equal(ragged.row_start_from_counts(cnt_t), rs_t)
    stream = torch.zeros((3, ((n - 1) // K + 2) * K))
    stream[:, :n] = torch.from_numpy(rng.standard_normal((3, n)).astype(np.float32))
    padded = ragged.expand_rows(stream, rs_t, cnt_t, K)
    assert padded.shape == (3, S, K)
    assert bool((padded[:, counts == 0] == 0).all())
    back = ragged.compact_rows(padded, rs_t, cnt_t, n, size=stream.shape[1])
    assert torch.equal(back, stream)
    y = torch.from_numpy(rng.standard_normal((3, S, K)).astype(np.float32))
    lhs = (padded.double() * y.double()).sum()
    rhs = (stream.double() * ragged.compact_rows(y, rs_t, cnt_t, n,
                                                 size=stream.shape[1]).double()).sum()
    assert abs(float(lhs - rhs)) < 1e-9 * max(1.0, abs(float(lhs)))
    ints = torch.arange(3 * stream.shape[1], dtype=torch.int32).reshape(stream.shape)
    ints[:, n:] = 0
    got = ragged.compact_rows(ragged.expand_rows(ints, rs_t, cnt_t, K), rs_t, cnt_t, n,
                              size=stream.shape[1])
    assert torch.equal(got, ints)
    # strided rows, as the slot route passes them
    st = ragged.compact_rows(padded.permute(1, 0, 2).contiguous().permute(1, 0, 2),
                             rs_t, cnt_t, n, size=stream.shape[1])
    assert torch.equal(st, stream)


# ---------------------------------------------------------------------------
# Plan tables
# ---------------------------------------------------------------------------


def _plans(rng, n=600, dim=2, N=16, m=3, B=1):
    pos, batch = points(rng, n, dim, B)
    jplan = jbinned.build_plan(pos, batch, N=N, m=m, batch_size=B)
    return pos, batch, jplan, port_plan(jplan)


@pytest.mark.parametrize("compact", [True, False])
def test_plan_tables_match_jax(rng, compact):
    pos, batch, jplan, plan = _plans(rng)
    want = jplan.with_benes_tables(block_log2=9, compact=compact).benes.pair_bits
    bt = plan.with_benes_tables(block_log2=9, compact=compact).benes
    assert bt.compact is compact
    np.testing.assert_array_equal(bt.pair_bits, want)
    np.testing.assert_array_equal(bt.bits.numpy().view(np.uint32), want)
    # also from the port's own host plan
    own = tp.build_plan(pos, batch, N=16, m=3, device="cpu")
    np.testing.assert_array_equal(
        own.with_benes_tables(compact=compact).benes.pair_bits, want)


def test_device_plan_takes_the_host_rank(rng, monkeypatch):
    """A device plan (no host order) with pos= given derives the rank on the
    host; its fingerprint matches the plan's (tests/test_benes.py:210-276)."""
    n, dim, B = 900, 3, 3
    pos = (rng.random((n, dim)) - 0.5).astype(np.float32)
    pos /= 4 * np.abs(pos).max()
    batch = np.sort(rng.integers(0, B, size=n)).astype(np.int32)
    plan = tp.build_plan_device(pos, batch, N=16, m=2, batch_size=B, device="cpu")
    assert plan.order is None
    rank = benes.host_rank_permutation(plan, pos, batch)
    assert benes.rank_hash_np(rank) == benes.device_rank_hash(plan)
    calls = []
    real = benes.host_rank_permutation
    monkeypatch.setattr(benes, "host_rank_permutation",
                        lambda *a: calls.append(1) or real(*a))
    with_pos = plan.with_benes_tables(pos=pos, batch=batch)
    assert calls == [1]
    jplan = jbinned.build_plan(pos, batch, N=16, m=2, batch_size=B)
    want = jplan.with_benes_tables(block_log2=9).benes.pair_bits
    np.testing.assert_array_equal(with_pos.benes.pair_bits, want)
    np.testing.assert_array_equal(plan.with_benes_tables().benes.pair_bits, want)
    # positions that bin otherwise: warned, and the plan's own rank is used
    with pytest.warns(RuntimeWarning, match="disagrees"):
        other = plan.with_benes_tables(pos=pos[::-1].copy(), batch=batch)
    np.testing.assert_array_equal(other.benes.pair_bits, want)


def test_routing_cache_writes_atomically(monkeypatch, tmp_path):
    perm = np.random.default_rng(3).permutation(1 << 18).astype(np.int32)
    monkeypatch.setenv(benes.CACHE_ENV, str(tmp_path))

    def fail(*a):
        raise OSError("replace refused")

    with monkeypatch.context() as mp:
        mp.setattr(os, "replace", fail)
        with pytest.raises(OSError, match="replace refused"):
            benes.route_tables(perm)
    assert not list(tmp_path.iterdir())  # neither the entry nor a temporary
    first = benes.route_tables(perm)
    (entry,) = tmp_path.iterdir()
    routed = []
    monkeypatch.setattr(_native, "benes_route", lambda *a: routed.append(1))
    again = benes.route_tables(perm)
    assert not routed and entry.name.startswith(f"benes_{1 << 18}_")
    np.testing.assert_array_equal(again.pair_bits, first.pair_bits)
    assert torch.equal(again.bits, first.bits)


# ---------------------------------------------------------------------------
# Transforms on the Benes route
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def benes_case():
    rng = np.random.default_rng(1)
    n, dim, N, m = 600, 2, 16, 3
    pos = (rng.random((n, dim)) - 0.5).astype(np.float32)
    pos /= 4 * np.abs(pos).max()
    batch = np.zeros((n,), np.int32)
    jplan = jbinned.build_plan(pos, batch, N=N, m=m, batch_size=1)
    jplan_b = jplan.with_benes_tables(block_log2=9)
    plan = port_plan(jplan)
    routes = {"compact": plan.with_benes_tables(block_log2=9),
              "slot space": plan.with_benes_tables(block_log2=9, compact=False)}
    return pos, batch, jplan_b, plan, routes


@pytest.mark.parametrize("route", ["compact", "slot space"])
def test_transforms_on_benes_plans_equal_the_sort_route(benes_case, route):
    pos, batch, jplan_b, plan, routes = benes_case
    pb = routes[route]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((600, 2)).astype(np.float32)
    kw = dict(batch_size=1, N=16, m=3, strategy="binned", device="cpu")
    want = tp.nfft_adjoint(x, pos, batch, plan=plan, **kw)
    got = tp.nfft_adjoint(x, pos, batch, plan=pb, **kw)
    assert torch.equal(got, want)
    ref = tn.nfft_adjoint(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(batch),
                          batch_size=1, bandwidth=16, cutoff=3, plan=jplan_b,
                          strategy="binned")
    assert rel_l2(got.numpy(), np.asarray(ref)) <= REL
    kwf = {k: v for k, v in kw.items() if k != "N"}
    yw = tp.nfft_forward(want, pos, batch, plan=plan, **kwf)
    yg = tp.nfft_forward(want, pos, batch, plan=pb, **kwf)
    assert torch.equal(yg, yw)
    ref_f = tn.nfft_forward(jnp.asarray(want.numpy()), jnp.asarray(pos), jnp.asarray(batch),
                            cutoff=3, plan=jplan_b, strategy="binned")
    assert rel_l2(yg.numpy(), np.asarray(ref_f)) <= REL


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("route", ["compact", "slot space"])
def test_pair_on_benes_plans_equals_the_sort_route(benes_case, route, C):
    pos, batch, jplan_b, plan, routes = benes_case
    x = np.random.default_rng(C).standard_normal((600, C)).astype(np.float32)
    kw = dict(batch_size=1, N=16, m=3, device="cpu")
    want = tp.nfft_pair_planar(x, pos, batch, plan, **kw)
    got = tp.nfft_pair_planar(x, pos, batch, routes[route], **kw)
    assert torch.equal(got, want)
    ref = tn.ops.planar.nfft_pair_planar(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(batch),
                                         jplan_b, batch_size=1, N=16, m=3)
    assert rel_l2(got.numpy(), np.asarray(ref)) <= REL


@pytest.mark.parametrize("route", ["compact", "slot space"])
def test_gradients_on_benes_plans_equal_the_sort_route(benes_case, route):
    """x.grad and pos.grad of sum |adjoint|^2 (tests/test_benes.py:308), and
    of a pair, bit for bit: every backward permutation runs the other
    direction of the same network."""
    pos, batch, jplan_b, plan, routes = benes_case
    x = np.random.default_rng(10).standard_normal((600, 1)).astype(np.float32)
    w = np.random.default_rng(11).standard_normal((600, 1)).astype(np.float32)

    def grads(p):
        xl = torch.from_numpy(x).requires_grad_()
        pl = torch.from_numpy(pos).requires_grad_()
        y = tp.nfft_adjoint(xl, pl, batch, batch_size=1, N=16, m=3, plan=p, device="cpu")
        z = tp.nfft_pair_planar(xl, pl, batch, p, batch_size=1, N=16, m=3, device="cpu")
        ((y.abs() ** 2).sum() + (z * torch.from_numpy(w)).sum()).backward()
        return xl.grad, pl.grad

    gx_w, gp_w = grads(plan)
    gx_g, gp_g = grads(routes[route])
    assert torch.equal(gx_g, gx_w) and torch.equal(gp_g, gp_w)
    # the adjoint's gradients against jax.grad through JAX's Benes plan
    rx, rp = jax.grad(
        lambda a, p: jnp.sum(jnp.abs(tn.nfft_adjoint(
            a, p, jnp.asarray(batch), batch_size=1, bandwidth=16, cutoff=3,
            plan=jplan_b, strategy="binned")) ** 2), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(pos))
    xl = torch.from_numpy(x).requires_grad_()
    pl = torch.from_numpy(pos).requires_grad_()
    y = tp.nfft_adjoint(xl, pl, batch, batch_size=1, N=16, m=3, plan=routes[route],
                        device="cpu")
    (y.abs() ** 2).sum().backward()
    assert rel_l2(xl.grad.numpy(), np.asarray(rx)) <= REL
    rp = np.asarray(rp)
    assert np.abs(pl.grad.numpy() - rp).max() <= 5e-5 * np.abs(rp).max()


@pytest.mark.parametrize("route", ["sort", "compact"])
def test_slot_layout_api_matches_jax(benes_case, route):
    pos, batch, jplan_b, plan, routes = benes_case
    p = plan if route == "sort" else routes["compact"]
    jp = jplan_b if route == "compact" else jbinned.build_plan(
        pos, batch, N=16, m=3, batch_size=1)
    x = np.random.default_rng(5).standard_normal((600, 2)).astype(np.float32)
    v = tp.to_slot_order(p, torch.from_numpy(x))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jbinned.to_slot_order(jp, x)))
    back = tp.from_slot_order(p, v)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jbinned.from_slot_order(jp, jnp.asarray(v))))
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(tp.plan_slot_pos_user(p).numpy(),
                                  np.asarray(jbinned.plan_slot_pos_user(jp)))
    assert torch.equal(slot_values(p, torch.from_numpy(x)), v)
    assert torch.equal(unslot_values(p, v.T), back)
