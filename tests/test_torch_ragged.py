"""PyTorch port: the host side of the ragged row kernels (B3, B3'), and the
Benes branch of slot_values / unslot_values against the sort route and the
JAX package.

The kernels themselves run only on the card (tests/test_torch_cuda.py).
Here: the divisor, row-group and layout choices their wrappers pass them,
and the Benes branch, which hands the network's output to the expansion
as it is (no pad to the JAX kernel's window length) and zeroes only the
network's padding. slot_values and unslot_values stay bit for bit the sort
route's and JAX ``_slot_values`` / ``_unslot_values`` (Pallas in interpret
mode), for a plan whose network is shorter than that window and for one
whose network is longer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import points, port_plan

from torch_nfft_tpu.ops import binned as jbinned
from torch_nfft_tpu.ops.pallas import contract as jcontract
from torch_nfft_tpu_torch.ops import binned, ragged


# ---------------------------------------------------------------------------
# Host helpers of the kernels
# ---------------------------------------------------------------------------


def _mulhi_div(j, mul, shift):
    j = j.astype(np.uint64)
    return (((j * np.uint64(mul)) >> np.uint64(32)) + j) >> np.uint64(shift)


@pytest.mark.parametrize("d", [1, 2, 3, 5, 7, 8, 24, 100, 1000, 1023, 1024, 3000, 65537,
                               (1 << 20) + 7])
def test_fast_divisor_is_exact(d):
    """The kernels' row/lane split: exact for every j < 2^31 tried (all of
    [0, 2^16), the ends of the range and 2^16 random words), a plain shift
    for powers of two."""
    mul, shift = ragged.fast_divisor(d)
    assert 0 <= mul < 1 << 32
    if d & (d - 1) == 0:
        assert (mul, 1 << shift) == (0, d)
    rng = np.random.default_rng(d)
    top = (1 << 31) - 1
    j = np.concatenate([np.arange(1 << 16), np.arange(top - (1 << 12), top + 1),
                        rng.integers(0, top, 1 << 16),
                        np.arange(1, top // d + 1, max(1, top // d // 4096)) * d - 1])
    np.testing.assert_array_equal(_mulhi_div(j, mul, shift), j // d)


def test_fast_divisor_rejects_zero():
    with pytest.raises(ValueError, match="positive"):
        ragged.fast_divisor(0)


@pytest.mark.parametrize("group_log2", [10, 12, 14])
def test_rows_per_group(monkeypatch, group_log2):
    """A group holds 2^GROUP_LOG2 words of the plans' power-of-two K (of
    every column in the slab), at least one row."""
    monkeypatch.setattr(ragged, "GROUP_LOG2", group_log2)
    for K in (8, 16, 128, 1024):
        R = ragged.rows_per_group(K)
        assert R * K == max(K, 1 << group_log2)
        for C in (2, 3, 8):
            R = ragged.rows_per_group(K, C)
            assert R == max(1, (1 << group_log2) // (K * C))
            assert R * K * C <= max(K * C, 1 << group_log2) < (R + 1) * K * C
    assert ragged.rows_per_group(100) == max(1, (1 << group_log2) // 100)


def test_compact_layout_follows_the_strides():
    """Contiguous rows read 16-byte vectors; unslot_values's (S*K, C) slot
    array at C > 1 is the slab; any other strides, K % 4 != 0 or a
    misaligned start read word by word."""
    S, K = 37, 128
    for C in (1, 3, 8):
        flat = torch.zeros((S * K, C))
        assert ragged.compact_layout(torch.zeros((C, S, K))) == "rows"
        assert ragged.compact_layout(flat.T.reshape(C, S, K)) == ("rows" if C == 1 else "slab")
    t = torch.zeros((3, S, K))
    assert ragged.compact_layout(t.permute(1, 2, 0).contiguous().permute(2, 0, 1)) == "slab"
    assert ragged.compact_layout(t.permute(1, 0, 2).contiguous().permute(1, 0, 2)) == "rows"
    assert ragged.compact_layout(t.permute(0, 2, 1).contiguous().permute(0, 2, 1)) == "strided"
    assert ragged.compact_layout(torch.zeros((3, S, 2 * K))[:, :, ::2]) == "strided"
    assert ragged.compact_layout(torch.zeros((2, S, 6))) == "strided"
    assert ragged.compact_layout(torch.zeros(2 * S * K + 1)[1:].reshape(2, S, K)) == "strided"
    # the slab of a row of 1024 lanes fits 15 columns a block, not 16
    for C, want in ((8, "slab"), (15, "slab"), (16, "strided")):
        flat = torch.zeros((4 * 1024, C))
        assert ragged.compact_layout(flat.T.reshape(C, 4, 1024)) == want


# ---------------------------------------------------------------------------
# The Benes branch of slot_values / unslot_values
# ---------------------------------------------------------------------------


def _compact_plans(n, K=128):
    pos, batch = points(np.random.default_rng(n), n, 2)
    jplan = jbinned.build_plan(pos, batch, N=16, m=3, batch_size=1, K=K)
    jplan_b = jplan.with_benes_tables(block_log2=9)
    plan = port_plan(jplan)
    return jplan_b, plan, plan.with_benes_tables(block_log2=9)


@pytest.mark.parametrize("n,short", [(1024, True), (600, False)])
@pytest.mark.parametrize("C", [1, 3])
def test_benes_slot_values_read_the_network_output(monkeypatch, n, short, C):
    """The network gets zeros past n and its output goes to the expansion as
    it is, whether it is shorter (n = 2^10) or longer (n = 600) than the JAX
    kernel's window ((n - 1) // K + 2) * K; slot_values and unslot_values
    equal the sort route's and JAX's bit for bit."""
    jplan_b, plan, plan_b = _compact_plans(n)
    bt, K, S = plan_b.benes, plan.K, plan.S
    assert bt.compact and (bt.n < ((n - 1) // K + 2) * K) == short
    seen = {}

    def network(v, tables, reverse=False, *a):
        if not reverse:
            seen["zero padding"] = bool((v[:, n:] == 0).all())
        out = apply_benes_(v, tables, reverse, *a)
        seen.setdefault("outputs", []).append(out)
        return out

    def expand(stream, *a):
        seen["expanded"] = stream
        return expand_rows(stream, *a)

    apply_benes_, expand_rows = binned.apply_benes_, binned.expand_rows
    monkeypatch.setattr(binned, "apply_benes_", network)
    monkeypatch.setattr(binned, "expand_rows", expand)
    x = np.random.default_rng(C).standard_normal((n, C)).astype(np.float32)
    xt = torch.from_numpy(x)
    got = binned.slot_values(plan_b, xt)
    assert seen["zero padding"] and seen["expanded"] is seen["outputs"][0]
    assert tuple(seen["expanded"].shape) == (C, bt.n)
    assert torch.equal(got, binned.slot_values(plan, xt))
    want = np.asarray(jcontract._slot_values(jplan_b, jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want)
    slots = torch.from_numpy(np.random.default_rng(C + 5).standard_normal(
        (S * K, C)).astype(np.float32))
    back = binned.unslot_values(plan_b, slots)
    assert torch.equal(back, binned.unslot_values(plan, slots))
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jcontract._unslot_values(jplan_b, jnp.asarray(slots.numpy()), n)))
    assert torch.equal(binned.unslot_values(plan_b, got.T), xt)


def test_slot_space_benes_zeroes_only_the_padding(monkeypatch):
    """Slot-space tables: the network gets the S*K slots and zeros after
    them, and both directions equal the sort route bit for bit."""
    _, plan, _ = _compact_plans(600)
    plan_s = plan.with_benes_tables(block_log2=9, compact=False)
    S, K = plan.S, plan.K
    seen = []
    apply_benes_ = binned.apply_benes_

    def network(v, tables, reverse=False, *a):
        seen.append(bool((v[:, S * K if reverse else plan.n:] == 0).all()))
        return apply_benes_(v, tables, reverse, *a)

    monkeypatch.setattr(binned, "apply_benes_", network)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((600, 2)).astype(np.float32))
    slots = torch.from_numpy(rng.standard_normal((S * K, 2)).astype(np.float32))
    assert torch.equal(binned.slot_values(plan_s, x), binned.slot_values(plan, x))
    assert torch.equal(binned.unslot_values(plan_s, slots), binned.unslot_values(plan, slots))
    assert seen == [True, True]
