"""PyTorch port vs JAX package: plan stacks (ops/plan_stack.py) and
``merge_active_runs``.

Every function of the port's plan_stack.py gives the JAX function's result
field for field, exactly: ``split_by_batch`` (uneven counts, an empty
member, tensors or NumPy in), ``pad_plan_rows``, ``build_plan_stack`` /
``stack_plans`` (the merged active slab), ``index_plan`` and
``squeeze_plan``; the errors of ``stack_plans`` and ``split_by_batch``
are JAX's. A stacked plan carried across (``convert.plan_from_numpy``)
equals the port's own.
"""

import numpy as np
import pytest
import torch

import torch_nfft_tpu_torch as tp
from torch_nfft_tpu.ops import binned as jbinned
from torch_nfft_tpu.ops import plan_stack as jstack
from torch_nfft_tpu_torch.convert import PLAN_ARRAYS
from torch_nfft_tpu_torch.ops import binned as pbinned

STATICS = ("n", "dim", "N", "m", "sigma", "T", "K", "batch_size", "pos_fp", "window",
           "active", "S_occ")


def _assert_same_plan(port, jax_plan):
    for name in PLAN_ARRAYS:
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(jax_plan, name)), err_msg=name)
    for name in STATICS:
        assert getattr(port, name) == getattr(jax_plan, name), name
    for name in ("order", "row_start", "benes"):
        assert (getattr(port, name) is None) == (getattr(jax_plan, name) is None), name


def _batched(rng, counts, dim):
    n = int(np.sum(counts))
    pos = (rng.random((n, dim)) - 0.5).astype(np.float32)
    pos /= 4 * np.abs(pos).max()
    batch = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
    return pos, batch


@pytest.mark.parametrize("counts", [(300, 300, 300), (250, 400, 175), (120, 0, 90, 33)])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_split_by_batch_equals_jax(rng, counts, as_tensor):
    pos, batch = _batched(rng, counts, 3)
    x = rng.standard_normal((pos.shape[0], 2, 3)).astype(np.float32)
    want = jstack.split_by_batch(pos, x, batch, len(counts))
    args = (torch.from_numpy(pos), torch.from_numpy(x), torch.from_numpy(batch)) \
        if as_tensor else (pos, x, batch)
    got = tp.split_by_batch(*args, len(counts))
    for g, w in zip(got[:2], want[:2]):
        assert isinstance(g, torch.Tensor) == as_tensor
        np.testing.assert_array_equal(np.asarray(g), w)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    pos_stack, _, got_counts, _ = tp.split_by_batch(pos, None, batch, len(counts))
    assert pos_stack.shape == (len(counts), max(counts), 3)
    assert list(got_counts) == list(counts)


def test_split_by_batch_requires_sorted_batch(rng):
    pos, batch = _batched(rng, (10, 10), 2)
    with pytest.raises(ValueError, match="sorted"):
        jstack.split_by_batch(pos, None, batch[::-1].copy(), 2)
    with pytest.raises(ValueError, match="sorted"):
        tp.split_by_batch(pos, None, batch[::-1].copy(), 2)


def test_split_by_batch_without_batch_is_one_member(rng):
    pos, _ = _batched(rng, (40,), 2)
    got, want = tp.split_by_batch(pos, None, None, 1), jstack.split_by_batch(pos, None, None, 1)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("dim,counts,N,T", [
    (2, (250, 400, 175), 16, None),
    (3, (128, 128), 8, None),
    (3, (400, 0, 310), 64, 16),  # an empty member, a partial slab
])
def test_build_plan_stack_equals_jax(rng, dim, counts, N, T):
    pos, batch = _batched(rng, counts, dim)
    pos_stack, _, _, _ = jstack.split_by_batch(pos, None, batch, len(counts))
    kw = dict(N=N, m=3, T=T)
    jplans = jstack.build_plan_stack(pos_stack, **kw)
    plans = tp.build_plan_stack(pos_stack, device="cpu", **kw)
    _assert_same_plan(plans, jplans)
    for i in range(len(counts)):
        _assert_same_plan(tp.index_plan(plans, i), jstack.index_plan(jplans, i))
    # views into the stack
    assert tp.index_plan(plans, 1).slot_pt.data_ptr() == plans.slot_pt[1].data_ptr()
    # carried across as numpy: the same stacked plan
    arrays = {name: np.asarray(getattr(jplans, name)) for name in PLAN_ARRAYS}
    statics = {name: getattr(jplans, name) for name in tp.convert.PLAN_STATICS}
    _assert_same_plan(tp.plan_from_numpy(arrays, **statics, device="cpu"), jplans)


def test_pad_plan_rows_equals_jax(rng):
    pos, batch = _batched(rng, (300,), 2)
    jplan = jbinned.build_plan(pos, batch, N=16, m=3, batch_size=1)
    plan = tp.build_plan(pos, batch, N=16, m=3, batch_size=1, device="cpu")
    S = plan.S
    _assert_same_plan(tp.pad_plan_rows(plan, S + 37), jstack.pad_plan_rows(jplan, S + 37))
    assert tp.pad_plan_rows(plan, S) is plan
    for pad in (tp.pad_plan_rows, jstack.pad_plan_rows):
        with pytest.raises(ValueError, match="rows > target"):
            pad(plan if pad is tp.pad_plan_rows else jplan, S - 1)


def test_squeeze_plan_equals_jax(rng):
    pos, batch = _batched(rng, (200,), 2)
    pos_stack, _, _, _ = jstack.split_by_batch(pos, None, batch, 1)
    jplans = jstack.build_plan_stack(pos_stack, N=16, m=3)
    plans = tp.build_plan_stack(pos_stack, N=16, m=3, device="cpu")
    _assert_same_plan(tp.squeeze_plan(plans), jstack.squeeze_plan(jplans))
    two = tp.stack_plans([tp.squeeze_plan(plans)] * 2)
    with pytest.raises(ValueError, match="one member"):
        tp.squeeze_plan(two)


def test_stack_plans_errors(rng):
    pos, batch = _batched(rng, (200, 260), 2)
    pos_stack, _, _, _ = jstack.split_by_batch(pos, None, batch, 2)
    for build, stack, pad in (
            (lambda p, **k: tp.build_plan(p, None, batch_size=1, device="cpu", **k),
             tp.stack_plans, tp.pad_plan_rows),
            (lambda p, **k: jbinned.build_plan(p, None, batch_size=1, **k),
             jstack.stack_plans, jstack.pad_plan_rows)):
        a = build(pos_stack[0], N=16, m=3, K=64)
        with pytest.raises(ValueError, match="must share \\(n, dim"):
            stack([a, build(pos_stack[1], N=16, m=2, K=64)])
        b = build(pos_stack[1][::-1].copy() * 0.5, N=16, m=3, K=64)
        if a.slot_pt.shape != b.slot_pt.shape:
            with pytest.raises(ValueError, match="pad_plan_rows first"):
                stack([a, b])
        S = max(a.slot_pt.shape[0], b.slot_pt.shape[0])
        stack([pad(a, S), pad(b, S)])


@pytest.mark.parametrize("actives,nb,dim", [
    ([((2, 3), (0, 8)), ((4, 3), (1, 2))], 8, 2),
    ([((6, 4),), ((1, 2),)], 8, 1),  # runs that wrap past the last tile
    ([((7, 3), (6, 4)), ((0, 2), (7, 2))], 8, 2),
    ([None, ((1, 2), (3, 3))], 8, 2),
    ([((0, 8), (2, 2)), ((3, 2), (2, 3))], 8, 2),
    ([((1, 2), (1, 2), (1, 2))], 16, 3),
    ([((2, 3), (2, 3)), ((6, 5), (0, 3))], 8, 2),
])
def test_merge_active_runs_equals_jax(actives, nb, dim):
    assert pbinned.merge_active_runs(actives, nb, dim) == \
        jbinned.merge_active_runs(actives, nb, dim)


def test_stacked_plan_merges_active_slabs(rng):
    pos, batch = _batched(rng, (300, 300), 3)
    pos[300:] += 0.2  # the second member in another corner
    pos_stack, _, _, _ = jstack.split_by_batch(pos, None, batch, 2)
    plans = tp.build_plan_stack(pos_stack, N=64, m=3, T=16, device="cpu")
    members = [tp.build_plan(p, None, N=64, m=3, T=16, K=plans.K, batch_size=1,
                             device="cpu") for p in pos_stack]
    assert plans.active == pbinned.merge_active_runs(
        [p.active for p in members], plans.M // plans.T, 3)
    assert plans.active == jstack.build_plan_stack(pos_stack, N=64, m=3, T=16).active
