"""Stacks of binned plans of one shape, one plan per member of a batched
point set.

Counterpart of the JAX package's ``ops/plan_stack.py``. A stacked plan is a
:class:`BinnedPlan` whose six tensors carry a leading member axis; its
statics come from the first member, with ``pos_fp``, ``S_occ`` and
``benes`` dropped (they belong to one member) and ``active`` the members'
merged slab (:func:`binned.merge_active_runs`). :func:`index_plan` takes
member i back out as a plain plan made of views; the entry points refuse
the stack itself (``planar.setup_plan``). The streamed transforms
(ops/streaming.py) run the members one at a time.

All members are padded to a common row count S and share the first
member's slot capacity K and tile edge T. A padded row has
``row_count == 0``, origin 0 and batch 0: it moves nothing through any
kernel, and the dense spread's tile ids point it at the tile of the row
before it (``binned.dense_tile_ids``), so each tile's rows stay one run.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from .binned import BinnedPlan, build_plan, host_array, merge_active_runs
from .window import DEFAULT_SIGMA, DEFAULT_WINDOW

__all__ = [
    "pad_plan_rows",
    "stack_plans",
    "index_plan",
    "squeeze_plan",
    "build_plan_stack",
    "split_by_batch",
]

_TENSORS = ("slot_pt", "slot_pos", "origin", "row_batch", "fill_keys", "row_count")


def pad_plan_rows(plan: BinnedPlan, S_target: int) -> BinnedPlan:
    """``plan`` padded to ``S_target`` rows with empty rows
    (``row_count == 0``); their slots extend the empty tail of
    ``fill_keys``. The host layout and Benes tables are dropped."""
    S, K = plan.S, plan.K
    if S > S_target:
        raise ValueError(f"plan has {S} rows > target {S_target}")
    if S == S_target:
        return plan
    p = S_target - S
    pad = torch.nn.functional.pad
    return replace(
        plan,
        slot_pt=pad(plan.slot_pt, (0, 0, 0, p)),
        slot_pos=pad(plan.slot_pos, (0, p * K)),
        origin=pad(plan.origin, (0, 0, 0, p)),
        row_batch=pad(plan.row_batch, (0, p)),
        fill_keys=torch.cat([plan.fill_keys, torch.arange(
            S * K, S_target * K, dtype=plan.fill_keys.dtype, device=plan.device)]),
        row_count=pad(plan.row_count, (0, p)),
        order=None, row_start=None, benes=None,
    )


def stack_plans(plans: list[BinnedPlan]) -> BinnedPlan:
    """Stack plans of one geometry and row count along a new leading axis.
    The members' Benes tables are dropped: a stack runs the sort route."""
    p0 = plans[0]
    key = lambda p: (p.n, p.dim, p.N, p.m, p.sigma, p.T, p.K, p.window)  # noqa: E731
    for p in plans[1:]:
        if key(p) != key(p0):
            raise ValueError("all stacked plans must share (n, dim, N, m, sigma, T, K, window)")
        if p.slot_pt.shape != p0.slot_pt.shape:
            raise ValueError("all stacked plans must share S — pad_plan_rows first")
    return replace(
        p0,
        **{name: torch.stack([getattr(p, name) for p in plans]) for name in _TENSORS},
        pos_fp=None, order=None, row_start=None, S_occ=None, benes=None,
        active=merge_active_runs([p.active for p in plans], p0.M // p0.T, p0.dim),
    )


def index_plan(stacked: BinnedPlan, i: int) -> BinnedPlan:
    """Member ``i`` of a stacked plan, its tensors views into the stack."""
    return replace(stacked, **{name: getattr(stacked, name)[i] for name in _TENSORS})


def squeeze_plan(stacked: BinnedPlan) -> BinnedPlan:
    """The only member of a stack of one (a shard's view of its stack)."""
    if stacked.slot_pt.shape[0] != 1:
        raise ValueError(f"squeeze_plan needs a stack of one member, got "
                         f"{stacked.slot_pt.shape[0]}")
    return index_plan(stacked, 0)


def member_slots(counts, n_max: int) -> np.ndarray:
    """(sum(counts),) int64: the flat (B * n_max) slot of each point of the
    flat layout, members in order, each point at its place in its member."""
    counts = np.asarray(counts)
    member = np.repeat(np.arange(counts.size), counts)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    return member * n_max + np.arange(member.size) - start[member]


def split_by_batch(pos, x, batch, batch_size: int):
    """Split a batched point set, flat with a sorted ``batch`` vector (the
    reference's layout), into members of one size.

    Members are padded to the largest member's count with points at the
    origin and zero values (a zero value spreads nothing; callers drop the
    padded outputs of a gather by ``counts``). Tensors give tensors on
    their device, NumPy gives NumPy. Returns ``(pos_stack (B, n_max, dim),
    x_stack (B, n_max, *cols) or None, counts (B,), bounds (B + 1,))``,
    ``counts`` and ``bounds`` as NumPy."""
    as_numpy = not isinstance(pos, torch.Tensor)
    pos_t = torch.as_tensor(pos)
    n = pos_t.shape[0]
    b = np.zeros((n,), np.int64) if batch is None else host_array(batch, np.int64)
    if np.any(b[1:] < b[:-1]):
        raise ValueError("batch must be sorted ascending")
    bounds = np.searchsorted(b, np.arange(batch_size + 1))
    counts = np.diff(bounds)
    n_max = int(counts.max())
    slot = torch.as_tensor(member_slots(counts, n_max))

    def pack(a):
        a = torch.as_tensor(a)[bounds[0]: bounds[-1]]
        out = a.new_zeros((batch_size * n_max,) + tuple(a.shape[1:]))
        out.index_copy_(0, slot.to(a.device), a)
        out = out.reshape((batch_size, n_max) + tuple(a.shape[1:]))
        return out.numpy() if as_numpy else out

    return pack(pos_t), None if x is None else pack(x), counts, bounds


def build_plan_stack(pos_stack, *, N: int, m: int, sigma: float = DEFAULT_SIGMA,
                     T: int | None = None, K: int | None = None,
                     window: str = DEFAULT_WINDOW, device=None) -> BinnedPlan:
    """One host plan (:func:`binned.build_plan`, batch size 1) per member of
    ``pos_stack`` (B, n, dim), on ``device`` (the card unless
    ``device="cpu"``), stacked. The first member's K and T are forced on the
    rest so that the stack is rectangular; S is padded to the largest
    member's row count."""
    pos_np = host_array(pos_stack, np.float32)
    plans = []
    for b in range(pos_np.shape[0]):
        p = build_plan(pos_np[b], None, N=N, m=m, sigma=sigma, batch_size=1, T=T, K=K,
                       window=window, device=device)
        if K is None:
            K, T = p.K, p.T
        plans.append(p)
    S_max = max(p.S for p in plans)
    return stack_plans([pad_plan_rows(p, S_max) for p in plans])
