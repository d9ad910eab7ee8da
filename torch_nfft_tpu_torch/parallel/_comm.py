"""Collectives with the gradients of the JAX package's sharded transforms.

Every rank calls a sharded transform with the same global tensors and
computes the same loss on its global outputs. Three autograd Functions
place the collectives where ``shard_map``'s varying-axes check
(``check_vma``) places ``psum`` and its implicit broadcast, so that each
rank's gradients equal ``jax.grad`` of the global function:

* :func:`reduce` — forward all-reduce (sum), backward identity: a rank's
  partial grid or spectrum becomes the replicated one;
* :func:`to_varying` — forward identity, backward all-reduce (sum): a
  replicated tensor (a global input, a replicated grid before a local
  gather, a forward's spectrum) enters work that differs by rank;
* :func:`all_gather_rows` — forward all-gather along the sharded axis,
  backward the rank's own block of the cotangent.

``torch.distributed.nn.functional.all_reduce`` is not used: its backward
all-reduces the cotangent, which, with a loss that every rank computes
alike, multiplies the gradient by the group's size.

:func:`ring_shift` stands for ``lax.ppermute`` by one place around a group
(``batch_isend_irecv``). It is a plain transfer: the grid-sharded slab's
fold and unfold, each the other's backward on the shard's tile route,
call it in both directions. A group of one rank is a ring of one: NCCL
sends to itself, otherwise the shift is a copy. A group of one does no
all-reduce or all-gather. Every function takes its group explicitly;
``None`` is no group (one rank, no transfer).

Each transfer runs in a span of the port's recorder
(:mod:`torch_nfft_tpu_torch.trace`): ``all-reduce``, ``all-gather`` and
``halo shift`` (the ring shift, which only the grid-sharded transforms'
halo takes), and :data:`sent_bytes` counts, by collective, the bytes this
rank hands to it: the tensor it all-reduces, its own block of an
all-gather, the block it shifts. ``trace.counters()`` reports them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import trace

__all__ = ["size", "rank", "reduce", "to_varying", "all_gather_rows", "ring_shift",
           "all_reduce_", "sent_bytes"]

# bytes this process handed to each kind of collective (see the module note)
sent_bytes = {"all_reduce": 0, "all_gather": 0, "ring_shift": 0}


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _host_staged(t: torch.Tensor, group) -> bool:
    # Gloo's send/recv fail on card tensors (the H100 probe of
    # tools/probe_dist.py: "writev: Bad address"), so under gloo the ring
    # shift moves card tensors through host memory; gloo's all-reduce and
    # all-gather take card tensors themselves. The arithmetic stays on the card.
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (no autograd)."""
    if size(group) > 1:
        with trace.span("all-reduce"):
            dist.all_reduce(t, group=group)
        sent_bytes["all_reduce"] += t.nbytes
    return t


def _all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    with trace.span("all-gather"):
        src = t.movedim(dim, 0).contiguous()
        out = src.new_empty((size(group) * src.shape[0],) + tuple(src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=group)
    sent_bytes["all_gather"] += src.nbytes
    return out.movedim(0, dim)


def ring_shift(t: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Rank r's ``t`` arrives at rank r + shift (mod the group's size): rank
    r receives rank (r - shift)'s. A ring of one sends to itself under NCCL,
    which takes that; with no group or another backend it is a copy. Not
    differentiable."""
    P, r = size(group), rank(group)
    if P == 1 and (group is None or dist.get_backend(group) != dist.Backend.NCCL):
        return t.clone()
    with trace.span("halo shift"):
        src = t.contiguous()
        staged = _host_staged(src, group)
        s = src.cpu() if staged else src
        out = torch.empty_like(s)
        ops = [dist.P2POp(dist.isend, s, dist.get_global_rank(group, (r + shift) % P), group),
               dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (r - shift) % P), group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        out = out.to(t.device) if staged else out
    sent_bytes["ring_shift"] += src.nbytes
    return out


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce_(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ToVarying(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, t.shape[dim]
        return _all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, rank(ctx.group) * ctx.n, ctx.n), None, None


def reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``; the gradient passes through unchanged."""
    return t if size(group) == 1 else _Reduce.apply(t, group)


def to_varying(t: torch.Tensor, *groups) -> torch.Tensor:
    """``t`` itself; its gradient is summed over each of ``groups``."""
    for group in groups:
        if size(group) > 1:
            t = _ToVarying.apply(t, group)
    return t


def all_gather_rows(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's blocks side by side along ``dim``, in rank order; the
    gradient is this rank's block of the cotangent."""
    return t if size(group) == 1 else _AllGather.apply(t, group, dim)
