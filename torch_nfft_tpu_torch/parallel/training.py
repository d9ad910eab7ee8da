"""A sharded training step of kernel regression on the Gram operator.

Counterpart of the JAX package's ``parallel/training.py``: fit per-source
weights ``w`` so that the fastsum matvec reproduces targets ``y``, over a
mesh with two axes:

* ``data_axis`` — independent point sets (the grid is block diagonal over
  sets: no communication beyond the scalar loss);
* ``points_axis`` — the points of every set: each rank spreads its block,
  one all-reduce over the axis sums the grid, the gathers stay local.

The step works on each rank's block of the (batch_size, n_per_set, .)
arrays (``shard`` cuts it from a global tensor). Its gradient is the
backward of the rank's local loss over ``batch_size * n_per_set``; through
the all-reduce and its transpose (``parallel/_comm.py``) it equals the
gradient of the global loss in the rank's block.
"""

from __future__ import annotations

import torch

from ..ops.binned import build_plan
from ..ops.planar import _tensor
from ..ops.window import DEFAULT_SIGMA
from ._comm import all_reduce_, rank, size
from .mesh import axis_group, mesh_device
from .sharded import fastsum_local

__all__ = ["make_fastsum_train_step"]


def make_fastsum_train_step(mesh, coeffs, *, batch_size, n_per_set, cutoff=3,
                            learning_rate=0.1, optimizer=None, optimizer_kwargs=None,
                            data_axis="data", points_axis="points", sigma=DEFAULT_SIGMA,
                            strategy="auto", window="gaussian"):
    """Build ``step(w, pos, y[, opt_state]) -> (w_new, loss[, opt_state])``
    over ``mesh``, and ``shard``.

    ``w``, ``pos`` and ``y`` are this rank's blocks (B_local, n_local, .)
    of the global (batch_size, n_per_set, .) arrays, C columns for w and y,
    dim coordinates for pos; ``shard(t)`` cuts the block from a global
    tensor and puts it on the mesh's device. ``batch_size`` must divide by
    the data axis and ``n_per_set`` by the points axis. ``loss`` is the
    global mean square error summed over columns, the same on every rank.

    ``optimizer``: a ``torch.optim`` optimizer class with its keyword
    arguments in ``optimizer_kwargs`` (``torch.optim.Adam`` and optax's
    ``adam`` share their defaults and update); the step then takes and
    returns an ``opt_state`` (``step.init(w)`` makes the first) instead of
    applying plain SGD with ``learning_rate``. With ``strategy="binned"``
    a rank plans its block once per ``pos`` tensor (the host builder) and
    keeps the plan while it is passed the same tensor.

    Returns (step, shard)."""
    dev = mesh_device(mesh)
    coeffs = _tensor(coeffs, dev)
    N = coeffs.shape[0]
    m = int(cutoff)
    dg, pg = axis_group(mesh, data_axis), axis_group(mesh, points_axis)
    dd, pp = size(dg), size(pg)
    if batch_size % dd:
        raise ValueError(f"batch_size {batch_size} not divisible by {data_axis}={dd}")
    if n_per_set % pp:
        raise ValueError(f"n_per_set {n_per_set} not divisible by {points_axis}={pp}")
    B_local, n_local = batch_size // dd, n_per_set // pp
    denom = float(batch_size * n_per_set)
    bvec = torch.arange(B_local, dtype=torch.int32, device=dev).repeat_interleave(n_local)
    planned = {}  # pos tensor -> the plan of its block (strategy "binned")

    def shard(t) -> torch.Tensor:
        t = torch.as_tensor(t, device=dev)
        b, p = rank(dg), rank(pg)
        return t[b * B_local:(b + 1) * B_local, p * n_local:(p + 1) * n_local].contiguous()

    def plan_for(posf, pos):
        if strategy != "binned":
            return None
        if planned.get("pos") is not pos:
            planned.update(pos=pos, plan=build_plan(
                posf, bvec, N=N, m=m, sigma=sigma, batch_size=B_local, window=window,
                device=dev))
        return planned["plan"]

    def grad_and_loss(w, pos, y):
        C, dim = w.shape[-1], pos.shape[-1]
        posf = pos.reshape(B_local * n_local, dim)
        wl = w.detach().to(torch.float32).requires_grad_()
        plan = plan_for(posf, pos)
        pred = fastsum_local(wl.reshape(-1, C), posf, bvec, posf, bvec, coeffs,
                             batch_size=B_local, N=N, m=m, sigma=sigma, window=window,
                             strategy=strategy, group=pg, source_plan=plan,
                             target_plan=plan, device=dev)
        local = ((pred.reshape(w.shape) - y) ** 2).sum()
        (local / denom).backward()
        loss = all_reduce_(all_reduce_(local.detach().clone(), pg), dg) / denom
        return wl.grad, loss

    if optimizer is None:
        def step(w, pos, y):
            grad, loss = grad_and_loss(w, pos, y)
            return w - learning_rate * grad, loss
    else:
        kwargs = dict(optimizer_kwargs or {})

        def init(w):
            param = w.detach().clone().requires_grad_()
            return param, optimizer([param], **kwargs)

        def step(w, pos, y, opt_state):
            param, opt = opt_state
            grad, loss = grad_and_loss(w, pos, y)
            with torch.no_grad():
                param.copy_(w)
            param.grad = grad
            opt.step()
            return param.detach().clone(), loss, opt_state

        step.init = init
    return step, shard
