"""Carry a binned plan or a kernel operator across packages as numpy arrays.

``plan_from_numpy`` builds the port's :class:`BinnedPlan` from the fields of
a JAX ``BinnedPlan`` (or any plan) passed as numpy arrays, so that both
packages run the same plan: the device arrays of :data:`PLAN_ARRAYS`, and
the statics of :data:`PLAN_STATICS` with the host builder's bin-id
fingerprint ``pos_fp``, sorted ``order``, ``row_start`` and ``S_occ``.
``plan_to_numpy`` is its inverse (Benes tables are not carried: route them
again with ``with_benes_tables``). ``operator_from_numpy`` builds the
port's ``GaussianKernel``, radial kernels, ``GramMatrix`` or
``AdjacencyMatrix`` from the leaves and aux data of the JAX object's
``tree_flatten``, ``layout_from_numpy`` a streamed layout with its
stacked member plans, and ``grid_layout_from_numpy`` a grid-sharded
layout with its stacked slab plans.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .models.kernel import GaussianKernel
from .models.matrices import AbstractMatrix, AdjacencyMatrix, GramMatrix
from .models.radial import InverseMultiquadricKernel, LaplaceKernel, MaternKernel, RadialKernel
from .ops.binned import BinnedPlan

__all__ = ["PLAN_ARRAYS", "PLAN_STATICS", "plan_from_numpy", "plan_to_numpy",
           "layout_from_numpy", "grid_layout_from_numpy", "operator_from_numpy"]

# array fields and their dtypes
PLAN_ARRAYS = {
    "slot_pt": torch.int32,
    "slot_pos": torch.float32,
    "origin": torch.int32,
    "row_batch": torch.int32,
    "fill_keys": torch.int32,
    "row_count": torch.int32,
}
PLAN_STATICS = ("n", "dim", "N", "m", "sigma", "T", "K", "batch_size",
                "window", "active", "pos_fp", "order", "row_start", "S_occ")


def plan_from_numpy(arrays: dict, *, n: int, dim: int, N: int, m: int,
                    sigma: float, T: int, K: int, batch_size: int,
                    window: str = "gaussian", active=None, pos_fp=None,
                    order=None, row_start=None, S_occ=None,
                    device=None) -> BinnedPlan:
    """A plan on ``device`` (the card unless "cpu" is asked for) from numpy
    arrays named as in :data:`PLAN_ARRAYS`; shapes are checked. ``order``
    and ``row_start`` stay on the host. Arrays with a leading member axis
    give a stacked plan (``ops/plan_stack.py:stack_plans``)."""
    dev = resolve_device(device)
    missing = set(PLAN_ARRAYS) - set(arrays)
    if missing:
        raise KeyError(f"plan arrays missing: {sorted(missing)}")
    t = {
        name: torch.as_tensor(np.array(arrays[name]), device=dev).to(dtype)
        for name, dtype in PLAN_ARRAYS.items()
    }
    # a stacked plan (stack_plans) carries a leading member axis
    lead = tuple(t["slot_pt"].shape[:-2])
    if len(lead) > 1 or (lead and (order is not None or row_start is not None)):
        raise ValueError("a stacked plan has one member axis and no host order/row_start")
    S = t["slot_pt"].shape[-2]
    expect = {
        "slot_pt": (S, K), "slot_pos": (dim, S * K), "origin": (S, dim),
        "row_batch": (S,), "fill_keys": (S * K,), "row_count": (S,),
    }
    for name, shape in expect.items():
        if tuple(t[name].shape) != lead + shape:
            raise ValueError(f"{name} has shape {tuple(t[name].shape)}, expected {lead + shape}")
    host = {}
    for name, a, size in (("order", order, n), ("row_start", row_start, S)):
        if a is not None:
            host[name] = np.array(a, dtype=np.int32)
            if host[name].shape != (size,):
                raise ValueError(f"{name} has shape {host[name].shape}, expected ({size},)")
    if active is not None:
        active = tuple(tuple(int(v) for v in run) for run in active)
    return BinnedPlan(
        **t, n=int(n), dim=int(dim), N=int(N), m=int(m), sigma=float(sigma),
        T=int(T), K=int(K), batch_size=int(batch_size), window=str(window),
        active=active, pos_fp=None if pos_fp is None else int(pos_fp),
        S_occ=None if S_occ is None else int(S_occ), **host,
    )


def plan_to_numpy(plan: BinnedPlan) -> tuple[dict, dict]:
    """(arrays, statics) such that ``plan_from_numpy(arrays, **statics)``
    rebuilds the plan."""
    arrays = {name: getattr(plan, name).cpu().numpy() for name in PLAN_ARRAYS}
    statics = {name: getattr(plan, name) for name in PLAN_STATICS}
    return arrays, statics


def layout_from_numpy(pos_stack, counts, plans, N: int, m: int, sigma: float,
                      window: str = "gaussian", *, device=None):
    """The port's :class:`~ops.streaming.StreamedLayout` from a JAX layout's
    fields: ``pos_stack`` (B, n_max, dim) and ``counts`` (B,) as numpy, and
    ``plans`` None or the stacked plan as the ``(arrays, statics)`` pair of
    :func:`plan_to_numpy` (statics without ``device``)."""
    from .ops.streaming import StreamedLayout

    dev = resolve_device(device)
    if plans is not None:
        arrays, statics = plans
        plans = plan_from_numpy(arrays, **statics, device=dev)
    pos_t = torch.as_tensor(np.array(pos_stack, dtype=np.float32), device=dev)
    return StreamedLayout(pos_t, np.asarray(counts), plans, N, m, sigma, window)


def grid_layout_from_numpy(plans, pos_stack, point_index, *, n: int, n_shards: int,
                           dim: int, N: int, m: int, sigma: float, T: int, A0_loc: int,
                           window: str = "gaussian", device=None):
    """The port's :class:`~parallel.grid_sharded.GridShardedLayout` from a
    JAX layout's fields: ``plans`` the stacked slab plans as the
    ``(arrays, statics)`` pair of :func:`plan_to_numpy` (statics without
    ``device``), ``pos_stack`` (P, n_loc, dim) and ``point_index``
    (P, n_loc) as numpy, and the static fields."""
    from .parallel.grid_sharded import GridShardedLayout

    dev = resolve_device(device)
    arrays, statics = plans
    return GridShardedLayout(
        plans=plan_from_numpy(arrays, **statics, device=dev),
        pos_stack=torch.as_tensor(np.array(pos_stack, dtype=np.float32), device=dev),
        point_index=torch.as_tensor(np.array(point_index, dtype=np.int32), device=dev),
        n=int(n), n_shards=int(n_shards), dim=int(dim), N=int(N), m=int(m),
        sigma=float(sigma), T=int(T), A0_loc=int(A0_loc), window=str(window))


def _leaf(a, dev):
    """A numpy leaf on ``dev``: float32 or complex64, batch vectors int32,
    None as None."""
    if a is None:
        return None
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int32), device=dev)
    return torch.as_tensor(a.astype(np.complex64 if np.iscomplexobj(a) else np.float32),
                           device=dev)


_SIGMA_KERNELS = {cls.__name__: cls for cls in (LaplaceKernel, InverseMultiquadricKernel)}


def _radial_from_numpy(coeffs, aux, dev) -> RadialKernel:
    at = next(i for i, a in enumerate(aux) if callable(a))
    head = aux[:at]
    (profile, dim, bandwidth, cutoff, shift_by_center, reg_degree, reg_width, scale_by_norm,
     factor, window) = aux[at:]
    kw = dict(dim=dim, bandwidth=bandwidth, cutoff=cutoff, shift_by_center=shift_by_center,
              reg_degree=reg_degree, reg_width=reg_width, window=window, device=dev,
              _coeffs=_leaf(coeffs, dev))
    if len(head) == 2:
        kernel = MaternKernel(head[1], nu=head[0], **kw)
    elif len(head) == 1:
        owner = getattr(profile, "__qualname__", "").split(".")[0]
        if owner not in _SIGMA_KERNELS:
            raise ValueError(f"unrecognised one-parameter radial profile {owner!r}")
        kernel = _SIGMA_KERNELS[owner](head[0], **kw)
    else:
        kernel = RadialKernel(profile, **kw)
    kernel.scale_by_norm, kernel.factor = scale_by_norm, factor
    return kernel


def operator_from_numpy(children, aux, *, device=None):
    """The port's operator from the JAX object's ``tree_flatten()`` with
    its leaves as numpy arrays (the coefficients and degree vectors taken
    as given, not recomputed):

    * ``GaussianKernel``: children ``(coeffs,)``, aux its 11 statics;
    * a radial kernel: children ``(coeffs,)``, aux the profile callable and
      its 9 statics, after ``sigma`` for ``LaplaceKernel`` and
      ``InverseMultiquadricKernel`` (told apart by the profile's name) and
      after ``(nu, sigma)`` for ``MaternKernel``; a ``RadialKernel`` keeps
      the callable as its profile (it takes NumPy float64 in both
      packages), the others use their own;
    * ``GramMatrix``: children ``(coeffs, sources, targets, source_batch,
      target_batch)``, aux ``(cutoff, batch_size, symmetric, window)``. A
      symmetric operator gets its sources as its targets (and its source
      batch as its target batch when the two are equal), keeping the
      identities its symmetry is decided by;
    * ``AdjacencyMatrix``: children ``((gram children, gram aux),
      {degree name: array})``, the Gram matrix carried by its own pair,
      aux ``(shape, diagonal_offset, normalization, shift)``.
    """
    dev = resolve_device(device)
    if len(children) == 1 and any(callable(a) for a in aux):
        return _radial_from_numpy(children[0], aux, dev)
    if len(children) == 1:
        (sigma, dim, bandwidth, cutoff, shift_by_center, analytic, reg_degree, reg_width,
         scale_by_norm, factor, window) = aux
        kernel = GaussianKernel(sigma, dim, bandwidth, cutoff, shift_by_center,
                                analytic=analytic, reg_degree=reg_degree,
                                reg_width=reg_width, window=window, device=dev,
                                _coeffs=_leaf(children[0], dev))
        kernel.scale_by_norm, kernel.factor = scale_by_norm, factor
        return kernel
    if len(children) == 5:
        cutoff, batch_size, symmetric, window = aux
        coeffs, sources, targets, sb, tb = (_leaf(a, dev) for a in children)
        if symmetric:
            targets = sources
            if sb is not None and tb is not None and torch.equal(sb, tb):
                tb = sb
        return GramMatrix(coeffs, sources, targets, sb, tb, cutoff=cutoff,
                          batch_size=batch_size, window=window, device=dev,
                          _symmetric=symmetric)
    if len(children) == 2:
        (gram_children, gram_aux), arrays = children
        shape, diagonal_offset, normalization, shift = aux
        adj = object.__new__(AdjacencyMatrix)
        AbstractMatrix.__init__(adj, tuple(shape), dev)
        adj.gram_matrix = operator_from_numpy(gram_children, gram_aux, device=dev)
        adj.diagonal_offset, adj.normalization, adj.shift = diagonal_offset, normalization, shift
        adj._slot_cache = {}
        for name, value in arrays.items():
            setattr(adj, name, _leaf(value, dev))
        return adj
    raise ValueError(f"unrecognised operator leaves: {len(children)} children")
