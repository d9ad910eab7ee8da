"""Carry a binned plan across packages as numpy arrays.

``plan_from_numpy`` builds the port's :class:`BinnedPlan` from the fields of
a JAX ``BinnedPlan`` (or any plan) passed as numpy arrays, so that both
packages run the same plan. ``plan_to_numpy`` is its inverse.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .ops.binned import BinnedPlan

__all__ = ["PLAN_ARRAYS", "PLAN_STATICS", "plan_from_numpy", "plan_to_numpy"]

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
                "window", "active")


def plan_from_numpy(arrays: dict, *, n: int, dim: int, N: int, m: int,
                    sigma: float, T: int, K: int, batch_size: int,
                    window: str = "gaussian", active=None,
                    device=None) -> BinnedPlan:
    """A plan on ``device`` (the card unless "cpu" is asked for) from numpy
    arrays named as in :data:`PLAN_ARRAYS`; shapes are checked."""
    dev = resolve_device(device)
    missing = set(PLAN_ARRAYS) - set(arrays)
    if missing:
        raise KeyError(f"plan arrays missing: {sorted(missing)}")
    t = {
        name: torch.as_tensor(np.array(arrays[name]), device=dev).to(dtype)
        for name, dtype in PLAN_ARRAYS.items()
    }
    S = t["slot_pt"].shape[0]
    expect = {
        "slot_pt": (S, K), "slot_pos": (dim, S * K), "origin": (S, dim),
        "row_batch": (S,), "fill_keys": (S * K,), "row_count": (S,),
    }
    for name, shape in expect.items():
        if tuple(t[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t[name].shape)}, expected {shape}")
    if active is not None:
        active = tuple(tuple(int(v) for v in run) for run in active)
    return BinnedPlan(
        **t, n=int(n), dim=int(dim), N=int(N), m=int(m), sigma=float(sigma),
        T=int(T), K=int(K), batch_size=int(batch_size), window=str(window),
        active=active,
    )


def plan_to_numpy(plan: BinnedPlan) -> tuple[dict, dict]:
    """(arrays, statics) such that ``plan_from_numpy(arrays, **statics)``
    rebuilds the plan."""
    arrays = {name: getattr(plan, name).cpu().numpy() for name in PLAN_ARRAYS}
    statics = {name: getattr(plan, name) for name in PLAN_STATICS}
    return arrays, statics
