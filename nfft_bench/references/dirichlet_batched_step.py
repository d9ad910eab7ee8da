"""Plain reference of the ``batched_step`` configurations: the training
step of ``references/dirichlet_pair.py``, loaded from its file, unchanged,
run member by member.

A batched step is block diagonal: member i's x.grad and pos.grad at a
point are the direct Dirichlet-kernel sums over member i's points alone
(in float64, or with ``precision="tf32"`` the control). The members are
the configuration's ``member_counts``, consecutive runs of the flat
points. Each sampled row is computed from its own member's points, pool
values and the sampled rows that fall in it, and every output is put back
in row order. Imports nothing of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from nfftb import spec

_pair = spec.module(spec.BENCH_DIR, "references", "dirichlet_pair")

dirichlet = _pair.dirichlet
grid_points = _pair.grid_points


def member_bounds(config: dict) -> np.ndarray:
    """(batch_size + 1,) offsets of the members in the flat points."""
    return np.concatenate([[0], np.cumsum(np.asarray(config["member_counts"], np.int64))])


def outputs(config: dict, traffic: dict, points, rows, pool: list,
            precision: str = "float64") -> list:
    """For each pool entry: {"xgrad": (rows, C), "posgrad": (rows, dim)},
    each row summed over its own member's points."""
    step = dict(traffic, call="step")
    bounds = member_bounds(config)
    rows = torch.as_tensor(rows)
    parts = []
    for lo, hi in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        mine = rows[(rows >= lo) & (rows < hi)]
        if mine.numel() == 0:
            continue
        member_pool = [{k: v[lo:hi] for k, v in values.items()} for values in pool]
        parts.append(_pair.outputs(config, step, points[lo:hi], mine - lo, member_pool,
                                   precision=precision))
    return [{key: torch.cat([part[k][key] for part in parts]) for key in parts[0][k]}
            for k in range(len(pool))]
