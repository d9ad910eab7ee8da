"""member_step_roofline (layer: streamed member step, ``ops/streaming.py``'s
member loop forward and backward): the least time of the window's
spreads, gathers and position gradients, counted member by member, over
the device time of the spread, gather and position-gradient kernels named
here, in percent.

As ``member_roofline``: each member's covered cells
(``nfftb/roofline.py:covered_cells``) are counted on its own M^dim grid,
with its own points, and each member's least time (``roofline.work``,
``roofline.least_s``) of the traffic's ``work`` is summed; the
recomputed forward passes of the backward are the program's overhead,
not work. None without a trace, the configuration's ``member_counts`` or
a matching kernel.
"""

import numpy as np

from nfftb import roofline, trace

KERNELS = ("spread_kernel", "spread_contract_kernel", "points_kernel")
PATTERN = r"\b(" + "|".join(KERNELS) + r")\b"
KINDS = ("spread", "gather", "pos_grad")


def least_s_per_call(ctx) -> float:
    """Least seconds of one step's spreads, gathers and position
    gradients, member by member."""
    cfg, per_call = ctx.config, ctx.cell.traffic.get("work", {})
    dim, m = int(cfg["dim"]), int(cfg["cutoff"])
    M = round(float(cfg["oversampling"]) * int(cfg["bandwidth"]))
    bounds = np.concatenate([[0], np.cumsum(np.asarray(cfg["member_counts"], np.int64))])
    grid = ctx.reference.grid_points(cfg, ctx.inputs.points)
    total = 0.0
    for lo, hi in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        if hi == lo:
            continue
        covered = roofline.covered_cells(grid[lo:hi], M, m)
        for kind in KINDS:
            work = roofline.work(kind, hi - lo, ctx.columns, dim, 2 * m + 2, covered)
            total += per_call.get(kind, 0) * roofline.least_s(*work)[0]
    return total


def read(ctx):
    if ctx.trace is None or ctx.win.calls == 0 or "member_counts" not in ctx.config:
        return None
    device_s = trace.total_ns(ctx.trace, PATTERN) / 1e9
    if device_s <= 0:
        return None
    return 100.0 * least_s_per_call(ctx) * ctx.win.calls / device_s
