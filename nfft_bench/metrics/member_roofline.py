"""member_roofline (layer: streamed member pass, ``ops/streaming.py``'s
member loop through ``nfft_pair_planar``): the least time of the window's
spreads and gathers, counted member by member, over the device time of the
spread and gather kernels named here, in percent.

Each member has its own M^dim grid, so its covered cells
(``nfftb/roofline.py:covered_cells``) are counted on their own, with its
own points, and each member's least time (``roofline.work``,
``roofline.least_s``) is summed: the union of the members' cells on one
grid, which ``spread_roofline`` and ``points_roofline`` count, holds a
member's cells once for all 16. None without a trace, the configuration's
``member_counts`` or a matching kernel.
"""

import numpy as np

from nfftb import roofline, trace

KERNELS = ("spread_kernel", "spread_contract_kernel", "points_kernel")
PATTERN = r"\b(" + "|".join(KERNELS) + r")\b"
KINDS = ("spread", "gather")


def least_s_per_call(ctx) -> float:
    """Least seconds of one call's spreads and gathers, member by member."""
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
