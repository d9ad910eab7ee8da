"""allreduce_ms (layer: collectives, ``parallel/_comm.py``): rank 0's
device ms per call of the kernels whose names match the pattern here
(NCCL's all-reduce)."""

from nfftb import trace

PATTERN = r"(?i)nccl\w*allreduce"


def read(ctx):
    if ctx.trace is None or ctx.win.calls == 0:
        return None
    ns = trace.total_ns(ctx.trace, PATTERN)
    return ns / 1e6 / ctx.win.calls if ns > 0 else None
