"""How ``correct`` is decided: every call's outputs at the sampled rows
against the plain reference of the call's input.

Each number compared is the worst, over the window's calls, of one
output's rel-L2 at the sampled rows (all its columns at once) against
the reference in float64; ``limits/<workload>.json`` gives its limit.
A call whose reading is over a limit, or not finite, has failed.
"""

from __future__ import annotations

import math

import torch


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 explicit mantissa bits (round
    to nearest, ties to even), as the tensor cores read a float32
    operand with TF32 on."""
    i = t.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    lsb = (i >> 13) & 1
    i = (i + 0x0FFF + lsb) & ~0x1FFF
    i = torch.where(i >= 2**31, i - 2**32, i)
    return i.to(torch.int32).view(torch.float32)


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    got = got.detach().to("cpu", torch.float64)
    ref = ref.detach().to("cpu", torch.float64)
    den = float(torch.linalg.vector_norm(ref))
    num = float(torch.linalg.vector_norm(got.reshape(ref.shape) - ref))
    val = num / den if den > 0 else num
    return val if math.isfinite(val) else math.inf


def compare(kept: list, pool_index: list, refs: list, limits: dict) -> tuple:
    """({number: worst reading}, calls failed). ``kept[i]`` holds call i's
    outputs at the rows, ``refs[k]`` the reference's for pool entry k;
    the number ``<output>_rel_l2`` reads output ``<output>``."""
    worst = {name: 0.0 for name in limits}
    failed = 0
    for out, k in zip(kept, pool_index):
        bad = False
        for name, limit in limits.items():
            output = name[:-len("_rel_l2")]
            val = rel_l2(out[output], refs[k][output]) if output in out else math.inf
            worst[name] = max(worst[name], val)
            bad |= not val <= limit
        failed += bad
    if not kept:
        worst = {name: math.inf for name in limits}
    return worst, failed
