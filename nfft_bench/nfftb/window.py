"""The closed loop of one caller, and the arithmetic of its metrics.

One caller issues one call at a time and waits for it
(``torch.cuda.synchronize()``), as a CG or Lanczos loop or a training
loop does; the pool of inputs is cycled. Each call is timed by the host
clock from issue to synchronise. After the clock stops, the call's
outputs at the sampled rows are copied aside (one small ``index_select``
per output), so that every call of the window is checked.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Window:
    times_s: list = field(default_factory=list)  # each call, issue to synchronise
    pool_index: list = field(default_factory=list)  # which pool entry each call took
    kept: list = field(default_factory=list)  # each call's outputs at the sampled rows
    window_s: float = 0.0

    @property
    def calls(self) -> int:
        return len(self.times_s)


def drive(call, pool: list, rows_t, seconds: float, sync) -> Window:
    """Call ``call(pool[i % len(pool)])`` until ``seconds`` have passed
    (at least once); the window ends when the last call has finished."""
    win = Window()
    t0 = time.perf_counter()
    i = 0
    while i == 0 or time.perf_counter() - t0 < seconds:
        k = i % len(pool)
        start = time.perf_counter()
        out = call(pool[k])
        sync()
        win.times_s.append(time.perf_counter() - start)
        win.pool_index.append(k)
        win.kept.append({name: t.detach().index_select(0, rows_t) for name, t in out.items()})
        del out
        i += 1
    sync()
    win.window_s = time.perf_counter() - t0
    return win


def percentile_ms(times_s: list, q: float) -> float:
    """The q-th percentile of the calls' times in ms (linear
    interpolation between the closest ranks, numpy's default)."""
    return float(np.percentile(np.asarray(times_s, dtype=np.float64) * 1e3, q))


def rate(calls: int, units_per_call: int, window_s: float) -> float:
    """Units completed per second over the whole window."""
    return calls * units_per_call / window_s
