"""The device trace of a window, from ``torch.profiler``.

The window is traced with CUDA activity alone: kernels, copies and fills
on the card, and the CUDA runtime calls that the host makes. Tracing
every host operator as well slowed the host-bound flat route by 15-30%
and so inflated the device's idle share it was meant to read. Device
activity (user annotations excepted) is the device time; the runtime
calls only label the idle gaps. Times are in nanoseconds on the
profiler's clock; nothing is written to disk.
"""

from __future__ import annotations

import heapq
import re
from collections import defaultdict
from dataclasses import dataclass

import torch

@dataclass
class Trace:
    device: list  # (name, start_ns, end_ns), sorted by start
    host: list  # (name, start_ns, end_ns)
    t0_ns: int  # the first device activity of the window
    t1_ns: int  # the end of its last


def read_profile(prof) -> Trace:
    """Split a finished ``torch.profiler.profile`` into device activity
    and host events."""
    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        span = (ev.name(), int(ev.start_ns()), int(ev.end_ns()))
        if ev.device_type() != cuda:
            host.append(span)
        elif not ev.is_user_annotation():
            device.append(span)
    device.sort(key=lambda e: e[1])
    t0 = device[0][1] if device else 0
    t1 = max((e[2] for e in device), default=0)
    return Trace(device, host, t0, t1)


def clipped(trace: Trace, pattern: str | None = None) -> list:
    """(name, start_ns, end_ns) of the device events clipped to the
    window, of those whose name matches ``pattern`` (a regular
    expression; every event when None)."""
    rx = re.compile(pattern) if pattern else None
    out = []
    for name, s, e in trace.device:
        if rx is not None and not rx.search(name):
            continue
        s, e = max(s, trace.t0_ns), min(e, trace.t1_ns)
        if e > s:
            out.append((name, s, e))
    return out


def intervals(trace: Trace, pattern: str | None = None) -> list:
    return [(s, e) for _, s, e in clipped(trace, pattern)]


def total_ns(trace: Trace, pattern: str) -> int:
    """Summed device time of the matching events (overlaps counted twice,
    as a kernel's own time)."""
    return sum(e - s for s, e in intervals(trace, pattern))


def merged(spans: list) -> list:
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_ns(trace: Trace) -> int:
    """Length of the union of every device interval in the window."""
    return sum(e - s for s, e in merged(intervals(trace)))


def idle_gaps(trace: Trace) -> list:
    """(start_ns, end_ns) of each stretch of the window with nothing on
    the device."""
    gaps, t = [], trace.t0_ns
    for s, e in merged(intervals(trace)):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if trace.t1_ns > t:
        gaps.append((t, trace.t1_ns))
    return gaps


def gap_labels(trace: Trace, gaps: list) -> list:
    """For each gap, the host event running at its midpoint that started
    last (the innermost of nested events), by one sweep over both sorted
    by time; "host, between CUDA calls" where none runs."""
    events = sorted(trace.host, key=lambda h: h[1])
    order = sorted(range(len(gaps)), key=lambda i: gaps[i][0] + gaps[i][1])
    labels = [""] * len(gaps)
    active, k = [], 0  # max-heap of (-start, end, name)
    for i in order:
        t = (gaps[i][0] + gaps[i][1]) // 2
        while k < len(events) and events[k][1] <= t:
            heapq.heappush(active, (-events[k][1], events[k][2], events[k][0]))
            k += 1
        while active and active[0][1] < t:
            heapq.heappop(active)
        labels[i] = active[0][2] if active else "host, between CUDA calls"
    return labels


def breakdown(trace: Trace, top: int = 10, name_chars: int = 160) -> dict:
    """The device operations that took most time, and the idle time of
    the device summed by what the host was doing in each gap, each list
    the ``top`` largest, in seconds; names cut to ``name_chars``."""
    by_op = defaultdict(int)
    for name, s, e in clipped(trace):
        by_op[name] += e - s
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps = idle_gaps(trace)
    by_host = defaultdict(int)
    for (s, e), label in zip(gaps, gap_labels(trace, gaps)):
        by_host[label] += e - s
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[name[:name_chars], ns / 1e9] for name, ns in ops],
            "idle_gaps": [[name[:name_chars], ns / 1e9] for name, ns in idle]}
