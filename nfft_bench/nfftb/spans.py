"""A traced window stage by stage, from the program's own spans.

The program records spans at its stage boundaries while its recorder is
on (``torch_nfft_tpu_torch.trace``: ``enable``, ``drain``, ``counters``;
each span a (name, start_ns, end_ns, thread, id, parent, root) tuple on
``time.time_ns()``'s clock, the profiler's, ``thread`` the recording
thread's ``threading.get_ident()``). Here:

- each device operation of the window goes to the innermost program span
  open, on the launching thread, at the start of the host call that CUPTI
  correlates with it (the runtime event of the same correlation id); an
  operation launched with no span open goes to "outside the program";
- device time is summed by span name, both where the span is the
  innermost and wherever it is an ancestor;
- each span's host self time is its duration less what its child spans
  cover;
- each idle gap of the device is labelled by the innermost span open (on
  any thread) at its midpoint, where no CUDA runtime call is open there.

Nothing here imports the program: :func:`recorder` finds its recorder,
or None for a program without one, and every reader then returns None.
"""

from __future__ import annotations

import heapq
import importlib
from collections import defaultdict
from dataclasses import dataclass, field

from . import trace

OUTSIDE = "outside the program"
BETWEEN = "host, between CUDA calls"
PLAN_BUILDERS = ("build_plan", "build_plan_device")


def recorder(program):
    """The program's span recorder module, or None where it has none."""
    try:
        mod = importlib.import_module(program.__name__ + ".trace")
    except ImportError:
        return None
    need = ("enable", "disable", "drain", "counters")
    return mod if all(hasattr(mod, n) for n in need) else None


@dataclass
class Events:
    """The profiler's events with what ties them together."""

    device: list  # (name, start_ns, end_ns, correlation id) of the device's activity
    runtime: list  # (name, start_ns, end_ns, correlation id, thread) of host calls


def read_events(prof) -> Events:
    """Device activity and host runtime calls of a finished
    ``torch.profiler.profile``, with their correlation ids; the host
    call's thread is its ``device_resource_id`` (for a CUDA runtime call
    the calling thread's pthread id cut to a signed 32-bit integer)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, runtime = [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == cuda:
            if not ev.is_user_annotation():
                device.append((ev.name(), int(ev.start_ns()), int(ev.end_ns()),
                               int(ev.correlation_id())))
        else:
            runtime.append((ev.name(), int(ev.start_ns()), int(ev.end_ns()),
                            int(ev.correlation_id()), int(ev.device_resource_id())))
    return Events(device, runtime)


def int32(v: int) -> int:
    """``v`` cut to a signed 32-bit integer, as CUPTI's thread ids are."""
    return ((v & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


def innermost(intervals: list, times: list) -> list:
    """For each time, the key of the interval open there that started
    last (the innermost of nested intervals; of two that started together,
    the larger key, as a child's span id is larger than its parent's), or
    None: one sweep over (start, end, key) intervals and the times, both
    sorted."""
    ivs = sorted(intervals, key=lambda iv: (iv[0], iv[2]))
    order = sorted(range(len(times)), key=lambda i: times[i])
    out = [None] * len(times)
    active, k = [], 0  # max-heap of (-start, -rank, end, key)
    for i in order:
        t = times[i]
        while k < len(ivs) and ivs[k][0] <= t:
            heapq.heappush(active, (-ivs[k][0], -k, ivs[k][1], ivs[k][2]))
            k += 1
        while active and active[0][2] < t:
            heapq.heappop(active)
        out[i] = active[0][3] if active else None
    return out


@dataclass
class Attribution:
    """A window's device time, idle time and host time by program span."""

    calls: int
    window: list  # the program's spans that ended inside the window
    setup: list  # those that ended before it
    device_ns: int = 0  # device time of the window
    matched_ns: int = 0  # of it, tied to a host call by its correlation id
    self_ns: dict = field(default_factory=dict)  # span name -> device ns, innermost
    within_ns: dict = field(default_factory=dict)  # span name -> device ns, any ancestor
    outside_ops: dict = field(default_factory=dict)  # device op -> ns outside every span
    host_self_ns: dict = field(default_factory=dict)  # span name -> host self ns
    idle_ns: dict = field(default_factory=dict)  # gap label -> ns
    idle_in_spans_ns: int = 0  # idle time whose gap's midpoint lies in a span
    launches: dict = field(default_factory=dict)  # counter -> count over the window

    def device_ms_within(self, names) -> float | None:
        """Device ms per call of operations launched inside a span of one
        of ``names`` (at any depth); None when the window had no device
        activity or no such span ran."""
        if self.calls <= 0 or self.device_ns <= 0 or not any(
                s[0] in names for s in self.window):
            return None
        ns = 0
        for name in names:
            ns += self.within_ns.get(name, 0)
        return ns / 1e6 / self.calls


def _chains(spans: list) -> dict:
    """span id -> the distinct names of the span and its ancestors."""
    by_id = {s[4]: s for s in spans}
    out = {}
    for s in spans:
        names, p = [], s
        while p is not None:
            if p[0] not in names:
                names.append(p[0])
            p = by_id.get(p[5]) if p[5] is not None else None
        out[s[4]] = names
    return out


def host_self_ns(spans: list) -> dict:
    """Span name -> summed duration less what each span's children cover."""
    child = defaultdict(int)
    for s in spans:
        if s[5] is not None:
            child[s[5]] += s[2] - s[1]
    out = defaultdict(int)
    for s in spans:
        out[s[0]] += max(0, s[2] - s[1] - child[s[4]])
    return dict(out)


def attribute(spans: list, events: Events, tr: trace.Trace, window_start_ns: int,
              calls: int, launches: dict | None = None) -> Attribution:
    """Put the window's device operations and idle gaps down to the
    program's spans. ``spans`` are what the recorder drained (set-up and
    window); ``tr`` is the window's trace (:func:`nfftb.trace.read_profile`),
    whose clipping and gaps this follows; ``window_start_ns`` is
    ``time.time_ns()`` as the window began."""
    spans = [tuple(s) for s in spans]
    setup = [s for s in spans if s[2] <= window_start_ns]
    win = [s for s in spans if s[2] > window_start_ns]
    att = Attribution(calls, win, setup, launches=dict(launches or {}))
    chains = _chains(win)
    names = {s[4]: s[0] for s in win}
    launch = {}
    for name, s, e, corr, thread in events.runtime:
        if corr > 0:
            launch[corr] = (s, thread)
    ops = []
    for name, s, e, corr in events.device:
        s, e = max(s, tr.t0_ns), min(e, tr.t1_ns)
        if e > s:
            ops.append((name, e - s, launch.get(corr)))
    att.device_ns = sum(d for _, d, _ in ops)
    by_thread = defaultdict(list)
    for s in win:
        by_thread[s[3]].append((s[1], s[2], s[4]))
    everywhere = [iv for ivs in by_thread.values() for iv in ivs]
    thread_of = {int32(t): t for t in by_thread}
    thread_of.update({t: t for t in by_thread})
    queries = defaultdict(list)  # thread (None: any) -> op indices
    for i, (_, _, at) in enumerate(ops):
        if at is not None:
            queries[thread_of.get(at[1])].append(i)
    span_of = [None] * len(ops)
    for thread, idx in queries.items():
        ivs = everywhere if thread is None else by_thread[thread]
        for i, sid in zip(idx, innermost(ivs, [ops[i][2][0] for i in idx])):
            span_of[i] = sid
    self_ns, within, outside = defaultdict(int), defaultdict(int), defaultdict(int)
    for (name, d, at), sid in zip(ops, span_of):
        if at is not None:
            att.matched_ns += d
        if sid is None:
            outside[name] += d
            self_ns[OUTSIDE] += d
            continue
        self_ns[names[sid]] += d
        for n in chains[sid]:
            within[n] += d
    att.self_ns, att.within_ns, att.outside_ops = dict(self_ns), dict(within), dict(outside)
    att.host_self_ns = host_self_ns(win)
    gaps = trace.idle_gaps(tr)
    labels = trace.gap_labels(tr, gaps)
    in_span = innermost(everywhere, [(a + b) // 2 for a, b in gaps])
    idle = defaultdict(int)
    for (a, b), label, sid in zip(gaps, labels, in_span):
        if sid is not None:
            att.idle_in_spans_ns += b - a
            if label == BETWEEN:
                label = names[sid]
        idle[label] += b - a
    att.idle_ns = dict(idle)
    return att


def plan_build_s(att: Attribution) -> float | None:
    """Host seconds of the outermost plan-builder spans of set-up."""
    ids = {s[4] for s in att.setup if s[0] in PLAN_BUILDERS}
    parents = {s[4]: s[5] for s in att.setup}
    total, found = 0, False
    for s in att.setup:
        if s[0] not in PLAN_BUILDERS:
            continue
        p, nested = s[5], False
        while p is not None:
            if p in ids:
                nested = True
                break
            p = parents.get(p)
        if not nested:
            total += s[2] - s[1]
            found = True
    return total / 1e9 if found else None


def breakdown(att: Attribution, top: int = 10) -> dict:
    """What a result's ``breakdown`` gains from the spans: ``spans``, the
    ``top`` span names by device time ([name, device s within it, host
    self s]); ``idle_gaps`` with the idle time the runtime calls leave
    unlabelled put down to the span open in the gap; ``launches``, the
    program's counters per call over the window."""
    names = set(att.within_ns) | set(att.host_self_ns)
    rows = sorted(([n, att.within_ns.get(n, 0) / 1e9, att.host_self_ns.get(n, 0) / 1e9]
                   for n in names), key=lambda r: (-r[1], -r[2]))[:top]
    idle = sorted(att.idle_ns.items(), key=lambda kv: -kv[1])[:top]
    calls = max(att.calls, 1)
    return {"spans": rows,
            "idle_gaps": [[label, ns / 1e9] for label, ns in idle],
            "launches": {k: v / calls for k, v in sorted(att.launches.items()) if v}}


def program_of(ctx) -> Attribution | None:
    """The attribution a reader may read from its context, or None."""
    return getattr(ctx, "program", None)
