"""One run of one cell: inputs from the seed, the system under test,
warm-up, the measured window, the check against the reference, the
metrics.

Set-up (``setup_s``) runs from the harness's start to the end of
warm-up: loading the port (its first use in a checkout builds the
kernels), making the inputs on the device, building the plan or
operator, and the calls that warm up this cell's shapes. The window
follows; after it the peak memory is read, the system is freed, and the
reference runs, outside every timed span.
"""

from __future__ import annotations

import functools
import gc
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import check, generate, roofline, spec, trace, window


@dataclass
class Context:
    """What a metric's reader may read (``metrics/<name>.py``:
    ``read(ctx)`` returns a number, or None where there is nothing to
    read)."""

    cell: spec.Cell
    inputs: generate.Inputs
    win: window.Window
    setup_s: float
    plan_s: float | None
    window_peak_bytes: int
    spans: dict = field(default_factory=dict)  # name -> per-call ms the system recorded
    trace: trace.Trace | None = None
    reference: object = None  # the config's reference module

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def columns(self) -> int:
        return int(self.cell.traffic["columns"])

    @property
    def points_per_call(self) -> int:
        return self.inputs.n * self.columns

    @functools.cached_property
    def covered_cells(self) -> int:
        cfg = self.config
        grid = self.reference.grid_points(cfg, self.inputs.points)
        return roofline.covered_cells(grid, round(cfg["oversampling"] * cfg["bandwidth"]),
                                      int(cfg["cutoff"]))

    def least_s(self, kind: str) -> tuple:
        """(least seconds of one ``kind`` of transform, what bounds it)."""
        cfg = self.config
        flops, nbytes = roofline.work(kind, self.inputs.n, self.columns, int(cfg["dim"]),
                                      2 * int(cfg["cutoff"]) + 2, self.covered_cells)
        return roofline.least_s(flops, nbytes)

    def roofline_pct(self, kinds: tuple, pattern: str):
        """Share (%) of the least time of the window's ``kinds`` of work
        (counted per call by the traffic's ``work``) in the device time
        of the kernels matching ``pattern``; None without a trace, work
        or matching kernel."""
        if self.trace is None:
            return None
        per_call = self.cell.traffic.get("work", {})
        least = sum(per_call.get(k, 0) * self.least_s(k)[0] for k in kinds) * self.win.calls
        device = trace.total_ns(self.trace, pattern) / 1e9
        if least <= 0 or device <= 0:
            return None
        return 100.0 * least / device


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0


def run(cell: spec.Cell, program, *, seed: int, seconds: float, traced: bool, device,
        t_start: float, bench_dir: Path = spec.BENCH_DIR, wrap=None) -> dict:
    """Run the cell once; returns the result's fields (see
    :func:`nfftb.cli.result_line`). ``wrap(system)`` plants a fault
    under the window (:mod:`nfftb.faults`)."""
    is_cuda = torch.device(device).type == "cuda"
    inputs = generate.make_inputs(cell.config, cell.traffic, seed, device)
    system = spec.module(bench_dir, "systems", cell.config["system"]).build(
        program, cell.config, cell.traffic, inputs, device, record=traced)
    if wrap is not None:
        system = wrap(system)
    for i in range(int(cell.traffic.get("warmup", 2))):
        out = system.call(inputs.pool[i % len(inputs.pool)])
        sync(device)
        kept = {name: t.detach().index_select(0, inputs.rows_t) for name, t in out.items()}
        del out, kept
    system.spans()  # drop the warm-up's spans
    sync(device)
    setup_s = time.perf_counter() - t_start
    setup_peak = peak_bytes(device)
    if is_cuda:
        torch.cuda.reset_peak_memory_stats(device)

    def measure():
        return window.drive(system.call, inputs.pool, inputs.rows_t, seconds,
                            lambda: sync(device))

    tr = None
    if traced:
        act = torch.profiler.ProfilerActivity
        with torch.profiler.profile(activities=[act.CUDA if is_cuda else act.CPU]) as prof:
            win = measure()
        tr = trace.read_profile(prof)
        del prof
    else:
        win = measure()
    window_peak = peak_bytes(device)
    spans = system.spans()
    plan_s = system.plan_s
    system.close()
    del system
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()

    reference = spec.module(bench_dir, "references", cell.config["reference"])
    ctx = Context(cell, inputs, win, setup_s, plan_s, window_peak, spans, tr, reference)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        val = spec.module(bench_dir, "metrics", m["name"]).read(ctx)
        if val is not None:
            metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
    t_ref = time.perf_counter()
    refs = reference.outputs(cell.config, cell.traffic, inputs.points, inputs.rows_t,
                             inputs.pool)
    sync(device)
    reference_s = time.perf_counter() - t_ref
    checks, failed = check.compare(win.kept, win.pool_index, refs, cell.limits)
    out = {
        "correct": failed == 0 and win.calls > 0,
        "attempted": win.calls,
        "failed": int(failed),
        "metrics": metrics,
        "memory_peak_bytes": int(max(setup_peak, window_peak)),
        "calls": win.calls,
        "window_s": win.window_s,
        "reference_s": reference_s,
        "checks": {k: {"value": v, "limit": cell.limits[k]} for k, v in checks.items()},
    }
    if tr is not None:
        out["busy_s"] = trace.busy_ns(tr) / 1e9
        out["breakdown"] = trace.breakdown(tr)
    return out
