"""Read one cell's window stage by stage, with the program's span recorder
on:

    python3 nfft_bench/stages.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout. The cell runs as a traced run of
``run.py`` does (inputs, system, warm-up, one window under
``torch.profiler`` with CUDA activity alone), except that the program's
recorder (``torch_nfft_tpu_torch.trace``) is on from before set-up to
the end of the window, and no reference runs. Prints one JSON line: every
per-layer metric of the cell in ``BENCHMARK.json``, and the layer metrics
read from the spans (``LAYERS``: ``metrics/<name>.py``, ``nfftb/spans.py``);
the share of device time tied to its launching host call and the device
operations launched outside every span; and the breakdown by span,
idle gaps labelled by stage, and launches per call.

The benchmark's own runs (``run.py``) leave the recorder off; a traced
``run.py`` run of the same cell is this one with the recorder off, so the
two compare the recorder's cost. Exits 2 where there is no card or the
program has no recorder.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402

from nfftb import cli, core, generate, guard, spans, spec, trace, window  # noqa: E402

LAYERS = ("tile_move_ms", "permute_ms", "host_overhead_ms", "autograd_ms", "plan_build_s")


def run(cell, program, *, seed: int, seconds: float, device, t_start: float,
        bench_dir: Path = spec.BENCH_DIR) -> dict:
    rec = spans.recorder(program)
    if rec is None:
        raise LookupError(f"{program.__name__} has no span recorder")
    rec.drain()
    rec.enable()
    try:
        inputs = generate.make_inputs(cell.config, cell.traffic, seed, device)
        system = spec.module(bench_dir, "systems", cell.config["system"]).build(
            program, cell.config, cell.traffic, inputs, device, record=True)
        for i in range(int(cell.traffic.get("warmup", 2))):
            out = system.call(inputs.pool[i % len(inputs.pool)])
            core.sync(device)
            del out
        system.spans()
        core.sync(device)
        setup_s = time.perf_counter() - t_start
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        act = torch.profiler.ProfilerActivity
        before = rec.counters()
        start_ns = time.time_ns()
        with torch.profiler.profile(
                activities=[act.CUDA if torch.device(device).type == "cuda" else act.CPU]) as prof:
            win = window.drive(system.call, inputs.pool, inputs.rows_t, seconds,
                               lambda: core.sync(device))
        after = rec.counters()
    finally:
        rec.disable()
    recorded = rec.drain()
    tr = trace.read_profile(prof)
    events = spans.read_events(prof)
    del prof
    launches = {k: after[k] - before.get(k, 0) for k in after}
    att = spans.attribute(recorded, events, tr, start_ns, win.calls, launches)
    ctx = core.Context(cell, inputs, win, setup_s, system.plan_s, core.peak_bytes(device),
                       system.spans(), tr,
                       spec.module(bench_dir, "references", cell.config["reference"]))
    ctx.program = att
    system.close()
    names = [m["name"] for m in cell.per_layer] + list(LAYERS)
    metrics = {}
    for name in names:
        val = spec.module(bench_dir, "metrics", name).read(ctx)
        if val is not None:
            metrics[name] = float(val)
    bd = trace.breakdown(tr)
    bd.update(spans.breakdown(att))
    outside = sorted(att.outside_ops.items(), key=lambda kv: -kv[1])[:5]
    return {
        "workload": cell.name, "calls": win.calls, "window_s": win.window_s,
        "setup_s": setup_s, "metrics": metrics,
        "matched_pct": 100.0 * att.matched_ns / att.device_ns if att.device_ns else None,
        "outside_pct": (100.0 * att.self_ns.get(spans.OUTSIDE, 0) / att.device_ns
                        if att.device_ns else None),
        "outside_ops": [[name[:120], ns / 1e9] for name, ns in outside],
        "spans_recorded": len(recorded),
        "breakdown": bd,
    }


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="nfft_bench/stages.py", description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    root = spec.checkout_root()
    cell = spec.cell(spec.load_benchmark(root), args.workload)
    cli.cache_dirs(root)
    if not torch.cuda.is_available():
        print("nfft_bench: stages.py needs a CUDA card", file=sys.stderr)
        return 2
    program = guard.import_program(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        res = run(cell, program, seed=args.seed, seconds=args.seconds,
                  device=torch.device("cuda", 0), t_start=T_START)
    except LookupError as exc:
        print(f"nfft_bench: {exc}", file=sys.stderr)
        return 2
    res["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
