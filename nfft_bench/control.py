"""Readings that set the limits of ``correct``, on the card, in one
process:

    python3 nfft_bench/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 101,102,103 [--fault-seeds 201,202,203] [--seconds 3]

- the program: one run of the cell per seed (a window of ``--seconds``),
  each number's worst reading over the window's calls;
- the control: the plain reference computed as the next precision below
  the configuration's float32 (TF32: the contractions' operands rounded
  to TF32) put in the program's place, at the same inputs and rows;
- the faults of :mod:`nfftb.faults`, planted under the window.

Prints one line per reading and, last, a JSON summary: per number the
largest program reading (the lower end), the smallest control reading
and each fault's smallest reading. The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from nfftb import check, cli, core, faults, generate, guard, spec  # noqa: E402


def seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def control_readings(cell, seed: int, device) -> dict:
    inputs = generate.make_inputs(cell.config, cell.traffic, seed, device)
    ref = spec.module(spec.BENCH_DIR, "references", cell.config["reference"])
    exact = ref.outputs(cell.config, cell.traffic, inputs.points, inputs.rows_t, inputs.pool)
    low = ref.outputs(cell.config, cell.traffic, inputs.points, inputs.rows_t, inputs.pool,
                      precision="tf32")
    return check.compare(low, list(range(len(low))), exact, cell.limits)[0]


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, required=True)
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--fault-seeds", type=seeds, default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    root = spec.checkout_root()
    cli.cache_dirs(root)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    program = guard.import_program(root)
    cell = spec.cell(spec.load_benchmark(root), args.workload)
    dev = torch.device("cuda", 0)
    summary = {"workload": args.workload, "program": {}, "control": {}, "faults": {}}
    for seed in args.seeds:
        res = core.run(cell, program, seed=seed, seconds=args.seconds, traced=False,
                       device=dev, t_start=time.perf_counter())
        vals = {k: c["value"] for k, c in res["checks"].items()}
        summary["program"][seed] = vals
        print(f"program seed {seed}: calls {res['calls']} correct {res['correct']} {vals}",
              flush=True)
    for seed in args.control_seeds:
        vals = control_readings(cell, seed, dev)
        summary["control"][seed] = vals
        print(f"control seed {seed}: {vals}", flush=True)
    for kind in faults.KINDS if args.fault_seeds else ():
        for seed in args.fault_seeds:
            res = core.run(cell, program, seed=seed, seconds=args.seconds, traced=False,
                           device=dev, t_start=time.perf_counter(),
                           wrap=lambda s, k=kind: faults.Faulty(s, k))
            vals = {k: c["value"] for k, c in res["checks"].items()}
            summary["faults"].setdefault(kind, {})[seed] = vals
            print(f"fault {kind} seed {seed}: correct {res['correct']} {vals}", flush=True)
    names = list(cell.limits)
    summary["lower"] = {n: max(v[n] for v in summary["program"].values()) for n in names}
    if summary["control"]:
        summary["control_min"] = {n: min(v[n] for v in summary["control"].values())
                                  for n in names}
    summary["fault_min"] = {kind: {n: min(v[n] for v in by.values()) for n in names}
                            for kind, by in summary["faults"].items()}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
