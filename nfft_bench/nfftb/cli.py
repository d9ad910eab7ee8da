"""``python3 nfft_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``: run one cell on this machine's card and print its
result as the last line of standard output.

Exits 2, printing no result, when there is no CUDA card, fewer cards
than the cell asks for, or no port in the checkout; exits 3 when a JAX
module was loaded. The numbers that decided ``correct`` are the last
lines of standard error and the last key of the result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

from . import guard, spec


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="nfft_bench/run.py", description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_dirs(root: Path) -> None:
    """Kernel and compiler caches at fixed paths inside the checkout, so
    that only the first run there builds. The port keeps its own build
    under ``torch_nfft_tpu_torch/_build/``."""
    base = root / ".nfft_bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)


def device_info(torch, count: int, res: dict) -> dict:
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": res["memory_peak_bytes"]}
    if "busy_s" in res:
        info["busy_s"] = res["busy_s"]
        info["window_s"] = res["window_s"]
    return info


def result_line(res: dict, device: dict) -> dict:
    """The printed result: the contract's keys, ``checks`` last."""
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": res["metrics"], "device": device}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    return line


def check_lines(checks: dict) -> list:
    return [f"check {name}: {c['value']!r} limit {c['limit']!r}" for name, c in checks.items()]


def main(argv, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    root = spec.checkout_root()
    try:
        bench = spec.load_benchmark(root)
        cell = spec.cell(bench, args.workload)
    except (OSError, KeyError, ValueError) as exc:
        print(f"nfft_bench: {exc}", file=sys.stderr)
        return 2
    cache_dirs(root)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"nfft_bench: {args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        program = guard.import_program(root)
    except ImportError as exc:
        print(f"nfft_bench: the port is not in this checkout: {exc}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from . import core

    res = core.run(cell, program, seed=args.seed, seconds=args.seconds,
                   traced=bool(args.trace), device=torch.device("cuda", 0), t_start=t_start)
    bad = guard.banned_modules()
    if bad:
        print(f"nfft_bench: JAX modules were loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(f"nfft_bench: {args.workload} seed {args.seed}: {res['calls']} calls in "
          f"{res['window_s']!r} s; reference {res['reference_s']:.3f} s", file=sys.stderr)
    print(json.dumps(result_line(res, device_info(torch, cell.chips, res))), flush=True)
    for line in check_lines(res["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0
