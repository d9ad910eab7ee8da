"""Shared set-up of the benchmark's CPU tests: import paths, and a copy
of the benchmark with its configurations cut to sizes a CPU test holds.

Run the tests from the root of the repository:
``python -m pytest nfft_bench/tests -q``.
"""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for _p in (str(BENCH), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from nfftb import core, guard, spec  # noqa: E402

# every cell keeps its name, traffic and limits; only the sizes shrink
TINY = {
    "gram3d-n22": {"n_log2": 12, "bandwidth": 32, "kernel_sigma": 0.5},
    "pair3d-n24": {"n_log2": 10, "bandwidth": 16},
}
CELLS = ("gram3d-n22.matvec-c1", "pair3d-n24.step-c1", "gram3d-n22.matvec-c8",
         "pair3d-n24.pair-c1")
SEED = 2**31 + 12345


def tiny_bench(dest: Path) -> tuple:
    """(root, bench_dir, benchmark) of a copy under ``dest`` at the TINY
    sizes."""
    bench_dir = dest / "nfft_bench"
    shutil.copytree(BENCH, bench_dir, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for name, sizes in TINY.items():
        path = bench_dir / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg.update(sizes)
        path.write_text(json.dumps(cfg))
    return dest, bench_dir, spec.load_benchmark(dest)


_CACHED = {}


def tiny_bench_cached() -> tuple:
    """One tiny copy per test process, in a temporary directory."""
    if "bench" not in _CACHED:
        import tempfile
        _CACHED["dir"] = tempfile.TemporaryDirectory(prefix="nfftbench_")
        _CACHED["bench"] = tiny_bench(Path(_CACHED["dir"].name))
    return _CACHED["bench"]


def program():
    return guard.import_program(ROOT)


def run_cpu(bench: dict, bench_dir: Path, workload: str, *, seconds: float = 0.2,
            traced: bool = False, wrap=None, seed: int = SEED) -> dict:
    cell = spec.cell(bench, workload, bench_dir)
    return core.run(cell, program(), seed=seed, seconds=seconds, traced=traced,
                    device=torch.device("cpu"), t_start=time.perf_counter(),
                    bench_dir=bench_dir, wrap=wrap)
