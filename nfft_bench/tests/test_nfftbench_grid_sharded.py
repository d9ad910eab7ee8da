"""The four-card cell ``grid3d-n26.pair-c1x4`` on the CPU: its harness code
(``nfftb/ranks.py``, ``systems/grid_sharded.py``,
``references/dirichlet_pair_host.py``, ``metrics/slab_tile_roofline.py``)
run through ``core.run`` on a gloo world of 4 processes at a size a CPU
test holds, with the cell's own traffic and limits.

- the cell's run is correct, and every spawned rank ends with exit code 0;
- each planted fault of ``nfftb/faults.py`` comes out not correct, and so
  does the exchange between the ranks left out on rank 0: the halo's ring
  shift (what rank 0 receives dropped) or the half-spectrum all-reduce
  (rank 0 keeps its own partial), the transfers themselves still made so
  that the other ranks do not wait;
- a rank killed in the window ends the harness with exit code 1, no result
  line, and no rank process left;
- ``slab_bytes`` against a count by hand.
"""

import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import nfftbench_helpers as h
from nfftb import faults, spec

WORKLOAD = "grid3d-n26.pair-c1x4"
# M = 64 on 4 slabs of one 16-cell tile row each (T = 16, E = 9): every
# slab spills into the next, so each exchange carries much of the grid
TINY_GRID = {"n_log2": 12, "bandwidth": 32}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    root, bench_dir, benchmark = h.tiny_bench(tmp_path_factory.mktemp("grid"))
    path = bench_dir / "configs" / "grid3d-n26.json"
    cfg = json.loads(path.read_text())
    cfg.update(TINY_GRID)
    path.write_text(json.dumps(cfg))
    return root, bench_dir, spec.load_benchmark(root)


def _run(bench, wrap=None):
    _, bench_dir, benchmark = bench
    seen = []

    def keep(system):
        seen.append(system)
        return system if wrap is None else wrap(system)

    res = h.run_cpu(benchmark, bench_dir, WORKLOAD, wrap=keep)
    return res, seen[0].ranks.procs


def test_the_cell_is_correct_and_its_ranks_end_cleanly(bench):
    res, procs = _run(bench)
    assert res["correct"] and res["failed"] == 0 and res["calls"] >= 1, res["checks"]
    assert len(procs) == 3
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]


@pytest.mark.parametrize("kind", faults.KINDS)
def test_a_planted_fault_is_not_correct(bench, kind):
    res, procs = _run(bench, lambda s: faults.Faulty(s, kind))
    assert not res["correct"] and res["failed"] >= 1, res["checks"]
    assert all(p.exitcode == 0 for p in procs)


def _grid_module():
    return importlib.import_module(h.program().__name__ + ".parallel.grid_sharded")


def _halo_dropped(real):
    def ring_shift(t, group, shift=1):
        return torch.zeros_like(real(t, group, shift))
    return ring_shift


def _own_partial(real):
    def reduce(t, group):
        real(t, group)
        return t
    return reduce


@pytest.mark.parametrize("name,fault", [("ring_shift", _halo_dropped),
                                        ("reduce", _own_partial)])
def test_the_exchange_left_out_is_not_correct(bench, monkeypatch, name, fault):
    gs = _grid_module()

    def plant(system):
        monkeypatch.setattr(gs, name, fault(getattr(gs, name)))
        return system

    res, procs = _run(bench, plant)
    monkeypatch.undo()
    assert not res["correct"] and res["failed"] == res["calls"], res["checks"]
    assert res["checks"]["y_rel_l2"]["value"] > 100 * res["checks"]["y_rel_l2"]["limit"]
    assert all(p.exitcode == 0 for p in procs)


KILL = r"""
import sys, time
from pathlib import Path
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
from nfftb import core, guard, spec
root, bench_dir = Path(sys.argv[3]), Path(sys.argv[3]) / "nfft_bench"
cell = spec.cell(spec.load_benchmark(root), sys.argv[4], bench_dir)

class KillsRankOne:
    def __init__(self, system):
        self.system, self.plan_s, self.n = system, system.plan_s, 0
        print("pids", *[p.pid for p in system.ranks.procs], flush=True)
    def call(self, values):
        self.n += 1
        if self.n == 4:  # the second call of the window
            self.system.ranks.procs[0].kill()
            time.sleep(30)
        return self.system.call(values)
    def spans(self):
        return {}
    def close(self):
        self.system.close()

core.run(cell, guard.import_program(Path(sys.argv[2])), seed=5, seconds=60.0, traced=False,
         device=torch.device("cpu"), t_start=time.perf_counter(), bench_dir=bench_dir,
         wrap=KillsRankOne)
print("RESULT", flush=True)
"""


def _running(pid: int) -> bool:
    try:
        state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0]
    except (FileNotFoundError, ProcessLookupError):
        return False
    return state != "Z"


def test_a_rank_killed_in_the_window_ends_the_run(bench):
    root, _, _ = bench
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", KILL, str(h.BENCH), str(h.ROOT), str(root),
                           WORKLOAD], capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONUNBUFFERED="1"))
    assert proc.returncode == 1, (proc.returncode, proc.stdout[-2000:], proc.stderr[-4000:])
    assert "RESULT" not in proc.stdout
    assert "rank 1 ended with exit code -9" in proc.stderr, proc.stderr[-4000:]
    assert time.monotonic() - t0 < 120  # the watcher, not the 60 s window or a timeout
    pids = [int(p) for p in proc.stdout.split("pids", 1)[1].split("\n", 1)[0].split()]
    deadline = time.monotonic() + 10
    while any(_running(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.2)
    assert not any(_running(p) for p in pids), pids


def test_slab_bytes_by_hand():
    reader = spec.module(spec.BENCH_DIR, "metrics", "slab_tile_roofline")
    cfg = spec.data_file(spec.BENCH_DIR, "configs", "grid3d-n26")
    # M = 2048, T = 16, H = 25, L0 = 512: 32 x 128 x 128 tiles of 25^3
    # cells, and 512 + 9 rows of 2048 x 2048 cells, 4 bytes each
    assert reader.slab_bytes(cfg, 1) == 4 * (32 * 128 * 128 * 15625 + 521 * 2048 * 2048) \
        == 41_508_929_536
    # 2D, M = 64 on 2 slabs, two columns: 2 x 4 tiles of 25^2 cells, 41 x 64 rows
    small = {"dim": 2, "tile": 16, "cutoff": 4, "oversampling": 2.0, "bandwidth": 32,
             "shards": 2}
    assert reader.slab_bytes(small, 2) == 4 * 2 * (8 * 625 + 41 * 64) == 60_992
