"""The result line's keys, the check lines, and the refusals."""

import json
import subprocess
import sys

import pytest

import nfftbench_helpers as h
from nfftb import cli


def _res(traced):
    res = {"correct": True, "attempted": 3, "failed": 0,
           "metrics": {"points_per_s": {"value": 1.5, "unit": "points/s"}},
           "memory_peak_bytes": 123, "checks": {"y_rel_l2": {"value": 1e-6, "limit": 3e-5}}}
    if traced:
        res.update(busy_s=0.9,
                   breakdown={"device_ops": [["k", 0.5]], "idle_gaps": [["sync", 0.1]]})
    return res


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(traced):
    res = _res(traced)
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
              "memory_peak_bytes": 123}
    if traced:
        device.update(busy_s=0.9, window_s=1.0)
    line = cli.result_line(res, device)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if traced else []) + ["checks"]
    assert json.loads(json.dumps(line)) == line
    assert cli.check_lines(res["checks"]) == ["check y_rel_l2: 1e-06 limit 3e-05"]


def test_a_cpu_run_has_every_field():
    _, bench_dir, bench = h.tiny_bench_cached()
    res = h.run_cpu(bench, bench_dir, "pair3d-n24.pair-c1")
    assert res["attempted"] == res["calls"] >= 1 and res["failed"] == 0
    assert list(res["checks"]) == ["y_rel_l2"]
    assert res["checks"]["y_rel_l2"]["limit"] == 1.6e-4


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "nfft_bench/run.py", "--workload",
                          "pair3d-n24.pair-c1", "--seed", "1", "--seconds", "1"],
                         cwd=h.ROOT, capture_output=True, text=True, timeout=120)
    if "needs 1 CUDA card" not in out.stderr:
        pytest.skip("this machine has a card")
    assert out.returncode != 0 and out.stdout == ""


def test_unknown_workload_no_result():
    out = subprocess.run([sys.executable, "nfft_bench/run.py", "--workload", "nope",
                          "--seed", "1", "--seconds", "1"],
                         cwd=h.ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
