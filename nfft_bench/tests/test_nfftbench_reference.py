"""The plain references against the port at a small size on the CPU,
through the harness's whole run (inputs, system, window, check)."""

import math

import pytest
import torch

import nfftbench_helpers as h
from nfftb import check


@pytest.mark.parametrize("workload", h.CELLS)
def test_port_agrees_with_the_reference(workload):
    _, bench_dir, bench = h.tiny_bench_cached()
    res = h.run_cpu(bench, bench_dir, workload)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    for name, c in res["checks"].items():
        # the port's error at this size: float32 rounding for the Gram,
        # the es m = 2 window for the pair (measured 7e-7, 5e-5, 1.4e-4)
        assert c["value"] <= c["limit"] and math.isfinite(c["value"]), name


@pytest.mark.parametrize("workload", ["pair3d-n24.pair-c1", "gram3d-n22.matvec-c1"])
def test_traced_cpu_run_reads_no_device_metric(workload):
    _, bench_dir, bench = h.tiny_bench_cached()
    res = h.run_cpu(bench, bench_dir, workload, traced=True)
    assert res["correct"]
    assert set(res["metrics"]) == {"plan_s"}  # no device trace on the CPU
    assert res["busy_s"] == 0.0


def test_tf32_rounding():
    one = 1.0
    ulp = 2.0**-10  # TF32 keeps 10 explicit mantissa bits
    x = torch.tensor([one + ulp / 2, one + 1.5 * ulp, -(one + 1.5 * ulp), one + ulp / 4,
                      3.0, 0.0, -2.5e-3])
    got = check.tf32(x).tolist()
    assert got[0] == one  # a tie rounds to even
    assert got[1] == one + 2 * ulp and got[2] == -(one + 2 * ulp)
    assert got[3] == one and got[4] == 3.0 and got[5] == 0.0
    assert abs(got[6] / -2.5e-3 - 1) <= 2.0**-11


def test_rel_l2_of_a_non_finite_answer_is_infinite():
    assert check.rel_l2(torch.tensor([float("nan")]), torch.tensor([1.0])) == math.inf
