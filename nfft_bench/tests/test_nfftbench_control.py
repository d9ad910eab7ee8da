"""The control and the planted faults come out not correct.

The control is the plain reference computed one precision below the
configuration's float32, TF32 (the contractions' operands rounded to
TF32), put in the program's place; the faults are planted under the
window (``nfftb/faults.py``). Both at the CPU sizes of
``nfftbench_helpers.TINY``, against each cell's own limits."""

import pytest
import torch

import nfftbench_helpers as h
from nfftb import check, faults, generate, spec


@pytest.mark.parametrize("workload", h.CELLS)
def test_the_tf32_control_fails_a_limit(workload):
    _, bench_dir, bench = h.tiny_bench_cached()
    cell = spec.cell(bench, workload, bench_dir)
    ref = spec.module(bench_dir, "references", cell.config["reference"])
    for seed in (h.SEED, h.SEED + 1, h.SEED + 2):
        inputs = generate.make_inputs(cell.config, cell.traffic, seed, torch.device("cpu"))
        args = (cell.config, cell.traffic, inputs.points, inputs.rows_t, inputs.pool)
        exact, low = ref.outputs(*args), ref.outputs(*args, precision="tf32")
        worst, failed = check.compare(low, list(range(len(low))), exact, cell.limits)
        assert failed == len(low), worst  # every control answer fails a limit


@pytest.mark.parametrize("kind", faults.KINDS)
@pytest.mark.parametrize("workload", h.CELLS)
def test_a_planted_fault_is_not_correct(workload, kind):
    _, bench_dir, bench = h.tiny_bench_cached()
    res = h.run_cpu(bench, bench_dir, workload, wrap=lambda s: faults.Faulty(s, kind))
    assert not res["correct"] and res["failed"] >= 1, res["checks"]
