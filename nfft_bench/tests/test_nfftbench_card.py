"""On a machine with the card: one short run of every cell through the
command line, correct and with the contract's keys. Skipped without a
card (decided inside the test)."""

import json
import subprocess
import sys

import pytest
import torch

import nfftbench_helpers as h


@pytest.mark.cuda
@pytest.mark.parametrize("workload", h.CELLS)
def test_cell_runs_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "nfft_bench/run.py", "--workload", workload,
                          "--seed", str(h.SEED), "--seconds", "2", "--trace", "0"],
                         cwd=h.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
