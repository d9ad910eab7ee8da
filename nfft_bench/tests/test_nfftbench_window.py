"""The closed loop and the arithmetic of points_per_s and call_ms_p95."""

import pytest
import torch

import nfftbench_helpers  # noqa: F401  (import paths)
from nfftb import trace, window


def test_one_stall_moves_the_tail_and_the_rate():
    steady = [0.010] * 10
    stalled = [0.010] * 9 + [0.500]
    assert window.percentile_ms(steady, 95) == pytest.approx(10.0)
    assert window.percentile_ms(stalled, 95) == pytest.approx(10.0 + 0.55 * 490.0)
    n = 1000
    assert window.rate(10, n, sum(steady)) == pytest.approx(10 * n / 0.1)
    assert window.rate(10, n, sum(stalled)) == pytest.approx(10 * n / 0.59)


def test_drive_runs_every_call_and_keeps_the_rows():
    pool = [{"x": torch.full((8, 1), float(k))} for k in range(3)]
    rows = torch.tensor([1, 5])
    win = window.drive(lambda v: {"y": 2 * v["x"]}, pool, rows, 0.05, lambda: None)
    assert win.calls >= 1 and len(win.kept) == win.calls == len(win.times_s)
    assert win.pool_index[:3] == [0, 1, 2][:win.calls]
    for out, k in zip(win.kept, win.pool_index):
        assert out["y"].shape == (2, 1) and torch.all(out["y"] == 2 * k)
    assert win.window_s >= sum(win.times_s)


def test_idle_gaps_and_busy_time():
    tr = trace.Trace(device=[("a", 10, 30), ("b", 20, 40), ("c", 60, 70)], host=[
        ("cudaDeviceSynchronize", 40, 60), ("outer", 0, 100)], t0_ns=0, t1_ns=100)
    assert trace.busy_ns(tr) == 40
    assert trace.idle_gaps(tr) == [(0, 10), (40, 60), (70, 100)]
    bd = trace.breakdown(tr)
    assert bd["device_ops"] == [["a", 20e-9], ["b", 20e-9], ["c", 10e-9]]
    assert bd["idle_gaps"] == [["outer", 40e-9], ["cudaDeviceSynchronize", 20e-9]]
