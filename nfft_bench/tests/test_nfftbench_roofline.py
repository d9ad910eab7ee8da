"""The roofline count from shapes and points, against hand counts."""

import pytest
import torch

import nfftbench_helpers  # noqa: F401  (import paths)
from nfftb import roofline, trace
from nfftb.core import Context


def test_covered_cells_by_hand():
    # M = 16, m = 1 (L = 4): a point at index i covers i-1 .. i+2, mod 16
    pts = torch.tensor([[0.0], [-0.5], [0.01]])  # indices 8, 0, 8
    assert roofline.covered_cells(pts, 16, 1) == 8  # {7..10} and {15, 0, 1, 2}
    pts = torch.cat([pts, torch.tensor([[0.1]])])  # index 9 adds cell 11
    assert roofline.covered_cells(pts, 16, 1) == 9


def test_covered_cells_2d_overlap():
    # two points one cell apart on each axis: 4x4 boxes overlapping in 3x3
    pts = torch.tensor([[0.0, 0.0], [1 / 16, 1 / 16]])
    assert roofline.covered_cells(pts, 16, 1) == 2 * 16 - 9


def test_work_and_least_time_by_hand():
    # n = 2 points, dim 1, C = 1, L = 4, 8 covered cells
    flops, nbytes = roofline.work("spread", 2, 1, 1, 4, 8)
    assert flops == 2 * (1 * 4 * 8 + 2 * 1 * 4) == 80
    assert nbytes == 4 * (2 + 2 + 8) == 48
    assert roofline.work("gather", 2, 1, 1, 4, 8) == (80, 48)
    flops, nbytes = roofline.work("pos_grad", 2, 1, 1, 4, 8)
    assert flops == 2 * (1 * 4 * 12 + 4 * 1 * 4) and nbytes == 4 * (8 + 2 + 2 + 2)
    t, by = roofline.least_s(80, 48)
    assert by == "bytes" and t == pytest.approx(48 / 3.35e12)
    t, by = roofline.least_s(67e12, 1.0)
    assert by == "operations" and t == pytest.approx(1.0)


class _Win:
    calls = 2


class _Cell:
    config = {"dim": 1, "cutoff": 1, "oversampling": 2.0, "bandwidth": 8}
    traffic = {"columns": 1, "work": {"spread": 1, "gather": 1, "pos_grad": 2}}


class _Inputs:
    points = torch.tensor([[0.0], [-0.5]])
    n = 2_000_000


def _ctx(device_events):
    tr = trace.Trace(device=device_events, host=[], t0_ns=0, t1_ns=10**9)
    ctx = Context(_Cell(), _Inputs(), _Win(), 1.0, None, 0, {}, tr, None)
    ctx.__dict__["covered_cells"] = 8_000_000
    return ctx


def test_roofline_share_from_trace():
    n, covered = _Inputs.n, 8_000_000
    least = roofline.least_s(*roofline.work("gather", n, 1, 1, 4, covered))[0]
    least += 2 * roofline.least_s(*roofline.work("pos_grad", n, 1, 1, 4, covered))[0]
    total = 2 * least * 2  # two calls; the kernels took twice the least time
    ns = round(total * 1e9)
    ctx = _ctx([("void tnt::points::points_kernel<4, 1, true, false>(Args)", 0, ns),
                ("void spread_contract_kernel<false>()", ns, ns + 5)])
    pct = ctx.roofline_pct(("gather", "pos_grad"), r"\bpoints_kernel\b")
    assert pct == pytest.approx(50.0, rel=1e-3)
    assert ctx.roofline_pct(("gather",), r"\bno_such_kernel\b") is None
    assert _ctx([]).roofline_pct(("spread",), r"\bspread_kernel\b") is None
