"""Stage attribution from the program's spans (``nfftb/spans.py``) on a
synthetic trace, the five span readers, and ``stages.py`` on the CPU."""

import importlib.util
import time
import types

import pytest

import nfftbench_helpers as h
from nfftb import spans, spec, trace

READERS = ("tile_move_ms", "permute_ms", "host_overhead_ms", "autograd_ms", "plan_build_s")
MAIN, AUTOGRAD = 101, 202  # thread ids


def _span(name, s, e, sid, parent=None, root=None, thread=MAIN):
    return (name, s, e, thread, sid, parent, sid if root is None else root)


def _synthetic():
    """One call from 1000 to 2000 ns: an entry span with a fold and a
    slot_values stage, a backward on another thread, a plan built in
    set-up; device work launched in each, one op launched outside every
    span and one with no host call."""
    program = [
        _span("build_plan", 100, 400, 1),
        _span("nfft_pair_planar", 1000, 1600, 2),
        _span("slot_values", 1010, 1100, 3, 2, 2),
        _span("fold", 1200, 1500, 4, 2, 2),
        _span("backward", 1300, 1900, 5, thread=AUTOGRAD),
        _span("unfold", 1310, 1400, 6, 5, 5, thread=AUTOGRAD),
    ]
    runtime = [  # (name, start, end, correlation, thread)
        ("cudaLaunchKernel", 1020, 1030, 1, MAIN),    # in slot_values
        ("cudaLaunchKernel", 1250, 1260, 2, MAIN),    # in fold (backward's unfold overlaps)
        ("cudaLaunchKernel", 1320, 1330, 3, AUTOGRAD),  # in unfold, thread 2
        ("cudaLaunchKernel", 1650, 1660, 4, MAIN),    # in no span on its thread
        ("cudaDeviceSynchronize", 1700, 1790, 0, MAIN),
    ]
    device = [  # (name, start, end, correlation)
        ("scatter", 1040, 1090, 1),
        ("copy", 1270, 1370, 2),
        ("unfold_copy", 1370, 1420, 3),
        ("harness_select", 1670, 1680, 4),
        ("memset", 1680, 1690, 99),  # no host call of that id
    ]
    tr = trace.Trace(device=sorted([(n, s, e) for n, s, e, _ in device], key=lambda d: d[1]),
                     host=[(n, s, e) for n, s, e, _, _ in runtime], t0_ns=1040, t1_ns=1800)
    tr_device_end = trace.Trace(device=tr.device, host=tr.host, t0_ns=1040, t1_ns=1690)
    return program, spans.Events(device, runtime), tr_device_end


def test_attribution_on_a_synthetic_trace():
    program, events, tr = _synthetic()
    att = spans.attribute(program, events, tr, window_start_ns=900, calls=1,
                          launches={"gather_points": 2, "pos_grad": 0})
    assert [s[0] for s in att.setup] == ["build_plan"]
    assert att.device_ns == 50 + 100 + 50 + 10 + 10
    assert att.matched_ns == att.device_ns - 10  # the memset has no host call
    assert att.self_ns == {"slot_values": 50, "fold": 100, "unfold": 50,
                           spans.OUTSIDE: 20}
    assert att.within_ns == {"slot_values": 50, "fold": 100, "nfft_pair_planar": 150,
                             "unfold": 50, "backward": 50}
    assert att.outside_ops == {"harness_select": 10, "memset": 10}
    # host self time: the entry less its two stages, the backward less its unfold
    assert att.host_self_ns["nfft_pair_planar"] == 600 - 90 - 300
    assert att.host_self_ns["backward"] == 600 - 90
    assert att.device_ms_within(("fold", "unfold")) == pytest.approx(150 / 1e6)
    assert att.device_ms_within(("tiles to grid",)) is None
    assert spans.plan_build_s(att) == pytest.approx(300 / 1e9)


def test_idle_gaps_take_the_stage_where_no_runtime_call_is_open():
    program, events, tr = _synthetic()
    att = spans.attribute(program, events, tr, window_start_ns=900, calls=2)
    # gaps of the device between 1040 and 1690: (1090, 1270) midpoint 1180
    # in nfft_pair_planar's self time (no runtime call open); (1420, 1670)
    # midpoint 1545 inside the backward's span on the other thread
    assert trace.idle_gaps(tr) == [(1090, 1270), (1420, 1670)]
    assert att.idle_ns == {"nfft_pair_planar": 180, "backward": 250}
    assert att.idle_in_spans_ns == 430
    bd = spans.breakdown(att)
    assert bd["idle_gaps"] == [["backward", 250e-9], ["nfft_pair_planar", 180e-9]]
    assert bd["spans"][0] == ["nfft_pair_planar", 150e-9, 210e-9]
    # a gap with a runtime call open keeps the call's name
    tr2 = trace.Trace(device=[("a", 0, 10), ("b", 30, 40)],
                      host=[("cudaDeviceSynchronize", 12, 28)], t0_ns=0, t1_ns=40)
    att2 = spans.attribute([_span("fold", 0, 40, 1)], spans.Events([], []), tr2, -1, 1)
    assert att2.idle_ns == {"cudaDeviceSynchronize": 20}
    assert att2.idle_in_spans_ns == 20
    att3 = spans.attribute([], spans.Events([], []), tr2, -1, 1)
    assert att3.idle_ns == {"cudaDeviceSynchronize": 20} and att3.idle_in_spans_ns == 0


def test_a_launch_goes_to_its_own_threads_span():
    """The fold on the main thread opened before the backward's unfold on
    the autograd thread, and both are open at 1320; the op launched from
    the autograd thread at 1320 belongs to the unfold."""
    program, events, tr = _synthetic()
    att = spans.attribute(program, events, tr, 900, 1)
    assert att.self_ns["unfold"] == 50 and att.self_ns["fold"] == 100
    # where the launch's thread recorded no span, the innermost span of any thread
    events.runtime[2] = ("cudaLaunchKernel", 1320, 1330, 3, 999)
    att = spans.attribute(program, events, tr, 900, 1)
    assert att.self_ns["unfold"] == 50


def test_innermost_of_nested_and_disjoint_intervals():
    ivs = [(0, 100, "a"), (10, 20, "b"), (30, 60, "c"), (40, 50, "d")]
    assert spans.innermost(ivs, [5, 15, 25, 45, 55, 99, 101]) == [
        "a", "b", "a", "d", "c", "a", None]
    # a parent and its child opened at once (a backward's deferred spans)
    assert spans.innermost([(0, 10, 7), (0, 10, 8)], [5]) == [8]


@pytest.mark.parametrize("name", READERS)
def test_readers_return_none_without_the_programs_spans(name):
    mod = spec.module(spec.BENCH_DIR, "metrics", name)
    assert mod.read(types.SimpleNamespace()) is None  # a context of run.py: no spans
    empty = spans.Attribution(calls=3, window=[], setup=[])
    assert mod.read(types.SimpleNamespace(program=empty)) is None


def test_a_program_without_a_recorder(tmp_path, monkeypatch):
    pkg = tmp_path / "oldprog"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path))
    import oldprog

    assert spans.recorder(oldprog) is None
    assert spans.recorder(h.program()) is not None
    stages = _stages_module()
    cell = spec.cell(h.tiny_bench_cached()[2], "pair3d-n24.pair-c1", h.tiny_bench_cached()[1])
    with pytest.raises(LookupError):
        stages.run(cell, oldprog, seed=h.SEED, seconds=0.1, device="cpu", t_start=0.0)


def _stages_module():
    spec_ = importlib.util.spec_from_file_location("nfftb_stages", h.BENCH / "stages.py")
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("workload", h.CELLS)
def test_stages_runs_every_cell_on_the_cpu(workload):
    """On the CPU the window has no device activity: the readers of device
    time read nothing, the plan's set-up span is read, and the recorder is
    off again after the run."""
    root, bench_dir, bench = h.tiny_bench_cached()
    stages = _stages_module()
    cell = spec.cell(bench, workload, bench_dir)
    program = h.program()
    res = stages.run(cell, program, seed=h.SEED, seconds=0.2, device="cpu",
                     t_start=time.perf_counter(), bench_dir=bench_dir)
    assert res["calls"] >= 1 and res["spans_recorded"] > 0
    assert res["metrics"]["plan_build_s"] > 0
    assert "tile_move_ms" not in res["metrics"]  # no device time on the CPU
    assert not program.trace.enabled() and program.trace.drain() == []
    assert set(res["breakdown"]) >= {"device_ops", "idle_gaps", "spans", "launches"}
