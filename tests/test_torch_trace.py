"""The port's span recorder (``torch_nfft_tpu_torch/trace.py``) and its span
sites, on the CPU: nothing recorded and no clock read while it is off;
names, parents and roots while it is on, through the autograd backward;
one span per stage of every route and none inside a chunk loop; the
streamed transforms' pack, member and unpack spans and their counters, and
the streamed pair's backward > member spans and its two counters;
two or more threads recording at once; one snapshot of the launch
counters."""

import sys
import threading
import types

import numpy as np
import pytest
import torch
from _torch_port import points

import torch_nfft_tpu_torch as tp
from torch_nfft_tpu_torch import _native, trace
from torch_nfft_tpu_torch.ops import (benes, binned, bitonic, contract, fft, nfft, ragged,
                                      streaming, tilefold)
from torch_nfft_tpu_torch.parallel import _comm

N, M_CUT, SIGMA = 16, 2, 2.0
PAIR = ["slot_values", "spread kernel", "fold", "rfftn", "irfftn", "unfold",
        "gather kernel", "unslot_values"]


@pytest.fixture
def recorder():
    """The recorder on for one test, drained before and after."""
    trace.drain()
    trace.enable()
    try:
        yield trace
    finally:
        trace.disable()
        trace.drain()


@pytest.fixture
def setup():
    rng = np.random.default_rng(7)
    pos, _ = points(rng, 2500, 3)
    x = rng.standard_normal((2500, 2)).astype(np.float32)
    pos_t = torch.from_numpy(pos)
    plan = tp.build_plan(pos, N=N, m=M_CUT, sigma=SIGMA, device="cpu")
    return pos, pos_t, torch.from_numpy(x), plan


KW = dict(batch_size=1, N=N, m=M_CUT, sigma=SIGMA, window="gaussian", strategy="binned",
          device="cpu")


def _coeffs():
    return tp.gaussian_analytic_coeffs(0.5, 3, N, device="cpu")


def _gram(pos_t):
    return tp.GramMatrix(_coeffs(), pos_t, cutoff=M_CUT, device="cpu")


# entry point: (its span's name, a call of it on the set-up)
ENTRIES = {
    "nfft_pair_planar": lambda pos, pos_t, x, plan: tp.nfft_pair_planar(x, pos_t, None, plan,
                                                                        **KW),
    "nfft_adjoint_planar": lambda pos, pos_t, x, plan: tp.nfft_adjoint_planar(
        x, pos_t, None, plan, **KW),
    "nfft_forward_planar": lambda pos, pos_t, x, plan: tp.nfft_forward_planar(
        torch.ones((1, N, N, N, 2)), None, pos_t, None, plan, dim=3, real_output=True,
        **{k: v for k, v in KW.items() if k != "N"}),
    "nfft_fastsum_real": lambda pos, pos_t, x, plan: tp.nfft_fastsum_real(
        x, _coeffs(), pos_t, pos_t, None, None, plan, plan, **KW),
    "nfft_adjoint": lambda pos, pos_t, x, plan: tp.nfft_adjoint(
        x, pos, N=N, m=M_CUT, plan=plan, strategy="binned", device="cpu"),
    "nfft_forward": lambda pos, pos_t, x, plan: tp.nfft_forward(
        torch.ones((1, N, N, N)), pos, m=M_CUT, plan=plan, strategy="binned", device="cpu"),
    "nfft_fastsum": lambda pos, pos_t, x, plan: tp.nfft_fastsum(
        x, _coeffs(), pos_t, m=M_CUT, source_plan=plan, strategy="binned", device="cpu"),
    "GramMatrix.apply": lambda pos, pos_t, x, plan: _gram(pos_t) @ x,
    "GramMatrix.apply_slot": lambda pos, pos_t, x, plan: _gram(pos_t).apply_slot(
        tp.to_slot_order(plan, x)),
    "AdjacencyMatrix.apply": lambda pos, pos_t, x, plan: tp.AdjacencyMatrix(
        _gram(pos_t)) @ x,
}


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_off_records_nothing_and_reads_no_clock(monkeypatch, setup, entry):
    def no_clock():
        raise AssertionError("the recorder read the clock while off")

    trace.disable()
    trace.drain()
    monkeypatch.setattr(trace, "time", types.SimpleNamespace(time_ns=no_clock))
    before = trace.counters()["fastsum_route.half"]
    out = ENTRIES[entry](*setup)
    assert torch.as_tensor(out[0] if isinstance(out, tuple) else out).numel() > 0
    assert trace.drain() == []
    # the route counter counts while the recorder is off
    ran = trace.counters()["fastsum_route.half"] - before
    assert (ran > 0) == (entry in ("nfft_fastsum", "GramMatrix.apply",
                                   "AdjacencyMatrix.apply"))
    assert trace.span("a") is trace.span("b")  # one shared object, nothing allocated


def test_off_leaves_the_backward_as_it_is(monkeypatch, setup):
    """Off, a step records nothing and adds no node to the graph; on, the
    same step gives the same bits."""
    _, pos_t, x, plan = setup
    trace.disable()
    trace.drain()
    grads = []
    for on in (False, True):
        if on:
            trace.enable()
        try:
            xg = x[:, :1].clone().requires_grad_(True)
            p = pos_t.clone().requires_grad_(True)
            y = tp.nfft_pair_planar(xg, p, None, plan, **KW)
            if not on:
                assert type(y.grad_fn).__name__ == "_GatherBackward"
            y.sum().backward()
            grads.append((y.detach(), xg.grad, p.grad))
        finally:
            trace.disable()
        assert bool(trace.drain()) == on
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_each_entry_point_is_the_root_of_its_call(setup, recorder, entry):
    ENTRIES[entry](*setup)
    spans = recorder.drain()
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == [entry]
    root = roots[0]
    inside = [s for s in spans if s.root == root.id and s is not root]
    assert inside, "no stage span under the entry point"
    by_id = {s.id: s for s in spans}
    for s in inside:
        parent = by_id[s.parent]
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    assert all(s.start_ns <= s.end_ns for s in spans)


def test_names_parents_and_roots_through_the_backward(setup, recorder):
    _, pos_t, x, plan = setup
    x = x[:, :1].clone().requires_grad_(True)
    p = pos_t.clone().requires_grad_(True)
    y = tp.nfft_pair_planar(x, p, None, plan, **KW)
    y.sum().backward()
    spans = sorted(recorder.drain(), key=lambda s: (s.start_ns, s.id))
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["nfft_pair_planar"] + ["backward"] * 4
    children = {r.id: [s.name for s in spans if s.parent == r.id] for r in roots}
    assert children[roots[0].id] == PAIR
    # _Gather's backward: y_bar to slot order, its spread, and pos_grad on g's tiles
    assert children[roots[1].id] == ["slot_values", "spread kernel", "fold", "unfold",
                                     "pos_grad", "unslot_values"]
    # the spectral stages' autograd nodes, in the backward's order
    assert children[roots[2].id] == ["irfftn"] and children[roots[3].id] == ["rfftn"]
    # _Spread's backward: g_bar's tiles, the gather of x.grad, pos_grad
    assert children[roots[4].id] == ["unfold", "gather kernel", "unslot_values",
                                     "pos_grad", "unslot_values"]
    # one after the other on the backward's thread
    assert all(a.end_ns <= b.start_ns for a, b in zip(roots[1:], roots[2:]))
    assert all(s.root == r.id for r in roots for s in spans if s.parent == r.id)
    assert len({s.id for s in spans}) == len(spans)
    assert x.grad is not None and p.grad is not None


STREAMED_COUNTS = (300, 0, 450)  # uneven, one member empty
# streamed entry point: (the planar entry point of its member passes, its
# spans before and after the members, a call of it on a layout); the
# forward unpacks its real and its imaginary plane
STREAMED = {
    "nfft_pair_streamed": ("nfft_pair_planar", ["pack"], ["unpack"],
                           lambda x, lay: tp.nfft_pair_streamed(x, lay)),
    "nfft_adjoint_streamed": ("nfft_adjoint_planar", ["pack"], [],
                              lambda x, lay: tp.nfft_adjoint_streamed(x, lay)),
    "nfft_forward_streamed": ("nfft_forward_planar", [], ["unpack", "unpack"],
                              lambda x, lay: tp.nfft_forward_streamed(
                                  torch.ones((len(STREAMED_COUNTS), N, N, N, 2)), None, lay)),
    "nfft_fastsum_streamed": ("nfft_fastsum_real", ["pack"], ["unpack"],
                              lambda x, lay: tp.nfft_fastsum_streamed(x, _coeffs(), lay)),
}


@pytest.fixture
def streamed():
    """(x, layout) of a batched set of three members, built with the
    recorder off."""
    rng = np.random.default_rng(11)
    n = sum(STREAMED_COUNTS)
    pos, _ = points(rng, n, 3)
    batch = np.repeat(np.arange(len(STREAMED_COUNTS)), STREAMED_COUNTS)
    layout = tp.make_streamed_layout(pos, batch, batch_size=len(STREAMED_COUNTS), N=N,
                                     m=M_CUT, sigma=SIGMA, window="gaussian", device="cpu")
    x = torch.from_numpy(rng.standard_normal((n, 2)).astype(np.float32))
    return x, layout


@pytest.mark.parametrize("entry", list(STREAMED))
def test_streamed_spans_nest_member_by_member(streamed, recorder, entry):
    """entry > pack, member x B > the planar entry point, unpack; each
    member's planar call records its own stages under it."""
    planar, before, after, call = STREAMED[entry]
    call(*streamed)
    spans = recorder.drain()
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == [entry]
    by_start = sorted(spans, key=lambda s: (s.start_ns, s.id))
    children = [s for s in by_start if s.parent == roots[0].id]
    B = len(STREAMED_COUNTS)
    assert [s.name for s in children] == before + ["member"] * B + after
    for member in (s for s in children if s.name == "member"):
        inner = [s for s in by_start if s.parent == member.id]
        assert [s.name for s in inner] == [planar]
        assert any(s.parent == inner[0].id for s in spans), "no stage under the member"
        assert member.start_ns <= inner[0].start_ns <= inner[0].end_ns <= member.end_ns
    assert all(s.root == roots[0].id for s in spans)


@pytest.mark.parametrize("chunk", [None, 1])
@pytest.mark.parametrize("on", [False, True])
def test_streamed_counters_count_with_the_recorder_on_and_off(monkeypatch, streamed, on,
                                                              chunk):
    x, layout = streamed
    trace.disable()
    trace.drain()
    if on:
        trace.enable()
    else:
        def no_clock():
            raise AssertionError("the recorder read the clock while off")

        monkeypatch.setattr(trace, "time", types.SimpleNamespace(time_ns=no_clock))
    try:
        before = trace.counters()
        tp.nfft_pair_streamed(x, layout, column_chunk=chunk)
        after = trace.counters()
    finally:
        trace.disable()
    assert bool(trace.drain()) == on
    B, n = len(STREAMED_COUNTS), sum(STREAMED_COUNTS)
    assert after["streamed_members"] - before["streamed_members"] == B * (2 if chunk else 1)
    assert after["streamed_pad_points"] - before["streamed_pad_points"] == \
        B * max(STREAMED_COUNTS) - n == layout.pad_points


# a member pass of the streamed pair's backward: w and x to slot order, x's
# pass to its tiles and pos_grad with w there, w's pass to its tiles, the
# gather of x.grad and pos_grad with x there
STREAMED_BACKWARD_MEMBER = ["slot_values", "slot_values", "spread kernel", "fold", "rfftn",
                            "irfftn", "unfold", "pos_grad", "unslot_values", "spread kernel",
                            "fold", "rfftn", "irfftn", "unfold", "gather kernel",
                            "unslot_values", "pos_grad", "unslot_values"]


def _streamed_step(x, layout, with_pos):
    """L = <nfft_pair_streamed(x, layout, pos=...), w>, L.backward()."""
    pos = None
    if with_pos:
        pos = layout.unpack(layout.pos_stack).clone().requires_grad_(True)
    x = x.clone().requires_grad_(True)
    z = tp.nfft_pair_streamed(x, layout, pos=pos)
    (z * torch.ones_like(z)).sum().backward()
    return x.grad, None if pos is None else pos.grad


def test_streamed_backward_spans_nest_member_by_member(streamed, recorder):
    """backward > pack (w), pack (x), member x B > the stages, unpack
    (x.grad), unpack (pos.grad), after the forward's root."""
    x, layout = streamed
    x = x.clone().requires_grad_(True)
    pos = layout.unpack(layout.pos_stack).clone().requires_grad_(True)
    recorder.drain()  # the unpack of the points records too
    z = tp.nfft_pair_streamed(x, layout, pos=pos)
    (z * torch.ones_like(z)).sum().backward()
    spans = sorted(recorder.drain(), key=lambda s: (s.start_ns, s.id))
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["nfft_pair_streamed", "backward"]
    B = len(STREAMED_COUNTS)
    forward = [s.name for s in spans if s.parent == roots[0].id]
    assert forward == ["pack"] + ["member"] * B + ["unpack"]
    children = [s for s in spans if s.parent == roots[1].id]
    assert [s.name for s in children] == ["pack", "pack"] + ["member"] * B + ["unpack"] * 2
    for member in (s for s in children if s.name == "member"):
        inner = [s.name for s in spans if s.parent == member.id]
        assert inner == STREAMED_BACKWARD_MEMBER
    assert all(s.root == roots[1].id for s in spans if s.start_ns >= roots[1].start_ns)
    assert roots[0].end_ns <= roots[1].start_ns
    assert x.grad is not None and pos.grad is not None


@pytest.mark.parametrize("with_pos", [False, True])
@pytest.mark.parametrize("on", [False, True])
def test_streamed_backward_counters_count_with_the_recorder_on_and_off(
        monkeypatch, streamed, on, with_pos):
    """A step counts B backward member passes, and B recomputed forward
    passes where it gives a position gradient, with the recorder off too."""
    x, layout = streamed
    trace.disable()
    trace.drain()
    if on:
        trace.enable()
    else:
        def no_clock():
            raise AssertionError("the recorder read the clock while off")

        monkeypatch.setattr(trace, "time", types.SimpleNamespace(time_ns=no_clock))
    try:
        before = trace.counters()
        xg, pg = _streamed_step(x, layout, with_pos)
        after = trace.counters()
    finally:
        trace.disable()
    assert bool(trace.drain()) == on
    B = len(STREAMED_COUNTS)
    ran = {k: after[k] - before[k] for k in streaming.streamed_counters}
    assert ran == {"streamed_members": B, "streamed_pad_points": layout.pad_points,
                   "streamed_backward_members": B,
                   "streamed_recompute_passes": B if with_pos else 0}
    assert xg is not None and (pg is not None) == with_pos


def _stage_cases():
    return [("spread", "dense"), ("gather", "dense"), ("spread", "flat"), ("gather", "flat")]


@pytest.mark.parametrize("direction,route", _stage_cases())
def test_run_stages_gives_one_span_per_stage(setup, recorder, direction, route):
    _, _, x, plan = setup
    tile_route = binned.TileRoute(plan, route)
    stages = {"spread": tile_route.spreading, "gather": tile_route.gathering}[direction]
    v = x if direction == "spread" else torch.ones(
        (plan.batch_size, x.shape[1]) + (plan.M,) * plan.dim)
    binned.run_stages(stages, v)
    spans = recorder.drain()
    assert [s.name for s in spans] == [name for name, _ in stages]
    assert all(s.parent is None for s in spans)


def test_flat_route_spans_do_not_grow_with_the_rows(monkeypatch, recorder):
    """The flat route's chunk loops (tiles_to_grid, grid_to_tiles) launch
    once per chunk of rows: no span sits inside them, so a call records
    the same spans whatever the plan's row count S and the chunk size."""
    monkeypatch.setattr(binned, "use_fold", lambda *a, **k: False)
    rng = np.random.default_rng(3)
    counts = []
    for n, K, entries in ((300, 64, 1 << 23), (3000, 16, 1 << 23), (3000, 16, 1 << 14)):
        monkeypatch.setattr(binned, "_cell_chunks",
                            lambda plan, C, e=entries: _chunks(plan, C, e))
        pos, _ = points(rng, n, 3)
        plan = tp.build_plan(pos, N=N, m=M_CUT, sigma=SIGMA, K=K, device="cpu")
        x = torch.from_numpy(rng.standard_normal((n, 1)).astype(np.float32))
        trace.drain()
        tp.nfft_pair_planar(x, torch.from_numpy(pos), None, plan, **KW)
        names = [s.name for s in trace.drain()]
        assert "tiles to grid" in names and "grid to tiles" in names
        counts.append((plan.S, len(_chunks(plan, 1, entries)), names))
    assert len({c[0] for c in counts}) > 1 and counts[2][1] > 1
    assert counts[0][2] == counts[1][2] == counts[2][2]


_REAL_CHUNKS = binned._cell_chunks


def _chunks(plan, C, entries):
    return _REAL_CHUNKS(plan, C, entries)


def _nested_spans(tag: str, rounds: int, start: threading.Barrier) -> None:
    start.wait(timeout=60)  # every thread alive at once: their idents differ
    for i in range(rounds):
        with trace.span(f"outer-{tag}"):
            with trace.span(f"inner-{tag}"):
                pass


@pytest.mark.parametrize("threads", [2, 16])
def test_threads_keep_their_own_stacks(recorder, threads):
    """More threads than cores, switching every microsecond: each keeps
    its own stack and no span is lost."""
    rounds = 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        start = threading.Barrier(threads)
        workers = [threading.Thread(target=_nested_spans, args=(str(k), rounds, start))
                   for k in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    spans = recorder.drain()
    assert len(spans) == 2 * rounds * threads
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        tag = s.name.split("-", 1)[1]
        if s.name.startswith("inner"):
            parent = by_id[s.parent]
            assert parent.name == f"outer-{tag}" and parent.thread == s.thread
            assert s.root == parent.id
        else:
            assert s.parent is None and s.root == s.id
    assert len({s.thread for s in spans}) == threads


def test_two_threads_calling_the_port(setup, recorder):
    """Two threads running the pair at once: each call's spans hang under
    its own entry point, on its own thread."""
    _, pos_t, x, plan = setup
    errors = []
    start = threading.Barrier(2)

    def call():
        try:
            start.wait(timeout=60)  # both alive at once: their idents differ
            tp.nfft_pair_planar(x, pos_t, None, plan, **KW)
        except Exception as exc:  # reported below
            errors.append(exc)

    workers = [threading.Thread(target=call) for _ in range(2)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=120)
    assert not any(w.is_alive() for w in workers) and not errors
    spans = recorder.drain()
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["nfft_pair_planar"] * 2
    assert roots[0].thread != roots[1].thread
    for r in roots:
        mine = sorted((s for s in spans if s.root == r.id and s is not r),
                      key=lambda s: s.start_ns)
        assert [s.name for s in mine] == PAIR
        assert all(s.thread == r.thread for s in mine)


WRAPPERS = [(contract, "spread_tiles_dense"), (contract, "spread_tiles"),
            (contract, "gather_points"), (contract, "pos_grad"), (ragged, "expand_rows"),
            (ragged, "compact_rows"), (benes, "benes_outer"), (benes, "benes_local"),
            (bitonic, "bitonic_local_sort"), (bitonic, "bitonic_cross_round"),
            (bitonic, "bitonic_local_merge"), (tilefold, "fold_tiles_to_grid"),
            (tilefold, "unfold_grid_to_tiles"), (tilefold, "fold_tiles_to_slab"),
            (tilefold, "unfold_slab_to_tiles"), (fft, "turn_half")]


def test_counters_equal_the_wrappers_attributes(monkeypatch):
    for k, (mod, name) in enumerate(WRAPPERS):
        fn = getattr(mod, name)
        monkeypatch.setattr(fn, "launches", 10 + k)
        if hasattr(fn, "launches_by_design"):
            monkeypatch.setattr(fn, "launches_by_design",
                                {"contraction": k, "tensor": 3 * k, "wide": 2 * k})
    monkeypatch.setattr(_comm, "sent_bytes", {"all_reduce": 7, "all_gather": 8,
                                              "ring_shift": 9})
    monkeypatch.setattr(nfft, "fastsum_routes", {"half": 5, "c2c": 6})
    monkeypatch.setattr(fft, "spectral_lines", {"run": 7, "skipped": 8})
    monkeypatch.setattr(streaming, "streamed_counters",
                        {"streamed_members": 3, "streamed_pad_points": 4,
                         "streamed_backward_members": 5, "streamed_recompute_passes": 6})
    got = trace.counters()
    want = {"kernel_builds": trace._REC.builds, "sent_bytes.all_reduce": 7,
            "sent_bytes.all_gather": 8, "sent_bytes.ring_shift": 9,
            "fastsum_route.half": 5, "fastsum_route.c2c": 6,
            "spectral_lines.run": 7, "spectral_lines.skipped": 8,
            "streamed_members": 3, "streamed_pad_points": 4,
            "streamed_backward_members": 5, "streamed_recompute_passes": 6}
    for mod, name in WRAPPERS:
        fn = getattr(mod, name)
        want[name] = fn.launches
        for design, n in getattr(fn, "launches_by_design", {}).items():
            want[f"{name}.{design}"] = n
    assert got == want


@pytest.mark.parametrize("dim,N,M,lead", [(1, 16, 32, (2, 1)), (2, 16, 26, (1, 3)),
                                          (3, 8, 16, (1, 2))])
def test_spectral_lines_count_the_pruned_passes(dim, N, M, lead):
    """spectral_lines against a hand count of each stage's C2C lines: 1D
    runs none; 2D (N = 16, M = 26: h = 8, 14 values on the last axis) runs
    9 of axis 0's 14 lines a slice; 3D (N = 8, M = 16: h = 4, 9 values)
    runs 16 x 5 = 80 of axis -2's 144 lines and 9 x 5 = 45 of axis 0's 144
    a slice. The same counts, call after call, with the recorder off."""
    L = lead[0] * lead[1]
    run, skipped = {1: (0, 0), 2: (9, 5), 3: (80 + 45, 64 + 99)}[dim]
    g = torch.randn(lead + (M,) * dim)
    trace.disable()
    for _ in range(2):
        before = trace.counters()
        half = fft.spectral_adjoint_half(g, dim, N, M_CUT, M / N)
        fft.spectral_forward_half(half, dim, N, M, M_CUT, M / N)
        after = trace.counters()
        assert (after["spectral_lines.run"] - before["spectral_lines.run"],
                after["spectral_lines.skipped"] - before["spectral_lines.skipped"]) == \
            (2 * L * run, 2 * L * skipped)


def test_spectral_lines_stay_at_zero_on_the_complex_route(setup):
    """The complex-to-complex stages and the fastsum of a complex x (its
    C2C route) transform no half spectrum: the counters do not move."""
    pos, pos_t, x, plan = setup
    g = torch.randn((1, 2) + (16,) * 3)
    before = trace.counters()
    y = fft.spectral_adjoint(g, 3, N // 2, M_CUT, 2.0)
    fft.spectral_forward(y, 3, 16, M_CUT, 2.0)
    tp.nfft_fastsum(torch.complex(x, x.flip(0)), _coeffs(), pos_t, m=M_CUT, source_plan=plan,
                    strategy="binned", device="cpu")
    after = trace.counters()
    assert after["fastsum_route.c2c"] == before["fastsum_route.c2c"] + 1
    for name in ("spectral_lines.run", "spectral_lines.skipped"):
        assert after[name] == before[name]


def test_counters_report_each_spread_design():
    """Every spread design has its counter, the tensor design's included."""
    got = trace.counters()
    for name in ("spread_tiles_dense", "spread_tiles"):
        for design in ("contraction", "tensor", "wide"):
            assert f"{name}.{design}" in got


@pytest.mark.parametrize("name", ["spread_tiles_dense", "spread_tiles"])
@pytest.mark.parametrize("H,C,culled", [(41, 2, 1), (25, 1, 0), (13, 1, 0), (25, 8, 0)])
def test_counters_count_the_culled_launches(monkeypatch, name, H, C, culled):
    """``<spread>.tensor_culled`` counts the launches that ran the culled
    tensor design, beside ``<spread>.tensor``, which counts them too: a
    streamed member's tiles (H = 41, C = 2) cull, the older cells' do not.
    Counted on the host from the design, with no launch here."""
    fn = getattr(contract, name)
    monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(fn, "launches_by_design", dict.fromkeys(fn.launches_by_design, 0))
    m = 4 if H != 13 else 2
    d = contract.spread_design(3, H, m, C)
    for _ in range(16):
        contract._count(fn, d)
    got = trace.counters()
    assert got[f"{name}.tensor"] == got[name] == 16
    assert got[f"{name}.tensor_culled"] == 16 * culled
    assert got[f"{name}.wide"] == got[f"{name}.contraction"] == 0


def test_kernel_builds_counts_a_compile(monkeypatch, tmp_path, recorder):
    """A compile of the host library counts one build; finding it built
    counts none."""
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path)
    before = trace.counters()["kernel_builds"]
    path, seconds = _native.build_native.__wrapped__()
    assert path.parent == tmp_path and seconds > 0
    assert trace.counters()["kernel_builds"] == before + 1
    _native.build_native.__wrapped__()
    assert trace.counters()["kernel_builds"] == before + 1
