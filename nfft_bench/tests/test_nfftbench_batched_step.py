"""The batched training step ``batch3d-16x21-grad.streamed-step-c2`` and the
headline pair at eight columns ``pair3d-n24.pair-c8`` on the CPU: their
harness code (``systems/batched_step.py``,
``references/dirichlet_batched_step.py``, ``metrics/streamed_backward_ms.py``,
``metrics/member_step_roofline.py``; the ``pair`` system at C = 8) run
through ``core.run`` at a size a CPU test holds, with the cells' own
traffic and limits.

- the pieces are found by name, and the published configuration is kept;
- the step's run is correct, and so is the eight-column pair's;
- the reference is the float64 gradient of each member's own pair, and
  loads neither JAX nor the port;
- a program whose ``nfft_pair_streamed`` takes no ``pos`` fails at the
  build, and each planted fault fails the limits;
- ``member_step_roofline`` counts each member's spreads, gathers and
  position gradients on its own grid.
"""

import json
import math
import subprocess
import sys
import types

import pytest
import torch

import nfftbench_helpers as h
from nfftb import core, faults, generate, guard, roofline, spec, trace

WORKLOAD = "batch3d-16x21-grad.streamed-step-c2"
C8 = "pair3d-n24.pair-c8"
# 4 uneven members of 2^12 points on N = 16 (M = 32), the window kept
TINY_BATCH = {"n_log2": 12, "bandwidth": 16, "batch_size": 4,
              "member_counts": [1100, 900, 1200, 896]}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    root, bench_dir, _ = h.tiny_bench(tmp_path_factory.mktemp("batched_step"))
    path = bench_dir / "configs" / "batch3d-16x21-grad.json"
    cfg = json.loads(path.read_text())
    cfg.update(TINY_BATCH)
    path.write_text(json.dumps(cfg))
    return root, bench_dir, spec.load_benchmark(root)


def _cell(bench, workload=WORKLOAD):
    _, bench_dir, benchmark = bench
    return spec.cell(benchmark, workload, bench_dir)


def _run(bench, program=None, workload=WORKLOAD, **kw):
    _, bench_dir, _ = bench
    return core.run(_cell(bench, workload), program or h.program(), seed=h.SEED, seconds=0.2,
                    traced=False, device=torch.device("cpu"), t_start=0.0,
                    bench_dir=bench_dir, **kw)


@pytest.mark.parametrize("kind,name", [("configs", "batch3d-16x21-grad"),
                                       ("traffic", "streamed-step-c2"),
                                       ("traffic", "pair-c8"),
                                       ("limits", WORKLOAD), ("limits", C8)])
def test_the_data_files_are_found_by_name(kind, name):
    assert spec.data_file(spec.BENCH_DIR, kind, name)


@pytest.mark.parametrize("kind,name", [("systems", "batched_step"),
                                       ("references", "dirichlet_batched_step"),
                                       ("metrics", "streamed_backward_ms"),
                                       ("metrics", "member_step_roofline")])
def test_the_modules_are_found_by_name(kind, name):
    mod = spec.module(spec.BENCH_DIR, kind, name)
    assert hasattr(mod, {"systems": "build", "references": "outputs",
                         "metrics": "read"}[kind])


def test_the_published_configuration_is_kept():
    """The batch's keys and values, with the step's system and reference."""
    cfg = spec.data_file(spec.BENCH_DIR, "configs", "batch3d-16x21-grad")
    batch = spec.data_file(spec.BENCH_DIR, "configs", "batch3d-16x21")
    differ = {k for k in batch if k in ("name", "source", "deployment", "system", "reference",
                                        "assumed")}
    assert {k: batch[k] for k in batch if k not in differ} == \
        {k: cfg[k] for k in batch if k not in differ}
    assert (cfg["system"], cfg["reference"]) == ("batched_step", "dirichlet_batched_step")
    assert cfg["reduced"] == [] and set(batch["assumed"]) <= set(cfg["assumed"])
    traffic = spec.data_file(spec.BENCH_DIR, "traffic", "streamed-step-c2")
    assert (traffic["call"], traffic["columns"], traffic["values"]) == \
        ("step_streamed", 2, {"x": 2, "w": 2})
    assert traffic["work"] == {"spread": 2, "gather": 2, "pos_grad": 2}
    bench = spec.load_benchmark(h.ROOT)
    for name in (WORKLOAD, C8):
        assert spec.workload_entry(bench, name)["chips"] == 1
    for metric in ("streamed_backward_ms", "member_step_roofline"):
        entry = next(m for m in bench["per_layer"] if m["name"] == metric)
        assert entry["workloads"] == [WORKLOAD]


def test_the_step_is_correct(bench):
    res = _run(bench)
    assert res["correct"] and res["failed"] == 0 and res["calls"] >= 1, res["checks"]
    assert set(res["checks"]) == {"xgrad_rel_l2", "posgrad_rel_l2"}
    assert set(res["metrics"]) == {"points_per_s", "call_ms_p95", "setup_s"}


def test_a_traced_cpu_run_reads_no_device_metric_of_the_step(bench):
    _, bench_dir, benchmark = bench
    res = h.run_cpu(benchmark, bench_dir, WORKLOAD, traced=True)
    assert res["correct"]
    assert "member_step_roofline" not in res["metrics"]
    assert "streamed_backward_ms" not in res["metrics"]  # CUDA events only on the card
    assert res["metrics"]["plan_s"]["value"] > 0


def test_the_eight_column_pair_is_correct(bench):
    cell = _cell(bench, C8)
    assert cell.traffic["columns"] == 8 and set(cell.limits) == {"y_rel_l2"}
    res = _run(bench, workload=C8)
    assert res["correct"] and res["failed"] == 0, res["checks"]


def _float64_step(pos, x, w, N):
    """x.grad and pos.grad of L = <Re forward(adjoint(x)), w> by the dense
    NDFT over one member's points, float64."""
    pos = pos.double().clone().requires_grad_(True)
    x = x.double().clone().requires_grad_(True)
    dim = pos.shape[1]
    k = torch.stack(torch.meshgrid(*[torch.arange(-N // 2, N // 2, dtype=torch.float64)] * dim,
                                   indexing="ij"), -1).reshape(-1, dim)
    E = torch.exp(2j * math.pi * (pos @ k.T))  # (n, N^dim)
    z = (E.conj() @ (E.T @ x.to(torch.complex128))).real
    return torch.autograd.grad((z * w.double()).sum(), (x, pos))


def test_reference_is_each_members_float64_step(bench):
    cell = _cell(bench)
    cfg = cell.config
    inputs = generate.make_inputs(cfg, cell.traffic, 7, "cpu")
    ref = spec.module(h.BENCH, "references", "dirichlet_batched_step")
    got = ref.outputs(cfg, cell.traffic, inputs.points, inputs.rows_t, inputs.pool[:2])
    bounds = ref.member_bounds(cfg)
    for k, values in enumerate(inputs.pool[:2]):
        want = {"xgrad": torch.empty((len(inputs.rows), 2), dtype=torch.float64),
                "posgrad": torch.empty((len(inputs.rows), 3), dtype=torch.float64)}
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            sel = (inputs.rows_t >= lo) & (inputs.rows_t < hi)
            gx, gp = _float64_step(inputs.points[lo:hi], values["x"][lo:hi],
                                   values["w"][lo:hi], cfg["bandwidth"])
            want["xgrad"][sel] = gx[inputs.rows_t[sel] - lo]
            want["posgrad"][sel] = gp[inputs.rows_t[sel] - lo]
        for key in want:
            err = float(torch.linalg.vector_norm(got[k][key] - want[key])
                        / torch.linalg.vector_norm(want[key]))
            assert err <= 1e-9, key


def test_reference_loads_neither_jax_nor_the_port():
    prog = (f"import sys; sys.path[:0] = [{str(h.BENCH)!r}]\n"
            "from nfftb import spec\n"
            "spec.module(spec.BENCH_DIR, 'references', 'dirichlet_batched_step')\n"
            "print('\\n'.join(sorted(sys.modules)))")
    mods = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                          timeout=300, check=True).stdout.split()
    assert "nfftb.check" in mods  # dirichlet_pair.py, loaded from its file
    assert not [m for m in mods if m.split(".")[0] == guard.PROGRAM]
    assert guard.banned_modules(mods) == []


def test_a_program_without_the_position_gradient_fails_at_build(bench):
    port = h.program()

    def nfft_pair_streamed(x, layout, *, strategy="auto", column_chunk=None):
        return port.nfft_pair_streamed(x, layout, strategy=strategy, column_chunk=column_chunk)

    older = types.SimpleNamespace(__name__=port.__name__,
                                  make_streamed_layout=port.make_streamed_layout,
                                  nfft_pair_streamed=nfft_pair_streamed)
    with pytest.raises(TypeError, match="takes no pos"):
        _run(bench, older)
    with pytest.raises(TypeError, match="takes no pos"):
        _run(bench, types.SimpleNamespace(__name__="none"))


@pytest.mark.parametrize("kind", faults.KINDS)
def test_a_planted_fault_is_not_correct(bench, kind):
    res = _run(bench, wrap=lambda s: faults.Faulty(s, kind))
    assert not res["correct"] and res["failed"] >= 1, res["checks"]


class _Win:
    calls = 3


def test_member_step_roofline_counts_each_members_step(bench):
    """Two members over the same region: their cells count twice; the
    position gradients count beside the spreads and gathers."""
    cell = _cell(bench)
    cfg = dict(cell.config, member_counts=[2048, 2048], batch_size=2)
    cell = spec.Cell(cell.name, 1, cfg, cell.traffic, cell.limits, [], [])
    gen = torch.Generator().manual_seed(3)
    half = torch.rand((2048, 3), generator=gen) * 0.5 - 0.25
    pts = torch.cat([half, half])
    inputs = types.SimpleNamespace(points=pts, n=4096)
    ref = spec.module(h.BENCH, "references", "dirichlet_batched_step")
    M, m, L, C = 2 * cfg["bandwidth"], cfg["cutoff"], 2 * cfg["cutoff"] + 2, 2
    covered = roofline.covered_cells(half.double(), M, m)
    least = 2 * sum(2 * roofline.least_s(*roofline.work(kind, 2048, C, 3, L, covered))[0]
                    for kind in ("spread", "gather", "pos_grad"))
    ns = round(4 * least * _Win.calls * 1e9)  # the kernels took 4x the least time
    tr = trace.Trace(device=[("void spread_contract_kernel<false, 2, 5>()", 0, ns // 2),
                             ("void tnt::points::points_kernel<10, 1>(Args)", ns // 2, ns),
                             ("void vector_fft_r2c()", ns, 2 * ns)],
                     host=[], t0_ns=0, t1_ns=2 * ns)
    mod = spec.module(h.BENCH, "metrics", "member_step_roofline")
    ctx = core.Context(cell, inputs, _Win(), 1.0, None, 0, {}, tr, ref)
    assert mod.read(ctx) == pytest.approx(25.0, rel=1e-4)  # ns rounded
    assert mod.least_s_per_call(ctx) == pytest.approx(least)
    assert mod.read(core.Context(cell, inputs, _Win(), 1.0, None, 0, {}, None, ref)) is None


def test_streamed_backward_ms_is_the_mean_of_the_steps():
    mod = spec.module(h.BENCH, "metrics", "streamed_backward_ms")
    ctx = types.SimpleNamespace(spans={"backward_ms": [300.0, 340.0, 320.0]})
    assert mod.read(ctx) == pytest.approx(320.0)
    assert mod.read(types.SimpleNamespace(spans={})) is None
