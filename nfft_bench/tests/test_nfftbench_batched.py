"""The streamed batched cell ``batch3d-16x21.streamed-c2`` on the CPU: its
harness code (``systems/batched.py``, ``references/dirichlet_batched.py``,
``metrics/member_roofline.py``) run through ``core.run`` at a size a CPU
test holds, with the cell's own traffic and limits.

- the cell's run is correct;
- the reference is a direct NDFT pair of each member on its own, in
  float64, and loads neither JAX nor the port;
- a program that sums over every member at once (the batch taken as one
  set of points) is not correct, nor is any planted fault;
- a program without ``nfft_pair_streamed`` fails at the build;
- ``member_roofline`` counts each member's cells on its own grid.
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

WORKLOAD = "batch3d-16x21.streamed-c2"
# 4 uneven members of 2^12 points on N = 16 (M = 32), the window kept
TINY_BATCH = {"n_log2": 12, "bandwidth": 16, "batch_size": 4,
              "member_counts": [1100, 900, 1200, 896]}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    root, bench_dir, _ = h.tiny_bench(tmp_path_factory.mktemp("batched"))
    path = bench_dir / "configs" / "batch3d-16x21.json"
    cfg = json.loads(path.read_text())
    cfg.update(TINY_BATCH)
    path.write_text(json.dumps(cfg))
    return root, bench_dir, spec.load_benchmark(root)


def _cell(bench):
    _, bench_dir, benchmark = bench
    return spec.cell(benchmark, WORKLOAD, bench_dir)


def _run(bench, program=None, **kw):
    _, bench_dir, benchmark = bench
    return core.run(_cell(bench), program or h.program(), seed=h.SEED, seconds=0.2,
                    traced=False, device=torch.device("cpu"), t_start=0.0,
                    bench_dir=bench_dir, **kw)


def test_the_published_configuration_is_kept():
    cfg = spec.data_file(spec.BENCH_DIR, "configs", "batch3d-16x21")
    assert (cfg["batch_size"], cfg["bandwidth"], cfg["cutoff"], cfg["oversampling"]) == \
        (16, 256, 4, 2.0)
    assert cfg["window"] == "gaussian" and cfg["reduced"] == []
    assert sum(cfg["member_counts"]) == 2 ** cfg["n_log2"] == 2 ** 21
    assert len(cfg["member_counts"]) == 16
    assert spec.data_file(spec.BENCH_DIR, "traffic", "streamed-c2")["columns"] == 2


def test_the_cell_is_correct(bench):
    res = _run(bench)
    assert res["correct"] and res["failed"] == 0 and res["calls"] >= 1, res["checks"]
    assert set(res["metrics"]) == {"points_per_s", "call_ms_p95", "setup_s"}


def test_a_traced_cpu_run_reads_no_member_roofline(bench):
    _, bench_dir, benchmark = bench
    res = h.run_cpu(benchmark, bench_dir, WORKLOAD, traced=True)
    assert res["correct"] and "member_roofline" not in res["metrics"]
    assert res["metrics"]["plan_s"]["value"] > 0


def _ndft_pair(pos, x, N):
    """Re forward(adjoint(x)) by the dense NDFT, float64: (n, C)."""
    dim = pos.shape[1]
    k = torch.stack(torch.meshgrid(*[torch.arange(-N // 2, N // 2, dtype=torch.float64)] * dim,
                                   indexing="ij"), -1).reshape(-1, dim)
    E = torch.exp(2j * math.pi * (pos @ k.T))  # (n, N^dim)
    y = E.T @ x.to(torch.complex128)
    return (E.conj() @ y).real


def test_reference_is_the_per_member_ndft_pair(bench):
    cell = _cell(bench)
    cfg = cell.config
    inputs = generate.make_inputs(cfg, cell.traffic, 7, "cpu")
    ref = spec.module(h.BENCH, "references", "dirichlet_batched")
    got = ref.outputs(cfg, cell.traffic, inputs.points, inputs.rows_t, inputs.pool[:2])
    bounds = ref.member_bounds(cfg)
    pos = inputs.points.double()
    for k, values in enumerate(inputs.pool[:2]):
        want = torch.empty((len(inputs.rows), cell.traffic["columns"]), dtype=torch.float64)
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            sel = (inputs.rows_t >= lo) & (inputs.rows_t < hi)
            z = _ndft_pair(pos[lo:hi], values["x"][lo:hi].double(), cfg["bandwidth"])
            want[sel] = z[inputs.rows_t[sel] - lo]
        err = float(torch.linalg.vector_norm(got[k]["y"] - want) / torch.linalg.vector_norm(want))
        assert err <= 1e-10


def test_reference_loads_neither_jax_nor_the_port():
    prog = (f"import sys; sys.path[:0] = [{str(h.BENCH)!r}]\n"
            "from nfftb import spec\n"
            "spec.module(spec.BENCH_DIR, 'references', 'dirichlet_batched')\n"
            "print('\\n'.join(sorted(sys.modules)))")
    mods = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                          timeout=300, check=True).stdout.split()
    assert "nfftb.check" in mods  # dirichlet_pair.py, loaded from its file
    assert not [m for m in mods if m.split(".")[0] == guard.PROGRAM]
    assert guard.banned_modules(mods) == []


def _one_set_double(program):
    """A program whose streamed pair sums every point of the batch against
    every other, as if the members were one set."""
    def make_streamed_layout(pos, batch, **kw):
        return types.SimpleNamespace(pos=pos, kw=kw)

    def nfft_pair_streamed(x, layout):
        kw = dict(layout.kw)
        kw.pop("batch_size")
        return program.nfft_pair_planar(x, layout.pos, None, batch_size=1, **kw)

    return types.SimpleNamespace(__name__="one_set_double",
                                 make_streamed_layout=make_streamed_layout,
                                 nfft_pair_streamed=nfft_pair_streamed)


def test_a_program_that_sums_across_members_is_not_correct(bench):
    res = _run(bench, _one_set_double(h.program()))
    assert not res["correct"] and res["failed"] >= 1, res["checks"]
    assert res["checks"]["y_rel_l2"]["value"] > 1.0


@pytest.mark.parametrize("kind", faults.KINDS)
def test_a_planted_fault_is_not_correct(bench, kind):
    res = _run(bench, wrap=lambda s: faults.Faulty(s, kind))
    assert not res["correct"] and res["failed"] >= 1, res["checks"]


def test_a_program_without_the_streamed_pair_fails_at_build(bench):
    port = h.program()
    older = types.SimpleNamespace(__name__=port.__name__,
                                  make_streamed_layout=port.make_streamed_layout)
    with pytest.raises(AttributeError, match="nfft_pair_streamed"):
        _run(bench, older)


class _Win:
    calls = 3


def test_member_roofline_counts_each_members_cells(bench):
    """Two members over the same region: their cells count twice, where
    the union on one grid counts them once."""
    cell = _cell(bench)
    cfg = dict(cell.config, member_counts=[2048, 2048], batch_size=2)
    cell = spec.Cell(cell.name, 1, cfg, cell.traffic, cell.limits, [], [])
    gen = torch.Generator().manual_seed(3)
    half = torch.rand((2048, 3), generator=gen) * 0.5 - 0.25
    pts = torch.cat([half, half])
    inputs = types.SimpleNamespace(points=pts, n=4096)
    ref = spec.module(h.BENCH, "references", "dirichlet_batched")
    M, m, L, C = 2 * cfg["bandwidth"], cfg["cutoff"], 2 * cfg["cutoff"] + 2, 2
    covered = roofline.covered_cells(half.double(), M, m)
    assert roofline.covered_cells(pts.double(), M, m) == covered
    least = 2 * sum(roofline.least_s(*roofline.work(kind, 2048, C, 3, L, covered))[0]
                    for kind in ("spread", "gather"))
    ns = round(4 * least * _Win.calls * 1e9)  # the kernels took 4x the least time
    tr = trace.Trace(device=[("void spread_contract_kernel<false, 2, 5>()", 0, ns // 2),
                             ("void tnt::points::points_kernel<10, 1>(Args)", ns // 2, ns),
                             ("void vector_fft_r2c()", ns, 2 * ns)],
                     host=[], t0_ns=0, t1_ns=2 * ns)
    mod = spec.module(h.BENCH, "metrics", "member_roofline")
    ctx = core.Context(cell, inputs, _Win(), 1.0, None, 0, {}, tr, ref)
    assert mod.read(ctx) == pytest.approx(25.0, rel=1e-4)  # ns rounded
    assert mod.least_s_per_call(ctx) == pytest.approx(least)
    assert mod.read(core.Context(cell, inputs, _Win(), 1.0, None, 0, {}, None, ref)) is None
