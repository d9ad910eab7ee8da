"""A configuration, a traffic mix, a cell and metrics added as new files
become a cell and metrics with no edit to any file that was there."""

import hashlib
import json

import nfftbench_helpers as h


def _digests(folder):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_make_a_new_cell_and_metrics(tmp_path):
    root, bench_dir, bench = h.tiny_bench(tmp_path)
    before = _digests(bench_dir)
    # a new configuration, traffic mix, limits and two metric readers
    cfg = json.loads((bench_dir / "configs" / "pair3d-n24.json").read_text())
    cfg.update(name="pair2d-small", dim=2, n_log2=11, bandwidth=32)
    (bench_dir / "configs" / "pair2d-small.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench_dir / "traffic" / "pair-c1.json").read_text())
    traffic.update(columns=2, values={"x": 2})
    (bench_dir / "traffic" / "pair-c2.json").write_text(json.dumps(traffic))
    (bench_dir / "limits" / "pair2d-small.pair-c2.json").write_text('{"y_rel_l2": 1e-3}')
    (bench_dir / "metrics" / "calls_per_s.py").write_text(
        "def read(ctx):\n    return ctx.win.calls / ctx.win.window_s\n")
    (bench_dir / "metrics" / "rows_sampled.py").write_text(
        "def read(ctx):\n    return len(ctx.inputs.rows)\n")
    bench["configs"].append({"name": "pair2d-small", "source": "a test", "reduced": [],
                             "file": "nfft_bench/configs/pair2d-small.json", "why": "a test"})
    bench["workloads"].append({"name": "pair2d-small.pair-c2", "config": "pair2d-small",
                               "traffic": "pair-c2", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "calls_per_s", "unit": "1/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["pair2d-small.pair-c2"]})
    bench["per_layer"].append({"name": "rows_sampled", "unit": "rows", "better": "higher",
                               "source": "program_counter", "layer": "check",
                               "moves": "points_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(bench_dir)
    assert all(after[p] == d for p, d in before.items())  # nothing edited

    bench = json.loads((root / "BENCHMARK.json").read_text())
    res = h.run_cpu(bench, bench_dir, "pair2d-small.pair-c2")
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"points_per_s", "call_ms_p95", "setup_s", "calls_per_s"}
    traced = h.run_cpu(bench, bench_dir, "pair2d-small.pair-c2", traced=True)
    assert traced["metrics"]["rows_sampled"]["value"] == 256
    # the new metric is in no other cell
    other = h.run_cpu(bench, bench_dir, "pair3d-n24.pair-c1")
    assert "calls_per_s" not in other["metrics"]
