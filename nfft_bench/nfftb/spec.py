"""Find a cell's pieces by the names in ``BENCHMARK.json``.

Layout under the benchmark's folder, one file per name:

- ``configs/<config>.json``: a configuration's sizes (``system`` names its
  adapter, ``reference`` its plain reference);
- ``traffic/<traffic>.json``: a traffic mix, read by :mod:`nfftb.generate`
  and :mod:`nfftb.window`;
- ``limits/<workload>.json``: the limit of each number that decides
  ``correct`` in that cell;
- ``systems/<system>.py``: builds the system under test from the program;
- ``references/<reference>.py``: the plain reference;
- ``metrics/<metric>.py``: one metric's reader, ``read(ctx)``.

A later cell, traffic mix or metric is a new file and a new entry in
``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def checkout_root(bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir.parent


def load_benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _path(bench_dir: Path, kind: str, name: str, suffix: str) -> Path:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return bench_dir / kind / f"{name}{suffix}"


def data_file(bench_dir: Path, kind: str, name: str) -> dict:
    return json.loads(_path(bench_dir, kind, name, ".json").read_text())


def module(bench_dir: Path, kind: str, name: str):
    """The module ``<kind>/<name>.py``, loaded from its file."""
    path = _path(bench_dir, kind, name, ".py")
    mod_name = "nfftb_" + kind + "_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def workload_entry(bench: dict, workload: str) -> dict:
    for entry in bench["workloads"]:
        if entry["name"] == workload:
            return entry
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def cell(bench: dict, workload: str, bench_dir: Path = BENCH_DIR) -> Cell:
    entry = workload_entry(bench, workload)
    return Cell(
        name=workload,
        chips=int(entry["chips"]),
        config=data_file(bench_dir, "configs", entry["config"]),
        traffic=data_file(bench_dir, "traffic", entry["traffic"]),
        limits=data_file(bench_dir, "limits", workload),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
    )
