"""The one generator of every traffic mix: points, value pools and the
sampled rows, all drawn from ``--seed``.

A configuration gives the points (``n_log2``, ``dim``, uniform in
[``points_low``, ``points_high``)); a traffic mix gives a pool of
``pool`` entries, each a dict of standard normal arrays of shape
(n, columns) named in ``values``, and ``sample_rows``, the rows at which
every call's outputs are compared with the reference. Points and values
are made on the device by one ``torch.Generator`` in a few large calls;
the rows by numpy from the same seed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

SEED_MOD = 1 << 64


@dataclass
class Inputs:
    points: torch.Tensor  # (n, dim) float32
    pool: list  # [{name: (n, columns) float32}]
    rows: np.ndarray  # sorted sample of row indices
    rows_t: torch.Tensor  # the same on the device (int64)

    @property
    def n(self) -> int:
        return self.points.shape[0]


def make_inputs(config: dict, traffic: dict, seed: int, device) -> Inputs:
    seed = int(seed) % SEED_MOD
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n, dim = 1 << int(config["n_log2"]), int(config["dim"])
    lo, hi = float(config["points_low"]), float(config["points_high"])
    points = torch.rand((n, dim), generator=gen, device=device) * (hi - lo) + lo
    pool = [{name: torch.randn((n, int(cols)), generator=gen, device=device)
             for name, cols in traffic["values"].items()}
            for _ in range(int(traffic["pool"]))]
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.choice(n, size=min(n, int(traffic["sample_rows"])), replace=False))
    return Inputs(points, pool, rows, torch.as_tensor(rows, device=device))
