"""Plain reference of the ``grid_sharded`` configurations: the pair of
``references/dirichlet_pair.py``, loaded from its file, unchanged (the
same direct Dirichlet-kernel sums in float64 on the points' device).

Only ``grid_points`` differs: it hands the harness's count of covered grid
cells (``nfftb/roofline.py:covered_cells``, for the roofline shares) the
points on the host. That count flags an M^dim grid and sums the flags in
int64: at M = 2048 the sum alone takes 64 GiB, more than the card has
beside the flags, so it runs in host memory. Imports nothing of the port.
"""

from __future__ import annotations

from nfftb import spec

_pair = spec.module(spec.BENCH_DIR, "references", "dirichlet_pair")

dirichlet = _pair.dirichlet
outputs = _pair.outputs


def grid_points(config: dict, points):
    """The points as the transform reads them, float64, on the host."""
    return _pair.grid_points(config, points).cpu()
