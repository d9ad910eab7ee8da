"""The port's grid-sharded pair against the benchmark's plain reference.

``nfft_adjoint_grid_sharded`` followed by ``nfft_forward_grid_sharded(...,
real_output=True)``, the pair of the ``grid3d-n26`` cell, on gloo worlds
of 1, 2 and 4 ranks (``_torch_parallel_ranks.run_world``; the ranks
import no JAX), held to ``nfft_bench/references/dirichlet_pair.py``: the
same pair as direct Dirichlet-kernel sums over every point in float64,
plain torch, loaded from its file. 3D N = 32, gaussian m = 4, sigma = 2,
2^12 seeded points uniform on the whole torus, as the cell draws them.

Tolerance: rel-L2 2e-4 at every row. The gaussian window at m = 4,
sigma = 2 leaves about 1e-4 of the exact sums (7.9e-5 and 7.8e-5 for these
two seeds on every world; 9.5e-5 and 8.8e-5 for the single-device pair at
N = 32 on 2^14 points); 2e-4 is the bar the grid-sharded transforms are
held to against JAX's, and TF32 operands in the reference's own sums read
2.4e-4 to 2.7e-4 there.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_parallel_ranks import run_world

BENCH = Path(__file__).resolve().parents[1] / "nfft_bench"
N, M_CUT, LOG2 = 32, 4, 12
TOL = 2e-4


def _reference():
    """``references/dirichlet_pair.py`` from its file (it imports the
    harness's ``nfftb.check`` for its TF32 control)."""
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    spec = importlib.util.spec_from_file_location("dirichlet_pair_reference",
                                                  BENCH / "references" / "dirichlet_pair.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _case(seed: int) -> dict:
    gen = torch.Generator().manual_seed(seed)
    n = 1 << LOG2
    pos = torch.rand((n, 3), generator=gen) - 0.5
    x = torch.randn((n, 1), generator=gen)
    return dict(pos=pos.numpy(), x=x.numpy(), N=N, m=M_CUT)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_grid_sharded_pair_matches_the_dirichlet_reference(world, tmp_path):
    cases = {f"seed{s}": _case(s) for s in (11, 12)}
    outs = run_world(world, "grid_pair", cases, tmp_path)
    ref_mod = _reference()
    for key, c in cases.items():
        pts, x = torch.from_numpy(c["pos"]), torch.from_numpy(c["x"])
        ref = ref_mod.outputs({"bandwidth": N}, {"call": "pair"}, pts, torch.arange(pts.shape[0]),
                              [{"x": x}])[0]["y"]
        for r, out in enumerate(outs):
            got = torch.from_numpy(out[key]).double()
            assert got.shape == ref.shape
            rel = float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))
            assert rel <= TOL, (key, r, rel)
        assert all(np.array_equal(outs[0][key], o[key]) for o in outs[1:])
