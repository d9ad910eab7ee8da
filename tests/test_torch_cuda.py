"""Card-only tests of the PyTorch port: the CUDA kernels against their plain
PyTorch versions, and the entry points on the card.

Marked ``cuda``; each test skips (inside the ``card`` fixture) where no CUDA
card is present. This file imports neither JAX nor the JAX package, so it
also runs on a machine with the card and without JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

Kernel and plain version agree to rel-L2 1e-5: they sum the same float32
products in another order (the spread kernel in the order of its atomics).
"""

import numpy as np
import pytest
import torch
from _torch_port import points

import torch_nfft_tpu_torch as tp
from torch_nfft_tpu_torch import _build
from torch_nfft_tpu_torch.ops import binned, contract
from torch_nfft_tpu_torch.ops.tilefold import row_tile_ids, unfold_grid_to_tiles

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return tp.resolve_device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _rel(a, b):
    return float(torch.linalg.vector_norm((a - b).double()) / torch.linalg.vector_norm(b.double()))


def _kernels_vs_plain(rng, dev, dim, N, m, sigma, window, n, B, C, K=None, T=None, blob=False):
    pos, batch = points(rng, n, dim, B)
    if blob:  # crowd the points into a few tiles: many rows per tile
        pos *= 0.1
    plan = tp.build_plan_device(pos, batch, N=N, m=m, sigma=sigma, batch_size=B, K=K,
                                T=T, window=window, device=dev)
    x = torch.from_numpy(rng.standard_normal((n, C)).astype(np.float32)).to(dev)
    vals = binned.slot_values(plan, x)
    tid = binned.dense_tile_ids(plan)
    got = contract.spread_tiles_dense(plan, vals, tid, plan.NT)
    ref = contract.spread_tiles_dense_plain(plan, vals, tid, plan.NT)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= 1e-5
    visited = torch.zeros(plan.NT, dtype=torch.bool, device=dev)
    visited[tid.long()] = True
    assert bool((got[~visited] == 0).all())  # tiles no row visits stay 0

    g = torch.randn((B, C) + (plan.M,) * dim, device=dev)
    tiles = unfold_grid_to_tiles(g, plan)
    tid = row_tile_ids(plan)
    got = contract.gather_points(plan, tiles, tid)
    ref = contract.gather_points_plain(plan, tiles, tid)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= 1e-5
    return plan


@pytest.mark.parametrize(
    "dim,N,m,sigma,window,n,B,C",
    [
        (1, 64, 2, 2.0, "gaussian", 3000, 1, 1),
        (2, 32, 3, 2.0, "es", 5000, 2, 2),
        (3, 16, 2, 1.625, "es", 20000, 1, 1),
        (3, 32, 4, 1.25, "kb", 20000, 2, 3),
    ],
)
def test_kernels_match_plain(card, rng, dim, N, m, sigma, window, n, B, C):
    _kernels_vs_plain(rng, card, dim, N, m, sigma, window, n, B, C)


def test_kernels_multirow_tiles(card, rng):
    plan = _kernels_vs_plain(rng, card, 3, 16, 2, 2.0, "es", 20000, 1, 2, K=128, blob=True)
    tid = row_tile_ids(plan)
    assert int(torch.unique(tid).numel()) < plan.S  # some tile has several rows


def test_spread_tile_beyond_shared_memory(card, rng):
    """T=32, m=3: a 39^3-cell tile (237 KB per channel) exceeds a block's
    shared memory, so the spread accumulates straight in global memory."""
    plan = _kernels_vs_plain(rng, card, 3, 32, 3, 2.0, "es", 4000, 1, 1, T=32)
    assert plan.H**3 * 4 > 232448


def test_entry_points_run_on_the_card_by_default(card, rng):
    pos, batch = points(rng, 5000, 3, 2)
    x = rng.standard_normal((5000, 2)).astype(np.float32)
    kw = dict(batch_size=2, N=16, m=2, sigma=1.625, window="es")
    s0, g0 = contract.spread_tiles_dense.launches, contract.gather_points.launches
    z = tp.nfft_pair_planar(x, pos, batch, **kw)
    assert z.device.type == "cuda" and z.shape == (5000, 2)
    assert contract.spread_tiles_dense.launches == s0 + 1
    assert contract.gather_points.launches == g0 + 1
    z_cpu = tp.nfft_pair_planar(x, pos, batch, device="cpu", **kw)
    assert _rel(z.cpu(), z_cpu) <= 1e-5


def test_build_is_plain_nvcc_for_sm90a(card):
    res = _build.build()
    assert res.path.is_file() and "sm_90a" in " ".join(_build.NVCC_FLAGS)
    for src in _build.CSRC.glob("*.cu"):
        assert "torch/extension.h" not in src.read_text()
