"""Card-only tests of the PyTorch port: the CUDA kernels against their plain
PyTorch versions, and the entry points and their gradients on the card.

Marked ``cuda``; each test skips (inside the ``card`` fixture) where no CUDA
card is present. This file imports neither JAX nor the JAX package, so it
also runs on a machine with the card and without JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

Kernel and plain version agree to rel-L2 1e-5: they sum the same float32
products in another order (the spread's wide-tile design in the order of its
atomics). The spread's contraction designs sum each output over the points
in slot order, so two launches, and launches with other chunk and band
sizes, give the same bits (the tensor design, in double, to a float32
ulp).
The permutation kernels (ragged rows, Benes network) and the bitonic sort
move words and agree with their plain versions bit for bit, as does the
unfold; the fold sums each cell's terms in a fixed order, so two launches
give the same bits.
Gradients on the card agree with the same call on the CPU (the plain
versions) to rel-L2 3e-5, the bar of the transforms against JAX. Tests
that mean the kernels pass ``strategy="binned"``: without a plan, small
calls run the plan-free engines (the "auto" rule).
"""

import dataclasses
import math
import re
import types

import numpy as np
import pytest
import torch
from _torch_port import points

import torch_nfft_tpu_torch as tp
from torch_nfft_tpu_torch import _build, _native
from torch_nfft_tpu_torch.ops import benes, binned, bitonic, contract, ragged, tilefold
from torch_nfft_tpu_torch.ops.tilefold import row_tile_ids, unfold_grid_to_tiles

KERNELS = ("spread_tiles_dense", "gather_points", "pos_grad")
DESIGNS = ("contraction", "tensor", "wide")

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


def _force_design(monkeypatch, design):
    """Make every spread take ``design`` (None: the geometry decides)."""
    if design is not None:
        ratio = 0.0 if design == "wide" else float("inf")
        monkeypatch.setattr(contract, "DENSE_RATIO_MAX", {1: ratio})
        monkeypatch.setattr(contract, "TENSOR_DIMS",
                            frozenset({1, 2, 3} if design == "tensor" else ()))
        monkeypatch.setattr(contract, "TENSOR_ROWS", 1 << 30)


class _Designs:
    """Counts the launches of ``wrapper`` per design inside a with block."""

    def __init__(self, wrapper):
        self.wrapper = wrapper

    def __enter__(self):
        self.before = dict(self.wrapper.launches_by_design)
        return self

    def __exit__(self, *exc):
        self.ran = {k: v - self.before[k] for k, v in self.wrapper.launches_by_design.items()}
        return False


def _kernels_vs_plain(rng, dev, dim, N, m, sigma, window, n, B, C, K=None, T=None, blob=False,
                      design=None):
    pos, batch = points(rng, n, dim, B)
    if blob:  # crowd the points into a few tiles: many rows per tile
        pos *= 0.1
    plan = tp.build_plan_device(pos, batch, N=N, m=m, sigma=sigma, batch_size=B, K=K,
                                T=T, window=window, device=dev)
    x = torch.from_numpy(rng.standard_normal((n, C)).astype(np.float32)).to(dev)
    vals = binned.slot_values(plan, x)
    tid = binned.dense_tile_ids(plan)
    with _Designs(contract.spread_tiles_dense) as ran:
        got = contract.spread_tiles_dense(plan, vals, tid, plan.NT)
    if design is not None:
        assert ran.ran[design] == 1
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


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize(
    "dim,N,m,sigma,window,n,B,C",
    [
        (1, 64, 2, 2.0, "gaussian", 3000, 1, 1),
        (2, 32, 3, 2.0, "es", 5000, 2, 2),
        (3, 16, 2, 1.625, "es", 20000, 1, 1),
        (3, 32, 4, 1.25, "kb", 20000, 2, 3),
        (3, 16, 2, 1.625, "es", 20000, 1, 8),
    ],
)
def test_kernels_match_plain(card, rng, monkeypatch, dim, N, m, sigma, window, n, B, C, design):
    _force_design(monkeypatch, design)
    _kernels_vs_plain(rng, card, dim, N, m, sigma, window, n, B, C, design=design)


def test_kernels_multirow_tiles(card, rng):
    plan = _kernels_vs_plain(rng, card, 3, 16, 2, 2.0, "es", 20000, 1, 2, K=128, blob=True)
    tid = row_tile_ids(plan)
    assert int(torch.unique(tid).numel()) < plan.S  # some tile has several rows


def test_spread_tile_beyond_shared_memory(card, rng, monkeypatch):
    """T=32, m=3: a 39^3-cell tile (237 KB per channel) exceeds a block's
    shared memory, so the wide-tile design, forced here (the rule takes the
    culled tensor design there), accumulates straight in global memory."""
    _force_design(monkeypatch, "wide")
    plan = _kernels_vs_plain(rng, card, 3, 32, 3, 2.0, "es", 4000, 1, 1, T=32, design="wide")
    assert plan.H**3 * 4 > 232448


def _headline_like(rng, dev, C, n=40000, K=None):
    """A 3D plan binned like the headline (T=8, m=2, es, sigma=1.625: H=13)
    and slot values of C columns."""
    pos, batch = points(rng, n, 3, 1)
    plan = tp.build_plan_device(pos, batch, N=32, m=2, sigma=1.625, batch_size=1, T=8, K=K,
                                window="es", device=dev)
    x = torch.from_numpy(rng.standard_normal((n, C)).astype(np.float32)).to(dev)
    return plan, binned.slot_values(plan, x)


@pytest.mark.parametrize("C", [1, 8])
def test_headline_like_spreads_take_the_contraction(card, rng, C):
    """3D, T=8, m=2 (the headline's tiles): both spreads run a contraction,
    on the tensor cores (the "tensor" design) at C = 1, in FP32 register
    tiles at C = 8 (104 rows on 169 columns), and agree with their plain
    versions."""
    plan, vals = _headline_like(rng, card, C)
    assert plan.H == 13
    tid = binned.dense_tile_ids(plan)
    with _Designs(contract.spread_tiles_dense) as dense, _Designs(contract.spread_tiles) as rows:
        got_d = contract.spread_tiles_dense(plan, vals, tid, plan.NT)
        got_r = contract.spread_tiles(plan, vals)
    want = "tensor" if C == 1 else "contraction"
    assert dense.ran == rows.ran == {"contraction": 0, "tensor": 0, "wide": 0,
                                     "tensor_culled": 0, want: 1}
    assert _rel(got_d, contract.spread_tiles_dense_plain(plan, vals, tid, plan.NT)) <= 1e-5
    assert _rel(got_r, contract.spread_tiles_plain(plan, vals)) <= 1e-5


@pytest.mark.parametrize("C", [1, 8])
def test_contraction_spreads_repeat_bit_for_bit(card, rng, monkeypatch, C):
    """Two launches on the same input give the same bits, and so do
    launches with other chunk and band sizes."""
    _force_design(monkeypatch, "contraction")
    plan, vals = _headline_like(rng, card, C, K=128)
    tid = binned.dense_tile_ids(plan)
    runs = {
        "dense": lambda: contract.spread_tiles_dense(plan, vals, tid, plan.NT),
        "rows": lambda: contract.spread_tiles(plan, vals),
    }
    want = {k: f() for k, f in runs.items()}
    for k, f in runs.items():
        assert torch.equal(f(), want[k])
    for KC, R in ((8, 8), (64, None), (5, 13)):
        d = contract.spread_design(3, plan.H, plan.m, C, KC=KC, R=R)
        assert d.name == "contraction"
        assert torch.equal(contract.spread_tiles_dense(plan, vals, tid, plan.NT, design=d),
                           want["dense"]), (KC, R)
        assert torch.equal(contract.spread_tiles(plan, vals, design=d), want["rows"]), (KC, R)


def _within_an_ulp(a, b):
    """Every float32 of ``a`` within one ulp of ``b``'s."""
    big = torch.maximum(a.abs(), b.abs())
    return bool(((a - b).abs() <= torch.nextafter(big, big + 1) - big).all())


@pytest.mark.parametrize("C", [1, 8])
def test_tensor_spreads_repeat_bit_for_bit(card, rng, C):
    """The tensor design: two launches on the same input give the same bits;
    launches with other chunk sizes, band sizes and warps a block agree to
    a float32 ulp."""
    plan, vals = _headline_like(rng, card, C, K=128)
    tid = binned.dense_tile_ids(plan)
    tensor = contract.spread_design(3, plan.H, plan.m, C, name="tensor")
    runs = {
        "dense": lambda d=tensor: contract.spread_tiles_dense(plan, vals, tid, plan.NT, design=d),
        "rows": lambda d=tensor: contract.spread_tiles(plan, vals, design=d),
    }
    want = {k: f() for k, f in runs.items()}
    for k, f in runs.items():
        assert torch.equal(f(), want[k])
    for KC, R, warps in ((8, 8, None), (64, None, None), (16, 13, 4), (None, None, 16)):
        d = contract.spread_design(3, plan.H, plan.m, C, name="tensor", KC=KC, R=R,
                                   warps=warps)
        for k, f in runs.items():
            assert _within_an_ulp(f(d), want[k]), (k, KC, R, warps)


def _f64_spread(plan, vals, tid=None, NT=None):
    """The plain spread of the same plan in float64, windows and sums: the
    per-row tiles, or with ``tid`` the NT dense tiles."""
    p64 = dataclasses.replace(plan, slot_pos=plan.slot_pos.double())
    v64 = vals.double()
    C, H, dim = vals.shape[0], plan.H, plan.dim
    rows = plan.S if tid is None else NT
    out = torch.zeros((rows, C * H**dim), dtype=torch.float64, device=vals.device)
    for r0, r1 in contract._row_chunks(plan.S, plan.K, H, dim, 2 * C):
        t = contract._spread_rows(p64, v64, r0, r1)
        if tid is None:
            out[r0:r1] = t
        else:
            out.index_add_(0, tid[r0:r1].long(), t)
    return out.reshape(rows, C, H, H ** (dim - 1))


def _cell_plan(rng, dev, cell, n):
    """A plan at a benchmark cell's geometry on n of its points: the Gram
    operator's (GaussianKernel(0.4, dim=3, bandwidth=256, cutoff=4) on
    [-1, 1)^3: gaussian, m = 4, T = 16, H = 25) or the headline pair's (es,
    m = 2, sigma = 1.625, N = 256 on [-1/4, 1/4)^3: T = 8 as the cell's 2^24
    points bin, H = 13)."""
    if cell == "gram":
        pts = (rng.random((n, 3)) * 2 - 1).astype(np.float32)
        plan = tp.GaussianKernel(0.4, dim=3, bandwidth=256, cutoff=4, device=dev)(pts)._plans()[0]
        assert (plan.H, plan.m) == (25, 4)
        # the device arrays alone (the host builder's sorted layout dropped)
        return dataclasses.replace(plan, pos_fp=None, order=None, row_start=None, S_occ=None)
    pos = ((rng.random((n, 3)) - 0.5) / 2).astype(np.float32)
    plan = tp.build_plan_device(pos, None, N=256, m=2, sigma=1.625, batch_size=1, window="es",
                                T=8, device=dev)
    assert (plan.H, plan.m) == (13, 2)
    return plan


@pytest.mark.parametrize("cell,C,kernel", [("gram", 1, "B1"), ("pair", 1, "B1"),
                                           ("gram", 8, "B7")])
def test_tensor_spread_at_the_cells_geometries(card, rng, cell, C, kernel):
    """B1 at both benchmark geometries and B7 at the Gram C = 8, on 2^20
    of a cell's points: the cell's design is the tensor one, launched once
    a spread; against a float64 plain spread of the same plan its tiles are
    no further off than the FP32 contraction's; a second launch gives the
    same bits; tiles no row visits, and an empty row, are exact zeros."""
    plan = _with_empty_row(_cell_plan(rng, card, cell, 1 << 20), card)
    x = torch.from_numpy(rng.standard_normal((plan.n, C)).astype(np.float32)).to(card)
    vals = binned.slot_values(plan, x)
    d = contract.spread_design(3, plan.H, plan.m, C)
    assert d.name == "tensor"
    fp32 = contract.spread_design(3, plan.H, plan.m, C, name="contraction")
    if kernel == "B1":
        tid = binned.dense_tile_ids(plan)
        wrapper = contract.spread_tiles_dense

        def run(design=None):
            return wrapper(plan, vals, tid, plan.NT, design=design)

        ref = _f64_spread(plan, vals, tid, plan.NT)
    else:
        wrapper = contract.spread_tiles

        def run(design=None):
            return wrapper(plan, vals, design=design)

        ref = _f64_spread(plan, vals)
    with _Designs(wrapper) as ran:
        got = run()
    assert ran.ran == {"contraction": 0, "tensor": 1, "wide": 0, "tensor_culled": 0}
    rel_tensor, rel_fp32 = _rel(got, ref), _rel(run(fp32), ref)
    print(f"{cell} C={C} {kernel}: rel-L2 to float64 tensor {rel_tensor:.3e} "
          f"contraction {rel_fp32:.3e}")
    assert rel_tensor <= rel_fp32
    assert torch.equal(run(), got)
    if kernel == "B1":
        visited = torch.zeros(plan.NT, dtype=torch.bool, device=card)
        visited[tid.long()] = True
        assert bool((got[~visited] == 0).all())
    else:
        assert bool((got[-1] == 0).all())


def _member_plan(rng, dev, n=1 << 17):
    """A plan at a streamed member's geometry (the batch3d-16x21 cell's):
    n points in [-1/4, 1/4)^3, N = 256, gaussian m = 4, sigma = 2, T = 32,
    so M = 512, H = 41: a wide accumulator of 2 x 41^3 floats exceeds
    shared memory, and (41 / 10)^3 = 68.9 exceeds the ratio limit."""
    pos = ((rng.random((n, 3)) - 0.5) / 2).astype(np.float32)
    plan = tp.build_plan_device(pos, None, N=256, m=4, sigma=2.0, batch_size=1,
                                window="gaussian", T=32, device=dev)
    assert (plan.M, plan.H, plan.m) == (512, 41, 4)
    return plan


@pytest.mark.parametrize("kernel", ["B1", "B7"])
def test_culled_tensor_spread_at_the_member_geometry(card, rng, kernel):
    """B1 and B7 at a streamed member's tiles (H = 41, C = 2, 2^17 points,
    an empty row appended): the rule takes the tensor design, culled, and
    launches it once; against a float64 plain spread of the same plan its
    tiles are no further off than the wide design's; they equal the
    unculled tensor design's to a float32 ulp; both repeat bit for bit;
    unvisited tiles and the empty row are exact zeros."""
    C = 2
    plan = _with_empty_row(_member_plan(rng, card), card)
    x = torch.from_numpy(rng.standard_normal((plan.n, C)).astype(np.float32)).to(card)
    vals = binned.slot_values(plan, x)
    d = contract.spread_design(3, plan.H, plan.m, C)
    assert d.name == "tensor" and d.cull
    wide = contract.spread_design(3, plan.H, plan.m, C, name="wide")
    unculled = contract.spread_design(3, plan.H, plan.m, C, name="tensor", cull=False)
    if kernel == "B1":
        tid = binned.dense_tile_ids(plan)
        wrapper = contract.spread_tiles_dense

        def run(design=None):
            return wrapper(plan, vals, tid, plan.NT, design=design)

        ref = _f64_spread(plan, vals, tid, plan.NT)
    else:
        wrapper = contract.spread_tiles

        def run(design=None):
            return wrapper(plan, vals, design=design)

        ref = _f64_spread(plan, vals)
    with _Designs(wrapper) as ran:
        got = run()
    assert ran.ran == {"contraction": 0, "tensor": 1, "wide": 0, "tensor_culled": 1}
    full = run(unculled)
    rel_culled, rel_wide, rel_full = _rel(got, ref), _rel(run(wide), ref), _rel(full, ref)
    print(f"member C={C} {kernel}: rel-L2 to float64 culled {rel_culled:.3e} unculled "
          f"{rel_full:.3e} wide {rel_wide:.3e}")
    assert rel_culled <= rel_wide
    assert _within_an_ulp(got, full)
    assert torch.equal(run(), got) and torch.equal(run(unculled), full)
    if kernel == "B1":
        visited = torch.zeros(plan.NT, dtype=torch.bool, device=card)
        visited[tid.long()] = True
        assert bool((got[~visited] == 0).all())
    else:
        assert bool((got[-1] == 0).all())


@pytest.mark.parametrize("dim,N,m,T,C,blob,kw", [
    (3, 32, 4, 16, 1, False, dict(warps=4)),  # four column bands
    (3, 32, 4, 16, 3, True, {}),  # three row bands; many rows a tile
    (3, 32, 3, 8, 8, False, dict(R=24, warps=4)),
    (3, 64, 4, 32, 2, False, dict(KC=16)),  # the member's tiles, chunks of 16
    (2, 64, 3, 32, 2, False, dict(warps=1)),
])
def test_culled_tensor_spreads_match_the_unculled(card, rng, dim, N, m, T, C, blob, kw):
    """Culling forced on small plans (an empty row appended; a band that is
    a strict part of the tile, other chunk, band and warp sizes): B1 and B7
    agree with their plain versions to 1e-5 and with the unculled tensor
    design to a float32 ulp, and repeat bit for bit."""
    n = 6000 if dim == 3 else 3000
    pos, batch = points(rng, n, dim, 1)
    if blob:
        pos *= 0.1
    plan = tp.build_plan_device(pos, batch, N=N, m=m, sigma=2.0, batch_size=1, T=T,
                                window="kb", device=card)
    plan = _with_empty_row(plan, card)
    x = torch.from_numpy(rng.standard_normal((plan.n, C)).astype(np.float32)).to(card)
    vals = binned.slot_values(plan, x)
    tid = binned.dense_tile_ids(plan)
    culled = contract.spread_design(dim, plan.H, plan.m, C, name="tensor", cull=True, **kw)
    full = contract.spread_design(dim, plan.H, plan.m, C, name="tensor", cull=False, **kw)
    assert culled.cull and not full.cull and culled.row_bands * culled.col_bands > 1
    for run, plain in (
            (lambda d: contract.spread_tiles_dense(plan, vals, tid, plan.NT, design=d),
             lambda: contract.spread_tiles_dense_plain(plan, vals, tid, plan.NT)),
            (lambda d: contract.spread_tiles(plan, vals, design=d),
             lambda: contract.spread_tiles_plain(plan, vals))):
        got = run(culled)
        assert _rel(got, plain()) <= 1e-5
        assert _within_an_ulp(got, run(full))
        assert torch.equal(run(culled), got)


def test_tensor_entry_points_match_the_contraction(card, rng, monkeypatch):
    """The pair, a training step's gradients and ``G @ x`` with every spread
    on the tensor design (two a step) agree with the same calls on the FP32
    contraction to rel-L2 1e-6."""
    from torch_nfft_tpu_torch import trace

    n = 1 << 16
    pos = ((rng.random((n, 3)) - 0.5) / 2).astype(np.float32)
    x0 = torch.from_numpy(rng.standard_normal((n, 1)).astype(np.float32)).to(card)
    w = torch.from_numpy(rng.standard_normal((n, 1)).astype(np.float32)).to(card)
    pts = (rng.random((n, 3)) * 2 - 1).astype(np.float32)
    G = tp.GaussianKernel(0.4, dim=3, bandwidth=64, cutoff=4)(pts)
    kw = dict(batch_size=1, N=64, m=2, sigma=1.625, window="es", strategy="binned")
    out = {}
    for design in ("tensor", "contraction"):
        if design == "contraction":
            _force_design(monkeypatch, design)
        before = trace.counters()
        x = x0.clone().requires_grad_()
        p = torch.from_numpy(pos).to(card).requires_grad_()
        z = tp.nfft_pair_planar(x, p, None, **kw)
        (z * w).sum().backward()
        y = G @ x0
        after = trace.counters()
        ran = {k: after[f"spread_tiles_dense.{k}"] - before[f"spread_tiles_dense.{k}"]
               for k in DESIGNS}
        assert ran == {"contraction": 0, "tensor": 0, "wide": 0, design: 3}, ran
        out[design] = (z.detach(), x.grad, p.grad, y)
    for name, a, b in zip(("pair", "x.grad", "pos.grad", "G @ x"), *out.values()):
        assert _rel(a, b) <= 1e-6, name


def test_entry_points_run_on_the_card_by_default(card, rng):
    pos, batch = points(rng, 5000, 3, 2)
    x = rng.standard_normal((5000, 2)).astype(np.float32)
    kw = dict(batch_size=2, N=16, m=2, sigma=1.625, window="es", strategy="binned")
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


def _with_empty_row(plan, dev):
    """The plan with one empty row (row_count 0, origin 0) appended, as plan
    stacks pad them."""
    arrays, statics = tp.plan_to_numpy(plan)
    S, K, dim = plan.S, plan.K, plan.dim
    pad = {"slot_pt": np.zeros((1, K), np.int32), "origin": np.zeros((1, dim), np.int32),
           "row_batch": np.zeros(1, np.int32), "row_count": np.zeros(1, np.int32),
           "slot_pos": np.zeros((dim, K), np.float32),
           "fill_keys": np.arange(S * K, (S + 1) * K, dtype=np.int32)}
    ax = {"slot_pos": 1}
    arrays = {k: np.concatenate([v, pad[k]], axis=ax.get(k, 0)) for k, v in arrays.items()}
    return tp.plan_from_numpy(arrays, **statics, device=dev)


@pytest.mark.parametrize("dim,N,m,sigma,window,n", [
    (1, 64, 2, 2.0, "gaussian", 3000),
    (2, 32, 3, 2.0, "es", 5000),
    (3, 16, 2, 1.625, "es", 20000),
    (3, 16, 4, 1.25, "kb", 8000),
    (2, 16, 2, 2.0, "kb", 4000),
])
@pytest.mark.parametrize("C", [1, 3])
def test_pos_grad_matches_plain(card, rng, dim, N, m, sigma, window, n, C):
    B = 2
    pos, batch = points(rng, n, dim, B)
    plan = tp.build_plan_device(pos, batch, N=N, m=m, sigma=sigma, batch_size=B,
                                window=window, device=card)
    plan = _with_empty_row(plan, card)
    tiles = unfold_grid_to_tiles(torch.randn((B, C) + (plan.M,) * dim, device=card), plan)
    w = torch.randn((C, plan.S * plan.K), device=card)
    tid = row_tile_ids(plan)
    got = contract.pos_grad(plan, tiles, w, tid)
    ref = contract.pos_grad_plain(plan, tiles, w, tid)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= 1e-5
    assert bool((got[-1] == 0).all())  # the empty row
    kmask = torch.arange(plan.K, device=card)[None, :] < plan.row_count[:, None]
    assert bool((got.transpose(1, 2)[~kmask] == 0).all())  # padded slots


# The gather (B2) and the position gradient (B5) in several launch layouts
# (None: the default; threads a block, the lanes' order), the row's tile
# staged in shared memory or, beyond the opt-in limit, read from global
# memory.
POINT_CASES = [
    # dim, N, m, sigma, window, n, C, T, staged
    (1, 64, 1, 2.0, "gaussian", 3000, 1, None, True),
    (1, 64, 9, 2.0, "es", 3000, 3, None, True),
    (2, 32, 2, 2.0, "kb", 5000, 8, None, True),
    (2, 32, 3, 2.0, "es", 5000, 1, None, True),
    (2, 16, 9, 2.0, "gaussian", 4000, 3, None, True),
    (3, 16, 1, 2.0, "es", 20000, 3, None, True),
    (3, 16, 2, 1.625, "es", 20000, 8, 8, True),  # the headline's tiles, H = 13
    (3, 16, 3, 2.0, "kb", 8000, 1, None, True),
    (3, 16, 4, 1.25, "gaussian", 8000, 8, None, False),  # 8 x 25^3 floats
    (3, 8, 9, 2.0, "kb", 3000, 1, None, True),  # L = 20
    (3, 32, 4, 2.0, "es", 3000, 16, 16, False),  # 16 x 25^3 floats
    (3, 32, 3, 2.0, "es", 3000, 1, 32, False),  # 39^3 floats
]


@pytest.mark.parametrize("lay_kw", [None, dict(threads=64), dict(sort=False)])
@pytest.mark.parametrize("dim,N,m,sigma,window,n,C,T,staged", POINT_CASES)
def test_points_kernels_match_plain(card, rng, dim, N, m, sigma, window, n, C, T, staged,
                                    lay_kw):
    """Both kernels against their plain versions (rel-L2 1e-5), padded slots
    and an empty row exactly 0, per-row tiles at C = 8 (the flat route's)
    and dense tiles else, the tile staged in shared memory or read from
    global memory; the default layout bit for bit across launches."""
    B = 2
    pos, batch = points(rng, n, dim, B)
    plan = tp.build_plan_device(pos, batch, N=N, m=m, sigma=sigma, batch_size=B, T=T,
                                window=window, device=card)
    plan = _with_empty_row(plan, card)
    g = torch.randn((B, C) + (plan.M,) * dim, device=card)
    if C == 8:
        tiles = binned.grid_to_tiles(plan, g)
        tid = torch.arange(plan.S, dtype=torch.int32, device=card)
    else:
        tiles, tid = unfold_grid_to_tiles(g, plan), row_tile_ids(plan)
    w = torch.randn((C, plan.S * plan.K), device=card)
    lays = {name: None if lay_kw is None else contract.points_layout(name, dim, plan.H, C,
                                                                      plan.K, **lay_kw)
            for name in ("gather_points", "pos_grad")}
    assert contract.points_layout("pos_grad", dim, plan.H, C, plan.K).staged == staged
    kmask = torch.arange(plan.K, device=card)[None, :] < plan.row_count[:, None]
    for name, run, plain in (
            ("gather_points", lambda: contract.gather_points(plan, tiles, tid,
                                                             lays["gather_points"]),
             lambda: contract.gather_points_plain(plan, tiles, tid)),
            ("pos_grad", lambda: contract.pos_grad(plan, tiles, w, tid, lays["pos_grad"]),
             lambda: contract.pos_grad_plain(plan, tiles, w, tid))):
        before = getattr(contract, name).launches
        got = run()
        ref = plain()
        torch.cuda.synchronize()
        assert getattr(contract, name).launches == before + 1
        assert _rel(got, ref) <= 1e-5, name
        assert bool((got[-1] == 0).all()), name  # the empty row
        assert bool((got.transpose(1, 2)[~kmask] == 0).all()), name  # padded slots
        if lay_kw is None:
            assert torch.equal(run(), got), name


@pytest.mark.parametrize("C", [1, 8])
def test_points_layouts_repeat_bit_for_bit(card, rng, C):
    """Threads a block and the lanes' order do not change a bit."""
    plan, vals = _headline_like(rng, card, C)
    g = torch.randn((1, C) + (plan.M,) * 3, device=card)
    tiles = binned.grid_to_tiles(plan, g)
    tid = torch.arange(plan.S, dtype=torch.int32, device=card)
    kw = [dict(threads=t, sort=srt) for t, srt in ((256, True), (64, True), (128, False),
                                                    (32, False))]
    outs = [(contract.gather_points(plan, tiles, tid, contract.points_layout(
                "gather_points", 3, plan.H, C, plan.K, **k)),
             contract.pos_grad(plan, tiles, vals, tid, contract.points_layout(
                 "pos_grad", 3, plan.H, C, plan.K, **k)))
            for k in kw]
    assert outs[0][0].shape == (plan.S, C, plan.K)
    for (y, d), k in zip(outs[1:], kw[1:]):
        assert torch.equal(y, outs[0][0]) and torch.equal(d, outs[0][1]), k


@pytest.mark.parametrize("entry", ["adjoint", "forward", "pair", "adjoint_planar",
                                   "forward_planar"])
def test_card_entry_points_raise_beyond_the_window_widths(card, rng, entry):
    """m = 10 (22 window cells, past contract.MAX_L): every entry point
    raises ValueError on the card before it builds a plan or launches."""
    n, m = 500, 10
    pos, _ = points(rng, n, 1)
    x = rng.standard_normal((n, 1)).astype(np.float32)
    spec = rng.standard_normal((1, 32, 1)).astype(np.float32)
    kw = dict(m=m, sigma=2.0, window="gaussian", strategy="binned")
    calls = {
        "adjoint": lambda: tp.nfft_adjoint(x, pos, N=32, **kw),
        "forward": lambda: tp.nfft_forward(spec, pos, **kw),
        "pair": lambda: tp.nfft_pair_planar(x, pos, batch_size=1, N=32, **kw),
        "adjoint_planar": lambda: tp.nfft_adjoint_planar(x, pos, batch_size=1, N=32, **kw),
        "forward_planar": lambda: tp.nfft_forward_planar(spec, None, pos, batch_size=1,
                                                         dim=1, **kw),
    }
    names = KERNELS + ("spread_tiles",)
    before = {k: getattr(contract, k).launches for k in names}
    with pytest.raises(ValueError, match="2m\\+2 <= 20"):
        calls[entry]()
    assert {k: getattr(contract, k).launches for k in names} == before


def _loss_grads(fn, x, pos, w, dev):
    """x.grad and pos.grad of <fn(x, pos), w> with x, pos as leaves on dev."""
    xl = torch.as_tensor(x, device=dev).clone().requires_grad_()
    pl = torch.as_tensor(pos, device=dev).clone().requires_grad_()
    out = fn(xl, pl, dev)
    out = torch.view_as_real(out) if out.is_complex() else out
    (out * torch.as_tensor(w, device=dev)).sum().backward()
    return xl.grad.cpu(), pl.grad.cpu()


@pytest.mark.parametrize("entry", ["pair", "adjoint"])
def test_gradients_on_the_card_match_the_cpu(card, rng, entry):
    n, dim, N, B = 6000, 3, 16, 2
    pos, batch = points(rng, n, dim, B)
    x = rng.standard_normal((n, 2)).astype(np.float32)
    kw = dict(batch_size=B, m=2, sigma=1.625, window="es", strategy="binned")
    if entry == "pair":
        w = rng.standard_normal((n, 2)).astype(np.float32)

        def fn(a, p, d):
            return tp.nfft_pair_planar(a, p, batch, N=N, device=d, **kw)
    else:
        w = rng.standard_normal((B,) + (N,) * dim + (2, 2)).astype(np.float32)

        def fn(a, p, d):
            return tp.nfft_adjoint(a, p, batch, N=N, device=d, **kw)
    gx, gp = _loss_grads(fn, x, pos, w, card)
    rx, rp = _loss_grads(fn, x, pos, w, "cpu")
    assert _rel(gx, rx) <= 3e-5 and _rel(gp, rp) <= 3e-5


def test_training_step_launches_each_kernel_twice(card, rng):
    n = 5000
    pos, _ = points(rng, n, 3)
    x = torch.from_numpy(rng.standard_normal((n, 1)).astype(np.float32)).to(card)
    p = torch.from_numpy(pos).to(card)
    x.requires_grad_()
    p.requires_grad_()
    before = {k: getattr(contract, k).launches for k in KERNELS}
    z = tp.nfft_pair_planar(x, p, None, batch_size=1, N=16, m=2, sigma=1.625, window="es",
                            strategy="binned")
    (z * torch.randn_like(z)).sum().backward()
    torch.cuda.synchronize()
    assert {k: getattr(contract, k).launches - before[k] for k in KERNELS} == dict.fromkeys(
        KERNELS, 2)
    assert x.grad.shape == (n, 1) and p.grad.shape == (n, 3)


def test_training_step_folds_twice_and_unfolds_three_times(card, rng):
    """The pair folds once and unfolds once; its backward folds the point
    cotangent and unfolds the grid cotangent and the primal grid."""
    n = 5000
    pos, _ = points(rng, n, 3)
    x = torch.from_numpy(rng.standard_normal((n, 1)).astype(np.float32)).to(card)
    p = torch.from_numpy(pos).to(card).requires_grad_()
    wrappers = (tilefold.fold_tiles_to_grid, tilefold.unfold_grid_to_tiles)
    before = [w.launches for w in wrappers]
    z = tp.nfft_pair_planar(x.requires_grad_(), p, None, batch_size=1, N=16, m=2,
                            sigma=1.625, window="es", strategy="binned")
    assert [w.launches - b for w, b in zip(wrappers, before)] == [1, 1]
    (z * torch.randn_like(z)).sum().backward()
    torch.cuda.synchronize()
    assert [w.launches - b for w, b in zip(wrappers, before)] == [2, 3]


# ---------------------------------------------------------------------------
# The dense route's fold and unfold (csrc/tilefold.cu) against their plain
# versions. The unfold copies, so it agrees bit for bit; the fold sums the
# same float32 terms as the plain fold in another order (rel-L2 1e-5, the
# file's bar), and in a fixed order, so two launches give the same bits.
# ---------------------------------------------------------------------------

# (M, T, H) per dim, M % T != 0 in 1D and 3D (3D: the plan of N = 16,
# sigma = 1.625, m = 2, as in test_fold_unfold_match_jax)
FOLD_GEOMETRIES = {1: (70, 8, 13), 2: (48, 8, 13), 3: (26, 16, 21)}
# extended axes that wrap more than once (M = 10, T = 8: 21 cells), and
# J = ceil(H / T) = 4: more than two terms a cell, the kernel's loop
FOLD_ODD = [(1, 10, 8, 13), (2, 10, 8, 13), (3, 10, 8, 13), (2, 32, 4, 13), (3, 26, 8, 13)]
# the benchmark's geometries: Gram (gram3d-n22), headline (pair3d-n24)
FOLD_FULL = {"gram": (512, 16, 25), "headline": (416, 8, 13)}


def _fold_unfold_vs_plain(card, dim, M, T, H, B, C):
    plan = types.SimpleNamespace(dim=dim, M=M, T=T, H=H, batch_size=B)
    nb = tilefold.tiles_per_axis(plan)
    gen = torch.Generator(device=card).manual_seed(dim * 1000 + M * 10 + C)
    tiles = torch.randn((B * nb**dim, C, H, H ** (dim - 1)), device=card, generator=gen)
    g = torch.randn((B, C) + (M,) * dim, device=card, generator=gen)
    fold, unfold = tilefold.fold_tiles_to_grid, tilefold.unfold_grid_to_tiles
    before = (fold.launches, unfold.launches)
    got, again, tt = fold(tiles, plan), fold(tiles, plan), unfold(g, plan)
    assert (fold.launches, unfold.launches) == (before[0] + 2, before[1] + 1)
    torch.cuda.synchronize()
    assert got.shape == g.shape and tt.shape == tiles.shape
    assert torch.equal(got, again)
    assert _rel(got, tilefold.fold_tiles_to_grid_plain(tiles, plan)) <= 1e-5
    assert torch.equal(tt, tilefold.unfold_grid_to_tiles_plain(g, plan))
    # the adjoint identity <fold(t), g> = <t, unfold(g)>, summed in float64
    lhs = float((got.double() * g.double()).sum())
    rhs = float((tiles.double() * tt.double()).sum())
    scale = float(torch.linalg.vector_norm(got.double()) * torch.linalg.vector_norm(g.double()))
    assert abs(lhs - rhs) <= 1e-6 * scale


@pytest.mark.parametrize("C", [1, 2, 8])
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_fold_unfold_kernels_match_plain(card, dim, B, C):
    _fold_unfold_vs_plain(card, dim, *FOLD_GEOMETRIES[dim], B, C)


@pytest.mark.parametrize("dim,M,T,H", FOLD_ODD)
def test_fold_unfold_kernels_wrap_and_overlap(card, dim, M, T, H):
    _fold_unfold_vs_plain(card, dim, M, T, H, 2, 2)


@pytest.mark.parametrize("geometry", sorted(FOLD_FULL))
def test_fold_unfold_kernels_at_benchmark_geometries(card, geometry):
    _fold_unfold_vs_plain(card, 3, *FOLD_FULL[geometry], 1, 1)


@pytest.mark.parametrize("view", ["transposed", "column slice", "expanded batch"])
def test_unfold_kernel_reads_a_strided_grid(card, view):
    """The unfold reads the grid through its strides: a view gives the same
    bits as its contiguous copy, and the batch may differ from the plan's."""
    plan = types.SimpleNamespace(dim=3, M=26, T=16, H=21, batch_size=1)
    gen = torch.Generator(device=card).manual_seed(7)
    g = torch.randn((2, 3, 26, 26, 26), device=card, generator=gen)
    g = {"transposed": g.transpose(2, 4), "column slice": g[:, 1:],
         "expanded batch": g[:1, :1].expand(3, 2, 26, 26, 26)}[view]
    before = tilefold.unfold_grid_to_tiles.launches
    got = tilefold.unfold_grid_to_tiles(g, plan)
    assert tilefold.unfold_grid_to_tiles.launches == before + 1
    assert torch.equal(got, tilefold.unfold_grid_to_tiles_plain(g.contiguous(), plan))


# ---------------------------------------------------------------------------
# A grid slab's fold and unfold (csrc/tilefold.cu's slab kernels) against
# their plain versions: axes 1.. wrapped, axis 0 folded onto its E rows past
# the slab and unfolded from the halo. The unfold copies (bit for bit), the
# fold sums in a fixed order (rel-L2 1e-5, two launches bit for bit).
# ---------------------------------------------------------------------------

# (dim, M, T, H, nb0): layouts' geometries (M % T == 0, E <= T), one slab
# tile row, and axes 1.. that wrap more than once (the fold's general loop)
SLAB_GEOMETRIES = [(2, 64, 16, 25, 2), (3, 32, 8, 15, 1), (3, 64, 16, 25, 2),
                   (3, 10, 8, 13, 2), (2, 26, 8, 13, 3)]
# the slab of grid3d-n26: 3D N = 1024, m = 4, sigma = 2, four slabs
SLAB_N1024 = (2048, 16, 25, 32)


def _slab_vs_plain(card, dim, M, T, H, nb0, C, view=False):
    plan = types.SimpleNamespace(dim=dim, M=M, T=T, H=H, batch_size=1)
    nb, E, L0 = tilefold.tiles_per_axis(plan), H - T, nb0 * T
    gen = torch.Generator(device=card).manual_seed(dim * 1000 + M * 10 + C)
    tiles = torch.randn((nb0 * nb ** (dim - 1), C, H, H ** (dim - 1)), device=card,
                        generator=gen)
    rest = (M,) * (dim - 1)
    g = torch.randn((1, C + int(view), L0) + rest, device=card, generator=gen)
    g = g[:, 1:] if view else g
    halo = torch.randn((1, C, E) + rest, device=card, generator=gen)
    fold, unfold = tilefold.fold_tiles_to_slab, tilefold.unfold_slab_to_tiles
    before = (fold.launches, unfold.launches)
    got, again, tt = fold(tiles, plan, nb0), fold(tiles, plan, nb0), unfold(g, halo, plan, nb0)
    assert (fold.launches, unfold.launches) == (before[0] + 2, before[1] + 1)
    torch.cuda.synchronize()
    assert got.shape == (1, C, L0 + E) + rest and tt.shape == tiles.shape
    assert torch.equal(got, again)
    assert _rel(got, tilefold.fold_tiles_to_slab_plain(tiles, plan, nb0)) <= 1e-5
    assert torch.equal(tt, tilefold.unfold_slab_to_tiles_plain(g, halo, plan, nb0))
    # the adjoint identity <fold(t), [g; halo]> = <t, unfold(g, halo)>
    ext = torch.cat([g, halo], dim=2).double()
    lhs, rhs = float((got.double() * ext).sum()), float((tiles.double() * tt.double()).sum())
    scale = float(torch.linalg.vector_norm(got.double()) * torch.linalg.vector_norm(ext))
    assert abs(lhs - rhs) <= 1e-6 * scale


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("dim,M,T,H,nb0", SLAB_GEOMETRIES)
def test_slab_fold_unfold_kernels_match_plain(card, dim, M, T, H, nb0, C):
    _slab_vs_plain(card, dim, M, T, H, nb0, C)


def test_slab_unfold_reads_a_strided_slab(card):
    """The slab unfold reads a column slice of a slab through its strides."""
    _slab_vs_plain(card, 3, 32, 8, 15, 2, 2, view=True)


def test_slab_fold_unfold_at_the_n1024_slab(card):
    """The slab kernels at grid3d-n26's slab (32.8 GB of tiles): the fold
    against its plain version to rel-L2 1e-5, in float64 a block at a
    time; the unfold bit for bit at the first, a middle and the last tile
    row (the last reads the halo)."""
    M, T, H, nb0 = SLAB_N1024
    plan = types.SimpleNamespace(dim=3, M=M, T=T, H=H, batch_size=1)
    nb, E, L0 = M // T, H - T, nb0 * T
    torch.cuda.empty_cache()
    gen = torch.Generator(device=card).manual_seed(1024)
    tiles = torch.randn((nb0 * nb * nb, 1, H, H * H), device=card, generator=gen)
    got = tilefold.fold_tiles_to_slab(tiles, plan, nb0)
    ref = tilefold.fold_tiles_to_slab_plain(tiles, plan, nb0)
    del tiles
    num = den = 0.0
    for a, b in zip(got.reshape(-1, M).split(1 << 15), ref.reshape(-1, M).split(1 << 15)):
        num += float(torch.linalg.vector_norm((a - b).double())) ** 2
        den += float(torch.linalg.vector_norm(b.double())) ** 2
    assert (num / den) ** 0.5 <= 1e-5
    del got, ref
    torch.cuda.empty_cache()
    g = torch.randn((1, 1, L0, M, M), device=card, generator=gen)
    halo = torch.randn((1, 1, E, M, M), device=card, generator=gen)
    tt = tilefold.unfold_slab_to_tiles(g, halo, plan, nb0)
    for t in (0, nb0 // 2, nb0 - 1):
        nxt = halo if t == nb0 - 1 else g[:, :, (t + 1) * T:(t + 1) * T + E]
        want = tilefold.unfold_slab_to_tiles_plain(g[:, :, t * T:(t + 1) * T], nxt, plan, 1)
        assert torch.equal(tt[t * nb * nb:(t + 1) * nb * nb], want), t
    del tt, g, halo
    torch.cuda.empty_cache()


def test_grid_sharded_pair_world_of_one_on_nccl(card, rng, tmp_path):
    """The grid-sharded adjoint and real forward on one NCCL slab (the ring
    shift sends to itself) against the single-device planar pair on the
    card: one slab fold and one slab unfold a pair, no dense-route fold."""
    import datetime

    import torch.distributed as dist

    from torch_nfft_tpu_torch import parallel as par

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = par.make_mesh({"grid": 1})
        n, N, m = 1 << 14, 32, 4
        pos, _ = points(rng, n, 3)
        x = torch.from_numpy(rng.standard_normal((n, 1)).astype(np.float32)).to(card)
        lay = par.build_grid_sharded_layout(pos, n_shards=1, N=N, m=m, T=16)
        moves = (tilefold.fold_tiles_to_slab, tilefold.unfold_slab_to_tiles,
                 tilefold.fold_tiles_to_grid, tilefold.unfold_grid_to_tiles)
        before = [w.launches for w in moves]
        yr, yi = par.nfft_adjoint_grid_sharded(x, lay, mesh)
        z, _ = par.nfft_forward_grid_sharded(yr, yi, lay, mesh, real_output=True)
        torch.cuda.synchronize()
        assert [w.launches - b for w, b in zip(moves, before)] == [1, 1, 0, 0]
        p = torch.from_numpy(pos).to(card)
        rr, ri = tp.nfft_adjoint_planar(x, p, None, batch_size=1, N=N, m=m, strategy="binned")
        assert _rel(torch.stack([yr, yi]), torch.stack([rr, ri])) <= 1e-5
        ref, _ = tp.nfft_forward_planar(rr, ri, p, None, batch_size=1, dim=3, m=m,
                                        real_output=True, strategy="binned")
        assert _rel(z, ref) <= 1e-5
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The permutation kernels: ragged row passes and the Benes network. They move
# 32-bit words, so kernel and plain version agree bit for bit.
# ---------------------------------------------------------------------------

PERMUTE = ("expand_rows", "compact_rows", "benes_outer", "benes_local")


def _permute_launches():
    return {"expand_rows": ragged.expand_rows.launches,
            "compact_rows": ragged.compact_rows.launches,
            "benes_outer": benes.benes_outer.launches,
            "benes_local": benes.benes_local.launches}


def _payload(rng, shape, dtype, dev):
    if dtype == torch.int32:
        a = rng.integers(-(1 << 30), 1 << 30, size=shape).astype(np.int32)
    else:
        a = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(dev)


def _benes_kernels_vs_plain(x, tables, s):
    """Each outer pass, the local pass and the whole network (its launches
    as the schedule says), both directions, bit for bit."""
    q = tables.q
    entry, exit_ = benes.outer_passes(q, min(s, q))
    for reverse in (False, True):
        before = _permute_launches()
        got = benes.apply_benes_(x.clone(), tables, reverse, s)
        after = _permute_launches()
        assert torch.equal(got, benes.apply_benes_plain(x, tables, reverse))
        assert after["benes_outer"] - before["benes_outer"] == len(entry) + len(exit_)
        assert after["benes_local"] - before["benes_local"] == 1
        local = benes.benes_local(x.clone(), tables, s, reverse)
        assert torch.equal(local, benes.benes_local_plain(x, tables, s, reverse))
        for js in entry + exit_:
            out = benes.benes_outer(x.clone(), tables, js, reverse)
            assert torch.equal(out, benes.benes_outer_plain(x, tables, js, reverse)), js


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("dq", [-2, 0, 3])
def test_benes_kernels_match_plain(card, rng, dq, C, dtype):
    """q below, at and above the local block 2^s on a routed permutation:
    every outer pass, the local pass and the whole network, both
    directions, and the network is the permutation."""
    s = benes.LOCAL_LOG2
    q = s + dq
    perm = rng.permutation(1 << q).astype(np.int32)
    tables = benes.tables_from_pair_bits(_native.benes_route(perm), 1 << q, device=card)
    x = _payload(rng, (C, 1 << q), dtype, card)
    _benes_kernels_vs_plain(x, tables, s)
    want = torch.empty_like(x)
    want[:, torch.from_numpy(perm).long().to(card)] = x
    assert torch.equal(benes.apply_benes(x, tables), want)
    assert torch.equal(benes.apply_benes(want, tables, reverse=True), x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("q,s", [(15, 15), (16, 15), (18, 9), (20, 9), (12, 6)])
def test_benes_outer_passes_match_plain(card, rng, q, s, C, dtype):
    """q - s of 0, 1, 9 and 11 (two outer passes per side), and the
    smallest local block, on random pair bits (any bits make a network)."""
    words = rng.integers(0, 1 << 32, size=(2 * q - 1, (1 << q) // 64), dtype=np.uint64)
    tables = benes.tables_from_pair_bits(words.astype(np.uint32), 1 << q, device=card)
    _benes_kernels_vs_plain(_payload(rng, (C, 1 << q), dtype, card), tables, s)


def _ragged_rows(rng, K):
    """Counts of S rows of at most K lanes, S not a multiple of the row
    group R: runs of empty rows at both ends and across group boundaries,
    and rows starting at every residue mod 4."""
    R = ragged.rows_per_group(K)
    S = max(3 * R + 5, 41)
    counts = rng.integers(0, K + 1, size=S).astype(np.int32)
    counts[rng.integers(0, S, size=S // 5)] = rng.integers(1, 4, size=S // 5)
    counts[:3] = counts[-3:] = 0
    for b in range(R, S, 2 * R):  # every other group boundary
        counts[max(0, b - 2):b + 2] = 0
    rs = np.concatenate([[0], np.cumsum(counts)[:-1]])
    assert set(rs[counts > 0] % 4) == {0, 1, 2, 3} and S % R
    return counts


def _ragged_check(got, ref, name, before):
    assert torch.equal(got, ref), name
    assert _permute_launches()[name] == before[name] + 1, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("C", [1, 3, 8])
@pytest.mark.parametrize("K", [8, 128, 1024])
def test_ragged_kernels_match_plain(card, rng, K, C, dtype):
    """expand_rows and compact_rows bit for bit against their plain
    versions, one launch each: row groups cut mid-run of empty rows, rows
    at every residue mod 4; expansion from a stream with spare tail, with
    none, and from a misaligned view; compaction
    of contiguous rows, of unslot_values's transposed (S*K, C) slot array,
    of rows with other strides, and of a misaligned view, with the default
    size and with a zero tail over several tail blocks."""
    counts = _ragged_rows(rng, K)
    S, n = counts.size, int(counts.sum())
    cnt = torch.from_numpy(counts).to(card)
    rs = ragged.row_start_from_counts(cnt)
    big = _payload(rng, (C, n + 3 * K + 1), dtype, card)
    for stream in (big, big[:, :n].contiguous(), big[:, 1:n + 2]):
        before = _permute_launches()
        got = ragged.expand_rows(stream, rs, cnt, K)
        _ragged_check(got, ragged.expand_rows_plain(stream, rs, cnt, K), "expand_rows",
                      before)
        assert bool((got[:, counts == 0] == 0).all())
    flat = _payload(rng, (S * K + 1, C), dtype, card)
    layouts = {
        "contiguous": torch.empty((C, S, K), dtype=dtype, device=card).copy_(
            flat[1:].T.reshape(C, S, K)),
        "slot array": flat[:-1].T.reshape(C, S, K),
        "strided": flat[:-1].reshape(C, K, S).permute(0, 2, 1),
        "misaligned": flat.T.contiguous().reshape(-1)[1:C * S * K + 1].reshape(C, S, K),
    }
    assert ragged.compact_layout(layouts["contiguous"]) == "rows"
    assert ragged.compact_layout(layouts["slot array"]) == ("slab" if C > 1 else "rows")
    assert ragged.compact_layout(layouts["strided"]) == "strided"
    assert ragged.compact_layout(layouts["misaligned"]) == "strided"
    for label, padded in layouts.items():
        for size in (None, n + 2 * 8192 + 5):
            before = _permute_launches()
            out = ragged.compact_rows(padded, rs, cnt, n, size=size)
            ref = ragged.compact_rows_plain(padded, rs, cnt, n, out.shape[1])
            _ragged_check(out, ref, "compact_rows", before)
            assert bool((out[:, n:] == 0).all()), label


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("K", [8, 1024])
def test_ragged_kernels_empty_plan(card, rng, K, C):
    """A plan whose rows are all empty: expansion gives zeros, compaction
    only the zero tail."""
    cnt = torch.zeros(ragged.rows_per_group(K) * 2 + 1, dtype=torch.int32, device=card)
    rs = ragged.row_start_from_counts(cnt)
    S = cnt.shape[0]
    stream = _payload(rng, (C, 16), torch.float32, card)
    got = ragged.expand_rows(stream, rs, cnt, K)
    assert got.shape == (C, S, K) and bool((got == 0).all())
    padded = _payload(rng, (C, S, K), torch.float32, card)
    for size in (0, 5, 9000):
        out = ragged.compact_rows(padded, rs, cnt, 0, size=size)
        assert out.shape == (C, size) and bool((out == 0).all())


def test_benes_slot_values_at_k1024_equal_the_sort_route(card, rng):
    """A plan of 1024 lanes a row (the headline's K): the Benes route's
    slot_values and unslot_values equal the sort route's bit for bit at 1,
    3 and 8 columns (unslot_values's slot array is the slab layout at
    C > 1), and the ragged kernels ran."""
    n = 60000
    pos, _ = points(rng, n, 3)
    plan = tp.build_plan(pos, N=16, m=2, sigma=1.625, window="es", K=1024)
    plan_b = plan.with_benes_tables()
    plan_s = dataclasses.replace(plan_b, benes=None)
    assert plan_b.K == 1024 and plan_b.benes.compact
    for C in (1, 3, 8):
        x = _payload(rng, (n, C), torch.float32, card)
        slots = _payload(rng, (plan.S * plan.K, C), torch.float32, card)
        before = _permute_launches()
        got = binned.slot_values(plan_b, x)
        back = binned.unslot_values(plan_b, slots)
        after = _permute_launches()
        assert torch.equal(got, binned.slot_values(plan_s, x))
        assert torch.equal(back, binned.unslot_values(plan_s, slots))
        assert torch.equal(binned.unslot_values(plan_b, got.T.contiguous()), x)
        assert after["expand_rows"] == before["expand_rows"] + 1
        assert after["compact_rows"] == before["compact_rows"] + 1


@pytest.mark.parametrize("compact", [True, False])
def test_benes_pair_on_the_card_matches_the_sort_pair(card, rng, compact):
    """A device plan with an empty row, upgraded with Benes tables from the
    host positions: slot_values is bit for bit the sort route's, and the
    pair agrees with the sort route's to rel-L2 1e-6 (the spread kernel's
    atomics reorder float sums). The network is deeper than the local
    block, so both Benes kernels run."""
    n, B = 40000, 2
    pos, batch = points(rng, n, 3, B)
    x = rng.standard_normal((n, 2)).astype(np.float32)
    kw = dict(batch_size=B, N=16, m=2, sigma=1.625, window="es")
    plan = _with_empty_row(tp.build_plan_device(pos, batch, device=card, **kw), card)
    plan_b = plan.with_benes_tables(compact=compact, pos=pos, batch=batch)
    assert plan_b.benes.q > benes.LOCAL_LOG2
    xt = torch.from_numpy(x).to(card)
    assert torch.equal(binned.slot_values(plan_b, xt), binned.slot_values(plan, xt))
    before = _permute_launches()
    z_b = tp.nfft_pair_planar(x, pos, batch, plan_b, **kw)
    after = _permute_launches()
    z = tp.nfft_pair_planar(x, pos, batch, plan, **kw)
    assert _rel(z_b, z) <= 1e-6
    used = ("benes_outer", "benes_local") + (("expand_rows", "compact_rows") if compact else ())
    for name in used:
        assert after[name] > before[name], name


# pos.grad of the two routes' training steps: this test's tiles (T = 16)
# take the spread's wide-tile design, whose float atomics reorder its sums
# on every run, so two runs of one route differ by rel-L2 up to 1.2e-6 (30
# runs on an H100, tools/probe_route_noise.py)
POS_GRAD_ROUTES = 3e-6


def test_benes_training_step_launches_every_kernel(card, rng):
    """The Benes route realises the sort route's permutation exactly
    (slot_values and unslot_values bit for bit), launches every kernel in a
    training step, and its gradients agree with the sort route's: x.grad
    to 1e-6, pos.grad to the spread's own run-to-run noise."""
    n = 40000
    pos, _ = points(rng, n, 3)
    plan = tp.build_plan(pos, N=16, m=2, sigma=1.625, window="es").with_benes_tables()
    plan_s = dataclasses.replace(plan, benes=None)
    assert plan.device == card and plan.benes.q > benes.LOCAL_LOG2
    x = torch.from_numpy(rng.standard_normal((n, 1)).astype(np.float32)).to(card)
    slots = torch.from_numpy(rng.standard_normal((plan.S * plan.K, 2)).astype(np.float32))
    slots = slots.to(card)
    assert torch.equal(binned.slot_values(plan, x), binned.slot_values(plan_s, x))
    assert torch.equal(binned.unslot_values(plan, slots), binned.unslot_values(plan_s, slots))
    p = torch.from_numpy(pos).to(card)
    x.requires_grad_()
    p.requires_grad_()
    before = {**{k: getattr(contract, k).launches for k in KERNELS}, **_permute_launches()}
    z = tp.nfft_pair_planar(x, p, None, plan, batch_size=1, N=16, m=2, sigma=1.625,
                            window="es")
    (z * torch.ones_like(z)).sum().backward()
    torch.cuda.synchronize()
    after = {**{k: getattr(contract, k).launches for k in KERNELS}, **_permute_launches()}
    assert all(after[k] > before[k] for k in KERNELS + PERMUTE), (before, after)
    gx, gp = x.grad.clone(), p.grad.clone()
    x.grad = p.grad = None
    z = tp.nfft_pair_planar(x, p, None, plan_s, batch_size=1, N=16, m=2, sigma=1.625,
                            window="es")
    (z * torch.ones_like(z)).sum().backward()
    assert _rel(gx, x.grad) <= 1e-6 and _rel(gp, p.grad) <= POS_GRAD_ROUTES


# ---------------------------------------------------------------------------
# The flat-grid route: per-row tiles (spread_tiles), the tile moves, and the
# route's pair and gradients against the dense route's.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("dim,N,m,sigma,window,n,T", [
    (1, 64, 2, 2.0, "gaussian", 3000, None),
    (2, 32, 3, 2.0, "es", 5000, None),
    (3, 16, 2, 1.625, "es", 20000, None),
    (3, 16, 4, 1.25, "kb", 8000, None),
    (3, 32, 3, 2.0, "es", 4000, 32),  # 39^3 cells: global atomics in the wide design
])
@pytest.mark.parametrize("C", [1, 3, 8])
def test_spread_tiles_match_plain(card, rng, monkeypatch, dim, N, m, sigma, window, n, T, C,
                                  design):
    _force_design(monkeypatch, design)
    B = 2
    pos, batch = points(rng, n, dim, B)
    plan = tp.build_plan_device(pos, batch, N=N, m=m, sigma=sigma, batch_size=B,
                                window=window, T=T, device=card)
    plan = _with_empty_row(plan, card)
    vals = torch.randn((C, plan.S * plan.K), device=card)
    before = contract.spread_tiles.launches
    with _Designs(contract.spread_tiles) as ran:
        got = contract.spread_tiles(plan, vals)
    ref = contract.spread_tiles_plain(plan, vals)
    torch.cuda.synchronize()
    assert contract.spread_tiles.launches == before + 1
    assert ran.ran[design] == 1
    assert _rel(got, ref) <= 1e-5
    assert bool((got[-1] == 0).all())  # the empty row


def _never_fold(*args, **kwargs):
    return False


def test_flat_route_matches_the_dense_route(card, rng, monkeypatch):
    """The pair and a training step forced onto the flat route: within
    rel-L2 1e-5 of the dense route (float sums in another order), with
    spread_tiles, gather_points and pos_grad launched twice per step and
    the dense spread never."""
    n, B = 20000, 2
    pos, batch = points(rng, n, 3, B)
    x = rng.standard_normal((n, 2)).astype(np.float32)
    w = rng.standard_normal((n, 2)).astype(np.float32)
    kw = dict(batch_size=B, N=16, m=2, sigma=1.625, window="es")
    plan = tp.build_plan(pos, batch, **{k: kw[k] for k in ("N", "m", "sigma", "window")},
                         batch_size=B)

    def step():
        xl = torch.from_numpy(x).to(card).requires_grad_()
        pl = torch.from_numpy(pos).to(card).requires_grad_()
        z = tp.nfft_pair_planar(xl, pl, batch, plan, **kw)
        (z * torch.from_numpy(w).to(card)).sum().backward()
        return z.detach(), xl.grad, pl.grad

    dense = step()
    monkeypatch.setattr(binned, "use_fold", _never_fold)
    names = KERNELS + ("spread_tiles",)
    before = {k: getattr(contract, k).launches for k in names}
    flat = step()
    torch.cuda.synchronize()
    launches = {k: getattr(contract, k).launches - before[k] for k in names}
    assert launches == {"spread_tiles_dense": 0, "gather_points": 2, "pos_grad": 2,
                        "spread_tiles": 2}
    for a, b in zip(flat, dense):
        assert _rel(a, b) <= 1e-5


# ---------------------------------------------------------------------------
# The bitonic sort: three kernels, bit for bit against the plain network.
# ---------------------------------------------------------------------------


BITONIC = ("bitonic_local_sort", "bitonic_cross_round", "bitonic_local_merge")


def _sort_keys(rng, Q, ties):
    """A permutation, or many ties among small keys and the int32 extremes."""
    if not ties:
        return rng.permutation(Q).astype(np.int32)
    i32 = np.iinfo(np.int32)
    ext = np.array([i32.min, i32.min + 1, -1, 0, 1, i32.max - 1, i32.max], np.int64)
    return np.where(rng.random(Q) < 0.5, rng.choice(ext, Q),
                    rng.integers(-40, 40, Q)).astype(np.int32)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("dq", [-1, 0, 1, 2, 3, 8])
def test_bitonic_kernels_match_plain(card, rng, dq, dtype, ties):
    """q below, at and above the block 2^b (2^20 at b = 12): each kernel on its
    own and the whole sort, against the plain network, with the launches
    the schedule says."""
    b = bitonic.LOCAL_LOG2
    q = b + dq
    Q = 1 << q
    k = torch.from_numpy(_sort_keys(rng, Q, ties)).to(card)
    v = _payload(rng, (Q,), dtype, card)
    before = {n: getattr(bitonic, n).launches for n in BITONIC}
    got = bitonic.sort_pairs(k, v)
    used = {n: getattr(bitonic, n).launches - before[n] for n in BITONIC}
    want = bitonic.sort_pairs_plain(k, v)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[0], torch.sort(k).values)
    bb = min(q, b)
    rounds = range(bb + 1, q + 1)
    assert used == {"bitonic_local_sort": 1,
                    "bitonic_cross_round": sum(len(bitonic.cross_passes(jj, bb))
                                               for jj in rounds),
                    "bitonic_local_merge": q - bb}
    ks, vs = bitonic.bitonic_local_sort(k.clone(), v.clone(), bb)
    kp, vp = bitonic.bitonic_local_sort_plain(k, v, bb)
    assert torch.equal(ks, kp) and torch.equal(vs, vp)
    for jj in rounds:
        for d_hi, d_lo in bitonic.cross_passes(jj, bb):
            kc, vc = bitonic.bitonic_cross_round(ks.clone(), vs.clone(), jj, d_hi, d_lo)
            kp, vp = bitonic.bitonic_cross_round_plain(ks, vs, jj, d_hi, d_lo)
            assert torch.equal(kc, kp) and torch.equal(vc, vp), (jj, d_hi, d_lo)
            ks, vs = kc, vc
        km, vm = bitonic.bitonic_local_merge(ks.clone(), vs.clone(), jj, bb)
        kp, vp = bitonic.bitonic_local_merge_plain(ks, vs, jj, bb)
        assert torch.equal(km, kp) and torch.equal(vm, vp), jj
        ks, vs = km, vm
    if not ties:
        out = bitonic.apply_permutation(k, v)
        assert torch.equal(out, torch.empty_like(v).index_copy_(0, k.long(), v))


@pytest.mark.parametrize("b", [8, 9, 14])
def test_bitonic_block_sizes(card, rng, b, monkeypatch):
    """The local kernels at the smallest block, the first with 16 words per
    thread and the largest (128 KB), and a cross tile of 2^10: the sort is
    the plain network's, ties included."""
    monkeypatch.setattr(bitonic, "LOCAL_LOG2", b)
    monkeypatch.setattr(bitonic, "CROSS_LOG2", 10)
    Q = 1 << 17
    k = torch.from_numpy(_sort_keys(rng, Q, True)).to(card)
    v = _payload(rng, (Q,), torch.int32, card)
    got = bitonic.sort_pairs(k, v)
    want = bitonic.sort_pairs_plain(k, v)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# The fastsum's geometry: gaussian window, m = 4, sigma = 2, 3D tiles of
# T = 16 (H = 25, window ratio (25/10)^3 = 15.6)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("C", [1, 8])
def test_gram_geometry_kernels_match_plain(card, rng, C):
    """At the Gram path's geometry: the per-row spread (B7) and, at C = 1,
    the dense spread (B1), the gather (B2) and the position gradient (B5),
    each against its plain version and bit for bit across two launches."""
    pos, batch = points(rng, 20000, 3, 1)
    plan = tp.build_plan_device(pos, batch, N=32, m=4, sigma=2.0, batch_size=1, T=16,
                                window="gaussian", device=card)
    assert plan.H == 25
    x = torch.from_numpy(rng.standard_normal((20000, C)).astype(np.float32)).to(card)
    vals = binned.slot_values(plan, x)
    runs = {"spread_tiles": (lambda: contract.spread_tiles(plan, vals),
                             lambda: contract.spread_tiles_plain(plan, vals))}
    g = torch.randn((1, C) + (plan.M,) * 3, device=card)
    if C == 1:
        tid_s = binned.dense_tile_ids(plan)
        runs["spread_tiles_dense"] = (
            lambda: contract.spread_tiles_dense(plan, vals, tid_s, plan.NT),
            lambda: contract.spread_tiles_dense_plain(plan, vals, tid_s, plan.NT))
        tiles, tid = unfold_grid_to_tiles(g, plan), row_tile_ids(plan)
    else:
        tiles = binned.grid_to_tiles(plan, g)
        tid = torch.arange(plan.S, dtype=torch.int32, device=card)
    runs["gather_points"] = (lambda: contract.gather_points(plan, tiles, tid),
                             lambda: contract.gather_points_plain(plan, tiles, tid))
    runs["pos_grad"] = (lambda: contract.pos_grad(plan, tiles, vals, tid),
                        lambda: contract.pos_grad_plain(plan, tiles, vals, tid))
    for name, (run, plain) in runs.items():
        got = run()
        assert _rel(got, plain()) <= 1e-5, name
        assert torch.equal(run(), got), name


@pytest.mark.parametrize("kind", ["gram", "adjacency"])
def test_gram_and_adjacency_matvecs_on_the_card_match_the_cpu(card, rng, kind):
    """n = 2^12 points, 3D, N = 32, gaussian window, m = 4: the operator on
    the card (its default device) against the same operator on the CPU (the
    plain chain), in user and in slot order; a Gram matvec launches the
    spread and the gather once each."""
    n = 1 << 12
    pts = (rng.random((n, 3)) * 2 - 1).astype(np.float32)
    x = rng.standard_normal((n, 2)).astype(np.float32)
    ops = []
    for device in (None, "cpu"):
        kernel = tp.GaussianKernel(0.4, dim=3, bandwidth=32, cutoff=4, device=device)
        ops.append(kernel(pts) if kind == "gram"
                   else kernel.adjacency_matrix(pts, normalization="sym"))
    card_op, cpu_op = ops
    assert card_op.device.type == "cuda"
    gram = card_op if kind == "gram" else card_op.gram_matrix
    gram.apply(x)  # plans built
    s0, g0 = contract.spread_tiles_dense.launches, contract.gather_points.launches
    y = card_op @ x
    torch.cuda.synchronize()
    if kind == "gram":
        assert (contract.spread_tiles_dense.launches, contract.gather_points.launches) \
            == (s0 + 1, g0 + 1)
    assert y.device.type == "cuda"
    assert _rel(y.cpu(), cpu_op @ x) <= 1e-5
    ys = gram.from_slot(card_op.apply_slot(gram.to_slot(x)))
    assert _rel(ys, y) <= 1e-5


@pytest.mark.parametrize("C,flat", [(1, False), (8, False), (8, True)])
def test_gram_matvec_runs_half_spectra_and_matches_c2c(card, rng, monkeypatch, C, flat):
    """At the Gram geometry (gaussian window, m = 4, sigma = 2, N = 32) on
    2^12 points: ``G @ x`` for a real x (the kernel's coefficients are
    complex64) takes the half-spectrum route, as the route counter reads,
    and agrees with the C2C stages within 1e-6 rel-L2, on the dense route
    and, forced, the flat one."""
    from torch_nfft_tpu_torch import trace
    from torch_nfft_tpu_torch.ops.planar import fastsum_stages

    if flat:
        monkeypatch.setattr(binned, "use_fold", lambda *a, **k: False)
    n = 1 << 12
    pts = (rng.random((n, 3)) * 2 - 1).astype(np.float32)
    G = tp.GaussianKernel(0.4, dim=3, bandwidth=32, cutoff=4)(pts)
    plan = G._plans()[0]
    x = torch.from_numpy(rng.standard_normal((n, C)).astype(np.float32)).to(card)
    before = trace.counters()
    y = G @ x
    after = trace.counters()
    assert (after["fastsum_route.half"] - before["fastsum_route.half"],
            after["fastsum_route.c2c"] - before["fastsum_route.c2c"]) == (1, 0)
    c2c = fastsum_stages(plan, plan, G.coeffs, m=4, sigma=2.0, window="gaussian", C=C,
                         hermitian=False)
    route = binned.tile_route(plan, C)
    assert [name for name, _ in c2c] == [name for name, _ in route.spreading] + [
        "ifftn", "filter", "fftn"] + [name for name, _ in route.gathering]
    assert _rel(y, binned.run_stages(c2c, x)) <= 1e-6


# ---------------------------------------------------------------------------
# The radial kernels, the Lanczos solver, the plan-free engines and the
# half-spectrum stages on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["matern", "laplace", "imq", "radial"])
def test_radial_gram_matvec_on_the_card_matches_the_cpu(card, rng, kind):
    """n = 2^12 points, 3D, N = 32, m = 4: a radial kernel's Gram matvec on
    the card (B1 and B2 launched once each) against the CPU's plain chain,
    and the coefficients built on each."""
    n = 1 << 12
    pts = (rng.random((n, 3)) * 2 - 1).astype(np.float32)
    x = rng.standard_normal((n, 1)).astype(np.float32)
    make = {"matern": lambda d: tp.MaternKernel(0.4, nu=1.5, dim=3, bandwidth=32, cutoff=4,
                                                device=d),
            "laplace": lambda d: tp.LaplaceKernel(0.4, dim=3, bandwidth=32, cutoff=4, device=d),
            "imq": lambda d: tp.InverseMultiquadricKernel(0.4, dim=3, bandwidth=32, cutoff=4,
                                                          device=d),
            "radial": lambda d: tp.RadialKernel(lambda r: np.exp(-(r / 0.4) ** 2), dim=3,
                                                bandwidth=32, cutoff=4, device=d)}[kind]
    kc, kh = make(None), make("cpu")
    assert kc.coeffs.device.type == "cuda"
    assert _rel(kc.coeffs.cpu(), kh.coeffs) <= 1e-5
    G = kc(pts)
    G @ x  # plans built
    s0, g0 = contract.spread_tiles_dense.launches, contract.gather_points.launches
    y = G @ x
    torch.cuda.synchronize()
    assert (contract.spread_tiles_dense.launches, contract.gather_points.launches) \
        == (s0 + 1, g0 + 1)
    assert _rel(y.cpu(), kh(pts) @ x) <= 1e-5


def test_lanczos_step_on_the_card_matches_the_cpu(card, rng):
    """Ten Lanczos steps of the sym adjacency operator in slot order on the
    card against the same on the CPU (one shared start vector), and
    eigsh_operator's top eigenvalue at the Perron value 1."""
    n = 1 << 12
    pts = (rng.random((n, 3)) * 2 - 1).astype(np.float32)
    v = rng.standard_normal((n, 1)).astype(np.float32)
    ops, out = [], []
    for device in (None, "cpu"):
        A = tp.GaussianKernel(0.4, dim=3, bandwidth=32, cutoff=4,
                              device=device).adjacency_matrix(pts, normalization="sym")
        v0 = A.gram_matrix.to_slot(torch.from_numpy(v).to(A.device))
        ops.append(A)
        out.append(tp.lanczos(A.apply_slot, v0, 10))
    for a, b in zip(out[0], out[1]):
        assert a.device.type == "cuda"
        assert _rel(a.cpu(), b) <= 1e-4
    w, y = tp.eigsh_operator(ops[0], 2, num_iters=20)
    assert w.device.type == "cuda" and abs(float(w[-1]) - 1.0) <= 1e-3
    assert y.shape == (n, 2)


@pytest.mark.parametrize("strategy", ["scatter", "matmul"])
def test_plan_free_engines_on_the_card_match_the_cpu(card, rng, strategy):
    """Each plan-free engine on the card: the adjoint, the pair and their
    gradients in x and the points against the CPU, no kernel launched."""
    n, dim, N, B = 600, 3, 16, 2
    pos, batch = points(rng, n, dim, B)
    x = rng.standard_normal((n, 2)).astype(np.float32)
    w = rng.standard_normal((n, 2)).astype(np.float32)
    kw = dict(batch_size=B, m=2, sigma=1.625, window="es", strategy=strategy)

    def fn(a, p, d):
        return tp.nfft_pair_planar(a, p, batch, N=N, device=d, **kw)

    before = {k: getattr(contract, k).launches for k in KERNELS}
    gx, gp = _loss_grads(fn, x, pos, w, card)
    torch.cuda.synchronize()
    assert {k: getattr(contract, k).launches for k in KERNELS} == before
    rx, rp = _loss_grads(fn, x, pos, w, "cpu")
    assert _rel(gx, rx) <= 3e-5 and _rel(gp, rp) <= 3e-5
    y = tp.nfft_adjoint(x, pos, batch, N=N, **kw)
    assert y.device.type == "cuda"
    assert _rel(y.cpu(), tp.nfft_adjoint(x, pos, batch, N=N, device="cpu", **kw)) <= 3e-5


@pytest.mark.parametrize("dim,N", [(2, 64), (3, 32), (3, 31)])
def test_half_spectrum_stages_on_the_card_match_c2c(card, rng, dim, N):
    """The pair's rfftn/irfftn stages on the card against the C2C chain
    (the asymmetric band's edge planes included), 1e-6 rel-L2."""
    from torch_nfft_tpu_torch.ops import fft as pfft

    M, m, sigma = 2 * N, 3, 2.0
    g = torch.randn((1, 2) + (M,) * dim, device=card)
    half = pfft.spectral_adjoint_half(g, dim, N, m, sigma, "es")
    w = pfft.band_filter_half(dim, N, card)
    got = pfft.spectral_forward_half(half if w is None else half * w, dim, N, M, m, sigma,
                                     "es")
    full = pfft.spectral_adjoint(g, dim, N, m, sigma, "es")
    want = pfft.spectral_forward(full, dim, M, m, sigma, "es").real
    assert _rel(got, want) <= 1e-6
    assert _rel(pfft.half_spectrum_to_full(half, dim, N), full) <= 1e-6


def _share(got, ref):
    """max |got - ref| as a share of max |ref|."""
    return float((got - ref).abs().max() / ref.abs().max())


# dim, N, M, leading shape, m, sigma, window
PRUNED_GEOMETRIES = {
    "member": (3, 256, 512, (1, 2), 4, 2.0, "gaussian"),
    "headline": (3, 256, 416, (1, 1), 2, 1.625, "es"),
    "slab rows": (2, 1024, 2048, (1, 1, 8), 4, 2.0, "gaussian"),
}


@pytest.mark.parametrize("turn", [False, True])
@pytest.mark.parametrize("geometry", list(PRUNED_GEOMETRIES))
def test_pruned_half_stages_match_the_whole_grid(card, monkeypatch, geometry, turn):
    """The band-pruned stages against the whole-grid formulation they
    replaced (``rfftn`` cropped; ``irfftn`` of the zero-padded embed) at a
    streamed member (3D N = 256, M = 512, C = 2), at the headline (M = 416,
    C = 1) and on rows of the grid-sharded pair's slab (2D N = 1024,
    M = 2048): both stages to 1e-6 of the largest entry, through cuFFT's
    turned layouts and through ``turn_half`` (its launches counted)."""
    from _torch_port import whole_adjoint, whole_forward

    from torch_nfft_tpu_torch.ops import fft as pfft

    dim, N, M, lead, m, sigma, window = PRUNED_GEOMETRIES[geometry]
    monkeypatch.setattr(pfft, "TURN_KERNEL_ABOVE", 0 if turn else 1 << 30)
    g = torch.randn(lead + (M,) * dim, device=card,
                    generator=torch.Generator(device=card).manual_seed(3))
    phi = pfft._phi_half(dim, N, m, sigma, window, card)
    before = pfft.turn_half.launches
    half = pfft.spectral_adjoint_half(g, dim, N, m, sigma, window)
    assert _share(half, whole_adjoint(g, dim, N, phi)) <= 1e-6
    got = pfft.spectral_forward_half(half, dim, N, M, m, sigma, window)
    assert _share(got, whole_forward(half, dim, N, M, phi)) <= 1e-6
    torch.cuda.synchronize()
    assert pfft.turn_half.launches - before == (2 if turn else 0)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("R,K,n2", [(1000, 257, 129), (4099, 1025, 513), (37, 9, 9)])
def test_turn_half_kernel_matches_plain(card, R, K, n2, dtype):
    """turn_half's kernel against its plain version, bit for bit (a
    copy), both ways, ragged tiles included."""
    from torch_nfft_tpu_torch.ops import fft as pfft

    gen = torch.Generator(device=card).manual_seed(R)
    src = torch.randn((R, K), dtype=dtype, device=card, generator=gen)
    rows = pfft.turn_half(src, R, K, n2, True)
    assert torch.equal(rows.cpu(), pfft.turn_half_plain(src.cpu(), R, K, n2, True))
    back = pfft.turn_half(rows, R, K, n2, False)
    assert torch.equal(back.cpu(), pfft.turn_half_plain(rows.cpu(), R, K, n2, False))


def test_pair_spectral_stages_gradient_at_the_member_geometry(card):
    """``pair_spectral_stages`` under autograd at a streamed member (3D
    N = 256, M = 512, C = 2): the pair's grid and the grid's gradient of
    <stages(g), r> against autograd through the whole-grid formulation,
    1e-6 of the largest entry."""
    from _torch_port import whole_adjoint, whole_forward

    from torch_nfft_tpu_torch.ops import fft as pfft
    from torch_nfft_tpu_torch.ops.planar import pair_spectral_stages

    dim, N, M, lead, m, sigma, window = PRUNED_GEOMETRIES["member"]
    gen = torch.Generator(device=card).manual_seed(9)
    g = torch.randn(lead + (M,) * dim, device=card, generator=gen, requires_grad=True)
    r = torch.randn(lead + (M,) * dim, device=card, generator=gen)
    out = g
    for _, fn in pair_spectral_stages(dim=dim, N=N, M=M, m=m, sigma=sigma, window=window,
                                      device=card):
        out = fn(out)
    got, = torch.autograd.grad((out * r).sum(), g)
    phi = pfft._phi_half(dim, N, m, sigma, window, card)
    whole = whole_forward(whole_adjoint(g, dim, N, phi) * pfft.band_filter_half(dim, N, card),
                          dim, N, M, phi)
    ref, = torch.autograd.grad((whole * r).sum(), g)
    assert _share(out.detach(), whole.detach()) <= 1e-6
    assert _share(got, ref) <= 1e-6


# ---------------------------------------------------------------------------
# Saved plans, plan stacks and the streamed transforms: no kernel of their
# own; each member runs B1 and B2 (B5 under autograd) on a padded plan.
# ---------------------------------------------------------------------------


def _streamed_case(rng, counts=(900, 0, 1400, 700), dim=3, C=2):
    n = sum(counts)
    pos = (rng.random((n, dim), dtype=np.float32) - 0.5) / 2.0
    batch = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
    x = rng.standard_normal((n, C)).astype(np.float32)
    return pos, batch, x


def test_streamed_pair_on_the_card_matches_the_cpu(card, rng):
    pos, batch, x = _streamed_case(rng)
    kw = dict(batch_size=4, N=16, m=4, window="gaussian")
    out = {}
    for dev in (card, torch.device("cpu")):
        layout = tp.make_streamed_layout(pos, batch, device=dev, **kw)
        yr, yi = tp.nfft_adjoint_streamed(x, layout)
        zr, zi = tp.nfft_forward_streamed(yr, yi, layout)
        out[dev.type] = (yr, yi, zr, zi)
    assert out["cuda"][0].device.type == "cuda"
    for got, want in zip(out["cuda"], out["cpu"]):
        assert _rel(got.cpu(), want) <= 1e-5
    # the empty member gives a zero spectrum
    assert float(out["cuda"][0][1].abs().max()) == 0.0


def test_streamed_pair_launches_b1_and_b2_per_member(card, rng):
    pos, batch, x = _streamed_case(rng)
    layout = tp.make_streamed_layout(pos, batch, batch_size=4, N=16, m=4)
    for chunk, per_member in ((None, 1), (1, 2)):
        before = {k: getattr(contract, k).launches for k in KERNELS}
        yr, yi = tp.nfft_adjoint_streamed(x, layout, column_chunk=chunk)
        tp.nfft_forward_streamed(yr, yi, layout, column_chunk=chunk)
        torch.cuda.synchronize()
        ran = {k: getattr(contract, k).launches - before[k] for k in KERNELS}
        assert ran == {"spread_tiles_dense": 4 * per_member, "gather_points": 4 * per_member,
                       "pos_grad": 0}


@pytest.mark.parametrize("chunk", [None, 1])
def test_streamed_half_spectrum_pair_on_the_card_matches_the_cpu(card, rng, chunk):
    pos, batch, x = _streamed_case(rng)
    kw = dict(batch_size=4, N=16, m=4, window="gaussian")
    out = {}
    for dev in (card, torch.device("cpu")):
        layout = tp.make_streamed_layout(pos, batch, device=dev, **kw)
        out[dev.type] = tp.nfft_pair_streamed(x, layout, column_chunk=chunk)
    assert out["cuda"].device.type == "cuda" and out["cuda"].shape == x.shape
    assert _rel(out["cuda"].cpu(), out["cpu"]) <= 1e-5


def test_streamed_half_spectrum_pair_at_the_member_geometry(card):
    """16 members of 2^14 points in [-1/4, 1/4)^3 at N = 256, gaussian
    m = 4, sigma = 2: each member bins at T = 32 (H = 41) on M = 512, as
    the benchmark's batch3d-16x21 members do. A call launches B1 (the
    culled tensor design), B2, the fold and the unfold once a member, takes
    the dense route and the half spectra, and gives the real plane of the
    streamed adjoint and forward."""
    B, per = 16, 1 << 14
    gen = np.random.default_rng(25)
    pos = ((gen.random((B * per, 3), dtype=np.float32) - 0.5) / 2.0).astype(np.float32)
    batch = np.repeat(np.arange(B, dtype=np.int32), per)
    x = torch.randn((B * per, 2), device=card)
    layout = tp.make_streamed_layout(pos, batch, batch_size=B, N=256, m=4, sigma=2.0,
                                     window="gaussian")
    plan = layout.member_plan(0)
    assert (plan.M, plan.T, plan.H) == (512, 32, 41)
    z = tp.nfft_pair_streamed(x, layout)  # builds the kernels
    torch.cuda.synchronize()
    def launches():
        return {**_launches(), **{k: getattr(tilefold, k).launches
                                  for k in ("fold_tiles_to_grid", "unfold_grid_to_tiles")}}

    before = launches()
    culled = tp.trace.counters()["spread_tiles_dense.tensor_culled"]
    tp.trace.drain()
    tp.trace.enable()
    try:
        z = tp.nfft_pair_streamed(x, layout)
        torch.cuda.synchronize()
    finally:
        tp.trace.disable()
    spans = tp.trace.drain()
    ran = {k: v - before[k] for k, v in launches().items()}
    assert ran == {"spread_tiles_dense": B, "gather_points": B, "pos_grad": 0,
                   "spread_tiles": 0, "fold_tiles_to_grid": B, "unfold_grid_to_tiles": B}
    assert tp.trace.counters()["spread_tiles_dense.tensor_culled"] - culled == B
    pairs = [s for s in spans if s.name == "nfft_pair_planar"]
    assert len(pairs) == B
    for pair in pairs:
        stages = [s.name for s in sorted(spans, key=lambda s: s.start_ns)
                  if s.parent == pair.id]
        assert stages == ["slot_values", "spread kernel", "fold", "rfftn", "irfftn", "unfold",
                          "gather kernel", "unslot_values"], stages
    zr, _ = tp.nfft_forward_streamed(*tp.nfft_adjoint_streamed(x, layout), layout)
    assert _rel(z, zr) <= 1e-5


def test_padded_member_plan_matches_the_unpadded_plan(card, rng):
    """A member plan padded by hundreds of empty rows (row_count 0, origin
    0, batch 0) at its end, as a plan stack pads it, against the same plan
    unpadded: B1 (through the dense tile ids), B2 and B5 (under autograd)."""
    n = 6000
    pos = (rng.random((n, 3), dtype=np.float32) - 0.5) / 2.0
    plan = tp.build_plan(pos, None, N=16, m=4, batch_size=1)
    padded = tp.pad_plan_rows(plan, plan.S + 700)
    x = torch.from_numpy(rng.standard_normal((n, 2)).astype(np.float32)).to(card)
    w = torch.randn((n, 2), device=card)
    grads = []
    for p in (plan, padded):
        xg = x.clone().requires_grad_()
        pg = torch.from_numpy(pos).to(card).requires_grad_()
        before = {k: getattr(contract, k).launches for k in KERNELS}
        z = tp.nfft_pair_planar(xg, pg, None, p, batch_size=1, N=16, m=4)
        (z * w).sum().backward()
        torch.cuda.synchronize()
        assert all(getattr(contract, k).launches > before[k] for k in KERNELS)
        grads.append((z.detach(), xg.grad, pg.grad))
    for got, want in zip(grads[1], grads[0]):
        assert _rel(got, want) <= 1e-6
    # kernel by kernel: the padded rows add nothing and read nothing
    vals_u, vals_p = binned.slot_values(plan, x), binned.slot_values(padded, x)
    assert torch.equal(vals_p[:, : plan.S * plan.K], vals_u)
    t_u = contract.spread_tiles_dense(plan, vals_u, binned.dense_tile_ids(plan), plan.NT)
    t_p = contract.spread_tiles_dense(padded, vals_p, binned.dense_tile_ids(padded), padded.NT)
    assert _rel(t_p, t_u) <= 1e-6
    g_u = contract.gather_points(plan, t_u, row_tile_ids(plan))
    g_p = contract.gather_points(padded, t_u, row_tile_ids(padded))
    assert torch.equal(g_p[: plan.S], g_u) and float(g_p[plan.S:].abs().max()) == 0.0
    d_u = contract.pos_grad(plan, t_u, vals_u, row_tile_ids(plan))
    d_p = contract.pos_grad(padded, t_u, vals_p, row_tile_ids(padded))
    assert torch.equal(d_p[: plan.S], d_u) and float(d_p[plan.S:].abs().max()) == 0.0


# The streamed pair's training step at the benchmark's batch3d-16x21 member
# geometry: members of ~2^17 points uniform in [-1/4, 1/4)^3, N = 256,
# gaussian m = 4, sigma = 2 (M = 512, T = 32, H = 41), C = 2.
MEMBER_COUNTS = (130995, 131512, 131599, 130743)
MEMBER_KW = dict(N=256, m=4, sigma=2.0, window="gaussian")
# The benchmark cell's limits (nfft_bench/limits/
# batch3d-16x21-grad.streamed-step-c2.json): the float32 step reads 7.0-7.9e-5
# in x.grad and 0.83-0.99e-3 in pos.grad against the float64 sums at 256 rows.
STEP_XGRAD_BAR, STEP_POSGRAD_BAR = 1.3e-4, 2.5e-3


def _member_batch(counts, seed=27):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = sum(counts)
    pos = torch.rand((n, 3), generator=gen, device="cuda") * 0.5 - 0.25
    batch = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
    x = torch.randn((n, 2), generator=gen, device="cuda")
    w = torch.randn((n, 2), generator=gen, device="cuda")
    return pos, batch, x, w


def _dirichlet_step(pos, x, w, rows, N, chunk=1 << 14):
    """x.grad and pos.grad at ``rows`` of L = <z, w>, z the pair, by the
    direct sums over every point with the real, even kernel
    K(u) = cos(pi sum_d u_d) prod_d sin(pi N u_d) / sin(pi u_d), float64
    (the benchmark's plain reference, nfft_bench/references/dirichlet_pair.py)."""
    s, X, W = pos.double(), x.double(), w.double()
    t, R, C, dim = s[rows], len(rows), x.shape[1], pos.shape[1]
    c2 = math.pi**2 * N * (N * N - 1) / 6.0
    accK = torch.zeros((R, C), dtype=torch.float64, device=pos.device)
    accGX = torch.zeros((dim, R, C), dtype=torch.float64, device=pos.device)
    accGW = torch.zeros_like(accGX)
    for c0 in range(0, s.shape[0], chunk):
        u = t[:, None, :] - s[None, c0:c0 + chunk, :]
        a = math.pi * u
        near = u.abs() < 1e-7
        S = torch.where(near, N - c2 * u * u, torch.sin(N * a) / torch.sin(a))
        dS = torch.where(near, -2.0 * c2 * u, math.pi * (N * torch.cos(N * a) * torch.sin(a)
                                                          - torch.cos(a) * torch.sin(N * a))
                         / torch.sin(a) ** 2)
        ang = math.pi * u.sum(-1)
        prodS = S.prod(-1)
        accK += (torch.cos(ang) * prodS) @ W[c0:c0 + chunk]
        for d in range(dim):
            others = torch.cat([S[..., :d], S[..., d + 1:]], -1).prod(-1)
            G = -math.pi * torch.sin(ang) * prodS + torch.cos(ang) * dS[..., d] * others
            accGX[d] += G @ X[c0:c0 + chunk]
            accGW[d] += G @ W[c0:c0 + chunk]
    pg = ((X[rows][None] * accGW).sum(-1) + (W[rows][None] * accGX).sum(-1)).T
    return accK, pg


def test_streamed_step_at_the_member_geometry_matches_float64(card):
    """x.grad and pos.grad of two members' step against the float64 sums at
    sampled rows of each member; B5 and B2 run once for each member and
    pass (two B5 a member), each member's forward pass once more."""
    counts = MEMBER_COUNTS[:2]
    pos, batch, x, w = _member_batch(counts)
    layout = tp.make_streamed_layout(pos, batch, batch_size=len(counts), **MEMBER_KW)
    plan = layout.member_plan(0)
    assert (plan.M, plan.T, plan.H) == (512, 32, 41)
    p = pos.clone().requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    (tp.nfft_pair_streamed(xg, layout, pos=p) * w).sum().backward()  # builds the kernels
    torch.cuda.synchronize()
    xg.grad = p.grad = None
    before, counters = _launches(), tp.trace.counters()
    (tp.nfft_pair_streamed(xg, layout, pos=p) * w).sum().backward()
    torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in _launches().items()}
    assert ran == {"spread_tiles_dense": 6, "gather_points": 4, "pos_grad": 4,
                   "spread_tiles": 0}
    after = tp.trace.counters()
    assert after["streamed_backward_members"] - counters["streamed_backward_members"] == 2
    assert after["streamed_recompute_passes"] - counters["streamed_recompute_passes"] == 2
    gen = np.random.default_rng(5)
    lo = 0
    for count in counts:
        rows = torch.as_tensor(np.sort(gen.choice(count, 128, replace=False)) + lo,
                               device=card)
        sl = slice(lo, lo + count)
        gx, gp = _dirichlet_step(pos[sl], x[sl], w[sl], rows - lo, MEMBER_KW["N"])
        assert _rel(xg.grad[rows], gx) <= STEP_XGRAD_BAR
        assert _rel(p.grad[rows], gp) <= STEP_POSGRAD_BAR
        lo += count


def test_streamed_step_peak_memory_does_not_grow_with_the_batch(card):
    """The step's peak (layout, inputs and the step) at B = 16 within 10% of
    B = 4's: the backward holds one member's pipeline at a time."""
    peaks = {}
    for B in (4, 16):
        counts = (MEMBER_COUNTS * 4)[:B]
        pos, batch, x, w = _member_batch(counts)
        layout = tp.make_streamed_layout(pos, batch, batch_size=B, **MEMBER_KW)
        p = pos.clone().requires_grad_(True)
        xg = x.clone().requires_grad_(True)
        (tp.nfft_pair_streamed(xg, layout, pos=p) * w).sum().backward()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(card)
        xg.grad = p.grad = None
        (tp.nfft_pair_streamed(xg, layout, pos=p) * w).sum().backward()
        torch.cuda.synchronize()
        peaks[B] = torch.cuda.max_memory_allocated(card)
        assert p.grad is not None and xg.grad is not None
        del layout, p, xg, pos, x, w
        torch.cuda.empty_cache()
    assert peaks[16] <= 1.1 * peaks[4], peaks


def test_pos_grad_at_the_member_geometry_matches_plain(card):
    """B5 at H = 41, C = 2 (the tile, 551 KB, read from global memory)
    against its plain version, and bit for bit across two launches."""
    pos, _, x, _ = _member_batch((1 << 14,))
    plan = tp.build_plan(pos.cpu().numpy(), None, N=256, m=4, sigma=2.0,
                         window="gaussian")
    assert (plan.H, plan.T) == (41, 32)
    assert not contract.points_layout("pos_grad", 3, plan.H, 2, plan.K).staged
    g = torch.randn((1, 2) + (plan.M,) * 3, device=card)
    tiles, tid = unfold_grid_to_tiles(g, plan), row_tile_ids(plan)
    w = binned.slot_values(plan, x)
    got = contract.pos_grad(plan, tiles, w, tid)
    assert _rel(got, contract.pos_grad_plain(plan, tiles, w, tid)) <= 1e-5
    assert torch.equal(contract.pos_grad(plan, tiles, w, tid), got)


def test_load_plan_defaults_to_the_card(card, rng, tmp_path, monkeypatch):
    _force_design(monkeypatch, "contraction")  # no atomics: pairs repeat bit for bit
    pos, _ = points(rng, 5000, 3)
    plan = tp.build_plan(pos, None, N=16, m=2, sigma=1.625, window="es").with_benes_tables()
    path = tmp_path / "plan.npz"
    tp.save_plan(path, plan)
    loaded = tp.load_plan(path)
    assert loaded.device == plan.device and loaded.device.type == "cuda"
    assert loaded.benes.bits.device == plan.device
    x = rng.standard_normal((5000, 1)).astype(np.float32)
    kw = dict(batch_size=1, N=16, m=2, sigma=1.625, window="es")
    assert torch.equal(tp.nfft_pair_planar(x, pos, None, loaded, **kw),
                       tp.nfft_pair_planar(x, pos, None, plan, **kw))


def test_sharded_transforms_world_of_one_on_nccl(card, rng, tmp_path):
    """One NCCL rank: the point-sharded fastsum, adjoint and forward on a
    stack of one plan against the single-device entry points on its member,
    launching B1 and B2."""
    import datetime

    import torch.distributed as dist

    from torch_nfft_tpu_torch import parallel as par

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = par.make_mesh({"data": 1, "points": 1})
        n, N, m = 1 << 14, 32, 3
        pos, _ = points(rng, n, 3)
        x = torch.from_numpy(rng.standard_normal((n, 2)).astype(np.float32)).to(card)
        coeffs = tp.gaussian_analytic_coeffs(0.3, dim=3, N=N, device=card)
        plans = par.build_sharded_plans(pos, n_shards=1, N=N, m=m)
        member = tp.index_plan(plans, 0)
        before = {k: getattr(contract, k).launches for k in KERNELS}
        y = par.nfft_fastsum_sharded(x, coeffs, pos, cutoff=m, mesh=mesh,
                                     source_plans=plans, target_plans=plans)
        torch.cuda.synchronize()
        ran = {k: getattr(contract, k).launches - before[k] for k in KERNELS}
        assert ran["spread_tiles_dense"] >= 1 and ran["gather_points"] >= 1, ran
        assert _rel(y, tp.nfft_fastsum(x, coeffs, pos, cutoff=m, source_plan=member)) <= 1e-5
        a = par.nfft_adjoint_sharded(x, pos, bandwidth=N, cutoff=m, mesh=mesh, plans=plans)
        ref = tp.nfft_adjoint(x, pos, bandwidth=N, cutoff=m, plan=member)
        assert _rel(torch.view_as_real(a), torch.view_as_real(ref)) <= 1e-5
        f = par.nfft_forward_sharded(a, pos, cutoff=m, mesh=mesh, plans=plans)
        ref = tp.nfft_forward(a, pos, cutoff=m, plan=member)
        assert _rel(torch.view_as_real(f), torch.view_as_real(ref)) <= 1e-5
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("pad", [0, 300])
def test_local_tile_kernels_match_plain(card, rng, pad):
    """B1, B2 and B5 at a grid-sharded slab's local tile space (slab 1 of
    4, so that the local tile 0 is not the global one), the slab's plan
    padded by ``pad`` empty rows: the local tile ids point every empty row
    at the tile of the row before it, so each tile's rows stay one run."""
    from torch_nfft_tpu_torch.parallel import grid_sharded as gs

    pos = rng.random((20000, 3), dtype=np.float32) - 0.5
    lays = {d: tp.parallel.build_grid_sharded_layout(pos, n_shards=4, N=32, m=3, T=8,
                                                     device=d) for d in (card, "cpu")}
    out = {}
    for d, lay in lays.items():
        plan = tp.index_plan(lay.plans, 1)
        plan = tp.pad_plan_rows(plan, plan.S + pad)
        tid = gs._local_tile_ids(plan, lay.A0_loc, 1)
        g = torch.Generator().manual_seed(5)
        x = torch.randn((plan.n, 2), generator=g).to(d)
        tiles = torch.randn((lay.NT, 2, plan.H, plan.H ** 2), generator=g).to(d)
        w = torch.randn((lay.NT, 2, plan.H, plan.H ** 2), generator=g).to(d)
        vals = binned.slot_values(plan, x)
        kern = (contract.spread_tiles_dense(plan, vals, tid, lay.NT),
                contract.gather_points(plan, tiles, tid))
        if d == card:
            plain = (contract.spread_tiles_dense_plain(plan, vals, tid, lay.NT),
                     contract.gather_points_plain(plan, tiles, tid))
            for k, p in zip(kern, plain):
                assert _rel(k, p) <= 1e-5
        pl = lay.pos_stack[1].clone().requires_grad_()
        before = contract.pos_grad.launches
        (binned.dense_tiles_local(lay.NT, plan, x, pl, tid) * w).sum().backward()
        if d == card:
            assert contract.pos_grad.launches == before + 1
        out[str(d)] = (*kern, pl.grad)
    for k, c in zip(out[str(card)], out["cpu"]):
        assert _rel(k.cpu(), c) <= 3e-5


def _launches():
    return {k: getattr(contract, k).launches for k in KERNELS + ("spread_tiles",)}


def test_zero_points_on_the_card(card):
    """C7 on the card: no points, 2D, N = 8, m = 3. Each entry point on
    every strategy returns the CPU's zeros (a zero (1, 8, 8) adjoint, empty
    forward and fastsum) on the card."""
    pos = np.zeros((0, 2), np.float32)
    x = np.zeros((0,), np.complex64)
    spectrum = np.zeros((1, 8, 8), np.complex64)
    coeffs = tp.gaussian_analytic_coeffs(0.1, dim=2, N=8, device="cpu")
    for strategy in ("auto", "scatter", "matmul", "binned"):
        for d in (card, "cpu"):
            kw = dict(cutoff=3, strategy=strategy, device=d)
            ys = (tp.nfft_adjoint(x, pos, bandwidth=8, **kw), tp.nfft_forward(spectrum, pos, **kw),
                  tp.nfft_fastsum(x, coeffs, pos, **kw))
            if d == card:
                got = ys
            else:
                for g, r in zip(got, ys):
                    assert g.device == card and g.shape == r.shape and g.dtype == r.dtype
                    assert torch.equal(g.cpu(), r)


def test_zero_columns_on_the_card(card, rng):
    """C8 on the card: x of shape (300, 0) at 300 3D points. The entry points
    return the CPU's empty results on the card before any FFT (cuFFT is not
    asked) or kernel runs."""
    pos = ((rng.random((300, 3), dtype=np.float32) - 0.5) / 4)
    x = np.zeros((300, 0), np.float32)
    spectrum = np.zeros((1, 8, 8, 8, 0), np.complex64)
    coeffs = tp.gaussian_analytic_coeffs(0.1, dim=3, N=8, device="cpu")
    for strategy in ("auto", "binned", "matmul"):
        kw = dict(cutoff=2, strategy=strategy)
        before = _launches()
        ys = (tp.nfft_adjoint(x, pos, bandwidth=8, device=card, **kw),
              tp.nfft_forward(spectrum, pos, device=card, **kw),
              tp.nfft_fastsum(x, coeffs, pos, device=card, **kw))
        torch.cuda.synchronize()
        assert _launches() == before
        refs = (tp.nfft_adjoint(x, pos, bandwidth=8, device="cpu", **kw),
                tp.nfft_forward(spectrum, pos, device="cpu", **kw),
                tp.nfft_fastsum(x, coeffs, pos, device="cpu", **kw))
        assert [tuple(y.shape) for y in ys] == [(1, 8, 8, 8, 0), (300, 0), (300, 0)]
        for y, r in zip(ys, refs):
            assert y.device == card and y.shape == r.shape and y.dtype == r.dtype


def test_compat_layer_on_the_card_matches_the_cpu(card, rng):
    """torch_compat on card tensors: the adjoint and x.grad through it, and a
    Gram matvec ``@`` with its backward, against the same calls on CPU
    tensors; the results and gradients stay on the card. The front end
    builds its kernel on the points' device: its coefficients are bitwise
    those of the port's own kernel there, and its matvec agrees with that
    kernel's within 1e-6 (this plan's spread adds by atomics)."""
    from torch_nfft_tpu_torch import torch_compat as tc

    pos, _ = points(rng, 5000, 3)
    x = rng.standard_normal((5000, 2)).astype(np.float32)
    out = {}
    for d in (card, "cpu"):
        p = torch.from_numpy(pos).to(d)
        xa = torch.from_numpy(x).to(d).requires_grad_()
        y = tc.nfft_adjoint(xa, p, bandwidth=16, cutoff=3)
        (y.abs() ** 2).sum().backward()
        xg = torch.from_numpy(x).to(d).requires_grad_()
        kernel = tc.GaussianKernel(0.4, dim=3, bandwidth=16, cutoff=3)
        z = kernel(p) @ xg
        (z ** 2).sum().backward()
        port = tp.GaussianKernel(0.4, dim=3, bandwidth=16, cutoff=3, device=d)
        assert kernel.coeffs.device == p.device and torch.equal(kernel.coeffs, port.coeffs)
        assert _rel(z.detach(), port(p) @ xg.detach()) <= 1e-6
        out[str(d)] = (torch.view_as_real(y.detach()), xa.grad, z.detach(), xg.grad)
    for g, c in zip(out[str(card)], out["cpu"]):
        assert g.device == card
        assert _rel(g.cpu(), c) <= 3e-5


# ---------------------------------------------------------------------------
# The span recorder against the device trace
# ---------------------------------------------------------------------------

CUSTOM = re.compile(r"\b(spread_kernel|spread_contract_kernel|points_kernel)\b")
STAGE_OF = {"spread": ("spread kernel", "spread tiles kernel"),
            "points": ("gather kernel", "pos_grad")}


def _int32(v):
    """A thread's ``threading.get_ident()`` as the profiler's runtime
    events carry it: cut to a signed 32-bit integer."""
    return ((v & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


def _innermost(recorded, s, e):
    """The span that started last among those around [s, e], and the
    least distance to its bounds in ns."""
    inside = [sp for sp in recorded if sp.start_ns <= s and e <= sp.end_ns]
    inner = max(inside, key=lambda sp: (sp.start_ns, sp.id), default=None)
    return inner, None if inner is None else min(s - inner.start_ns, inner.end_ns - e)


def _custom_launches(prof, recorded):
    """(kernel, its launch's thread, the innermost span at the launch on
    that thread, the same on any thread, the launch's least distance to
    that span's bounds in ns) for every custom kernel of the trace, tied
    to its host launch by correlation id."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels, runtime = [], {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == cuda:
            if CUSTOM.search(ev.name()):
                kernels.append((ev.name(), ev.correlation_id()))
        elif ev.correlation_id() > 0:
            runtime[ev.correlation_id()] = (ev.start_ns(), ev.end_ns(), ev.device_resource_id())
    out = []
    for name, corr in kernels:
        s, e, thread = runtime[corr]
        mine = [sp for sp in recorded if _int32(sp.thread) == thread]
        strict, _ = _innermost(mine, s, e)
        anywhere, margin = _innermost(recorded, s, e)
        out.append((name, thread, strict, anywhere, margin))
    return out


def test_custom_launches_fall_inside_their_stage_spans(card, rng, monkeypatch):
    """The recorder on, ``torch.profiler`` with CUDA activity alone: one
    ``nfft_pair_planar`` call (dense route, C = 1), its training step (the
    backward on autograd's device thread) and one Gram matvec at C = 8
    (flat route, forced). Every launch of B1, B7, B2 and B5 is tied to
    its host call by correlation id, and that call lies inside the stage
    span that launched it, on the launching thread and the same clock."""
    n, N = 1 << 17, 32
    pos = torch.from_numpy(points(rng, n, 3)[0]).to(card)
    plan = tp.build_plan_device(pos, N=N, m=2, sigma=1.625, window="es", device=card)
    kw = dict(batch_size=1, N=N, m=2, sigma=1.625, window="es", strategy="binned",
              device=card)
    x1 = torch.randn((n, 1), device=card)
    x8 = torch.randn((n, 8), device=card)
    G = tp.GaussianKernel(0.4, dim=3, bandwidth=N, cutoff=4, device=card)(pos)

    def step():
        x = x1.clone().requires_grad_(True)
        p = pos.clone().requires_grad_(True)
        tp.nfft_pair_planar(x, p, None, plan, **kw).sum().backward()

    def gram_flat():
        with monkeypatch.context() as mp:
            mp.setattr(binned, "use_fold", lambda *a, **k: False)
            return G @ x8

    calls = (lambda: tp.nfft_pair_planar(x1, pos, None, plan, **kw), step, gram_flat)
    for call in calls:  # build the kernels and the operator's plan
        call()
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    tp.trace.drain()
    tp.trace.enable()
    try:
        with torch.profiler.profile(activities=[act.CUDA]) as prof:
            for call in calls:
                call()
            torch.cuda.synchronize()
    finally:
        tp.trace.disable()
    recorded = tp.trace.drain()
    roots = sorted(s.name for s in recorded if s.parent is None)
    assert roots == ["GramMatrix.apply"] + ["backward"] * 4 + ["nfft_pair_planar"] * 2
    launches = _custom_launches(prof, recorded)
    kinds = {"spread": 0, "points": 0}
    for name, _, strict, anywhere, _ in launches:
        kind = "points" if "points_kernel" in name else "spread"
        kinds[kind] += 1
        assert anywhere is not None, f"{name} launched outside every span"
        assert anywhere.name in STAGE_OF[kind], (name, anywhere.name)
    assert kinds == {"spread": 4, "points": 6}
    span_threads = sorted({_int32(s.thread) for s in recorded})
    launch_threads = sorted({t for _, t, _, _, _ in launches})
    same = sum(strict is not None and strict.id == anywhere.id
               for _, _, strict, anywhere, _ in launches)
    margins = [m for *_, m in launches]
    print(f"custom launches {len(launches)}: 100% inside their stage span; on the launching "
          f"thread {same}; threads of the spans {span_threads}, of the launches "
          f"{launch_threads}; least margin between a launch and its span's bounds "
          f"{min(margins) / 1e3:.1f} us")
    assert same == len(launches)
