"""PyTorch port vs JAX package: the streamed batched transforms
(ops/streaming.py), at the cases of tests/test_streaming.py.

The port's streamed adjoint, forward and fastsum agree with the JAX
package's streamed functions within rel-L2 3e-5, on the port's own layout
and on the JAX layout carried across (``convert.layout_from_numpy``), and
with the port's all-at-once batched transforms within 1e-5 (block-diagonal
independence: each member is a transform of its own). ``pack`` and
``unpack`` are inverses; the entry points refuse a stacked plan.
"""

import numpy as np
import pytest
import torch
from _torch_port import rel_l2

import torch_nfft_tpu as tn
import torch_nfft_tpu_torch as tp
from torch_nfft_tpu.ops import streaming as jstream
from torch_nfft_tpu_torch.convert import PLAN_ARRAYS, PLAN_STATICS

JAX_TOL, BATCHED_TOL = 3e-5, 1e-5


def _batched_points(rng, counts, dim):
    n = int(np.sum(counts))
    pos = (rng.random((n, dim)) - 0.5).astype(np.float32)
    pos /= 4 * np.abs(pos).max()
    batch = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
    return pos, batch


def _layouts(pos, batch, B, N, m, **kw):
    """(JAX layout, the port's own layout, the JAX layout carried across)."""
    jl = tn.make_streamed_layout(pos, batch, batch_size=B, N=N, m=m, **kw)
    pl = tp.make_streamed_layout(pos, batch, batch_size=B, N=N, m=m, device="cpu", **kw)
    plans = None
    if jl.plans is not None:
        plans = ({name: np.asarray(getattr(jl.plans, name)) for name in PLAN_ARRAYS},
                 {name: getattr(jl.plans, name) for name in PLAN_STATICS})
    carried = tp.layout_from_numpy(np.asarray(jl.pos_stack), jl.counts, plans, jl.N, jl.m,
                                   jl.sigma, jl.window, device="cpu")
    return jl, pl, carried


def _c(yr, yi):
    return np.asarray(yr) + 1j * np.asarray(yi)


@pytest.mark.parametrize("counts", [(300, 300, 300), (250, 400, 175)])
def test_adjoint_streamed(rng, counts):
    dim, N, m, C = 2, 16, 4, 3
    B = len(counts)
    pos, batch = _batched_points(rng, counts, dim)
    x = rng.standard_normal((pos.shape[0], C)).astype(np.float32)
    jl, pl, carried = _layouts(pos, batch, B, N, m)
    want = _c(*tn.nfft_adjoint_streamed(x, jl))
    got = _c(*tp.nfft_adjoint_streamed(x, pl))
    assert got.shape == want.shape == (B, N, N, C)
    assert rel_l2(got, want) <= JAX_TOL
    assert rel_l2(_c(*tp.nfft_adjoint_streamed(torch.from_numpy(x), carried)), want) <= JAX_TOL
    ref = _c(*tp.nfft_adjoint_planar(x, pos, batch, batch_size=B, N=N, m=m,
                                     strategy="binned", device="cpu"))
    assert rel_l2(got, ref) <= BATCHED_TOL


def test_forward_streamed(rng):
    counts, dim, N, m, C = (220, 350), 2, 16, 4, 2
    B = len(counts)
    pos, batch = _batched_points(rng, counts, dim)
    spec_r = rng.standard_normal((B,) + (N,) * dim + (C,)).astype(np.float32)
    spec_i = rng.standard_normal(spec_r.shape).astype(np.float32)
    jl, pl, carried = _layouts(pos, batch, B, N, m)
    for xi in (None, spec_i):
        want = _c(*tn.nfft_forward_streamed(spec_r, xi, jl))
        got = _c(*tp.nfft_forward_streamed(spec_r, xi, pl))
        assert got.shape == want.shape == (pos.shape[0], C)
        assert rel_l2(got, want) <= JAX_TOL
        assert rel_l2(_c(*tp.nfft_forward_streamed(spec_r, xi, carried)), want) <= JAX_TOL
        ref = _c(*tp.nfft_forward_planar(spec_r, xi, pos, batch, batch_size=B, dim=dim, m=m,
                                         strategy="binned", device="cpu"))
        assert rel_l2(got, ref) <= BATCHED_TOL


def test_fastsum_streamed(rng):
    counts, dim, N, m = (200, 300), 2, 8, 3
    B = len(counts)
    src, batch = _batched_points(rng, counts, dim)
    x = rng.standard_normal((src.shape[0], 2)).astype(np.float32)
    coeffs = np.asarray(tn.gaussian_analytic_coeffs(0.25, dim=dim, N=N))
    jl, pl, carried = _layouts(src, batch, B, N, m)
    want = np.asarray(tn.nfft_fastsum_streamed(x, coeffs, jl))
    got = tp.nfft_fastsum_streamed(x, coeffs, pl).numpy()
    assert rel_l2(got, want) <= JAX_TOL
    assert rel_l2(tp.nfft_fastsum_streamed(x, coeffs, carried).numpy(), want) <= JAX_TOL
    ref = tp.nfft_fastsum_real(x, coeffs, src, src, batch, batch, batch_size=B, N=N, m=m,
                               strategy="binned", device="cpu").numpy()
    assert rel_l2(got, ref) <= BATCHED_TOL


def test_fastsum_streamed_asymmetric_targets(rng):
    dim, N, m = 2, 8, 3
    src, sb = _batched_points(rng, (180, 220), dim)
    tgt, tb = _batched_points(rng, (150, 260), dim)
    x = rng.standard_normal((src.shape[0], 1)).astype(np.float32)
    coeffs = np.asarray(tn.gaussian_analytic_coeffs(0.3, dim=dim, N=N))
    jsl, psl, _ = _layouts(src, sb, 2, N, m)
    jtl, ptl, _ = _layouts(tgt, tb, 2, N, m)
    want = np.asarray(tn.nfft_fastsum_streamed(x, coeffs, jsl, jtl))
    got = tp.nfft_fastsum_streamed(x, coeffs, psl, ptl).numpy()
    assert got.shape == (tgt.shape[0], 1)
    assert rel_l2(got, want) <= JAX_TOL
    ref = tp.nfft_fastsum_real(x, coeffs, src, tgt, sb, tb, batch_size=2, N=N, m=m,
                               strategy="binned", device="cpu").numpy()
    assert rel_l2(got, ref) <= BATCHED_TOL
    with pytest.raises(ValueError, match="bandwidth"):
        tp.nfft_fastsum_streamed(x, coeffs[1:-1, 1:-1], psl)


@pytest.mark.parametrize("plan", [False, True])
def test_streamed_column_chunks(rng, plan):
    counts, dim, N, m, C = (150, 150), 2, 16, 4, 5
    B = len(counts)
    pos, batch = _batched_points(rng, counts, dim)
    x = rng.standard_normal((pos.shape[0], C)).astype(np.float32)
    jl, pl, _ = _layouts(pos, batch, B, N, m, plan=plan)
    assert (pl.plans is None) == (not plan)
    want = _c(*tn.nfft_adjoint_streamed(x, jl, column_chunk=2))
    whole = _c(*tp.nfft_adjoint_streamed(x, pl))
    chunked = _c(*tp.nfft_adjoint_streamed(x, pl, column_chunk=2))
    assert rel_l2(chunked, want) <= JAX_TOL
    assert rel_l2(chunked, whole) <= BATCHED_TOL
    yr, yi = tp.nfft_adjoint_streamed(x, pl)
    fw = _c(*tp.nfft_forward_streamed(yr, yi, pl, column_chunk=3))
    assert rel_l2(fw, _c(*tp.nfft_forward_streamed(yr, yi, pl))) <= BATCHED_TOL
    assert rel_l2(fw, _c(*tn.nfft_forward_streamed(yr.numpy(), yi.numpy(), jl,
                                                    column_chunk=3))) <= JAX_TOL


def test_streamed_round_trip_3d(rng):
    """The batched configuration in miniature: a 3D streamed pair, two
    trailing columns."""
    counts, dim, N, m, C = (128, 128), 3, 8, 3, 2
    B = len(counts)
    pos, batch = _batched_points(rng, counts, dim)
    x = rng.standard_normal((pos.shape[0], C)).astype(np.float32)
    jl, pl, _ = _layouts(pos, batch, B, N, m)
    yr, yi = tp.nfft_adjoint_streamed(x, pl)
    zr, _ = tp.nfft_forward_streamed(yr, yi, pl)
    jyr, jyi = tn.nfft_adjoint_streamed(x, jl)
    jzr, _ = tn.nfft_forward_streamed(jyr, jyi, jl)
    assert rel_l2(zr.numpy(), np.asarray(jzr)) <= JAX_TOL
    ref = tp.nfft_pair_planar(x, pos, batch, batch_size=B, N=N, m=m, strategy="binned",
                              device="cpu").numpy()
    assert rel_l2(zr.numpy(), ref) <= BATCHED_TOL


def test_streamed_shared_slab_t16(rng):
    """Members binned at T = 16 share one merged active slab (a partial one
    at this size); the streamed adjoint matches JAX's and the plan-free
    batched scatter pipeline."""
    n, dim, N, m, B = 1200, 3, 64, 4, 2
    pos = ((rng.random((n, dim)) - 0.5) * 0.5).astype(np.float32)
    batch = np.sort(rng.integers(0, B, n)).astype(np.int32)
    batch[0], batch[-1] = 0, B - 1
    x = rng.standard_normal((n, 2)).astype(np.float32)
    jl, pl, carried = _layouts(pos, batch, B, N, m, T=16)
    assert pl.plans.T == 16 and pl.plans.active is not None
    assert pl.plans.active == jl.plans.active
    got = _c(*tp.nfft_adjoint_streamed(x, pl))
    assert rel_l2(got, _c(*jstream.nfft_adjoint_streamed(x, jl))) <= JAX_TOL
    assert rel_l2(_c(*tp.nfft_adjoint_streamed(x, carried)), got) <= BATCHED_TOL
    ref = _c(*tp.nfft_adjoint_planar(x, pos, batch, batch_size=B, N=N, m=m,
                                     strategy="scatter", device="cpu"))
    assert rel_l2(got, ref) <= BATCHED_TOL


@pytest.mark.parametrize("counts", [(7, 0, 12), (30, 30)])
def test_pack_unpack_are_inverses(rng, counts):
    pos, batch = _batched_points(rng, counts, 2)
    pl = tp.make_streamed_layout(pos, batch, batch_size=len(counts), N=8, m=2, plan=False,
                                 device="cpu")
    x = torch.from_numpy(rng.standard_normal((pos.shape[0], 3)).astype(np.float32))
    packed = pl.pack(x)
    assert packed.shape == (len(counts), max(counts), 3)
    assert torch.equal(pl.unpack(packed), x)
    # the padding is zero, and the points sit where split_by_batch puts them
    _, x_stack, _, _ = tp.split_by_batch(pos, x.numpy(), batch, len(counts))
    np.testing.assert_array_equal(packed.numpy(), x_stack)
    np.testing.assert_array_equal(np.asarray(tn.make_streamed_layout(
        pos, batch, batch_size=len(counts), N=8, m=2, plan=False).pack(x.numpy())),
        packed.numpy())


def test_entry_points_refuse_a_stacked_plan(rng):
    pos, batch = _batched_points(rng, (100, 100), 2)
    pl = tp.make_streamed_layout(pos, batch, batch_size=2, N=16, m=3, device="cpu")
    x = rng.standard_normal((100, 1)).astype(np.float32)
    with pytest.raises(ValueError, match="index_plan"):
        tp.nfft_adjoint_planar(x, pl.pos_stack[0], None, pl.plans, batch_size=1, N=16, m=3,
                               device="cpu")
    with pytest.raises(ValueError, match="index_plan"):
        tp.nfft_adjoint(x, pl.pos_stack[0], bandwidth=16, cutoff=3, plan=pl.plans,
                        device="cpu")
    # one member runs
    tp.nfft_adjoint_planar(x, pl.pos_stack[0], None, tp.index_plan(pl.plans, 0),
                           batch_size=1, N=16, m=3, device="cpu")


def test_layout_needs_a_card_unless_asked(rng, monkeypatch):
    pos, batch = _batched_points(rng, (20, 20), 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.make_streamed_layout(pos, batch, batch_size=2, N=8, m=2)


@pytest.mark.parametrize("chunk", [None, 1])
@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("counts", [(250, 400, 175), (300, 0, 450)])
def test_pair_streamed(rng, monkeypatch, counts, C, chunk):
    """The streamed pair on half spectra against the streamed adjoint and
    forward (the real plane), JAX's streamed composition and the
    all-at-once batched pair; an empty member's pass gives zeros."""
    dim, N, m = 2, 16, 4
    B = len(counts)
    pos, batch = _batched_points(rng, counts, dim)
    x = rng.standard_normal((pos.shape[0], C)).astype(np.float32)
    jl, pl, carried = _layouts(pos, batch, B, N, m)
    stacked = []
    unpack = pl.unpack
    monkeypatch.setattr(pl, "unpack", lambda y: stacked.append(y.clone()) or unpack(y))
    got = tp.nfft_pair_streamed(x, pl, column_chunk=chunk)
    assert got.shape == (pos.shape[0], C) and got.dtype == torch.float32
    zr, _ = tp.nfft_forward_streamed(*tp.nfft_adjoint_streamed(x, carried), carried,
                                     column_chunk=chunk)
    assert rel_l2(got.numpy(), zr.numpy()) <= BATCHED_TOL
    jzr, _ = tn.nfft_forward_streamed(*tn.nfft_adjoint_streamed(x, jl, column_chunk=chunk),
                                      jl, column_chunk=chunk)
    assert rel_l2(got.numpy(), np.asarray(jzr)) <= JAX_TOL
    ref = tp.nfft_pair_planar(x, pos, batch, batch_size=B, N=N, m=m, strategy="binned",
                              device="cpu")
    assert rel_l2(got.numpy(), ref.numpy()) <= BATCHED_TOL
    assert stacked[0].shape == (B, max(counts), C)
    for i, count in enumerate(counts):
        if count == 0:
            assert float(stacked[0][i].abs().max()) == 0.0


def test_pair_streamed_3d_trailing_columns(rng):
    """The batched configuration in miniature through the streamed pair:
    3D, trailing columns (2, 2) kept in the result's shape."""
    counts, dim, N, m = (128, 96), 3, 8, 3
    B = len(counts)
    pos, batch = _batched_points(rng, counts, dim)
    x = rng.standard_normal((pos.shape[0], 2, 2)).astype(np.float32)
    jl, pl, _ = _layouts(pos, batch, B, N, m)
    got = tp.nfft_pair_streamed(torch.from_numpy(x), pl)
    assert got.shape == x.shape
    jzr, _ = tn.nfft_forward_streamed(*tn.nfft_adjoint_streamed(x, jl), jl)
    assert rel_l2(got.numpy(), np.asarray(jzr)) <= JAX_TOL
    ref = tp.nfft_pair_planar(x.reshape(-1, 4), pos, batch, batch_size=B, N=N, m=m,
                              strategy="binned", device="cpu")
    assert rel_l2(got.reshape(-1, 4).numpy(), ref.numpy()) <= BATCHED_TOL
