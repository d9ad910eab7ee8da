"""PyTorch port vs JAX package: the streamed batched transforms
(ops/streaming.py), at the cases of tests/test_streaming.py.

The port's streamed adjoint, forward and fastsum agree with the JAX
package's streamed functions within rel-L2 3e-5, on the port's own layout
and on the JAX layout carried across (``convert.layout_from_numpy``), and
with the port's all-at-once batched transforms within 1e-5 (block-diagonal
independence: each member is a transform of its own). ``pack`` and
``unpack`` are inverses; the entry points refuse a stacked plan.

The streamed pair's training step (``nfft_pair_streamed(x, layout,
pos=pos)``, L = <z, w>): x.grad and pos.grad against float64 sums over
each member's points and against autograd through each member's
``nfft_pair_planar``; without ``pos`` only x.grad; other points raise;
with nothing that requires grad the call is the member loop, bit for bit
and launch for launch.
"""

import math

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


# The streamed pair's training step: 3D, N = 16, gaussian m = 4, C = 2, three
# members of uneven counts, one of them empty.
STEP_COUNTS, STEP_N, STEP_M, STEP_C = (300, 0, 420), 16, 4, 2
# The step's error is the pair's window error at gaussian m = 4, sigma = 2
# (~1e-4 rel-L2 at this size); the position gradient runs the window's
# derivative, ~5x less accurate (~5e-4 here). Each bar is ~3x the reading.
STEP_XGRAD_TOL, STEP_POSGRAD_TOL = 3e-4, 2e-3


def _step_case(rng):
    pos, batch = _batched_points(rng, STEP_COUNTS, 3)
    n = pos.shape[0]
    layout = tp.make_streamed_layout(pos, batch, batch_size=len(STEP_COUNTS), N=STEP_N,
                                     m=STEP_M, window="gaussian", device="cpu")
    x = torch.from_numpy(rng.standard_normal((n, STEP_C)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((n, STEP_C)).astype(np.float32))
    return pos, layout, x, w


def _step(layout, x, w, pos=None, **kw):
    """(z, x.grad, pos.grad) of L = <nfft_pair_streamed(x, layout, pos=pos), w>."""
    x = x.clone().requires_grad_(True)
    z = tp.nfft_pair_streamed(x, layout, pos=pos, **kw)
    (z * w).sum().backward()
    return z.detach(), x.grad, None if pos is None else pos.grad


def _member_bounds():
    return np.concatenate([[0], np.cumsum(STEP_COUNTS)])


def _float64_step(pos, x, w, N):
    """z, x.grad and pos.grad of L = <z, w>, z = Re forward(adjoint(x)) by
    the dense sums over one member's points, in float64."""
    pos = torch.as_tensor(pos, dtype=torch.float64).clone().requires_grad_(True)
    x = x.double().clone().requires_grad_(True)
    dim = pos.shape[1]
    k = torch.stack(torch.meshgrid(*[torch.arange(-N // 2, N // 2, dtype=torch.float64)] * dim,
                                   indexing="ij"), -1).reshape(-1, dim)
    E = torch.exp(2j * math.pi * (pos @ k.T))
    z = (E.conj() @ (E.T @ x.to(torch.complex128))).real
    gx, gp = torch.autograd.grad((z * w.double()).sum(), (x, pos))
    return z.detach(), gx, gp


@pytest.mark.parametrize("chunk", [None, 1])
def test_pair_streamed_step_matches_float64(rng, chunk):
    pos, layout, x, w = _step_case(rng)
    p = torch.from_numpy(pos).requires_grad_(True)
    z, xg, pg = _step(layout, x, w, p, column_chunk=chunk)
    assert xg.shape == x.shape and pg.shape == p.shape and pg.dtype == torch.float32
    b = _member_bounds()
    for lo, hi in zip(b[:-1], b[1:]):
        if hi == lo:
            continue
        zr, gx, gp = _float64_step(pos[lo:hi], x[lo:hi], w[lo:hi], STEP_N)
        assert rel_l2(z[lo:hi].numpy(), zr.numpy()) <= STEP_XGRAD_TOL
        assert rel_l2(xg[lo:hi].numpy(), gx.numpy()) <= STEP_XGRAD_TOL
        assert rel_l2(pg[lo:hi].numpy(), gp.numpy()) <= STEP_POSGRAD_TOL


@pytest.mark.parametrize("chunk", [None, 1])
def test_pair_streamed_step_matches_member_autograd(rng, chunk):
    """Autograd through each member's ``nfft_pair_planar`` on its own plan
    runs the same kernels in another order: within 1e-5."""
    pos, layout, x, w = _step_case(rng)
    p = torch.from_numpy(pos).requires_grad_(True)
    z, xg, pg = _step(layout, x, w, p, column_chunk=chunk)
    b = _member_bounds()
    for i, (lo, hi) in enumerate(zip(b[:-1], b[1:])):
        if hi == lo:
            assert xg[lo:hi].numel() == 0
            continue
        xi = x[lo:hi].clone().requires_grad_(True)
        pi = torch.from_numpy(pos[lo:hi]).requires_grad_(True)
        zi = tp.nfft_pair_planar(xi, pi, None, batch_size=1, N=STEP_N, m=STEP_M,
                                 window="gaussian", strategy="binned", device="cpu")
        (zi * w[lo:hi]).sum().backward()
        assert rel_l2(z[lo:hi].numpy(), zi.detach().numpy()) <= BATCHED_TOL
        assert rel_l2(xg[lo:hi].numpy(), xi.grad.numpy()) <= BATCHED_TOL
        assert rel_l2(pg[lo:hi].numpy(), pi.grad.numpy()) <= BATCHED_TOL


@pytest.mark.parametrize("pos_dtype", [None, torch.float32, torch.float64])
def test_pair_streamed_step_gives_the_gradients_asked_for(rng, pos_dtype):
    """Without ``pos`` only x.grad, and no recomputed pass; ``pos`` that
    requires grad in float64 gets its gradient in float64; ``pos`` given
    alone (x not requiring grad) gets pos.grad and x none."""
    pos, layout, x, w = _step_case(rng)
    before = tp.trace.counters()
    if pos_dtype is None:
        _, xg, _ = _step(layout, x, w)
        after = tp.trace.counters()
        assert after["streamed_recompute_passes"] == before["streamed_recompute_passes"]
        assert after["streamed_backward_members"] - before["streamed_backward_members"] == 3
        _, want, _ = _step(layout, x, w, torch.from_numpy(pos).requires_grad_(True))
        assert torch.equal(xg, want)
        return
    p = torch.from_numpy(pos).to(pos_dtype).requires_grad_(True)
    z = tp.nfft_pair_streamed(x, layout, pos=p)
    (z * w).sum().backward()
    assert p.grad.dtype == pos_dtype and p.grad.shape == p.shape
    assert tp.trace.counters()["streamed_recompute_passes"] - \
        before["streamed_recompute_passes"] == 3
    _, _, want = _step(layout, x, w, torch.from_numpy(pos).requires_grad_(True))
    assert torch.equal(p.grad.float(), want)


@pytest.mark.parametrize("other", ["shape", "moved", "dropped"])
def test_pair_streamed_refuses_other_points(rng, other):
    pos, layout, x, _ = _step_case(rng)
    p = torch.from_numpy(pos)
    if other == "shape":
        p = p[:, :2]
    elif other == "moved":
        p = p.clone()
        p[5, 1] += 1e-3
    else:
        p, x = p[1:], x[1:]
    with pytest.raises(ValueError, match="pos"):
        tp.nfft_pair_streamed(x, layout, pos=p.requires_grad_(True))


@pytest.mark.parametrize("case", ["no grad", "grad mode off", "pos without grad",
                                  "grad forward"])
def test_pair_streamed_without_grad_is_the_member_loop(rng, monkeypatch, case):
    """With nothing that requires grad the call is the member loop (each
    member's ``nfft_pair_planar`` on its plan): the same bits, the same
    kernel calls, nothing saved; the differentiable forward gives the
    same bits too."""
    from torch_nfft_tpu_torch.ops import binned, tilefold

    pos, layout, x, _ = _step_case(rng)
    calls = {}

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)

        monkeypatch.setattr(mod, name, wrapper)

    for name in ("spread_tiles_dense", "gather_points", "pos_grad", "slot_values",
                 "unslot_values"):
        counted(binned, name)
    counted(tilefold, "fold_tiles_to_grid")
    counted(tilefold, "unfold_grid_to_tiles")
    want = torch.zeros_like(x)
    b = _member_bounds()
    for i, (lo, hi) in enumerate(zip(b[:-1], b[1:])):
        xi = torch.zeros((layout.n_max, STEP_C))
        xi[: hi - lo] = x[lo:hi]
        zi = tp.nfft_pair_planar(xi, layout.pos_stack[i], None, layout.member_plan(i),
                                 batch_size=1, N=STEP_N, m=STEP_M, window="gaussian",
                                 device="cpu")
        want[lo:hi] = zi[: hi - lo]
    loop, calls = calls, {}
    if case == "no grad":
        z = tp.nfft_pair_streamed(x, layout)
    elif case == "grad mode off":
        with torch.no_grad():
            z = tp.nfft_pair_streamed(x.clone().requires_grad_(True), layout,
                                      pos=torch.from_numpy(pos).requires_grad_(True))
    elif case == "pos without grad":
        z = tp.nfft_pair_streamed(x, layout, pos=torch.from_numpy(pos))
    else:
        z = tp.nfft_pair_streamed(x.clone().requires_grad_(True), layout,
                                  pos=torch.from_numpy(pos).requires_grad_(True))
    assert torch.equal(z.detach(), want)
    assert calls == loop and loop["spread_tiles_dense"] == len(STEP_COUNTS)
    assert (z.grad_fn is None) == (case != "grad forward")


def test_pair_streamed_step_needs_member_plans(rng):
    pos, batch = _batched_points(rng, (40, 60), 3)
    layout = tp.make_streamed_layout(pos, batch, batch_size=2, N=8, m=2, plan=False,
                                     device="cpu")
    x = torch.ones((100, 1), requires_grad=True)
    with pytest.raises(ValueError, match="plan=True"):
        tp.nfft_pair_streamed(x, layout)
    assert tp.nfft_pair_streamed(x.detach(), layout).shape == (100, 1)
