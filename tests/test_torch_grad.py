"""PyTorch port vs JAX package: gradients in the values and the point
positions, from the position-gradient contraction up to the planar entry
points, and against finite differences.

The same plan (built by JAX, carried across with ``plan_from_numpy``) runs
in both packages. The port's ``pos_grad`` (its plain version on the CPU) is
held against the TPU kernel B5 (``pos_grad_pallas``) in interpret mode,
and the port's autograd Functions against ``jax.grad`` of the JAX engines
(the XLA ones and the fused Pallas VJPs), at max-abs 5e-5 of the
reference's largest entry: the bar the JAX package holds its fused
backward to (tests/test_binned.py:335-341). Value gradients of the entry
points meet rel-L2 3e-5, the bar of the transforms themselves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import points, port_plan, rel_l2
from helpers import make_points
from test_torch_pair import CASES

import torch_nfft_tpu_torch as tp
from torch_nfft_tpu.ops import binned as jbinned
from torch_nfft_tpu.ops import planar as jplanar
from torch_nfft_tpu.ops import tilefold as jtilefold
from torch_nfft_tpu.ops.pallas import contract as jcontract
from torch_nfft_tpu_torch import trace
from torch_nfft_tpu_torch.ops import binned as pbinned
from torch_nfft_tpu_torch.ops import contract as pcontract
from torch_nfft_tpu_torch.ops.tilefold import row_tile_ids

REL = 3e-5


def assert_close_to_max(got, ref, frac=5e-5):
    """max |got - ref| <= frac * max |ref|."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(1e-6, float(np.abs(ref).max()))
    assert float(np.abs(got - ref).max()) <= frac * scale


@pytest.fixture
def highest_precision(monkeypatch):
    # the JAX kernels' f32-exact mode (their bf16 modes trade accuracy away)
    monkeypatch.setenv("TORCH_NFFT_TPU_KERNEL_PRECISION", "highest")
    monkeypatch.setenv("TORCH_NFFT_TPU_FUSED_BWD", "1")


def _setup(rng, dim, N, B=2, C=2, m=3, window="gaussian", n=200):
    pos, batch = points(rng, n, dim, B)
    jplan = jbinned.build_plan(pos, batch, N=N, m=m, batch_size=B, K=128, window=window)
    x = rng.standard_normal((n, C)).astype(np.float32)
    return pos, batch, x, jplan, port_plan(jplan)


def _grid_to_port(g_flat, plan, C):
    """JAX's flat grid (B*M^dim, C) -> the port's (B, C, M^dim)."""
    shape = (plan.batch_size,) + (plan.M,) * plan.dim + (C,)
    return np.moveaxis(np.asarray(g_flat).reshape(shape), -1, 1).copy()


@pytest.mark.parametrize("window", ["gaussian", "es", "kb"])
@pytest.mark.parametrize("dim,N", [(1, 32), (2, 16), (3, 8)])
def test_pos_grad_matches_b5(rng, highest_precision, dim, N, window):
    C = 2
    pos, batch, x, jplan, plan = _setup(rng, dim, N, C=C, window=window,
                                        m=2 if window == "kb" else 3)
    tiles = rng.standard_normal((plan.NT, C, plan.H, plan.H ** (dim - 1))).astype(np.float32)
    w_slot = rng.standard_normal((C, plan.S * plan.K)).astype(np.float32)
    ref = jcontract.pos_grad_pallas(jplan, jnp.asarray(tiles), None, C=C,
                                    tile_index=jtilefold.row_tile_ids(jplan),
                                    w_slot=jnp.asarray(w_slot))
    got = pcontract.pos_grad(plan, torch.from_numpy(tiles), torch.from_numpy(w_slot),
                             row_tile_ids(plan))
    assert got.shape == (plan.S, dim, plan.K)
    assert_close_to_max(got.numpy(), ref)


@pytest.mark.parametrize("engine", ["xla", "pallas"])
@pytest.mark.parametrize("dim,N", [(1, 16), (2, 16), (3, 8)])
def test_engine_vjps_match_jax(rng, highest_precision, engine, dim, N):
    """x.grad/pos.grad of <spread_binned(plan, x, pos), g> and g.grad/pos.grad
    of <gather_binned(plan, g, pos), y> against jax.grad of the JAX engines."""
    B, C = 2, 2
    pos, batch, x, jplan, plan = _setup(rng, dim, N, B=B, C=C)
    M = plan.M
    g = rng.standard_normal((B * M**dim, C)).astype(np.float32)
    jx, jpos, jg = jnp.asarray(x), jnp.asarray(pos), jnp.asarray(g)
    if engine == "xla":
        def spread(a, b):
            return jbinned._spread_xla(jplan, a, b, B)

        def gather(a, b):
            return jbinned._gather_xla(jplan, a, b)
    else:
        def spread(a, b):
            return jbinned._spread_pallas_cv(B, jplan, a, b)

        def gather(a, b):
            return jbinned._gather_pallas_cv(jplan, a, b)

    rx, rp = jax.grad(lambda a, b: jnp.vdot(spread(a, b), jg), argnums=(0, 1))(jx, jpos)
    xt = torch.from_numpy(x).requires_grad_()
    pt = torch.from_numpy(pos).requires_grad_()
    gt = torch.from_numpy(_grid_to_port(g, plan, C))
    (tp.spread_binned(plan, xt, pt) * gt).sum().backward()
    assert_close_to_max(xt.grad.numpy(), rx)
    assert_close_to_max(pt.grad.numpy(), rp)

    rg, rp = jax.grad(lambda a, b: jnp.vdot(gather(a, b), jx), argnums=(0, 1))(jg, jpos)
    pt.grad = None
    gt.requires_grad_()
    (tp.gather_binned(plan, gt, pt) * torch.from_numpy(x)).sum().backward()
    assert_close_to_max(gt.grad.numpy(), _grid_to_port(rg, plan, C))
    assert_close_to_max(pt.grad.numpy(), rp)


@pytest.mark.parametrize("dim", [2, 3])
def test_local_tile_spaces_match_jax(rng, highest_precision, dim):
    """dense_tiles_local and points_from_tiles_local on a caller's tile ids
    (here the plan's own dense ids) against the JAX package's and their
    custom VJPs: the tiles and the values, and the gradients in the
    values, the tiles and the positions. Each backward runs inside a
    ``backward`` span, its stages inside it."""
    C, N = 2, 8
    pos, batch, x, jplan, plan = _setup(rng, dim, N, B=1, C=C)
    NT, tid = plan.NT, pbinned.dense_tile_ids(plan)
    shape = (NT, C, plan.H, plan.H ** (dim - 1))
    w = rng.standard_normal(shape).astype(np.float32)
    tiles = rng.standard_normal(shape).astype(np.float32)
    y = rng.standard_normal(x.shape).astype(np.float32)
    jtid, jpos = jnp.asarray(tid.numpy()), jnp.asarray(pos)

    def spread(a, b):
        return jbinned.dense_tiles_local(NT, jplan, a, b, jtid).reshape(shape)

    def gather(a, b):
        return jbinned.points_from_tiles_local(NT, jplan, a, b, jtid)

    ref_t = spread(jnp.asarray(x), jpos)
    rx, rp = jax.grad(lambda a, b: jnp.vdot(spread(a, b), jnp.asarray(w)),
                      argnums=(0, 1))(jnp.asarray(x), jpos)
    ref_y = gather(jnp.asarray(tiles), jpos)
    rt, rq = jax.grad(lambda a, b: jnp.vdot(gather(a, b), jnp.asarray(y)),
                      argnums=(0, 1))(jnp.asarray(tiles), jpos)

    trace.drain()
    trace.enable()
    try:
        xt = torch.from_numpy(x).requires_grad_()
        pt = torch.from_numpy(pos).requires_grad_()
        got_t = pbinned.dense_tiles_local(NT, plan, xt, pt, tid)
        (got_t * torch.from_numpy(w)).sum().backward()
        tt = torch.from_numpy(tiles).requires_grad_()
        qt = torch.from_numpy(pos).requires_grad_()
        got_y = pbinned.points_from_tiles_local(NT, plan, tt, qt, tid)
        (got_y * torch.from_numpy(y)).sum().backward()
    finally:
        trace.disable()
        spans = sorted(trace.drain(), key=lambda s: (s.start_ns, s.id))
    for got, ref in ((got_t.detach(), ref_t), (xt.grad, rx), (pt.grad, rp),
                     (got_y.detach(), ref_y), (tt.grad, rt), (qt.grad, rq)):
        assert_close_to_max(got.numpy(), ref)
    backward = [s for s in spans if s.name == "backward"]
    assert [[c.name for c in spans if c.parent == b.id] for b in backward] == [
        ["gather kernel", "unslot_values", "pos_grad", "unslot_values"],
        ["slot_values", "spread kernel", "pos_grad", "unslot_values"]]


def test_value_grads_need_no_pos(rng):
    """pos=None (the default): value gradients only; pos.dtype is kept."""
    pos, batch, x, jplan, plan = _setup(rng, 2, 16)
    xt = torch.from_numpy(x).requires_grad_()
    tp.spread_binned(plan, xt).square().sum().backward()
    assert xt.grad is not None and xt.grad.shape == x.shape
    pt = torch.from_numpy(pos).double().requires_grad_()
    tp.spread_binned(plan, torch.from_numpy(x), pt).square().sum().backward()
    assert pt.grad.dtype == torch.float64 and pt.grad.shape == pos.shape
    with pytest.raises(ValueError, match="pos has shape"):
        tp.spread_binned(plan, torch.from_numpy(x), pt[:-1])


def _entry_case(rng, dim, N, B, C, m, sigma, window, n=200):
    pos, batch = points(rng, n, dim, B)
    x = rng.standard_normal((n, C)).astype(np.float32)
    jplan = jbinned.build_plan(pos, batch, N=N, m=m, sigma=sigma, batch_size=B,
                               K=128, window=window)
    kw = dict(batch_size=B, m=m, sigma=sigma, window=window)
    return pos, batch, x, jplan, port_plan(jplan), kw


def _leaves(*arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


@pytest.mark.parametrize("dim,N,B,C,m,sigma,window", CASES)
def test_entry_point_grads_match_jax(rng, dim, N, B, C, m, sigma, window):
    pos, batch, x, jplan, plan, kw = _entry_case(rng, dim, N, B, C, m, sigma, window)
    jb = jnp.asarray(batch)
    spec = (B,) + (N,) * dim + (C,)

    # pair: <pair(x, pos), w>
    w = rng.standard_normal(x.shape).astype(np.float32)
    rx, rp = jax.grad(lambda a, p: jnp.vdot(
        jplanar.nfft_pair_planar(a, p, jb, jplan, N=N, **kw), w), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(pos))
    xt, pt = _leaves(x, pos)
    (tp.nfft_pair_planar(xt, pt, batch, plan, N=N, device="cpu", **kw)
     * torch.from_numpy(w)).sum().backward()
    assert rel_l2(xt.grad.numpy(), rx) <= REL
    assert_close_to_max(pt.grad.numpy(), rp)

    # adjoint: <yr, wr> + <yi, wi>
    wr, wi = (rng.standard_normal(spec).astype(np.float32) for _ in range(2))

    def jadj(a, p):
        yr, yi = jplanar.nfft_adjoint_planar(a, p, jb, jplan, N=N, **kw)
        return jnp.vdot(yr, wr) + jnp.vdot(yi, wi)

    rx, rp = jax.grad(jadj, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(pos))
    xt, pt = _leaves(x, pos)
    yr, yi = tp.nfft_adjoint_planar(xt, pt, batch, plan, N=N, device="cpu", **kw)
    ((yr * torch.from_numpy(wr)).sum() + (yi * torch.from_numpy(wi)).sum()).backward()
    assert rel_l2(xt.grad.numpy(), rx) <= REL
    assert_close_to_max(pt.grad.numpy(), rp)

    # forward of both planes: <fr, vr> + <fi, vi>
    sr, si = (rng.standard_normal(spec).astype(np.float32) for _ in range(2))
    vr, vi = (rng.standard_normal(x.shape).astype(np.float32) for _ in range(2))

    def jfwd(a, b, p):
        fr, fi = jplanar.nfft_forward_planar(a, b, p, jb, jplan, dim=dim, **kw)
        return jnp.vdot(fr, vr) + jnp.vdot(fi, vi)

    rr, ri, rp = jax.grad(jfwd, argnums=(0, 1, 2))(jnp.asarray(sr), jnp.asarray(si),
                                                   jnp.asarray(pos))
    srt, sit, pt = _leaves(sr, si, pos)
    fr, fi = tp.nfft_forward_planar(srt, sit, pt, batch, plan, dim=dim, device="cpu", **kw)
    ((fr * torch.from_numpy(vr)).sum() + (fi * torch.from_numpy(vi)).sum()).backward()
    assert rel_l2(srt.grad.numpy(), rr) <= REL
    assert rel_l2(sit.grad.numpy(), ri) <= REL
    assert_close_to_max(pt.grad.numpy(), rp)


# ---------------------------------------------------------------------------
# Finite differences: the port's counterparts of tests/test_grad.py:101-157
# (adjoint and forward position gradients) and :202-233 (planar adjoint, x
# and pos), with the same inputs and bars.
# ---------------------------------------------------------------------------


def _fd(loss, p0, eps):
    """Central finite differences of ``loss`` at numpy ``p0``."""
    g = np.zeros_like(p0)
    for idx in np.ndindex(p0.shape):
        p = p0.copy()
        p[idx] += eps
        up = loss(p)
        p[idx] -= 2 * eps
        g[idx] = (up - loss(p)) / (2 * eps)
    return g


def _autograd(loss_t, a0):
    t = torch.from_numpy(a0).requires_grad_()
    loss_t(t).backward()
    return t.grad.numpy()


def _max_rel(g, g_ref):
    return np.abs(g - g_ref).max() / np.abs(g_ref).max()


def test_position_gradients_finite_differences(rng):
    n, dim, N, m = 6, 2, 16, 6
    pos0, _ = make_points(rng, n, dim)
    x = torch.from_numpy(rng.random((n, 1), dtype=np.float32))

    def loss(pos):
        y = tp.nfft_adjoint(x, pos, N=N, m=m, device="cpu")
        return (y.abs() ** 2).sum()

    g = _autograd(loss, pos0)
    g_fd = _fd(lambda p: float(loss(torch.from_numpy(p))), pos0, 2e-4)
    assert _max_rel(g, g_fd) < 5e-2


def test_position_gradients_forward_finite_differences(rng):
    n, dim, N, m = 6, 1, 16, 6
    pos0, _ = make_points(rng, n, dim)
    x = torch.from_numpy(rng.random((1, N), dtype=np.float32))

    def loss(pos):
        return (tp.nfft_forward(x, pos, cutoff=m, device="cpu").abs() ** 2).sum()

    g = _autograd(loss, pos0)
    g_fd = _fd(lambda p: float(loss(torch.from_numpy(p))), pos0, 2e-4)
    assert _max_rel(g, g_fd) < 5e-2


def test_planar_adjoint_finite_differences(rng):
    n, dim, N, m = 6, 2, 16, 4
    pos0, _ = make_points(rng, n, dim)
    x0 = rng.random((n, 2), dtype=np.float32)
    kw = dict(batch_size=1, N=N, m=m, device="cpu")

    def loss_x(x):
        yr, yi = tp.nfft_adjoint_planar(x, torch.from_numpy(pos0), None, **kw)
        return (yr**2 + yi**2).sum()

    g = _autograd(loss_x, x0)
    base = float(loss_x(torch.from_numpy(x0)))
    g_fd = np.zeros_like(x0)  # forward differences, as the JAX test takes them
    for idx in np.ndindex(x0.shape):
        xp = x0.copy()
        xp[idx] += 1e-3
        g_fd[idx] = (float(loss_x(torch.from_numpy(xp))) - base) / 1e-3
    assert _max_rel(g, g_fd) < 5e-3

    def loss_p(pos):
        yr, yi = tp.nfft_adjoint_planar(torch.from_numpy(x0), pos, None, **kw)
        return (yr**2 + yi**2).sum()

    g = _autograd(loss_p, pos0)
    g_fd = _fd(lambda p: float(loss_p(torch.from_numpy(p))), pos0, 2e-4)
    assert _max_rel(g, g_fd) < 5e-2
