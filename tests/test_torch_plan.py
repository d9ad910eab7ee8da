"""PyTorch port vs JAX package: the host plan builder.

The port's ``build_plan`` (the native counting sort of its own copy of
``csrc/plan_builder.cpp``) must equal the JAX package's ``build_plan`` field
by field, exactly, at the sizes of tests/test_binned.py (n=200, N=8, m=3,
K=128). Its NumPy reference tables and the port's device builder agree with
it on every filled slot and on every other table exactly: in a padded slot
the native builder writes point 0 where the NumPy and device builders repeat
the row's last point (slot_pt and the slot_pos gathered from it).
"""

import numpy as np
import pytest
import torch
from _torch_port import points

import torch_nfft_tpu_torch as tp
from torch_nfft_tpu.ops import binned as jbinned
from torch_nfft_tpu_torch import _native
from torch_nfft_tpu_torch.ops import binned
from torch_nfft_tpu_torch.ops import nfft as pnfft

TENSORS = ("slot_pt", "slot_pos", "origin", "row_batch", "fill_keys", "row_count")
STATICS = ("T", "K", "pos_fp", "S_occ", "active")

PLAN_CASES = [
    # dim, B, window, K, N, sigma
    (1, 1, "gaussian", None, 8, 2.0),
    (1, 3, "es", 128, 8, 2.0),
    (2, 1, "kb", None, 8, 2.0),
    (2, 3, "gaussian", 128, 8, 2.0),
    (3, 1, "es", 128, 8, 2.0),
    (3, 3, "kb", None, 8, 2.0),
    (3, 1, "es", None, 32, 2.0),  # M = 64: the density probe picks T = 32
]


def _filled(plan):
    k = torch.arange(plan.K)[None, :]
    return (k < plan.row_count.cpu()[:, None]).reshape(-1)


@pytest.mark.parametrize("dim,B,window,K,N,sigma", PLAN_CASES)
def test_host_plan_equals_jax(rng, dim, B, window, K, N, sigma):
    pos, batch = points(rng, 200, dim, B)
    kw = dict(N=N, m=3, sigma=sigma, batch_size=B, K=K, window=window)
    jp = jbinned.build_plan(pos, batch, **kw)
    pp = tp.build_plan(pos, batch, device="cpu", **kw)
    for name in TENSORS:
        np.testing.assert_array_equal(getattr(pp, name).numpy(),
                                      np.asarray(getattr(jp, name)), err_msg=name)
    for name in ("order", "row_start"):
        np.testing.assert_array_equal(getattr(pp, name), getattr(jp, name), err_msg=name)
    for name in STATICS:
        assert getattr(pp, name) == getattr(jp, name), name
    assert pp.pos_fp is not None and pp.S_occ > 0


@pytest.mark.parametrize("dim,B,window,K,N,sigma", PLAN_CASES[:6])
def test_native_tables_equal_numpy_tables(rng, dim, B, window, K, N, sigma):
    """The native builder against its NumPy reference, with K chosen from
    the counts (K=None) or given."""
    pos, batch = points(rng, 200, dim, B)
    M, m, T = int(round(sigma * N)), 3, 8
    nb = -(-M // T)
    n = len(pos)

    def pick_K(counts):
        return binned._choose_K(counts[counts > 0].astype(np.int64), n)

    args = (pos, batch, M, m, T, nb, K, B)
    nat, K_nat = _native.plan_tables(*args, pick_K=pick_K)
    ref, K_ref = binned.plan_tables_np(*args, pick_K=pick_K)
    assert K_nat == K_ref
    names = ("slot_pt", "slot_valid", "origin", "row_batch", "inv_slot", "order",
             "row_start", "row_count")
    valid = ref[1] > 0
    for name, a, b in zip(names, nat, ref):
        if name == "slot_pt":
            np.testing.assert_array_equal(a[valid], b[valid])
            assert (a[~valid] == 0).all()
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("dim,B,window,K,N,sigma", PLAN_CASES)
def test_host_plan_equals_device_plan(rng, dim, B, window, K, N, sigma):
    pos, batch = points(rng, 200, dim, B)
    kw = dict(N=N, m=3, sigma=sigma, batch_size=B, K=K, window=window, device="cpu")
    ph = tp.build_plan(pos, batch, **kw)
    pd = tp.build_plan_device(pos, batch, **kw)
    filled = _filled(ph)
    assert torch.equal(ph.slot_pt.reshape(-1)[filled], pd.slot_pt.reshape(-1)[filled])
    assert torch.equal(ph.slot_pos[:, filled], pd.slot_pos[:, filled])
    for name in TENSORS[2:]:
        assert torch.equal(getattr(ph, name), getattr(pd, name)), name
    for name in ("T", "K", "S_occ", "active"):
        assert getattr(ph, name) == getattr(pd, name), name
    assert pd.pos_fp is None and pd.order is None and pd.row_start is None


def test_host_plan_runs_like_the_device_plan(rng):
    """Both plans give the same pair, bit for bit: padded slots never reach
    a result."""
    pos, batch = points(rng, 300, 3, 2)
    x = rng.standard_normal((300, 2)).astype(np.float32)
    kw = dict(batch_size=2, N=8, m=2, sigma=1.625, window="es")
    ph = tp.build_plan(pos, batch, device="cpu", **kw)
    pd = tp.build_plan_device(pos, batch, device="cpu", **kw)
    a = tp.nfft_pair_planar(x, pos, batch, ph, device="cpu", **kw)
    b = tp.nfft_pair_planar(x, pos, batch, pd, device="cpu", **kw)
    assert torch.equal(a, b)


def test_host_plan_takes_tensors_and_lives_on_its_device(rng):
    pos, batch = points(rng, 150, 2, 2)
    a = tp.build_plan(torch.from_numpy(pos), torch.from_numpy(batch), N=16, m=3,
                      device="cpu")
    b = tp.build_plan(pos, batch, N=16, m=3, device="cpu")
    assert a.batch_size == b.batch_size == 2
    for name in TENSORS:
        assert torch.equal(getattr(a, name), getattr(b, name))
    assert a.device == torch.device("cpu") and isinstance(a.order, np.ndarray)


def test_plan_carries_host_fields_through_numpy(rng):
    pos, batch = points(rng, 200, 2, 1)
    plan = tp.build_plan(pos, batch, N=16, m=3, device="cpu")
    arrays, statics = tp.plan_to_numpy(plan)
    back = tp.plan_from_numpy(arrays, **statics, device="cpu")
    assert (back.pos_fp, back.S_occ) == (plan.pos_fp, plan.S_occ)
    np.testing.assert_array_equal(back.order, plan.order)
    np.testing.assert_array_equal(back.row_start, plan.row_start)
    with pytest.raises(ValueError, match="row_start"):
        tp.plan_from_numpy(arrays, **{**statics, "row_start": plan.row_start[:-1]},
                           device="cpu")


def test_position_fingerprint_matches_jax(rng):
    pos, _ = points(rng, 500, 3, full_box=True)
    for M, m in ((16, 3), (416, 2), (52, 4)):
        assert binned.position_fingerprint(pos, M, m) == jbinned.position_fingerprint(pos, M, m)


def test_entry_points_cache_their_plans(rng):
    """With plan=None and the binned strategy (which "auto" takes only for
    large problems), nfft_adjoint/nfft_forward plan a point set once (host
    plan, LRU of four, keyed by content), as JAX's _PLAN_CACHE."""
    pnfft.clear_plan_cache()
    pos, _ = points(rng, 120, 2)
    x = rng.standard_normal((120, 1)).astype(np.float32)
    tp.nfft_adjoint(x, pos, N=8, m=2, device="cpu")
    assert not pnfft._PLAN_CACHE  # "auto" at 120 points: the matmul engine
    y1 = tp.nfft_adjoint(x, pos, N=8, m=2, strategy="binned", device="cpu")
    assert len(pnfft._PLAN_CACHE) == 1
    (plan,) = pnfft._PLAN_CACHE.values()
    assert plan.pos_fp is not None and plan.order is not None
    y2 = tp.nfft_adjoint(x, pos.copy(), N=8, m=2, strategy="binned", device="cpu")
    tp.nfft_forward(np.asarray(y1), pos, m=2, strategy="binned", device="cpu")
    assert len(pnfft._PLAN_CACHE) == 1 and torch.equal(y1, y2)
    for k in range(5):
        tp.nfft_adjoint(x, pos * (0.5 + 0.1 * k), N=8, m=2, strategy="binned",
                        device="cpu")
    assert len(pnfft._PLAN_CACHE) == 4
    tp.clear_plan_cache()
    assert not pnfft._PLAN_CACHE


@pytest.mark.parametrize("bad_id", ["batch_size", "-1"])
@pytest.mark.parametrize("builder", ["host", "device"])
def test_builders_raise_on_batch_ids_outside_the_batch(rng, builder, bad_id):
    """A batch id outside [0, batch_size) raises ValueError in both
    builders (the JAX builders drop such points silently: a documented
    deviation). 2D, N=16, m=3, sigma=2, es, n=200, ids 0-2 with
    batch_size=2, or one id -1."""
    pos, batch = points(rng, 200, 2, 3)
    if bad_id == "-1":
        batch = np.maximum(batch - 1, -1)  # ids -1..1
        assert batch.min() == -1
    build = tp.build_plan if builder == "host" else tp.build_plan_device
    with pytest.raises(ValueError, match="outside the bin range"):
        build(pos, batch, N=16, m=3, sigma=2.0, batch_size=2, window="es", device="cpu")


def test_host_builder_raises_without_a_card(rng, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pos, _ = points(rng, 50, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.build_plan(pos, N=8, m=2)


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A source g++ rejects is an error, never a silent NumPy path."""
    for name in _native.SOURCES:
        (tmp_path / name).write_text("this is not C++;\n")
    monkeypatch.setattr(_native, "CSRC", tmp_path)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    _native.build_native.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            _native.build_native()
        assert not list((tmp_path / "build").glob("*.so"))
    finally:
        _native.build_native.cache_clear()
