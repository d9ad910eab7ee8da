"""PyTorch port vs JAX package: saved plans (ops/plan_io.py).

Both packages write and read one ``.npz`` format. A plan saved by either
loads in the other with every field equal; transforms through a loaded
plan equal those through the plan it was saved from bit for bit, and the
port's agree with the JAX package's within rel-L2 3e-5. Version-1 files
(an ``inv_slot`` array in place of ``fill_keys``) load in both; wrong and
future files raise. Sizes of tests/test_plan_io.py: n = 96, 2D, N = 16,
m = 3, two batches.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import points, rel_l2

import torch_nfft_tpu as tn
import torch_nfft_tpu_torch as tp
from torch_nfft_tpu.ops import binned as jbinned
from torch_nfft_tpu.ops import plan_io as jplan_io
from torch_nfft_tpu_torch.convert import PLAN_ARRAYS

STATICS = ("n", "dim", "N", "m", "sigma", "T", "K", "batch_size", "pos_fp", "window",
           "active", "S_occ")
GEOM = dict(N=16, m=3, batch_size=2)


def _points(rng):
    return points(rng, 96, 2, B=2)


def _port_plan(pos, batch, builder, window="gaussian"):
    if builder == "host":
        return tp.build_plan(pos, batch, window=window, device="cpu", **GEOM)
    return tp.build_plan_device(torch.from_numpy(pos), torch.from_numpy(batch),
                                window=window, device="cpu", **GEOM)


def _assert_same_plan(a, b):
    """Every field of two plans (either package's) equal."""
    for name in PLAN_ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)), err_msg=name)
    for name in STATICS:
        assert getattr(a, name) == getattr(b, name), name
    for name in ("order", "row_start"):
        va, vb = getattr(a, name), getattr(b, name)
        assert (va is None) == (vb is None), name
        if va is not None:
            np.testing.assert_array_equal(va, vb, err_msg=name)


def _rewrite_meta(path, edit):
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    meta = json.loads(bytes(arrays["__meta__"].tobytes()).decode("utf-8"))
    edit(meta, arrays)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    np.savez(path, **arrays)


def _adjoint(plan, pos, batch, x):
    return tp.nfft_adjoint(torch.from_numpy(x), pos, batch, batch_size=2, bandwidth=16,
                           cutoff=3, plan=plan, window=plan.window, device="cpu").numpy()


@pytest.mark.parametrize("builder", ["host", "device"])
@pytest.mark.parametrize("window", ["gaussian", "es", "kb"])
@pytest.mark.parametrize("benes", [False, True])
def test_round_trip_keeps_every_field(rng, tmp_path, builder, window, benes):
    pos, batch = _points(rng)
    plan = _port_plan(pos, batch, builder, window)
    if benes:
        kw = {} if builder == "host" else dict(pos=pos, batch=batch)
        plan = plan.with_benes_tables(**kw)
    path = tmp_path / "plan.npz"
    tp.save_plan(path, plan)
    loaded = tp.load_plan(path, device="cpu")
    _assert_same_plan(loaded, plan)
    assert loaded.device == torch.device("cpu")
    if benes:
        assert (loaded.benes.n, loaded.benes.compact) == (plan.benes.n, plan.benes.compact)
        assert torch.equal(loaded.benes.bits, plan.benes.bits)
        np.testing.assert_array_equal(loaded.benes.pair_bits, plan.benes.pair_bits)
    else:
        assert loaded.benes is None
    x = rng.standard_normal((96, 2)).astype(np.float32)
    np.testing.assert_array_equal(_adjoint(loaded, pos, batch, x), _adjoint(plan, pos, batch, x))


@pytest.mark.parametrize("benes", [False, True])
def test_jax_file_loads_in_the_port(rng, tmp_path, benes):
    pos, batch = _points(rng)
    jplan = jbinned.build_plan(pos, batch, **GEOM)
    if benes:
        jplan = jplan.with_benes_tables(block_log2=9)
    path = tmp_path / "jax.npz"
    jplan_io.save_plan(path, jplan)
    loaded = tp.load_plan(path, device="cpu")
    _assert_same_plan(loaded, jplan)
    if benes:
        np.testing.assert_array_equal(loaded.benes.pair_bits, jplan.benes.pair_bits)
        assert loaded.benes.compact == jplan.benes.compact
    # bit for bit with the port's own (unsaved) plan of the same points
    own = tp.build_plan(pos, batch, device="cpu", **GEOM)
    if benes:
        own = own.with_benes_tables()
    x = rng.standard_normal((96, 2)).astype(np.float32)
    got = _adjoint(loaded, pos, batch, x)
    np.testing.assert_array_equal(got, _adjoint(own, pos, batch, x))
    want = np.asarray(tn.nfft_adjoint(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(batch),
                                      batch_size=2, bandwidth=16, cutoff=3, plan=jplan))
    assert rel_l2(got, want) <= 3e-5


@pytest.mark.parametrize("benes", [False, True])
def test_port_file_loads_in_jax(rng, tmp_path, benes):
    pos, batch = _points(rng)
    plan = tp.build_plan(pos, batch, device="cpu", **GEOM)
    if benes:
        plan = plan.with_benes_tables()
    path = tmp_path / "port.npz"
    tp.save_plan(path, plan)
    jloaded = jplan_io.load_plan(path)
    _assert_same_plan(plan, jloaded)
    if benes:
        np.testing.assert_array_equal(jloaded.benes.pair_bits, plan.benes.pair_bits)
        assert jloaded.benes.b == min(plan.benes.q, 18)
    jplan = jbinned.build_plan(pos, batch, **GEOM)
    if benes:
        jplan = jplan.with_benes_tables()
    x = rng.standard_normal((96, 2)).astype(np.float32)
    kw = dict(batch_size=2, bandwidth=16, cutoff=3, strategy="binned")
    args = (jnp.asarray(x), jnp.asarray(pos), jnp.asarray(batch))
    got = np.asarray(tn.nfft_adjoint(*args, plan=jloaded, **kw))
    np.testing.assert_array_equal(got, np.asarray(tn.nfft_adjoint(*args, plan=jplan, **kw)))
    assert rel_l2(_adjoint(plan, pos, batch, x), got) <= 3e-5


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_version_1_file_rebuilds_fill_keys(rng, tmp_path, writer):
    pos, batch = _points(rng)
    plan = tp.build_plan(pos, batch, device="cpu", **GEOM)
    path = tmp_path / "plan.npz"
    if writer == "port":
        tp.save_plan(path, plan)
    else:
        jplan_io.save_plan(path, jbinned.build_plan(pos, batch, **GEOM))

    def to_v1(meta, arrays):
        meta["format_version"] = 1
        del meta["S_occ"]  # files of that time carry no S_occ
        arrays["inv_slot"] = arrays.pop("fill_keys")[: plan.n]

    _rewrite_meta(path, to_v1)
    loaded = tp.load_plan(path, device="cpu")
    _assert_same_plan(loaded, plan)
    x = rng.standard_normal((96, 2)).astype(np.float32)
    np.testing.assert_array_equal(_adjoint(loaded, pos, batch, x), _adjoint(plan, pos, batch, x))


def test_loaded_plan_keeps_fingerprint_check(rng, tmp_path):
    pos, batch = _points(rng)
    path = tmp_path / "plan.npz"
    tp.save_plan(path, tp.build_plan(pos, batch, device="cpu", **GEOM))
    loaded = tp.load_plan(path, device="cpu")
    other = np.roll(pos, 1, axis=0) * 0.9  # bins otherwise
    x = rng.standard_normal((96, 1)).astype(np.float32)
    with pytest.raises(ValueError, match="plan"):
        tp.nfft_adjoint(x, other, batch, batch_size=2, bandwidth=16, cutoff=3, plan=loaded,
                        device="cpu")


def test_rejects_wrong_files(tmp_path):
    bogus = tmp_path / "bogus.npz"
    np.savez(bogus, a=np.arange(3))
    with pytest.raises(ValueError, match="not a torch_nfft_tpu plan"):
        tp.load_plan(bogus, device="cpu")
    with pytest.raises(TypeError, match="BinnedPlan"):
        tp.save_plan(tmp_path / "x.npz", object())


@pytest.mark.parametrize("version", [999, 0, None])
def test_rejects_other_format_versions(rng, tmp_path, version):
    pos, batch = _points(rng)
    path = tmp_path / "plan.npz"
    tp.save_plan(path, tp.build_plan(pos, batch, device="cpu", **GEOM))

    def edit(meta, arrays):
        meta["format_version"] = version

    _rewrite_meta(path, edit)
    with pytest.raises(ValueError, match="format version"):
        tp.load_plan(path, device="cpu")
    with pytest.raises(ValueError, match="format version"):
        jplan_io.load_plan(path)


def test_load_without_a_card_raises(rng, tmp_path, monkeypatch):
    pos, batch = _points(rng)
    path = tmp_path / "plan.npz"
    tp.save_plan(path, tp.build_plan(pos, batch, device="cpu", **GEOM))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.load_plan(path)
