"""PyTorch port vs JAX package: the bitonic key/value sort (B8,
``ops/pallas/bitonic.py:sort_pairs`` and ``apply_permutation``).

The port's plain network (``sort_pairs_plain``) and its block schedule (the
CUDA kernels' order of stages, driven here through the wrappers' plain
versions) are held against the JAX kernels in interpret mode bit for bit:
keys and values, ties included. Both run one fixed compare-exchange network,
so any difference is a fault, not rounding. The cases are those of
tests/test_bitonic.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_nfft_tpu.ops.pallas import bitonic as jbitonic
from torch_nfft_tpu_torch.ops import bitonic

I32 = np.iinfo(np.int32)


def _values(rng, Q, dtype):
    if dtype == np.int32:
        return rng.integers(I32.min, I32.max, Q, dtype=np.int64).astype(np.int32)
    return rng.standard_normal(Q).astype(np.float32)


def _jax_sort(keys, vals, **kw):
    sk, sv = jbitonic.sort_pairs(jnp.asarray(keys), jnp.asarray(vals), interpret=True, **kw)
    return np.asarray(sk), np.asarray(sv)


def _assert_same(got, want):
    """Bitwise: the same 32-bit words in the same places."""
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("q,b", [(9, 9), (10, 10), (12, 10), (14, 11)])
def test_permutation_keys_match_jax(q, b, dtype):
    rng = np.random.default_rng(q * 31 + b)
    Q = 1 << q
    dest = rng.permutation(Q).astype(np.int32)
    vals = _values(rng, Q, dtype)
    want = _jax_sort(dest, vals, block_log2=b)
    kt, vt = torch.from_numpy(dest), torch.from_numpy(vals)
    _assert_same(bitonic.sort_pairs_plain(kt, vt), want)
    _assert_same(bitonic.sort_pairs(kt, vt, block_log2=b), want)
    out = bitonic.apply_permutation(kt, vt, block_log2=b)
    ref = torch.empty_like(vt).index_copy_(0, kt.long(), vt)
    _assert_same((out,), (ref.numpy(),))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_ties_match_jax(dtype):
    """Many equal keys: the network's own order of tied values, bit for bit
    (the JAX test holds only the multiset; the port holds the positions)."""
    rng = np.random.default_rng(7)
    Q = 1 << 12
    keys = rng.integers(0, 37, Q).astype(np.int32)
    vals = _values(rng, Q, dtype)
    want = _jax_sort(keys, vals, block_log2=10)
    np.testing.assert_array_equal(want[0], np.sort(keys))
    kt, vt = torch.from_numpy(keys), torch.from_numpy(vals)
    _assert_same(bitonic.sort_pairs_plain(kt, vt), want)
    _assert_same(bitonic.sort_pairs(kt, vt, block_log2=10), want)


@pytest.mark.parametrize("keys", ["duplicates", "extremes"])
def test_negative_duplicate_and_extreme_keys(keys):
    rng = np.random.default_rng(0)
    Q = 1 << 9
    if keys == "duplicates":
        k = np.concatenate([np.full(Q // 2, -5), np.full(Q // 2, 3)])
    else:
        k = rng.choice(np.array([I32.min, I32.min + 1, -1, 0, 1, I32.max - 1, I32.max]), Q)
    rng.shuffle(k)
    k = k.astype(np.int32)
    vals = np.arange(Q, dtype=np.float32)
    want = _jax_sort(k, vals)
    np.testing.assert_array_equal(want[0], np.sort(k))
    kt, vt = torch.from_numpy(k), torch.from_numpy(vals)
    _assert_same(bitonic.sort_pairs(kt, vt), want)
    _assert_same(bitonic.sort_pairs_plain(kt, vt), want)


@pytest.mark.parametrize("ties", [False, True])
def test_tiny_path_is_a_stable_sort(ties):
    """Below 2^8 the JAX function calls lax.sort_key_val (stable); the port
    a stable torch.sort."""
    rng = np.random.default_rng(3)
    Q = 1 << 6
    keys = (rng.integers(0, 5, Q) if ties else rng.permutation(Q)).astype(np.int32)
    vals = rng.standard_normal(Q).astype(np.float32)
    want = _jax_sort(keys, vals)
    kt, vt = torch.from_numpy(keys), torch.from_numpy(vals)
    _assert_same(bitonic.sort_pairs(kt, vt), want)
    if not ties:
        ref = np.zeros(Q, np.float32)
        ref[keys] = vals
        out = bitonic.apply_permutation(kt, vt)
        np.testing.assert_array_equal(out.numpy(), ref)
        np.testing.assert_array_equal(
            np.asarray(jbitonic.apply_permutation(jnp.asarray(keys), jnp.asarray(vals),
                                                  interpret=True)), ref)


def test_bad_inputs_raise():
    with pytest.raises(ValueError, match="power of two"):
        bitonic.sort_pairs(torch.zeros(100, dtype=torch.int32), torch.zeros(100))
    with pytest.raises(ValueError, match="identical"):
        bitonic.sort_pairs(torch.zeros(128, dtype=torch.int32), torch.zeros(64))
    with pytest.raises(ValueError, match="int32"):
        bitonic.sort_pairs(torch.zeros(128, dtype=torch.int64), torch.zeros(128))
    with pytest.raises(ValueError, match="float32 or int32"):
        bitonic.sort_pairs(torch.zeros(128, dtype=torch.int32),
                           torch.zeros(128, dtype=torch.float64))
    with pytest.raises(ValueError, match="power of two"):
        jbitonic.sort_pairs(jnp.zeros(100, jnp.int32), jnp.zeros(100, jnp.float32),
                            interpret=True)


def _ties_and_extremes(rng, Q):
    """Keys with many ties among small values and the int32 extremes."""
    ext = np.array([I32.min, I32.min + 1, -1, 0, 1, I32.max - 1, I32.max], np.int64)
    return np.where(rng.random(Q) < 0.5, rng.choice(ext, Q),
                    rng.integers(-50, 50, Q)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _schedule_case(dtype):
    """Inputs of the schedule tests at q = 10 and JAX's sort of them."""
    rng = np.random.default_rng(11)
    keys = _ties_and_extremes(rng, 1 << 10)
    vals = _values(rng, 1 << 10, dtype)
    return keys, vals, _jax_sort(keys, vals, block_log2=9)


@pytest.mark.parametrize("cross_log2", [6, 14])
@pytest.mark.parametrize("local_log2", [7, 10, 12])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_schedule_through_the_plain_routes(monkeypatch, local_log2, cross_log2, dtype):
    """The card's schedule (local sort, cross passes, local merges) with the
    block below, at and above q = 10 (rounds of 1, 2 and 3 cross stages), a
    cross pass of one stage or of the whole round, through the wrappers'
    plain versions: JAX's network output bit for bit, ties and int32
    extremes included, with each kernel called as often as the schedule
    says."""
    q = 10
    keys_np, vals_np, want = _schedule_case(dtype)
    keys, vals = torch.from_numpy(keys_np), torch.from_numpy(vals_np)
    monkeypatch.setattr(bitonic, "LOCAL_LOG2", local_log2)
    monkeypatch.setattr(bitonic, "CROSS_LOG2", cross_log2)
    calls = dict.fromkeys(("bitonic_local_sort", "bitonic_cross_round",
                           "bitonic_local_merge"), 0)
    for name in calls:
        def counted(*args, _fn=getattr(bitonic, name), _name=name):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(bitonic, name, counted)
    got = bitonic.sort_pairs(keys, vals)
    _assert_same(got, want)
    _assert_same(got, tuple(t.numpy() for t in bitonic.sort_pairs_plain(keys, vals)))
    b = min(q, local_log2)
    per_pass = cross_log2 - 5
    assert calls == {"bitonic_local_sort": 1,
                     "bitonic_cross_round": sum(-(-(jj - b) // per_pass)
                                                for jj in range(b + 1, q + 1)),
                     "bitonic_local_merge": q - b}
    assert torch.equal(got[0], torch.sort(keys).values)


@pytest.mark.parametrize("cross_log2", [6, 7, 9, 14])
@pytest.mark.parametrize("r", [1, 2, 4, 9])
def test_cross_passes_cover_each_round(monkeypatch, r, cross_log2):
    """Each round's cross stages, in order, each in exactly one pass of at
    most CROSS_LOG2 - 5 stages, in the fewest passes."""
    monkeypatch.setattr(bitonic, "CROSS_LOG2", cross_log2)
    b = 13
    passes = bitonic.cross_passes(b + r, b)
    stages = [d for hi, lo in passes for d in range(hi, lo - 1, -1)]
    assert stages == list(range(b + r - 1, b - 1, -1))
    assert all(hi - lo + 1 <= cross_log2 - 5 for hi, lo in passes)
    assert len(passes) == -(-r // (cross_log2 - 5))


@pytest.mark.parametrize("jj,d_hi,d_lo", [(9, 8, 8), (10, 9, 8), (11, 10, 6), (11, 7, 5)])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_cross_round_plain_is_the_stages_composed(jj, d_hi, d_lo, dtype):
    """bitonic_cross_round_plain equals its stages run one by one."""
    rng = np.random.default_rng(jj * 7 + d_lo)
    k = torch.from_numpy(_ties_and_extremes(rng, 1 << 11))
    v = torch.from_numpy(_values(rng, 1 << 11, dtype))
    kk, ww = k, bitonic._words(v)
    for d in range(d_hi, d_lo - 1, -1):
        kk, ww = bitonic._stage_plain(kk, ww, jj, d)
    _assert_same(bitonic.bitonic_cross_round_plain(k, v, jj, d_hi, d_lo),
                 (kk.numpy(), ww.view(v.dtype).numpy()))


def test_kernel_plain_versions_compose_to_the_network():
    """Local sort, then per round the cross passes and the local merge, on
    the plain versions directly, at q = 11 with blocks of 2^8."""
    rng = np.random.default_rng(5)
    q, b = 11, 8
    k = torch.from_numpy(rng.permutation(1 << q).astype(np.int32))
    v = torch.from_numpy(rng.standard_normal(1 << q).astype(np.float32))
    kk, vv = bitonic.bitonic_local_sort_plain(k, v, b)
    for jj in range(b + 1, q + 1):
        for d_hi, d_lo in bitonic.cross_passes(jj, b):
            kk, vv = bitonic.bitonic_cross_round_plain(kk, vv, jj, d_hi, d_lo)
        kk, vv = bitonic.bitonic_local_merge_plain(kk, vv, jj, b)
    want = _jax_sort(k.numpy(), v.numpy(), block_log2=b)
    _assert_same((kk, vv), want)
