"""Benes-network permutations of a plan's user <-> slot maps: routing on the
host, the apply on the card (CUDA kernels) or the CPU (plain versions).

Counterpart of the JAX package's ``ops/pallas/benes.py``. A static
permutation of n = 2^q elements runs as 2q-1 masked exchange stages whose
swap decisions are fixed at plan time, one bit per pair per stage:

    stage t, distance 2^d (d = q-1, ..., 1, 0, 1, ..., q-1), pair p joins
    elements lo = ((p >> d) << (d+1)) + (p & (2^d - 1)) and lo + 2^d, and
    swaps them where bit (p & 31) of word p >> 5 of row t is set.

Forward gives ``out[perm[i]] = vals[i]``; ``reverse=True`` runs the stages
back to front with the same bits and applies the inverse. The looping
router is the native ``csrc/benes_router.cpp`` (``_native.benes_route``);
``route_benes_np`` is its NumPy reference. The tables keep the router's
per-pair bits as they are, (2q-1, n/64) int32 on the plan's device: a CUDA
thread indexes them directly, so the TPU's one-word-per-element layout
(``pack_masks``, ``expand_pair_bits``) has no counterpart here.

``apply_benes`` replaces the TPU kernel ``ops/pallas/benes.py:apply_benes``
with two kernels in ``csrc/permute.cu``: ``benes_outer`` (a run of
consecutive stages of distance >= 2^LOCAL_LOG2 in one pass over the whole
array: one pass per side where a tile of 2^OUTER_LOG2 words holds them,
:func:`outer_passes`) and ``benes_local`` (every stage below, on blocks of
2^LOCAL_LOG2 elements). Both launch once per pass over all C columns of a
(C, 2^q) array, and move 32-bit words: float32 and int32 payloads alike,
exact to the bit. Each wrapper launches its kernel for CUDA tensors, or
raises; it takes the plain version only for CPU tensors. ``launches``
counts the launches.
"""

from __future__ import annotations

import hashlib
import os
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from .. import _native
from .._build import check, library
from .contract import _route

__all__ = [
    "LOCAL_LOG2",
    "BenesTables",
    "stage_distances",
    "route_benes_np",
    "apply_benes_np",
    "unpack_pair_bits_np",
    "route_tables",
    "tables_from_pair_bits",
    "host_rank_permutation",
    "rank_hash_np",
    "device_rank_hash",
    "plan_benes_tables",
    "apply_benes",
    "apply_benes_plain",
    "outer_passes",
    "benes_outer",
    "benes_outer_plain",
    "benes_stage_plain",
    "benes_local",
    "benes_local_plain",
]

# Stages of distance < 2^LOCAL_LOG2 run in one local pass on blocks of 2^13
# words (32 KB of shared memory beside 12.5 KB of pair bits, two blocks an
# SM); an outer pass takes tiles of 2^OUTER_LOG2 words and runs at most
# OUTER_LOG2 - 5 stages (its rows hold 32 columns at least). Of blocks of
# 2^13 to 2^15 and tiles of 2^13 and 2^14, this pair ran the 2^24 network
# fastest on an H100 (chip_smoke.py phase 6b), two outer passes a side.
LOCAL_LOG2 = 13
OUTER_LOG2 = 13
CACHE_ENV = "TORCH_NFFT_TPU_TORCH_BENES_CACHE"


def stage_distances(q: int) -> list[int]:
    """The 2q-1 per-stage exchange distances (as exponents d; pair i^2^d)."""
    return list(range(q - 1, -1, -1)) + list(range(1, q))


# ---------------------------------------------------------------------------
# NumPy oracles
# ---------------------------------------------------------------------------


def route_benes_np(perm: np.ndarray) -> np.ndarray:
    """Swap masks (2q-1, n) bool for ``out[perm[i]] = x[i]`` (the looping
    algorithm, one element per mask entry; mask[t][i] == mask[t][i ^ 2^d]).
    ``perm`` is a permutation of [0, n), n a power of two. O(n log n)
    Python: the reference of the native router, for small n."""
    perm = np.asarray(perm, dtype=np.int64)
    n = perm.shape[0]
    q = int(n).bit_length() - 1
    if (1 << q) != n:
        raise ValueError(f"length must be a power of two, got {n}")
    masks = np.zeros((max(2 * q - 1, 1), n), dtype=bool)

    def rec(base: int, pi: np.ndarray, level: int):
        m = pi.shape[0]
        if m == 1:
            return
        h = m // 2
        t_in = level
        t_out = 2 * q - 2 - level
        if m == 2:
            if pi[0] == 1:  # the middle switch swaps iff the pair crosses
                masks[t_in, base] = masks[t_in, base + 1] = True
            return
        inv = np.empty(m, dtype=np.int64)
        inv[pi] = np.arange(m)
        subnet = np.full(m, -1, dtype=np.int8)  # 0 upper, 1 lower
        for seed in range(m):
            if subnet[seed] >= 0:
                continue
            i, s = seed, 0
            while subnet[i] < 0:
                subnet[i] = s
                subnet[i ^ h] = 1 - s  # the input partner takes the other
                # the element sharing the output pair with the input
                # partner must avoid the partner's subnet
                j = inv[pi[i ^ h] ^ h]
                if subnet[j] < 0:
                    i = j
                else:
                    break
        low = np.arange(h)
        swap_in = subnet[low] == 1
        masks[t_in, base + low] = swap_in
        masks[t_in, base + low + h] = swap_in
        swap_out = subnet[inv[low]] == 1
        masks[t_out, base + low] = swap_out
        masks[t_out, base + low + h] = swap_out
        pi_u = np.empty(h, dtype=np.int64)
        pi_l = np.empty(h, dtype=np.int64)
        for i in range(m):
            if subnet[i] == 0:
                pi_u[i & (h - 1)] = pi[i] & (h - 1)
            else:
                pi_l[i & (h - 1)] = pi[i] & (h - 1)
        rec(base, pi_u, level + 1)
        rec(base + h, pi_l, level + 1)

    rec(0, perm.copy(), 0)
    return masks


def apply_benes_np(masks: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Push x through the network (stage t exchanges i ^ 2^ds[t] where
    masks[t])."""
    n = x.shape[0]
    q = int(n).bit_length() - 1
    out = x.copy()
    for t, d in enumerate(stage_distances(q)):
        partner = out.reshape(-1, 2, 1 << d)[:, ::-1, :].reshape(n)
        out = np.where(masks[t], partner, out)
    return out


def unpack_pair_bits_np(bits: np.ndarray, q: int) -> np.ndarray:
    """Per-element masks (2q-1, n) bool from the router's per-pair bits."""
    n = bits.shape[1] * 64
    masks = np.empty((bits.shape[0], n), dtype=bool)
    for t, d in enumerate(stage_distances(q)):
        pb = np.unpackbits(np.ascontiguousarray(bits[t]).view(np.uint8),
                           bitorder="little")  # (n/2,) in pair order
        masks[t] = np.broadcast_to(pb.reshape(-1, 1, 1 << d),
                                   (n >> (d + 1), 2, 1 << d)).reshape(n)
    return masks


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------


@dataclass
class BenesTables:
    """Routed per-pair bits of a plan's permutation, padded to n = 2^q.

    ``bits`` (2q-1, n/64) int32 lives on the plan's device; ``pair_bits``
    keeps the router's uint32 copy on the host. ``compact`` tags the space
    the network routes: True, the n-point rank space (expanded to the padded
    slot rows by ``ops/ragged.py``); False, the padded slot space S*K."""

    bits: torch.Tensor
    n: int
    compact: bool = False
    pair_bits: np.ndarray | None = None

    @property
    def q(self) -> int:
        return self.n.bit_length() - 1


def tables_from_pair_bits(bits: np.ndarray, n: int, *, compact: bool = False,
                          device=None) -> BenesTables:
    """:class:`BenesTables` on ``device`` from the router's per-pair bits."""
    q = int(n).bit_length() - 1
    if (1 << q) != n or n < 64:
        raise ValueError(f"padded length must be a power of two >= 64, got {n}")
    bits = np.ascontiguousarray(bits, dtype=np.uint32)
    if bits.shape != (2 * q - 1, n // 64):
        raise ValueError(f"pair bits have shape {bits.shape}, expected "
                         f"{(2 * q - 1, n // 64)}")
    dev = torch.device("cpu") if device is None else torch.device(device)
    return BenesTables(torch.from_numpy(bits.view(np.int32)).to(dev), n,
                       compact=compact, pair_bits=bits)


def _save_atomic(path: str, bits: np.ndarray) -> None:
    """Write ``bits`` to ``path`` through a temporary file in the same
    directory and ``os.replace``: a reader sees the whole file or none."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            np.save(f, bits)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def route_tables(perm_ext: np.ndarray, *, compact: bool = False,
                 device=None) -> BenesTables:
    """Route an extended permutation (host, length 2^q >= 64) with the
    native router.

    With ``TORCH_NFFT_TPU_TORCH_BENES_CACHE=<dir>`` set, networks of at
    least 2^18 elements keep their bits in ``<dir>``, keyed by the
    permutation's content (a stale entry cannot match), written atomically."""
    n = perm_ext.shape[0]
    cache_dir = os.environ.get(CACHE_ENV)
    key = None
    if cache_dir and n >= (1 << 18):
        h = hashlib.blake2b(np.ascontiguousarray(perm_ext, np.int32).tobytes(),
                            digest_size=16).hexdigest()
        key = os.path.join(cache_dir, f"benes_{n}_{h}.npy")
        if os.path.exists(key):
            return tables_from_pair_bits(np.load(key), n, compact=compact, device=device)
    bits = _native.benes_route(perm_ext)
    if key is not None:
        os.makedirs(cache_dir, exist_ok=True)
        _save_atomic(key, bits)
    return tables_from_pair_bits(bits, n, compact=compact, device=device)


def host_rank_permutation(plan, pos, batch=None) -> np.ndarray:
    """user -> rank (int32, length n) on the host: the device builder's
    binning (float32 multiply, floor, int32 mod and divide) and the
    stable-sort rank. Callers check it against the plan
    (:func:`rank_hash_np` vs :func:`device_rank_hash`)."""
    pos = np.asarray(pos, dtype=np.float32)
    n = pos.shape[0]
    M, m, T = plan.M, plan.m, plan.T
    nb = -(-M // T)
    s_mod = (np.floor(pos * np.float32(M)).astype(np.int32) - m) % M
    b = s_mod // T
    if batch is None:
        bid = np.zeros((n,), np.int32)
    else:
        bid = np.asarray(batch, dtype=np.int32).copy()
    for d in range(pos.shape[1]):
        bid = bid * nb + b[:, d]
    order = np.argsort(bid, kind="stable")
    rank = np.empty(n, np.int32)
    rank[order] = np.arange(n, dtype=np.int32)
    return rank


_H = (2654435761, 40503, 2246822519, 10369, 374761393)


def rank_hash_np(rank: np.ndarray):
    """Order-independent 2x32-bit fingerprint of a rank permutation."""
    r = rank.astype(np.uint32) + np.uint32(1)
    i = np.arange(r.size, dtype=np.uint32)
    w1 = i * np.uint32(_H[0]) + np.uint32(_H[1])
    w2 = i * np.uint32(_H[2]) + np.uint32(_H[3])
    f1 = int(np.sum(r * w1, dtype=np.uint32))
    f2 = int(np.sum((r ^ w2) * np.uint32(_H[4]), dtype=np.uint32))
    return f1, f2


_U32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 a, b in [0, 2^32), without overflowing
    int64: the high 16 bits of b only reach the low 32 bits through the low
    16 bits of a * b_hi."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def device_rank_hash(plan):
    """The plan's own rank fingerprint, computed on its device from
    ``fill_keys`` and ``row_count``, as :func:`rank_hash_np` of it."""
    K, n = plan.K, plan.n
    rs = (torch.cumsum(plan.row_count.to(torch.int64), 0) - plan.row_count)
    head = plan.fill_keys[:n].to(torch.int64)
    r = rs[head // K] + head % K + 1
    i = torch.arange(n, dtype=torch.int64, device=r.device)
    w1 = (_mul32(i, _H[0]) + _H[1]) & _U32
    w2 = (_mul32(i, _H[2]) + _H[3]) & _U32
    f1 = int(_mul32(r, w1).sum() & _U32)
    f2 = int(_mul32(r ^ w2, _H[4]).sum() & _U32)
    return f1, f2


def _plan_rank(plan, pos=None, batch=None) -> np.ndarray:
    """user -> rank (int32, length n): from the host ``order`` when the plan
    carries one, else derived from host positions (checked against the
    plan's fingerprint), else read from the plan's ``fill_keys`` head."""
    n, K = plan.n, plan.K
    if plan.order is not None:
        rank = np.empty(n, np.int32)
        rank[np.asarray(plan.order, dtype=np.int64)] = np.arange(n, dtype=np.int32)
        return rank
    if pos is not None:
        cand = host_rank_permutation(plan, pos, batch)
        if rank_hash_np(cand) == device_rank_hash(plan):
            return cand
        warnings.warn(
            "host-derived rank permutation disagrees with the device plan "
            "(binning mismatch); falling back to the device fill_keys pull",
            RuntimeWarning)
    # rows tile [0, n) contiguously in plan order: rank = row_start[row] + lane
    slot_head = plan.fill_keys[:n].cpu().numpy().astype(np.int64)
    row_count = plan.row_count.cpu().numpy().astype(np.int64)
    row_start = np.concatenate([np.zeros(1, np.int64), np.cumsum(row_count)[:-1]])
    return (row_start[slot_head // K] + slot_head % K).astype(np.int32)


def plan_benes_tables(plan, *, compact: bool = True, pos=None,
                      batch=None) -> BenesTables:
    """Tables for a plan's user <-> slot permutation, on the plan's device.

    ``compact=True`` routes the rank permutation (user point i to its place
    in the plan's sorted order), padded to 2^q with q = max(6,
    bit_length(max(n, K) - 1)); the ragged passes turn the rank stream into
    the padded slot rows. ``compact=False`` routes the padded slot space:
    points to their slots, padding to the empty slots, padded to 2^q >= S*K.
    Device plans (no host ``order``) take the rank from host ``pos`` (and
    ``batch``) when given, checked against the plan, else from the plan's
    ``fill_keys``."""
    S, K, n = plan.S, plan.K, plan.n
    rank = _plan_rank(plan, pos, batch)
    if compact:
        # 2^q >= K: the compact stream blocks (ceil(n/K)*K <= 2^q) fit
        q = max(6, int(max(n, K) - 1).bit_length())
        perm_ext = np.concatenate([rank, np.arange(n, 1 << q, dtype=np.int32)])
        return route_tables(perm_ext, compact=True, device=plan.device)
    n_slots = S * K
    q = max(6, int(n_slots - 1).bit_length())
    row_count = plan.row_count.cpu().numpy().astype(np.int32)
    row_start = np.concatenate([np.zeros(1, np.int64),
                                np.cumsum(row_count, dtype=np.int64)[:-1]])
    row = np.searchsorted(row_start, rank, side="right") - 1
    slot = (row.astype(np.int64) * K + (rank - row_start[row])).astype(np.int32)
    k_ar = np.arange(K, dtype=np.int32)[None, :]
    invalid = np.flatnonzero((k_ar >= row_count[:, None]).reshape(-1)).astype(np.int32)
    perm_ext = np.concatenate([slot, invalid, np.arange(n_slots, 1 << q, dtype=np.int32)])
    return route_tables(perm_ext, device=plan.device)


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------


def _stage_bits(words: torch.Tensor) -> torch.Tensor:
    """(n/2,) bool pair bits of one stage from its (n/64,) int32 words."""
    sh = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((words[:, None] >> sh) & 1).bool().reshape(-1)


def benes_stage_plain(v: torch.Tensor, words: torch.Tensor, d: int) -> torch.Tensor:
    """One stage at distance 2^d on (C, n) values, driven by its (n/64,)
    bit words (returns a new array): the plain network's building block."""
    C, n = v.shape
    sel = _stage_bits(words).reshape(n >> (d + 1), 1, 1 << d)
    v4 = v.reshape(C, n >> (d + 1), 2, 1 << d)
    return torch.where(sel, v4.flip(2), v4).reshape(C, n)


def _middle(q: int, s: int) -> range:
    """Network positions of the stages with distance < 2^s."""
    return range(q - s, q + s - 1)


def _bit_row(q: int, j: int, reverse: bool) -> int:
    return 2 * q - 2 - j if reverse else j


def benes_local_plain(v: torch.Tensor, tables: BenesTables, s: int,
                      reverse: bool = False) -> torch.Tensor:
    """Plain version of :func:`benes_local` (returns a new array)."""
    q = tables.q
    ds = stage_distances(q)
    for j in _middle(q, min(s, q)):
        v = benes_stage_plain(v, tables.bits[_bit_row(q, j, reverse)], ds[j])
    return v


def apply_benes_plain(vals: torch.Tensor, tables: BenesTables,
                      reverse: bool = False) -> torch.Tensor:
    """Plain version of :func:`apply_benes`: every stage in network order."""
    v = vals[None] if vals.ndim == 1 else vals
    q = tables.q
    for j, d in enumerate(stage_distances(q)):
        v = benes_stage_plain(v, tables.bits[_bit_row(q, j, reverse)], d)
    return v[0] if vals.ndim == 1 else v


def _check_apply(v: torch.Tensor, tables: BenesTables) -> None:
    if v.dtype not in (torch.float32, torch.int32):
        raise ValueError(f"the network moves float32 or int32, not {v.dtype}")
    if v.ndim != 2 or v.shape[1] != tables.n or not v.is_contiguous():
        raise ValueError(f"values must be contiguous (C, {tables.n}), got "
                         f"{tuple(v.shape)}")
    if v.device != tables.bits.device:
        raise ValueError(f"values are on {v.device}, the tables on {tables.bits.device}")


def _stream(v: torch.Tensor) -> tuple:
    return v.device.index or 0, torch.cuda.current_stream(v.device).cuda_stream


def outer_passes(q: int, s: int) -> tuple[list[range], list[range]]:
    """Network positions of the outer passes, entry side and exit side: the
    q-s stages of each side in as few runs as hold at most OUTER_LOG2 - 5
    stages each, of near-equal length."""
    r = q - s
    if r <= 0:
        return [], []
    n_pass = -(-r // (OUTER_LOG2 - 5))
    cuts = [0]
    for i in range(n_pass):
        cuts.append(cuts[-1] + (r + i) // n_pass)  # smallest parts first
    entry = [range(a, b) for a, b in zip(cuts, cuts[1:])]
    exit_ = [range(2 * q - 1 - b, 2 * q - 1 - a) for a, b in zip(cuts, cuts[1:])][::-1]
    return entry, exit_


def benes_outer_plain(v: torch.Tensor, tables: BenesTables, js: range,
                      reverse: bool = False) -> torch.Tensor:
    """Plain version of :func:`benes_outer`: the stages at positions ``js``
    one after another (returns a new array)."""
    q = tables.q
    ds = stage_distances(q)
    for j in js:
        v = benes_stage_plain(v, tables.bits[_bit_row(q, j, reverse)], ds[j])
    return v


def benes_outer(v: torch.Tensor, tables: BenesTables, js: range,
                reverse: bool = False) -> torch.Tensor:
    """The consecutive outer stages at network positions ``js`` (one side's,
    distances >= 2^5) on (C, 2^q) values in one pass, in place on CUDA
    tensors; returns the result."""
    _check_apply(v, tables)
    if not _route(v):
        return benes_outer_plain(v, tables, js, reverse)
    check(library().tnt_benes_outer(v.data_ptr(), tables.bits.data_ptr(), tables.n,
                                    v.shape[0], tables.q, js.start, js.stop - 1,
                                    int(reverse), OUTER_LOG2, *_stream(v)))
    benes_outer.launches += 1
    return v


benes_outer.launches = 0


def benes_local(v: torch.Tensor, tables: BenesTables, s: int | None = None,
                reverse: bool = False) -> torch.Tensor:
    """Every stage of distance < 2^s (all of them when q <= s; s defaults to
    LOCAL_LOG2) on (C, 2^q) values, block by block, in place on CUDA
    tensors; returns the result."""
    s = LOCAL_LOG2 if s is None else s
    _check_apply(v, tables)
    if not _route(v):
        return benes_local_plain(v, tables, s, reverse)
    q = tables.q
    check(library().tnt_benes_local(v.data_ptr(), tables.bits.data_ptr(), tables.n,
                                    v.shape[0], q, min(s, q), int(reverse),
                                    *_stream(v)))
    benes_local.launches += 1
    return v


benes_local.launches = 0


def apply_benes_(v: torch.Tensor, tables: BenesTables, reverse: bool = False,
                 s: int | None = None) -> torch.Tensor:
    """:func:`apply_benes` on (C, 2^q) values, in place on CUDA tensors:
    the entry side's outer stages in one pass, the middle (distances below
    2^s, s defaulting to LOCAL_LOG2) in one local pass, the exit side's
    outer stages in one pass (more outer passes where a side has more
    stages than a tile holds)."""
    s = LOCAL_LOG2 if s is None else s
    _check_apply(v, tables)
    if not _route(v):
        return apply_benes_plain(v, tables, reverse)
    entry, exit_ = outer_passes(tables.q, min(s, tables.q))
    for js in entry:
        v = benes_outer(v, tables, js, reverse)
    v = benes_local(v, tables, s, reverse)
    for js in exit_:
        v = benes_outer(v, tables, js, reverse)
    return v


def apply_benes(vals: torch.Tensor, tables: BenesTables, reverse: bool = False) -> torch.Tensor:
    """Push ``vals`` ((2^q,) or (C, 2^q), float32 or int32) through the
    routed network: ``out[perm[i]] = vals[i]`` per column, the inverse with
    ``reverse=True``."""
    v = vals[None] if vals.ndim == 1 else vals
    out = apply_benes_(v.contiguous().clone(), tables, reverse)
    return out[0] if vals.ndim == 1 else out
