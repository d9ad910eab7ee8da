"""Bitonic key/value sort: CUDA kernels and their plain PyTorch versions.

Counterpart of the JAX package's ``ops/pallas/bitonic.py`` (``sort_pairs``,
``apply_permutation``), which keeps the sort as a tested reference point: no
transform calls it, in either package. The network is the JAX module's:
Q = 2^q elements, rounds jj = 1..q, in round jj stages d = jj-1..0 that
compare-exchange the pairs (i, i ^ 2^d), descending iff bit jj of i is set,
with ``swap = (key_lo > key_hi) XOR desc`` for both members. Tied keys
therefore land exactly where the JAX kernels put them, and the output,
values included, equals theirs bit for bit for any schedule.

The schedule runs the network on blocks of 2^b elements (``csrc/bitonic.cu``):
``bitonic_local_sort`` (rounds 1..b), then per round jj > b the stages of
distance >= 2^b in one ``bitonic_cross_round`` pass (or as few as the tile
of 2^CROSS_LOG2 elements allows, :func:`cross_passes`) and
``bitonic_local_merge`` for the stages below. b = min(q, LOCAL_LOG2,
max(block_log2, 8)): the JAX default block (2^18, a TPU VMEM size) is
larger than a Hopper block's shared memory, so the card's own LOCAL_LOG2
caps it, and the card's kernels take no block below 2^8.

Keys are int32; values any 32-bit word (float32 or int32), moved unchanged.
Each wrapper launches its kernel for CUDA tensors, in place, or raises; it
takes the plain version only for CPU tensors. ``launches`` counts the
launches.
"""

from __future__ import annotations

import torch

from .._build import check, library
from .contract import _route

__all__ = [
    "LOCAL_LOG2",
    "sort_pairs",
    "apply_permutation",
    "sort_pairs_plain",
    "CROSS_LOG2",
    "cross_passes",
    "bitonic_local_sort",
    "bitonic_cross_round",
    "bitonic_local_merge",
    "bitonic_local_sort_plain",
    "bitonic_cross_round_plain",
    "bitonic_local_merge_plain",
]

# Blocks of the local sort and merges, and tiles of a cross pass: 2^12
# keys and values (32 KB of shared memory, 256 threads of 16 each, two
# blocks an SM). A cross pass runs at most CROSS_LOG2 - 5 stages (its rows
# hold 32 columns at least). Of blocks and tiles of 2^11 to 2^14, 2^12 sorted
# 2^24 keys fastest on an H100 (chip_smoke.py phase 6b); at 2^14 a thread's
# 32 keys and values spill registers.
LOCAL_LOG2 = 12
CROSS_LOG2 = 12
_TINY_LOG2 = 8  # below 2^8 elements the JAX function sorts without a kernel


def _stage_plain(k: torch.Tensor, v: torch.Tensor, jj: int, d: int):
    """Stage d of round jj on int32 (k, v), as new tensors. Pair g of
    distance 2^d starts at g * 2^(d+1); its direction is bit jj of that
    start, bit jj-d-1 of g."""
    D = 1 << d
    k3, v3 = k.view(-1, 2, D), v.view(-1, 2, D)
    g = torch.arange(k3.shape[0], device=k.device)[:, None]
    desc = ((g >> (jj - d - 1)) & 1) == 1
    ka, kb, va, vb = k3[:, 0], k3[:, 1], v3[:, 0], v3[:, 1]
    swap = (ka > kb) ^ desc
    k = torch.stack([torch.where(swap, kb, ka), torch.where(swap, ka, kb)], 1)
    v = torch.stack([torch.where(swap, vb, va), torch.where(swap, va, vb)], 1)
    return k.reshape(-1), v.reshape(-1)


def _rounds_plain(k, v, jjs, b: int):
    """Rounds ``jjs``, each from stage min(jj, b) - 1 down to 0."""
    for jj in jjs:
        for d in range(min(jj, b) - 1, -1, -1):
            k, v = _stage_plain(k, v, jj, d)
    return k, v


def _words(v: torch.Tensor) -> torch.Tensor:
    return v.view(torch.int32) if v.dtype == torch.float32 else v


def sort_pairs_plain(keys: torch.Tensor, vals: torch.Tensor):
    """Plain version of the network: every stage of every round in order,
    on (2^q,) int32 keys and 32-bit values; returns (keys, vals)."""
    q = keys.shape[0].bit_length() - 1
    k, v = _rounds_plain(keys, _words(vals), range(1, q + 1), q)
    return k, v.view(vals.dtype)


def bitonic_local_sort_plain(k: torch.Tensor, v: torch.Tensor, b: int):
    """Plain version of :func:`bitonic_local_sort` (returns new tensors)."""
    k, w = _rounds_plain(k, _words(v), range(1, b + 1), b)
    return k, w.view(v.dtype)


def bitonic_cross_round_plain(k: torch.Tensor, v: torch.Tensor, jj: int, d_hi: int,
                              d_lo: int):
    """Plain version of :func:`bitonic_cross_round`: the stages d_hi..d_lo of
    round jj one after another (returns new tensors)."""
    w = _words(v)
    for d in range(d_hi, d_lo - 1, -1):
        k, w = _stage_plain(k, w, jj, d)
    return k, w.view(v.dtype)


def bitonic_local_merge_plain(k: torch.Tensor, v: torch.Tensor, jj: int, b: int):
    """Plain version of :func:`bitonic_local_merge` (returns new tensors)."""
    k, w = _rounds_plain(k, _words(v), (jj,), b)
    return k, w.view(v.dtype)


def _check_pairs(keys: torch.Tensor, vals: torch.Tensor) -> int:
    """q of a valid (2^q,) key/value pair of tensors."""
    Q = keys.shape[0] if keys.ndim == 1 else -1
    q = Q.bit_length() - 1
    if Q < 1 or (1 << q) != Q:
        raise ValueError(f"length must be a power of two, got {tuple(keys.shape)}")
    if vals.shape != keys.shape:
        raise ValueError("keys and vals must have identical shapes")
    if keys.dtype != torch.int32:
        raise ValueError(f"keys must be int32, not {keys.dtype}")
    if vals.dtype not in (torch.float32, torch.int32):
        raise ValueError(f"values must be float32 or int32, not {vals.dtype}")
    if vals.device != keys.device:
        raise ValueError(f"keys are on {keys.device}, values on {vals.device}")
    return q


def _kernel_args(k: torch.Tensor, v: torch.Tensor) -> tuple:
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("keys and values must be contiguous")
    return (k.data_ptr(), v.data_ptr(), k.shape[0])


def _stream(t: torch.Tensor) -> tuple:
    return t.device.index or 0, torch.cuda.current_stream(t.device).cuda_stream


def bitonic_local_sort(k: torch.Tensor, v: torch.Tensor, b: int):
    """Rounds 1..b of the network on each block of 2^b elements, in place on
    CUDA tensors; returns (k, v)."""
    _check_pairs(k, v)
    if not _route(k):
        return bitonic_local_sort_plain(k, v, b)
    check(library().tnt_bitonic_local_sort(*_kernel_args(k, v), b, *_stream(k)))
    bitonic_local_sort.launches += 1
    return k, v


bitonic_local_sort.launches = 0


def bitonic_cross_round(k: torch.Tensor, v: torch.Tensor, jj: int, d_hi: int,
                        d_lo: int):
    """Stages d_hi..d_lo (2^d_lo >= the block) of round jj over the whole
    array in one pass, in place on CUDA tensors; returns (k, v)."""
    _check_pairs(k, v)
    if not _route(k):
        return bitonic_cross_round_plain(k, v, jj, d_hi, d_lo)
    check(library().tnt_bitonic_cross_round(*_kernel_args(k, v), jj, d_hi, d_lo,
                                            CROSS_LOG2, *_stream(k)))
    bitonic_cross_round.launches += 1
    return k, v


bitonic_cross_round.launches = 0


def cross_passes(jj: int, b: int) -> list[tuple[int, int]]:
    """The (d_hi, d_lo) passes that run round jj's stages jj-1..b: as few as
    hold at most CROSS_LOG2 - 5 stages each, of near-equal length."""
    r = jj - b
    n_pass = -(-r // (CROSS_LOG2 - 5))
    out, d_hi = [], jj - 1
    for i in range(n_pass):
        size = (r + i) // n_pass  # the near-equal parts of r, smallest first
        out.append((d_hi, d_hi - size + 1))
        d_hi -= size
    return out


def bitonic_local_merge(k: torch.Tensor, v: torch.Tensor, jj: int, b: int):
    """Stages b-1..0 of round jj > b on each block of 2^b elements, in place
    on CUDA tensors; returns (k, v)."""
    _check_pairs(k, v)
    if not _route(k):
        return bitonic_local_merge_plain(k, v, jj, b)
    check(library().tnt_bitonic_local_merge(*_kernel_args(k, v), jj, b, *_stream(k)))
    bitonic_local_merge.launches += 1
    return k, v


bitonic_local_merge.launches = 0


def sort_pairs(keys: torch.Tensor, vals: torch.Tensor, *, block_log2: int = 18,
               interpret: bool = False, unrolled: bool = False):
    """Sort ``vals`` by int32 ``keys`` (both (2^q,)): returns (sorted keys,
    values in the same order), as the JAX function does: the bitonic
    network for q >= 8 (ties in its order), a stable sort below.
    ``interpret`` and ``unrolled`` are the TPU kernels' compile options and
    change nothing here."""
    del interpret, unrolled
    q = _check_pairs(keys, vals)
    if q < _TINY_LOG2:
        sk, idx = torch.sort(keys, stable=True)
        return sk, vals[idx]
    b = min(q, LOCAL_LOG2, max(block_log2, _TINY_LOG2))
    k, v = keys.clone(), vals.clone()
    k, v = bitonic_local_sort(k, v, b)
    for jj in range(b + 1, q + 1):
        for d_hi, d_lo in cross_passes(jj, b):
            k, v = bitonic_cross_round(k, v, jj, d_hi, d_lo)
        k, v = bitonic_local_merge(k, v, jj, b)
    return k, v


def apply_permutation(dest: torch.Tensor, vals: torch.Tensor, *,
                      block_log2: int = 18, interpret: bool = False) -> torch.Tensor:
    """``out[dest[i]] = vals[i]`` for a full permutation ``dest`` of
    [0, 2^q): the values sorted by destination."""
    return sort_pairs(dest, vals, block_log2=block_log2, interpret=interpret)[1]
