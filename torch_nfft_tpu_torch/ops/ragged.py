"""Ragged row streams: expand the compact rank stream into the plan's padded
slot rows, and compact the rows back into the stream. CUDA kernels and their
plain PyTorch versions.

The plan's rows tile the sorted order [0, n) contiguously: row s holds
stream positions [row_start[s], row_start[s] + row_count[s]), with
``row_start`` the exclusive cumsum of ``row_count``. Per column c:

    expand_rows:   padded[c, s, k] = stream[c, row_start[s] + k]  (k < row_count[s]), else 0
    compact_rows:  stream[c, row_start[s] + k] = padded[c, s, k]  (k < row_count[s]),
                   and 0 from position n on

``expand_rows`` replaces the JAX package's TPU kernel
``ops/pallas/ragged.py:expand_rows`` and ``compact_rows`` its
``compact_rows``. The TPU kernels roll a two-block window per group of R
rows to align lanes. The CUDA kernels (``csrc/permute.cu``) take a group of
:func:`rows_per_group` rows per block, whose filled lanes are one span of
the stream: the rows' starts and counts are read once per block, the span
moves through shared memory, and global memory is read and written in
16-byte vectors. Both move 32-bit words: one kernel serves float32 and
int32 payloads, bit for bit. ``GROUP_LOG2`` sets the words a block takes.

Each wrapper launches its kernel for CUDA tensors, or raises; it takes the
plain version only for CPU tensors. ``launches`` on each wrapper counts the
kernel launches.
"""

from __future__ import annotations

import torch

from .._build import check, library
from .contract import _route

# A block of the ragged kernels takes 2^GROUP_LOG2 words: rows_per_group
# rows of K lanes (of all C columns for compact_rows's slab layout). Chosen
# on the card (chip_smoke.py phase 6b).
GROUP_LOG2 = 12
# Shared memory of one slab block (compact_rows, strides (1, K*C, C)) above
# which that layout is read one word at a time instead
SLAB_SMEM = 64 * 1024

__all__ = [
    "row_start_from_counts",
    "rows_per_group",
    "fast_divisor",
    "compact_layout",
    "expand_rows",
    "compact_rows",
    "expand_rows_plain",
    "compact_rows_plain",
]

_WORDS = (torch.float32, torch.int32)


def row_start_from_counts(row_count: torch.Tensor) -> torch.Tensor:
    """(S,) int32 exclusive cumsum: each plan row's offset in the stream."""
    rs = torch.cumsum(row_count, 0, dtype=torch.int32) - row_count
    return rs.to(torch.int32)


def _lanes(row_start, row_count, K: int):
    """(S, K) stream index of every lane and the mask of the filled ones."""
    k = torch.arange(K, dtype=torch.int64, device=row_start.device)
    idx = row_start.to(torch.int64)[:, None] + k[None, :]
    return idx, k[None, :] < row_count[:, None]


def expand_rows_plain(stream: torch.Tensor, row_start: torch.Tensor,
                      row_count: torch.Tensor, K: int) -> torch.Tensor:
    """Plain version of :func:`expand_rows`."""
    idx, valid = _lanes(row_start, row_count, K)
    out = stream[:, torch.where(valid, idx, 0)]
    return torch.where(valid, out, torch.zeros((), dtype=stream.dtype))


def compact_rows_plain(padded: torch.Tensor, row_start: torch.Tensor,
                       row_count: torch.Tensor, n: int, size: int) -> torch.Tensor:
    """Plain version of :func:`compact_rows`."""
    C, S, K = padded.shape
    idx, valid = _lanes(row_start, row_count, K)
    out = padded.new_zeros((C, size))
    out[:, idx[valid]] = padded[:, valid]
    return out


def _check_rows(row_start, row_count, S: int, dev) -> None:
    for name, a in (("row_start", row_start), ("row_count", row_count)):
        if a.device != dev or a.dtype != torch.int32 or tuple(a.shape) != (S,) \
                or not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous ({S},) int32 on {dev}")


def _check_words(t: torch.Tensor, what: str) -> None:
    if t.dtype not in _WORDS:
        raise ValueError(f"{what} must be float32 or int32, not {t.dtype}")


def rows_per_group(K: int, C: int = 1) -> int:
    """Rows a block of the ragged kernels takes: 2^GROUP_LOG2 words of rows
    of K lanes and C columns, at least one row."""
    return max(1, (1 << GROUP_LOG2) // (K * C))


def fast_divisor(d: int) -> tuple[int, int]:
    """(mul, shift) such that j // d == (mulhi32(j, mul) + j) >> shift for
    0 <= j < 2^31, mulhi32 the high word of the 64-bit product: a shift for
    a power of two (mul = 0), else Granlund and Montgomery's round-up
    multiplier. The kernels split a word index into row and lane with it."""
    if d < 1:
        raise ValueError(f"divisor {d} must be positive")
    shift = (d - 1).bit_length()
    if d == 1 << shift:
        return 0, shift
    return ((1 << 32) * ((1 << shift) - d)) // d + 1, shift


def _span_words(R: int, K: int) -> int:
    return -(-R * K // 4) * 4 + 8  # csrc/permute.cu:span_words


def compact_layout(padded: torch.Tensor) -> str:
    """Which read of :func:`compact_rows`'s kernel takes the (C, S, K) rows:
    ``"rows"`` where each row's K lanes are contiguous and 16-byte aligned
    (16-byte loads); ``"slab"`` for strides (1, K*C, C) at C > 1, the (S*K, C)
    slot array of ``unslot_values`` (a group's rows of every column are one
    contiguous range, read with 16-byte loads and transposed in shared
    memory), while a block's shared memory stays within ``SLAB_SMEM``;
    ``"strided"`` (one word at a time) for anything else."""
    C, S, K = padded.shape
    sc, ss, sk = padded.stride()
    if C > 1 and (sc, ss, sk) == (1, K * C, C):
        R = rows_per_group(K, C)
        if 4 * (-(-2 * R // 4) * 4 + C * _span_words(R, K)) <= SLAB_SMEM:
            return "slab"
    if sk == 1 and K % 4 == 0 and ss % 4 == 0 and (C == 1 or sc % 4 == 0) \
            and padded.data_ptr() % 16 == 0:
        return "rows"
    return "strided"


_LAYOUTS = {"rows": 0, "strided": 1, "slab": 2}


def expand_rows(stream: torch.Tensor, row_start: torch.Tensor,
                row_count: torch.Tensor, K: int) -> torch.Tensor:
    """Compact stream (L,) or (C, L), L >= n (the tail is not read) ->
    padded rows (S, K) or (C, S, K), empty lanes 0."""
    one = stream.ndim == 1
    st = stream[None] if one else stream
    _check_words(st, "the stream")
    S = row_start.shape[0]
    _check_rows(row_start, row_count, S, st.device)
    if not _route(st):
        out = expand_rows_plain(st, row_start, row_count, K)
        return out[0] if one else out
    if st.stride(1) != 1:
        st = st.contiguous()
    C, L = st.shape
    out = torch.empty((C, S, K), dtype=st.dtype, device=st.device)
    check(library().tnt_expand_rows(
        st.data_ptr(), row_start.data_ptr(), row_count.data_ptr(), out.data_ptr(),
        st.stride(0), L, S, K, C, rows_per_group(K), *fast_divisor(K),
        st.device.index or 0, torch.cuda.current_stream(st.device).cuda_stream))
    expand_rows.launches += 1
    return out[0] if one else out


expand_rows.launches = 0


def compact_rows(padded: torch.Tensor, row_start: torch.Tensor,
                 row_count: torch.Tensor, n: int, size: int | None = None) -> torch.Tensor:
    """Padded rows (S, K) or (C, S, K), any strides -> compact stream (size,)
    or (C, size): filled lanes at row_start[s] + k, zeros from n on. ``size``
    defaults to ceil(n/K)*K, the JAX package's output length. On the card
    the rows' strides choose the kernel's read (:func:`compact_layout`):
    contiguous rows and the transposed (S*K, C) slot array each have a
    coalesced 16-byte read, other strides a word-at-a-time one."""
    one = padded.ndim == 2
    pd = padded[None] if one else padded
    _check_words(pd, "the rows")
    C, S, K = pd.shape
    _check_rows(row_start, row_count, S, pd.device)
    size = -(-n // K) * K if size is None else int(size)
    if size < n:
        raise ValueError(f"size {size} is below n = {n}")
    if not _route(pd):
        out = compact_rows_plain(pd, row_start, row_count, n, size)
        return out[0] if one else out
    out = torch.empty((C, size), dtype=pd.dtype, device=pd.device)
    layout = compact_layout(pd)
    check(library().tnt_compact_rows(
        pd.data_ptr(), row_start.data_ptr(), row_count.data_ptr(), out.data_ptr(),
        *pd.stride(), size, n, S, K, C, _LAYOUTS[layout],
        rows_per_group(K, C if layout == "slab" else 1), *fast_divisor(K),
        *fast_divisor(max(C, 1)), pd.device.index or 0,
        torch.cuda.current_stream(pd.device).cuda_stream))
    compact_rows.launches += 1
    return out[0] if one else out


compact_rows.launches = 0
