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
rows to align lanes; a CUDA thread addresses its element directly, so the
kernels in ``csrc/permute.cu`` run one thread per padded element. Both move
32-bit words: one kernel serves float32 and int32 payloads, bit for bit.

Each wrapper launches its kernel for CUDA tensors, or raises; it takes the
plain version only for CPU tensors. ``launches`` on each wrapper counts the
kernel launches.
"""

from __future__ import annotations

import torch

from .._build import check, library
from .contract import _route

__all__ = [
    "row_start_from_counts",
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
        st.stride(0), L, S, K, C, st.device.index or 0,
        torch.cuda.current_stream(st.device).cuda_stream))
    expand_rows.launches += 1
    return out[0] if one else out


expand_rows.launches = 0


def compact_rows(padded: torch.Tensor, row_start: torch.Tensor,
                 row_count: torch.Tensor, n: int, size: int | None = None) -> torch.Tensor:
    """Padded rows (S, K) or (C, S, K), any strides -> compact stream (size,)
    or (C, size): filled lanes at row_start[s] + k, zeros from n on. ``size``
    defaults to ceil(n/K)*K, the JAX package's output length."""
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
    check(library().tnt_compact_rows(
        pd.data_ptr(), row_start.data_ptr(), row_count.data_ptr(), out.data_ptr(),
        *pd.stride(), size, n, S, K, C, pd.device.index or 0,
        torch.cuda.current_stream(pd.device).cuda_stream))
    compact_rows.launches += 1
    return out[0] if one else out


compact_rows.launches = 0
