"""Batched transforms streamed one member at a time.

Counterpart of the JAX package's ``ops/streaming.py``. The reference
allocates the whole ``batch * cols * (2N)^dim`` grid at once
(``core_cuda.cu:216``): 16 GiB of complex grid at the 3D batch = 16,
N = 256 configuration. Batched transforms are block diagonal (each member
and each column is a signal of its own), so these functions run a Python
loop over the members: each pass calls the planar entry points
(ops/planar.py) with ``batch_size=1`` and the member's plan
(``plan_stack.index_plan``) and writes its slice of a preallocated
``(B, ...)`` output on the layout's device. Peak memory is one member's
pipeline plus the outputs. ``column_chunk=`` runs the columns in chunks as
well, bounding a pass's grid at ``column_chunk`` columns.

A :class:`StreamedLayout` holds the points split into members (padded to
one size, ``plan_stack.split_by_batch``) and the members' stacked plans,
built once per point set and reused by every call. Its :meth:`pack` and
:meth:`unpack` move values between the reference's flat layout (n, C) and
the member layout (B, n_max, C) on the device, through one index
computed with the layout (``index_copy_`` / ``index_select``); the JAX
package packs on the host. Inputs may be tensors or NumPy; the results are
the planar (real, imaginary) pairs and flat layouts of the JAX functions.
:func:`nfft_pair_streamed` runs the adjoint+forward pair of real values
(``planar.nfft_pair_planar``, half spectra) member by member, with no
``(B, N^dim, C)`` spectrum in between; it has no JAX counterpart. The
functions are not differentiable (the JAX ones take host arrays).

Each function is a root span of the port's recorder (``trace.py``), with
``pack`` and ``unpack`` spans around the moves between layouts and a
``member`` span around each member's pass, in which the planar entry
point's own span nests. :data:`streamed_counters` holds
``streamed_members`` (member passes run, one per member and column chunk)
and ``streamed_pad_points`` (B * n_max - n of the call's layout per call:
the padded rows the members carry), counted whether the recorder is on or
off; ``trace.counters()`` reads them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import trace
from .._device import resolve_device
from .plan_stack import build_plan_stack, index_plan, member_slots, split_by_batch
from .planar import (
    nfft_adjoint_planar,
    nfft_fastsum_real,
    nfft_forward_planar,
    nfft_pair_planar,
)
from .window import DEFAULT_SIGMA, DEFAULT_WINDOW

__all__ = [
    "StreamedLayout",
    "make_streamed_layout",
    "nfft_adjoint_streamed",
    "nfft_forward_streamed",
    "nfft_fastsum_streamed",
    "nfft_pair_streamed",
]

streamed_counters = {"streamed_members": 0, "streamed_pad_points": 0}


class StreamedLayout:
    """One batched point set split into members, with their plans.

    ``pos_stack`` (B, n_max, dim) float32 on the layout's device, ``counts``
    (B,) NumPy points per member, ``plans`` the stacked member plans or None
    (the members then run without plans, by the ``strategy`` rule)."""

    def __init__(self, pos_stack: torch.Tensor, counts, plans, N, m, sigma,
                 window=DEFAULT_WINDOW):
        self.pos_stack = pos_stack
        self.counts = np.asarray(counts)
        self.plans = plans
        self.N = int(N)
        self.m = int(m)
        self.sigma = float(sigma)
        self.window = str(window)
        self._slot = torch.as_tensor(member_slots(self.counts, self.n_max),
                                     device=pos_stack.device)

    @property
    def batch_size(self) -> int:
        return self.pos_stack.shape[0]

    @property
    def n_max(self) -> int:
        return self.pos_stack.shape[1]

    @property
    def device(self) -> torch.device:
        return self.pos_stack.device

    @property
    def pad_points(self) -> int:
        """The padded rows of the member layout: B * n_max - n."""
        return self.batch_size * self.n_max - int(self.counts.sum())

    def pack(self, x) -> torch.Tensor:
        """Per-point values (n, C) -> the member layout (B, n_max, C),
        padded points zero, on the layout's device."""
        with trace.span("pack"):
            x = torch.as_tensor(x, device=self.device)
            out = x.new_zeros((self.batch_size * self.n_max,) + tuple(x.shape[1:]))
            out.index_copy_(0, self._slot, x)
            return out.reshape((self.batch_size, self.n_max) + tuple(x.shape[1:]))

    def unpack(self, y_stack: torch.Tensor) -> torch.Tensor:
        """The inverse of :meth:`pack` for per-point outputs (B, n_max, C)."""
        with trace.span("unpack"):
            flat = y_stack.reshape((self.batch_size * self.n_max,)
                                   + tuple(y_stack.shape[2:]))
            return flat.index_select(0, self._slot)

    def member_plan(self, i: int):
        return None if self.plans is None else index_plan(self.plans, i)


def make_streamed_layout(pos, batch=None, *, batch_size: int, N: int, m: int,
                         sigma: float = DEFAULT_SIGMA, plan: bool = True,
                         T: int | None = None, window: str = DEFAULT_WINDOW,
                         device=None) -> StreamedLayout:
    """Split (pos, batch) into members and build their plan stack (the host
    builder, one plan per member), on ``device`` (the card unless
    ``device="cpu"``). ``plan=False`` builds no plans."""
    dev = resolve_device(device)
    pos_np = np.asarray(pos.detach().cpu() if isinstance(pos, torch.Tensor) else pos,
                        dtype=np.float32)
    pos_stack, _, counts, _ = split_by_batch(pos_np, None, batch, batch_size)
    plans = build_plan_stack(pos_stack, N=N, m=m, sigma=sigma, T=T, window=window,
                             device=dev) if plan else None
    return StreamedLayout(torch.from_numpy(pos_stack).to(dev), counts, plans, N, m, sigma,
                          window)


def _column_chunks(C: int, column_chunk) -> list:
    if column_chunk is None or column_chunk >= C:
        return [(0, C)]
    return [(lo, min(lo + column_chunk, C)) for lo in range(0, C, column_chunk)]


def _passes(layout: StreamedLayout, C: int, column_chunk):
    """(member, lo, hi) of each member pass of a call, chunk by chunk; counts
    the call's padded rows once and each pass as it starts."""
    streamed_counters["streamed_pad_points"] += layout.pad_points
    for lo, hi in _column_chunks(C, column_chunk):
        for i in range(layout.batch_size):
            streamed_counters["streamed_members"] += 1
            yield i, lo, hi


def _flat_values(x, layout: StreamedLayout):
    """(x packed to (B, n_max, C) float32, trailing column shape, C)."""
    x = torch.as_tensor(x, device=layout.device)
    trailing = tuple(x.shape[1:])
    C = math.prod(trailing)
    return layout.pack(x.reshape(x.shape[0], C).to(torch.float32)), trailing, C


@trace.spanned("nfft_adjoint_streamed")
def nfft_adjoint_streamed(x, layout: StreamedLayout, *, strategy: str = "auto",
                          column_chunk: int | None = None):
    """Adjoint NFFT of real samples, one member at a time. ``x`` (n, *cols)
    in the flat layout of the layout's (pos, batch). Returns planar
    (yr, yi), each (batch_size, (N,)*dim, *cols)."""
    xs, trailing, C = _flat_values(x, layout)
    B, dim, N = layout.batch_size, layout.pos_stack.shape[-1], layout.N
    yr = torch.empty((B,) + (N,) * dim + (C,), dtype=torch.float32, device=layout.device)
    yi = torch.empty_like(yr)
    for i, lo, hi in _passes(layout, C, column_chunk):
        with trace.span("member"):
            r, im = nfft_adjoint_planar(
                xs[i, :, lo:hi].contiguous(), layout.pos_stack[i], None,
                layout.member_plan(i), batch_size=1, N=N, m=layout.m, sigma=layout.sigma,
                strategy=strategy, window=layout.window, device=layout.device)
            yr[i, ..., lo:hi] = r[0]
            yi[i, ..., lo:hi] = im[0]
    shape = (B,) + (N,) * dim + trailing
    return yr.reshape(shape), yi.reshape(shape)


@trace.spanned("nfft_forward_streamed")
def nfft_forward_streamed(xr, xi, layout: StreamedLayout, *, strategy: str = "auto",
                          column_chunk: int | None = None):
    """Forward NFFT of a planar spectrum xr/xi (batch_size, (N,)*dim,
    *cols), xi may be None, one member at a time. Returns planar (yr, yi),
    each (n, *cols) in the flat layout."""
    dev, dim, B, N = layout.device, layout.pos_stack.shape[-1], layout.batch_size, layout.N
    xr = torch.as_tensor(xr, device=dev).to(torch.float32)
    trailing = tuple(xr.shape[1 + dim:])
    C = math.prod(trailing)
    xr = xr.reshape((B,) + (N,) * dim + (C,))
    if xi is not None:
        xi = torch.as_tensor(xi, device=dev).to(torch.float32).reshape(xr.shape)
    out_r = torch.empty((B, layout.n_max, C), dtype=torch.float32, device=dev)
    out_i = torch.empty_like(out_r)
    for i, lo, hi in _passes(layout, C, column_chunk):
        with trace.span("member"):
            r, im = nfft_forward_planar(
                xr[i:i + 1, ..., lo:hi], None if xi is None else xi[i:i + 1, ..., lo:hi],
                layout.pos_stack[i], None, layout.member_plan(i), batch_size=1, dim=dim,
                m=layout.m, sigma=layout.sigma, strategy=strategy, window=layout.window,
                device=dev)
            out_r[i, :, lo:hi] = r
            out_i[i, :, lo:hi] = im
    shape = (-1,) + trailing
    return layout.unpack(out_r).reshape(shape), layout.unpack(out_i).reshape(shape)


@trace.spanned("nfft_fastsum_streamed")
def nfft_fastsum_streamed(x, coeffs, source_layout: StreamedLayout,
                          target_layout: StreamedLayout | None = None, *,
                          strategy: str = "auto", column_chunk: int | None = None):
    """The real fastsum (``planar.nfft_fastsum_real``) one member at a
    time: ``x`` (n_src, *cols) flat, real -> (n_tgt, *cols) flat, real.
    Without ``target_layout`` the targets are the sources."""
    if target_layout is None:
        target_layout = source_layout
    dev = source_layout.device
    xs, trailing, C = _flat_values(x, source_layout)
    coeffs = torch.as_tensor(coeffs, device=dev)
    N = coeffs.shape[0]
    if N != source_layout.N:
        raise ValueError(f"coeffs bandwidth {N} != layout bandwidth {source_layout.N}")
    B = source_layout.batch_size
    out = torch.empty((B, target_layout.n_max, C), dtype=torch.float32, device=dev)
    for i, lo, hi in _passes(source_layout, C, column_chunk):
        with trace.span("member"):
            out[i, :, lo:hi] = nfft_fastsum_real(
                xs[i, :, lo:hi].contiguous(), coeffs, source_layout.pos_stack[i],
                target_layout.pos_stack[i], None, None, source_layout.member_plan(i),
                target_layout.member_plan(i), batch_size=1, N=N, m=source_layout.m,
                sigma=source_layout.sigma, strategy=strategy, window=source_layout.window,
                device=dev)
    return target_layout.unpack(out).reshape((-1,) + trailing)


@trace.spanned("nfft_pair_streamed")
def nfft_pair_streamed(x, layout: StreamedLayout, *, strategy: str = "auto",
                       column_chunk: int | None = None) -> torch.Tensor:
    """The adjoint followed by the real-output forward on the same points,
    one member at a time: ``x`` (n, *cols) real in the flat layout of the
    layout's (pos, batch) -> z (n, *cols) real, flat. Each member's pass
    is ``nfft_pair_planar`` on its plan (half spectra, ``column_chunk``
    columns at a time), equal to the real plane of
    ``nfft_forward_streamed(*nfft_adjoint_streamed(x, layout), layout)``;
    no (B, N^dim, C) spectrum is made. The padded points carry zero values
    and their outputs are dropped."""
    xs, trailing, C = _flat_values(x, layout)
    out = torch.empty((layout.batch_size, layout.n_max, C), dtype=torch.float32,
                      device=layout.device)
    for i, lo, hi in _passes(layout, C, column_chunk):
        with trace.span("member"):
            out[i, :, lo:hi] = nfft_pair_planar(
                xs[i, :, lo:hi].contiguous(), layout.pos_stack[i], None,
                layout.member_plan(i), batch_size=1, N=layout.N, m=layout.m,
                sigma=layout.sigma, strategy=strategy, window=layout.window,
                device=layout.device)
    return layout.unpack(out).reshape((-1,) + trailing)
