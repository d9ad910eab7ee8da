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
``(B, N^dim, C)`` spectrum in between; it has no JAX counterpart (the
JAX functions take host arrays and are not differentiable).

:func:`nfft_pair_streamed` is differentiable in its values and, given
``pos=`` (the layout's points, flat), in the point positions, in one
member's memory: one autograd Function (:class:`_PairStreamed`) holds the
flat x and runs its backward member by member. For L = <z, w> the pair's
kernel K is real and even, so x.grad = K w, the member's pair applied to
w, and pos.grad_a = sum_s (x_a w_s + w_a x_s) grad K(p_a - p_s): per
member, x's pass is recomputed up to its unfolded tiles and the position
gradient kernel (``pos_grad``) runs on them with w; then w's pass runs up
to its tiles, where the gather gives x.grad and ``pos_grad`` with x the
spread's share of pos.grad. Nothing of a member outlives its pass, so the
step's peak is one member's pipeline plus the flat tensors, whatever the
batch size. With nothing that requires grad, or grad mode off, the call
runs the member loop alone, as it did before the Function existed. The
other streamed functions are not differentiable.

Each function is a root span of the port's recorder (``trace.py``), with
``pack`` and ``unpack`` spans around the moves between layouts and a
``member`` span around each member's pass, in which the planar entry
point's own span nests. The pair's backward is a ``backward`` root with
the same ``pack``, ``member`` and ``unpack`` spans, the stages it runs
(``slot_values``, ``spread kernel``, ``fold``, ``rfftn``, ``irfftn``,
``unfold``, ``pos_grad``, ``gather kernel``, ``unslot_values``) directly
under each ``member``. :data:`streamed_counters` holds
``streamed_members`` (member passes run, one per member and column chunk),
``streamed_pad_points`` (B * n_max - n of the call's layout per call:
the padded rows the members carry), ``streamed_backward_members`` (the
backward's member passes) and ``streamed_recompute_passes`` (the forward
passes the backward recomputes: one per backward pass that gives a
position gradient), counted whether the recorder is on or off;
``trace.counters()`` reads them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import trace
from .._device import resolve_device
from .binned import _pos_cotangent, run_stages, tile_route
from .plan_stack import build_plan_stack, index_plan, member_slots, split_by_batch
from .planar import (
    nfft_adjoint_planar,
    nfft_fastsum_real,
    nfft_forward_planar,
    nfft_pair_planar,
    pair_spectral_stages,
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

streamed_counters = {"streamed_members": 0, "streamed_pad_points": 0,
                     "streamed_backward_members": 0, "streamed_recompute_passes": 0}


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


def _passes(layout: StreamedLayout, C: int, column_chunk, counter="streamed_members"):
    """(member, lo, hi) of each member pass of a call, chunk by chunk; counts
    each pass under ``counter`` as it starts and, for a forward call, the
    call's padded rows once."""
    if counter == "streamed_members":
        streamed_counters["streamed_pad_points"] += layout.pad_points
    for lo, hi in _column_chunks(C, column_chunk):
        for i in range(layout.batch_size):
            streamed_counters[counter] += 1
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


def _pair_members(xs: torch.Tensor, layout: StreamedLayout, strategy: str,
                  column_chunk) -> torch.Tensor:
    """The member passes of the pair: packed xs (B, n_max, C) -> z (n, C)."""
    C = xs.shape[-1]
    out = torch.empty((layout.batch_size, layout.n_max, C), dtype=torch.float32,
                      device=layout.device)
    for i, lo, hi in _passes(layout, C, column_chunk):
        with trace.span("member"):
            out[i, :, lo:hi] = nfft_pair_planar(
                xs[i, :, lo:hi].contiguous(), layout.pos_stack[i], None,
                layout.member_plan(i), batch_size=1, N=layout.N, m=layout.m,
                sigma=layout.sigma, strategy=strategy, window=layout.window,
                device=layout.device)
    return layout.unpack(out)


def _check_points(pos, layout: StreamedLayout) -> None:
    """``pos`` must be the (n, dim) points the layout was built from, as
    its float32 copy holds them."""
    dim = layout.pos_stack.shape[-1]
    n = int(layout.counts.sum())
    if tuple(pos.shape) != (n, dim):
        raise ValueError(f"pos has shape {tuple(pos.shape)}; the layout was built for "
                         f"({n}, {dim})")
    mine = layout.pos_stack.reshape(-1, dim).index_select(0, layout._slot)
    if not torch.equal(torch.as_tensor(pos).detach().to(mine.device, torch.float32), mine):
        raise ValueError("pos differs from the points the layout was built from — "
                         "build a layout for these points (make_streamed_layout)")


def _member_grads(layout: StreamedLayout, i: int, x: torch.Tensor | None,
                  w: torch.Tensor, want_x: bool) -> tuple:
    """One member pass of the pair's backward, x and w (n_max, C) of member
    ``i``: (x.grad (n_max, C) or None, pos.grad (n_max, dim) or None). With
    ``x`` given, x's pass is recomputed up to its tiles, ``pos_grad`` runs
    there with w and its tiles are freed; then w's pass runs up to its
    tiles, for the gather (x.grad) and ``pos_grad`` with x."""
    plan = layout.member_plan(i)
    route = tile_route(plan, w.shape[1])
    to_grid = route.spread_kernel + route.to_grid + pair_spectral_stages(
        dim=plan.dim, N=layout.N, M=plan.M, m=layout.m, sigma=layout.sigma,
        window=layout.window, device=plan.device)
    w_slot = route.values_in(w)
    dp = None
    if x is not None:
        streamed_counters["streamed_recompute_passes"] += 1
        x_slot = route.values_in(x)
        dp = _pos_cotangent(route, route.tiles_from(run_stages(to_grid, x_slot)), w_slot, w)
    tiles = route.tiles_from(run_stages(to_grid, w_slot))
    dx = route.values_out(run_stages(route.gather_kernel, tiles)) if want_x else None
    if x is not None:
        dp += _pos_cotangent(route, tiles, x_slot, w)
    return dx, dp


class _PairStreamed(torch.autograd.Function):
    """x (n, C) float32 flat, pos (n, dim) flat or None -> z (n, C): the
    member passes, with a backward that runs member by member in one
    member's memory (module docstring). Saves the flat x and pos alone."""

    @staticmethod
    def forward(ctx, x, pos, layout, strategy, column_chunk):
        ctx.layout, ctx.column_chunk = layout, column_chunk
        ctx.save_for_backward(x, pos)
        return _pair_members(layout.pack(x), layout, strategy, column_chunk)

    @staticmethod
    @torch.autograd.function.once_differentiable
    @trace.spanned("backward")
    def backward(ctx, z_bar):
        layout = ctx.layout
        x, pos = ctx.saved_tensors
        want_x, want_pos = ctx.needs_input_grad[:2]
        B, n_max, C = layout.batch_size, layout.n_max, x.shape[1]
        ws = layout.pack(z_bar.to(torch.float32))
        xs = layout.pack(x) if want_pos else None
        f32 = dict(dtype=torch.float32, device=layout.device)
        dx = torch.empty((B, n_max, C), **f32) if want_x else None
        dp = torch.zeros((B, n_max, layout.pos_stack.shape[-1]), **f32) if want_pos else None
        for i, lo, hi in _passes(layout, C, ctx.column_chunk, "streamed_backward_members"):
            with trace.span("member"):
                gx, gp = _member_grads(
                    layout, i, None if xs is None else xs[i, :, lo:hi].contiguous(),
                    ws[i, :, lo:hi].contiguous(), want_x)
                if want_x:
                    dx[i, :, lo:hi] = gx
                if want_pos:
                    dp[i] += gp
        return (None if dx is None else layout.unpack(dx),
                None if dp is None else layout.unpack(dp).to(pos), None, None, None)


@trace.spanned("nfft_pair_streamed")
def nfft_pair_streamed(x, layout: StreamedLayout, *, pos=None, strategy: str = "auto",
                       column_chunk: int | None = None) -> torch.Tensor:
    """The adjoint followed by the real-output forward on the same points,
    one member at a time: ``x`` (n, *cols) real in the flat layout of the
    layout's (pos, batch) -> z (n, *cols) real, flat. Each member's pass
    is ``nfft_pair_planar`` on its plan (half spectra, ``column_chunk``
    columns at a time), equal to the real plane of
    ``nfft_forward_streamed(*nfft_adjoint_streamed(x, layout), layout)``;
    no (B, N^dim, C) spectrum is made. The padded points carry zero values
    and their outputs are dropped.

    z is differentiable in ``x`` and, when ``pos`` is given (the (n, dim)
    points the layout was built from, flat; other points raise), in the
    positions, member by member in one member's memory (module docstring;
    the layout needs its plans). With nothing that requires grad, or grad
    mode off, the call is the member loop alone."""
    if pos is not None:
        _check_points(pos, layout)
    x = torch.as_tensor(x, device=layout.device)
    trailing = tuple(x.shape[1:])
    C = math.prod(trailing)
    x = x.reshape(x.shape[0], C).to(torch.float32)
    grad_pos = isinstance(pos, torch.Tensor) and pos.requires_grad
    if C and torch.is_grad_enabled() and (x.requires_grad or grad_pos):
        if layout.plans is None:
            raise ValueError("the streamed pair differentiates through the members' plans; "
                             "build the layout with plan=True")
        z = _PairStreamed.apply(x, pos if grad_pos else None, layout, strategy, column_chunk)
    else:
        z = _pair_members(layout.pack(x), layout, strategy, column_chunk)
    return z.reshape((-1,) + trailing)
