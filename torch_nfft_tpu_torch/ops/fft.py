"""Spectral stage of the NFFT with ``torch.fft`` (cuFFT on the card).

The JAX package builds its DFTs from matmuls (its ``ops/fft.py``)
only because its TPU runtime had no complex dtype and no FFT. Here the
transforms are cuFFT's, in two formulations.

Complex to complex, for complex inputs (``nfft_adjoint``, ``nfft_forward``,
``nfft_fastsum``, the two-plane ``nfft_forward_planar``):

* adjoint: y[k] = sum_j g[j] exp(+2 pi i j.k / M), the unnormalised inverse
  DFT (``ifftn(norm="forward")``), then the centered crop and the rolloff;
* forward: rolloff, zero-padded embed, then g[j] = sum_k y[k]
  exp(-2 pi i j.k / M), the forward DFT (``fftn``).

Hermitian, for real grids and real outputs (the planar adjoint of real
samples, the pair, the real-output forward, the real fastsum), on a
real-to-complex transform of the last axis and its inverse. The adjoint
of a real grid is conjugate symmetric, y[-k] = conj y[k], so half of it
is stored: a "half spectrum" holds the
frequencies k in [-h, h] on every axis but the last and [0, h] on the
last, h = N // 2, at index k + h (leading) and k (last). The band of the
NFFT is B = [-h, N - h) per axis: for even N it is asymmetric, its -N/2
plane has no +N/2 partner, and the half spectrum's extended band holds
that partner. A real-output forward computes

    Re sum_{k in B} Z[k] phi_hat_inv(k) exp(-2 pi i a.k / M)
        = sum_k Herm Z[k] phi_hat_inv(k) exp(-2 pi i a.k / M),
    Herm Z[k] = (Z~[k] + conj Z~[-k]) / 2,  Z~ = Z on B, 0 elsewhere,

a C2R transform of Herm Z: the -N/2 edge planes enter halved, their
conjugate halves at +N/2 (:func:`full_to_half`). The JAX package's
Hermitian pipelines do the same with their "pinned +-N/2 shell
corrections". For the real adjoint Y (Hermitian on every frequency) and a
filter c, Herm(c Y) = Y Herm(c~): the pair's filter is Herm(1_B), the
fastsum's Herm(c~), exact for any coefficients. cuFFT halves the last axis
where the JAX package halves axis 0; only the entry points' outputs are
held to it.

The half spectrum keeps (2h + 1)^(dim-1) (h + 1) of the grid's frequencies
(an eighth at M = 2N in 3D), so in 2D and 3D the stages transform each
axis after the last only on the lines the band keeps: the adjoint's C2C
of axis -2 on the lines k_last <= h, and of axis 0 on those whose other
frequencies lie in the band; the forward the same backwards from the band,
zero-padded. No whole-grid spectrum is written. Each pass is one batched
FFT over strided lines (``ops/cufft.py``: cuFFT plans of the port's own,
which read every pass's lines in place), and the two stages are each
other's adjoint under autograd. ``spectral_lines`` counts the C2C lines
run and skipped.

Grids are channel-first, (batch_size, C, M, ..., M); the spatial axes are
the last ``dim`` axes of every array here.

The pruned DFT matrices (:func:`_pruned_mats_np`, :func:`_axis_contract`)
are the JAX package's: one (L, N) matrix per axis folding the DFT, the crop
to the centered band and the rolloff into one product. The point-sharded
spectral stages (parallel/sharded.py) contract with them; the grid-sharded
ones (parallel/grid_sharded.py) take the half spectrum of a slab's own
axes with :func:`spectral_adjoint_half` and contract only the sharded
axis 0 with a block of rows of such a matrix, then all-reduce the half
spectrum, which no FFT of the slab alone can give. They are float32 products: the entry points pin
TF32 off (``_device.pin_fp32``), since one TF32 pass would cost ~1e-3.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .._build import check, library
from .contract import _require, _route, _stream
from .cufft import lines_fft
from .spectral import apply_phi_hat_inv, centered_crop, centered_embed
from .window import DEFAULT_SIGMA, DEFAULT_WINDOW, phi_hat_inv_centered, phi_hat_inv_np

__all__ = ["spectral_adjoint", "spectral_forward", "spectral_adjoint_half",
           "spectral_forward_half", "half_spectrum_to_full", "full_to_half",
           "band_filter_half"]


def spectral_adjoint(g: torch.Tensor, dim: int, N: int, m: int,
                     sigma: float = DEFAULT_SIGMA,
                     window: str = DEFAULT_WINDOW) -> torch.Tensor:
    """(B, C, M^dim) real grid -> (B, C, N^dim) complex64 centered band."""
    axes = tuple(range(2, 2 + dim))
    gh = torch.fft.ifftn(g, dim=axes, norm="forward")
    gh = centered_crop(gh, dim, N, spatial_axis0=2)
    return apply_phi_hat_inv(gh, dim, N, m, sigma, spatial_axis0=2, window=window)


def spectral_forward(y: torch.Tensor, dim: int, M: int, m: int,
                     sigma: float = DEFAULT_SIGMA,
                     window: str = DEFAULT_WINDOW) -> torch.Tensor:
    """(B, C, N^dim) complex centered band -> (B, C, M^dim) complex grid."""
    N = y.shape[2]
    y = apply_phi_hat_inv(y, dim, N, m, sigma, spatial_axis0=2, window=window)
    y = centered_embed(y, dim, N, M, spatial_axis0=2)
    return torch.fft.fftn(y, dim=tuple(range(2, 2 + dim)))


# ---------------------------------------------------------------------------
# Hermitian half spectra
# ---------------------------------------------------------------------------


def _axes(dim: int) -> tuple:
    return tuple(range(-dim, 0))


def _outer(vectors: list) -> torch.Tensor:
    """prod_d vectors[d][i_d] as a tensor of the vectors' lengths."""
    out = vectors[0]
    for v in vectors[1:]:
        out = out[..., None] * v
    return out


def _phi_half(dim: int, N: int, m: int, sigma: float, window: str, device) -> torch.Tensor:
    """phi_hat_inv on the half spectrum's frequencies (phi_hat is even: the
    +N/2 entry of an even N takes the -N/2 value)."""
    h = N // 2
    v = phi_hat_inv_centered(N, m, sigma, window, device=device)  # k in [-h, N - h)
    ext = torch.cat([v, v[:1]]) if N % 2 == 0 else v  # k in [-h, h]
    return _outer([ext] * (dim - 1) + [ext[h:]])


# C2C lines the Hermitian stages transformed ("run") and the lines a
# whole-grid transform would have run beyond them ("skipped"): integer adds,
# with the recorder off too; trace.counters() reads spectral_lines.<name>
spectral_lines = {"run": 0, "skipped": 0}


def _band_runs(N: int, M: int) -> tuple:
    """The band k in [-h, h] of an M-point DFT axis as (first DFT row, rows,
    first band index) runs: k in [-h, 0) at rows M - h.., k in [0, h] at
    rows 0.. (a run of no rows for h = 0)."""
    h = N // 2
    return ((M - h, h, 0), (0, h + 1, h))


def _count_lines(dim: int, N: int, M: int, L: int) -> None:
    """Count one stage's C2C lines (L leading slices): after the last axis's
    transform a whole-grid one runs M^(dim-2) (M // 2 + 1) lines on each
    further axis; the pruned one runs M (h + 1) on axis -2 (3D) and
    (2h + 1)^(dim-2) (h + 1) on axis 0."""
    h, K = N // 2, M // 2 + 1
    passes = [(M ** (dim - 2) * K, (2 * h + 1) ** (dim - 2) * (h + 1))]
    if dim == 3:
        passes.append((M * K, M * (h + 1)))
    for whole, run in passes:
        spectral_lines["run"] += L * run
        spectral_lines["skipped"] += L * max(whole - run, 0)


def _last_axis_weights(N: int, M: int, dtype, device) -> torch.Tensor:
    """c(k) on the last axis's k in [0, h]: how often a C2R counts the term
    (1 at k = 0 and k = M / 2, else 2, its mirror's too)."""
    c = torch.full((N // 2 + 1,), 2.0, dtype=dtype, device=device)
    c[0] = 1.0
    if M % 2 == 0 and N // 2 == M // 2:
        c[-1] = 1.0
    return c


def turn_half(src: torch.Tensor, R: int, K: int, n2: int, to_rows: bool) -> torch.Tensor:
    """The kept values k < n2 of R lines of K (the last axis's R2C or C2R
    layout, value k of line b at b * K + k), turned to n2 rows of R
    (k * R + b) with ``to_rows``; otherwise back, as R lines of K with
    zeros past n2. One kernel launch on the card (``csrc/spectral.cu``);
    :func:`turn_half_plain` on the CPU."""
    width = K if to_rows else n2
    _require(src.is_complex() and src.is_contiguous() and src.numel() == R * width,
             f"the source must hold {R} x {width} contiguous complex values")
    if not _route(src):
        return turn_half_plain(src, R, K, n2, to_rows)
    out = src.new_empty((n2, R) if to_rows else (R, K))
    check(library().tnt_turn_half(src.data_ptr(), out.data_ptr(), R, K, n2, int(to_rows),
                                  int(src.dtype == torch.complex128), *_stream(src)))
    turn_half.launches += 1
    return out


turn_half.launches = 0


def turn_half_plain(src: torch.Tensor, R: int, K: int, n2: int, to_rows: bool) -> torch.Tensor:
    """:func:`turn_half` in PyTorch ops."""
    if to_rows:
        return src.view(R, K)[:, :n2].t().contiguous()
    out = src.new_empty((R, K))
    out[:, n2:].zero_()
    out[:, :n2] = src.view(n2, R).t()
    return out


# Above this many points a line, the last axis's R2C and C2R run on
# contiguous lines and :func:`turn_half` turns the kept values; up to it
# cuFFT reads and writes the turned layout itself, which costs less there
# (tools/spectral_stages.py on an H100: 1.3-1.7x the contiguous R2C and
# C2R at 512 and 1024 points, less than the turn's extra pass; 2.4-3.0x
# at 2048, several times the turn's)
TURN_KERNEL_ABOVE = 1024


def _adjoint_lines(g: torch.Tensor, dim: int, N: int, phi: torch.Tensor) -> torch.Tensor:
    """:func:`spectral_adjoint_half` of a 2D or 3D grid, band-pruned. With L
    the leading slices, l one of them and arrays named by their axes in
    memory order:

    * the R2C of the last axis on every line, into (k_last, l, i_0, ...):
      written so by cuFFT up to :data:`TURN_KERNEL_ABOVE` points, above
      it written (l, i_0, ..., k_last) and its values k_last <= h turned
      by :func:`turn_half`;
    * 3D: the C2C of axis -2 on the lines k_last <= h only, into
      (k_1, k_last, l, i_0);
    * the C2C of axis 0 on the lines whose other frequencies lie in the
      band only, into (k_0, [k_1 band,] k_last, l);
    * the band's rows k_0 times phi_hat_inv, conjugated, into (k_0, [k_1,]
      k_last, l).

    Each C2C reads contiguous lines and writes its output turned, so that
    the next pass's lines are contiguous (ops/cufft.py). The result is a
    view of that last array with the leading axes in front: their slices
    lie side by side in memory, as :func:`_forward_lines` reads them, so
    neither stage transposes the band."""
    M = g.shape[-1]
    h, K = N // 2, M // 2 + 1
    n2, nb = h + 1, 2 * h + 1
    lead = g.shape[:g.ndim - dim]
    L = math.prod(lead)
    g = g.contiguous()
    if g.data_ptr() % (2 * g.element_size()):  # cuFFT's R2C reads complex-aligned
        g = g.clone()
    cdt = torch.complex128 if g.dtype == torch.float64 else torch.complex64
    R = L * M ** (dim - 1)
    turned = M > TURN_KERNEL_ABOVE
    if turned:
        A = g.new_empty((R, K), dtype=cdt)  # (l, i_0, ..., k_last)
        lines_fft("r2c", g, 0, A, 0, M, R, 1, M, 1, K)
        A = turn_half(A, R, K, n2, True)
    else:
        A = g.new_empty((K, R), dtype=cdt)
        lines_fft("r2c", g, 0, A, 0, M, R, 1, M, R, 1)
    # A: (k_last, l, i_0, ...), its first n2 rows read
    runs = _band_runs(N, M)
    if dim == 3:
        P = n2 * L * M
        B = g.new_empty((M, P), dtype=cdt)  # (k_1, k_last, l, i_0)
        lines_fft("c2c", A, 0, B, 0, M, P, 1, M, P, 1)
        Q = nb * n2 * L
        A = g.new_empty((M, Q), dtype=cdt)  # (k_0, k_1 band, k_last, l)
        for row, rows, band in runs:
            lines_fft("c2c", B, row * P, A, band * n2 * L, M, rows * n2 * L, 1, M, Q, 1)
        del B
    else:
        Q = n2 * L
        B, A = A, g.new_empty((M, Q), dtype=cdt)  # (k_0, k_last, l)
        lines_fft("c2c", B, 0, A, 0, M, Q, 1, M, Q, 1)
        del B
    A = A.view((M,) + (nb,) * (dim - 2) + (n2, L))
    out = g.new_empty((nb,) * (dim - 1) + (n2, L), dtype=cdt)
    phi = phi.unsqueeze(-1)
    for row, rows, band in runs:
        torch.mul(A[row:row + rows], phi[band:band + rows], out=out[band:band + rows])
    out.conj_physical_()
    _count_lines(dim, N, M, L)
    return out.movedim(-1, 0).view(lead + out.shape[:-1])


def _forward_lines(H: torch.Tensor, dim: int, N: int, M: int, phi: torch.Tensor) -> torch.Tensor:
    """:func:`spectral_forward_half` of a 2D or 3D half spectrum,
    band-pruned: :func:`_adjoint_lines` backwards. conj(H) phi_hat_inv
    into (k_0 zero-padded to M, [k_1 band,] k_last, l); the inverse C2C of
    axis 0 on the band's lines, into (k_1, k_last, l, i_0) (3D, k_1
    zero-padded to M), and of axis -2 on the lines k_last <= h (3D; in 2D
    axis 0's straight), into (k_last, l, i_0, ...),
    zero past h, which the C2R of the last axis reads on every line, or,
    above the limit, turned back to (l, i_0, ..., k_last) first
    (:func:`turn_half`). Each C2C reads its lines across the array (the
    lines side by side) and writes them contiguous."""
    h, K = N // 2, M // 2 + 1
    n2, nb = h + 1, 2 * h + 1
    lead = H.shape[:H.ndim - dim]
    L = math.prod(lead)
    H = H.reshape((L,) + H.shape[H.ndim - dim:]).movedim(0, -1)  # (k_0, ..., k_last, l)
    turned = M > TURN_KERNEL_ABOVE
    runs = _band_runs(N, M)
    Q = nb ** (dim - 2) * n2 * L
    A = H.new_empty((M,) + (nb,) * (dim - 2) + (n2, L))  # (k_0, [k_1 band,] k_last, l)
    A[h + 1:M - h].zero_()
    phi = phi.unsqueeze(-1)
    for row, rows, band in runs:
        torch.mul(H[band:band + rows], phi[band:band + rows], out=A[row:row + rows])
        A[row:row + rows].conj_physical_()
    A, lines = A.view(M, Q), Q
    if dim == 3:
        P = n2 * L * M
        B = H.new_empty((M, P))  # (k_1, k_last, l, i_0)
        B[h + 1:M - h].zero_()
        for row, rows, band in runs:
            lines_fft("c2c", A, band * n2 * L, B, row * P, M, rows * n2 * L, Q, 1, 1, M,
                      inverse=True)
        A, lines = B, P
    R = L * M ** (dim - 1)
    E = H.new_empty((n2 if turned else K, R))  # (k_last, l, i_0, ...)
    lines_fft("c2c", A, 0, E, 0, M, lines, lines, 1, 1, M, inverse=True)
    del A
    g = H.new_empty((R, M), dtype=H.real.dtype)
    if turned:
        E = turn_half(E, R, K, n2, False)  # (l, i_0, ..., k_last)
        lines_fft("c2r", E, 0, g, 0, M, R, 1, K, 1, M)
    else:
        E[n2:].zero_()
        lines_fft("c2r", E, 0, g, 0, M, R, R, 1, 1, M)
    _count_lines(dim, N, M, L)
    return g.view(lead + (M,) * dim)


class _AdjointHalf(torch.autograd.Function):
    """:func:`_adjoint_lines` under autograd. For a real loss and the half
    spectrum's cotangent G, the grid's is Re sum_k G[k] phi_hat_inv(k)
    exp(-2 pi i j.k / M), which is the forward stage of G / c (c from
    :func:`_last_axis_weights`)."""

    @staticmethod
    def forward(ctx, g, dim, N, phi):
        ctx.dim, ctx.N, ctx.M = dim, N, g.shape[-1]
        ctx.save_for_backward(phi)
        return _adjoint_lines(g, dim, N, phi)

    @staticmethod
    def backward(ctx, G):
        phi, = ctx.saved_tensors
        c = _last_axis_weights(ctx.N, ctx.M, phi.dtype, phi.device)
        return _ForwardHalf.apply(G / c, ctx.dim, ctx.N, ctx.M, phi), None, None, None


class _ForwardHalf(torch.autograd.Function):
    """:func:`_forward_lines` under autograd: the half spectrum's cotangent
    of a real grid cotangent is c times the adjoint stage of it."""

    @staticmethod
    def forward(ctx, H, dim, N, M, phi):
        ctx.dim, ctx.N, ctx.M = dim, N, M
        ctx.save_for_backward(phi)
        return _forward_lines(H, dim, N, M, phi)

    @staticmethod
    def backward(ctx, G):
        phi, = ctx.saved_tensors
        c = _last_axis_weights(ctx.N, ctx.M, phi.dtype, phi.device)
        return _AdjointHalf.apply(G, ctx.dim, ctx.N, phi) * c, None, None, None, None


def spectral_adjoint_half(g: torch.Tensor, dim: int, N: int, m: int,
                          sigma: float = DEFAULT_SIGMA,
                          window: str = DEFAULT_WINDOW) -> torch.Tensor:
    """(B, C, M^dim) real grid -> the half spectrum (complex64) of its
    rolloff-corrected adjoint, Y[k] = phi_hat_inv(k) sum_j g[j]
    exp(+2 pi i j.k / M): the conjugate of the R2C transform on the half
    spectrum's frequencies. In 2D and 3D the further axes are transformed
    only on the lines the band keeps (:func:`_adjoint_lines`)."""
    real = torch.float64 if g.dtype == torch.float64 else torch.float32
    phi = _phi_half(dim, N, m, sigma, window, g.device).to(real)
    if dim == 1:
        return torch.fft.rfft(g, dim=-1)[..., :N // 2 + 1].conj() * phi
    return _AdjointHalf.apply(g, dim, N, phi)


def spectral_forward_half(H: torch.Tensor, dim: int, N: int, M: int, m: int,
                          sigma: float = DEFAULT_SIGMA,
                          window: str = DEFAULT_WINDOW) -> torch.Tensor:
    """The half spectrum H of a conjugate-symmetric Z -> the real grid
    (B, C, M^dim) sum_k Z[k] phi_hat_inv(k) exp(-2 pi i a.k / M): the
    unnormalised C2R transform of conj(phi_hat_inv H), zero outside the
    half spectrum's frequencies. In 2D and 3D the further axes are
    transformed only on the band's lines (:func:`_forward_lines`)."""
    if not H.is_complex():
        H = H.to(torch.complex128 if H.dtype == torch.float64 else torch.complex64)
    phi = _phi_half(dim, N, m, sigma, window, H.device).to(H.real.dtype)
    if dim == 1:
        return torch.fft.irfft(H.conj() * phi, n=M, dim=-1, norm="forward")
    return _ForwardHalf.apply(H, dim, N, M, phi)


def half_spectrum_to_full(H: torch.Tensor, dim: int, N: int) -> torch.Tensor:
    """The half spectrum of a conjugate-symmetric Y -> Y on the centered
    band, (..., N, ..., N) with k at index k + N // 2: the last axis's
    negative frequencies are the conjugates of the mirrored entries."""
    h = N // 2
    lead = tuple(range(-dim, -1))
    band = (Ellipsis,) + (slice(0, N),) * (dim - 1)
    pos = H[band + (slice(0, N - h),)]  # k_last in [0, N - h)
    mirror = H.flip(lead) if lead else H  # k_lead -> -k_lead
    neg = mirror[band + (slice(1, h + 1),)].flip(-1).conj()  # k_last in [-h, 0)
    return torch.cat([neg, pos], dim=-1)


def full_to_half(X: torch.Tensor, dim: int, N: int) -> torch.Tensor:
    """X on the centered band (..., N, ..., N) -> the half spectrum of its
    Hermitian part (X~[k] + conj X~[-k]) / 2, X~ = X on the band and 0 on
    the +N/2 planes of an even N. Real for real X."""
    h = N // 2
    axes = _axes(dim)
    Xp = X
    if N % 2 == 0:  # the +N/2 planes, zero
        for ax in axes:
            shape = list(Xp.shape)
            shape[ax] = 1
            Xp = torch.cat([Xp, Xp.new_zeros(shape)], dim=ax)
    Xm = Xp.flip(axes)  # k -> -k
    return ((Xp + (Xm.conj() if Xm.is_complex() else Xm)) * 0.5)[..., h:]


def band_filter_half(dim: int, N: int, device=None):
    """The pair's filter: the half spectrum of Herm(1_B), (1_B(k) + 1_B(-k))
    / 2 on the extended band, float32; None for an odd N, whose band is
    symmetric (the filter is 1)."""
    if N % 2:
        return None
    h = N // 2
    k = torch.arange(-h, h + 1, device=device)
    inside, mirrored = (k != h).float(), (k != -h).float()  # k in B, -k in B
    return 0.5 * (_outer([inside] * (dim - 1) + [inside[h:]])
                  + _outer([mirrored] * (dim - 1) + [mirrored[h:]]))


# ---------------------------------------------------------------------------
# Pruned DFT matrices
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _pruned_mats_np(N: int, M: int, m: int, sigma: float, sign: int,
                    off: int = 0, L: int | None = None,
                    window: str = DEFAULT_WINDOW):
    """(cos, sin) planes of the pruned DFT matrix, (L, N) float32 numpy:

        D[a, j] = exp(sign 2 pi i (off + a) k / M) phi_hat_inv(k), k = j - N // 2,

    rows a covering the grid cells off + [0, L) of an M-cell axis (the full
    axis by default). A product with it is the M-point DFT, the crop to the
    centered band and the rolloff in one step (the JAX package's
    ``ops/fft.py:_pruned_mats_np``)."""
    L = M if L is None else L
    k = np.arange(N, dtype=np.float64) - N // 2
    a = np.arange(L, dtype=np.float64) + off
    theta = 2.0 * np.pi * np.outer(a, k) / M
    phinv = phi_hat_inv_np(N, m, sigma, window)
    cr = np.cos(theta) * phinv[None, :]
    ci = np.sin(theta) * sign * phinv[None, :]
    return cr.astype(np.float32), ci.astype(np.float32)


def _cells_spec(dim: int, M: int, cells) -> tuple:
    """Per-axis (cell offset, cell count); None is every axis whole."""
    if cells is None:
        return tuple((0, M) for _ in range(dim))
    return tuple(cells)


def _axis_contract(x: torch.Tensor, mat: torch.Tensor, ax: int) -> torch.Tensor:
    """Axis ``ax`` of x (length L_in) contracted with mat (L_in, L_out): the
    result has L_out there, as one matmul of (pre, post, L_in) rows."""
    return torch.matmul(x.movedim(ax, -1), mat).movedim(-1, ax)


def _pruned_mats(N: int, M: int, m: int, sigma: float, sign: int, off: int, L: int,
                 window: str, device, transpose: bool = False):
    """:func:`_pruned_mats_np` as float32 tensors on ``device``, (L, N), or
    (N, L) with ``transpose`` (the forward's)."""
    cr, ci = _pruned_mats_np(N, M, m, float(sigma), sign, off, L, window)
    if transpose:
        cr, ci = cr.T, ci.T
    return (torch.as_tensor(np.ascontiguousarray(cr), device=device),
            torch.as_tensor(np.ascontiguousarray(ci), device=device))


def _axis_contract_planar(xr, xi, mr, mi, ax: int, real_only: bool = False):
    """(xr + i xi) contracted along ``ax`` with (mr + i mi); xi may be
    None; ``real_only`` returns (real plane, None)."""
    rr = _axis_contract(xr, mr, ax)
    if xi is not None:
        rr = rr - _axis_contract(xi, mi, ax)
    if real_only:
        return rr, None
    ri = _axis_contract(xr, mi, ax)
    if xi is not None:
        ri = ri + _axis_contract(xi, mr, ax)
    return rr, ri
