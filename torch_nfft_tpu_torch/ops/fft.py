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
samples, the pair, the real-output forward, the real fastsum), on
``rfftn``/``irfftn``. The adjoint of a real grid is conjugate symmetric,
y[-k] = conj y[k], so half of it is stored: a "half spectrum" holds the
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

Grids are channel-first, (batch_size, C, M, ..., M); the spatial axes are
the last ``dim`` axes of every array here.

The pruned DFT matrices (:func:`_pruned_mats_np`, :func:`_axis_contract`)
are the JAX package's: one (L, N) matrix per axis folding the DFT, the crop
to the centered band and the rolloff into one product. The point-sharded
spectral stages (parallel/sharded.py) contract with them; the grid-sharded
ones (parallel/grid_sharded.py) take the half spectrum of a slab's own
axes with ``rfftn`` and contract only the sharded axis 0 with a block of
rows of such a matrix, then all-reduce the half spectrum, which no FFT of
the slab alone can give. They are float32 products: the entry points pin
TF32 off (``_device.pin_fp32``), since one TF32 pass would cost ~1e-3.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

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


def _half_blocks(dim: int, N: int, M: int):
    """(half-spectrum slices, grid slices) pairs that map the half
    spectrum's leading axes (k in [-h, h] at index k + h) to the DFT
    layout's (k at index k mod M), one pair per sign pattern; the last
    axis is [0, h] in both."""
    h = N // 2
    neg = (slice(0, h), slice(M - h, M))  # k in [-h, 0)
    pos = (slice(h, 2 * h + 1), slice(0, h + 1))  # k in [0, h]
    for signs in itertools.product((neg, pos), repeat=dim - 1):
        yield (tuple(s[0] for s in signs) + (slice(0, h + 1),),
               tuple(s[1] for s in signs) + (slice(0, h + 1),))


def _half_shape(lead: tuple, dim: int, N: int) -> tuple:
    h = N // 2
    return lead + (2 * h + 1,) * (dim - 1) + (h + 1,)


def _crop_half(R: torch.Tensor, dim: int, N: int) -> torch.Tensor:
    """An ``rfftn`` spectrum (..., M, ..., M, M // 2 + 1) -> its half
    spectrum (..., 2h+1, ..., 2h+1, h+1), in one copy."""
    if dim == 1:
        return R[..., :N // 2 + 1]
    out = R.new_empty(_half_shape(R.shape[:R.ndim - dim], dim, N))
    for dst, src in _half_blocks(dim, N, R.shape[-2]):
        out[(Ellipsis,) + dst] = R[(Ellipsis,) + src]
    return out


def _embed_half(H: torch.Tensor, dim: int, N: int, M: int) -> torch.Tensor:
    """A half spectrum -> the ``irfftn`` input (..., M, ..., M, M // 2 + 1),
    zero outside the half spectrum's frequencies."""
    lead = H.shape[:H.ndim - dim]
    out = H.new_zeros(lead + (M,) * (dim - 1) + (M // 2 + 1,))
    for src, dst in _half_blocks(dim, N, M):
        out[(Ellipsis,) + dst] = H[(Ellipsis,) + src]
    return out


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


def spectral_adjoint_half(g: torch.Tensor, dim: int, N: int, m: int,
                          sigma: float = DEFAULT_SIGMA,
                          window: str = DEFAULT_WINDOW) -> torch.Tensor:
    """(B, C, M^dim) real grid -> the half spectrum (complex64) of its
    rolloff-corrected adjoint, Y[k] = phi_hat_inv(k) sum_j g[j]
    exp(+2 pi i j.k / M): the conjugate of ``rfftn``, cropped."""
    R = torch.fft.rfftn(g, dim=_axes(dim))
    return _crop_half(R, dim, N).conj() * _phi_half(dim, N, m, sigma, window, g.device)


def spectral_forward_half(H: torch.Tensor, dim: int, N: int, M: int, m: int,
                          sigma: float = DEFAULT_SIGMA,
                          window: str = DEFAULT_WINDOW) -> torch.Tensor:
    """The half spectrum H of a conjugate-symmetric Z -> the real grid
    (B, C, M^dim) sum_k Z[k] phi_hat_inv(k) exp(-2 pi i a.k / M):
    ``irfftn`` of conj(phi_hat_inv H), unnormalised."""
    X = _embed_half(H.conj() * _phi_half(dim, N, m, sigma, window, H.device), dim, N, M)
    return torch.fft.irfftn(X, s=(M,) * dim, dim=_axes(dim), norm="forward")


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
