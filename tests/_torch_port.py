"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: seeded inputs as numpy arrays, a JAX plan carried across, and the
whole-grid formulation of the half-spectrum stages that the band-pruned
ones replaced (no JAX: the card tests use it too)."""

import itertools

import numpy as np
import torch

import torch_nfft_tpu_torch as tp


def _warm_up_cpu_math():
    """Run the vectorised CPU math functions the port uses once over a large
    tensor before any test does. With PyTorch 2.13's CPU build (MKL, 8
    threads) the first parallel call of torch.exp or torch.sqrt in a process
    has evaluated part of its input with another, less accurate
    implementation (window values off by up to ~1e-3 relative, in 5 of 55
    fresh processes; in 0 of 55 after this warm-up). Later calls agree with
    each other and with a one-element evaluation."""
    t = torch.linspace(0.5, 4.0, 1 << 22)
    for fn in (torch.exp, torch.sqrt, torch.rsqrt):
        fn(t)
    torch.exp(torch.complex(t, t))


_warm_up_cpu_math()


def points(rng, n, dim, B=1, full_box=False):
    """n float32 points (inside [-1/4, 1/4]^dim unless ``full_box``) and a
    sorted int32 batch vector with every batch non-empty."""
    pos = (rng.random((n, dim), dtype=np.float32) - 0.5)
    if not full_box:
        pos /= 4 * np.abs(pos).max()
    batch = np.repeat(np.arange(B, dtype=np.int32), -(-n // B))[:n]
    return pos, batch


def port_plan(jplan, device="cpu"):
    """The port's plan from a JAX BinnedPlan's fields, as numpy arrays,
    with its host fields (fingerprint, sorted order, row starts, S_occ)."""
    arrays = {name: np.asarray(getattr(jplan, name)) for name in tp.convert.PLAN_ARRAYS}
    return tp.plan_from_numpy(
        arrays, n=jplan.n, dim=jplan.dim, N=jplan.N, m=jplan.m,
        sigma=jplan.sigma, T=jplan.T, K=jplan.K, batch_size=jplan.batch_size,
        window=jplan.window, active=jplan.active, pos_fp=jplan.pos_fp,
        order=jplan.order, row_start=jplan.row_start, S_occ=jplan.S_occ,
        device=device,
    )


def rel_l2(a, b) -> float:
    a = np.asarray(a, dtype=np.complex128)
    b = np.asarray(b, dtype=np.complex128)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _half_blocks(dim, N, M):
    """(half-spectrum slices, grid slices) pairs, one per sign pattern of
    the leading axes (k in [-h, 0) at M - h.., k in [0, h] at 0..)."""
    h = N // 2
    neg = (slice(0, h), slice(M - h, M))
    pos = (slice(h, 2 * h + 1), slice(0, h + 1))
    for signs in itertools.product((neg, pos), repeat=dim - 1):
        yield (tuple(s[0] for s in signs) + (slice(0, h + 1),),
               tuple(s[1] for s in signs) + (slice(0, h + 1),))


def whole_adjoint(g, dim, N, phi):
    """``rfftn`` of the whole grid, cropped to the half spectrum, conj, phi."""
    R = torch.fft.rfftn(g, dim=tuple(range(-dim, 0)))
    h = N // 2
    out = R.new_zeros(R.shape[:R.ndim - dim] + (2 * h + 1,) * (dim - 1) + (h + 1,))
    for dst, src in _half_blocks(dim, N, g.shape[-1]):
        out[(Ellipsis,) + dst] = R[(Ellipsis,) + src]
    return out.conj() * phi


def whole_forward(H, dim, N, M, phi):
    """conj(H) phi embedded in a zeroed M x ... x (M // 2 + 1) array, ``irfftn``."""
    X = H.conj() * phi
    out = X.new_zeros(X.shape[:X.ndim - dim] + (M,) * (dim - 1) + (M // 2 + 1,))
    for src, dst in _half_blocks(dim, N, M):
        out[(Ellipsis,) + dst] = X[(Ellipsis,) + src]
    return torch.fft.irfftn(out, s=(M,) * dim, dim=tuple(range(-dim, 0)), norm="forward")
