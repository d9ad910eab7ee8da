"""Window functions of the NFFT in PyTorch: gaussian, es and kb.

Counterpart of the JAX package's ``ops/window.py``. Everything is written in the
scaled argument t = M*x - cell, M = sigma*N the oversampled grid size:

* gaussian: phi(t) = exp(-t^2 * inv_b) * inv_sqrt_b_pi,
  inv_b = pi*(2 sigma - 1)/(2 sigma m);
* es ("exponential of semicircle"):
  phi(t) = exp(beta*(sqrt(1 - (t/(m+1))^2) - 1)) for |t| < m+1,
  beta = 0.976*pi*(2m+2)*(1 - 1/(2 sigma));
* kb (Kaiser-Bessel): phi(t) = I0(beta*sqrt(1 - (t/(m+1))^2)) / I0(beta).

The inverse window Fourier coefficients come from a float64 Gauss-Legendre
quadrature on the host (closed form for the gaussian). The CUDA kernels
(``csrc/contract.cu``) evaluate the same float32 expressions from the
parameters of :func:`window_params`.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = [
    "DEFAULT_SIGMA",
    "DEFAULT_WINDOW",
    "WINDOWS",
    "window_inv_b",
    "window_inv_sqrt_b_pi",
    "phi_hat_inv_param",
    "es_beta",
    "kb_beta",
    "window_value_fn",
    "window_params",
    "phi_hat_inv_np",
    "phi_hat_inv_centered",
    "window_index_offsets",
]

DEFAULT_SIGMA = 2.0
DEFAULT_WINDOW = "gaussian"
WINDOWS = ("gaussian", "es", "kb")


def check_window(window: str) -> str:
    if window not in WINDOWS:
        raise ValueError(f"unknown window {window!r}; supported: {WINDOWS}")
    return window


def window_inv_b(m: int, sigma: float = DEFAULT_SIGMA) -> float:
    """1/b in the scaled window argument. sigma=2 -> 3*pi/(4*m)."""
    return math.pi * (2.0 * sigma - 1.0) / (2.0 * sigma * m)


def window_inv_sqrt_b_pi(m: int, sigma: float = DEFAULT_SIGMA) -> float:
    """1/sqrt(pi*b). sigma=2 -> sqrt(0.75/m)."""
    return math.sqrt((2.0 * sigma - 1.0) / (2.0 * sigma * m))


def phi_hat_inv_param(N: int, m: int, sigma: float = DEFAULT_SIGMA) -> float:
    """b*(pi/M)^2 with M = sigma*N. sigma=2 -> m*pi/(3*N^2)."""
    b = 2.0 * sigma * m / ((2.0 * sigma - 1.0) * math.pi)
    M = sigma * N
    return b * (math.pi / M) ** 2


def es_beta(m: int, sigma: float = DEFAULT_SIGMA) -> float:
    """Shape parameter of the es window: 0.976*pi*(2m+2)*(1-1/(2*sigma))."""
    return 0.976 * math.pi * (2 * m + 2) * (1.0 - 1.0 / (2.0 * sigma))


def kb_beta(m: int, sigma: float = DEFAULT_SIGMA) -> float:
    """Shape parameter of the Kaiser-Bessel window (Beatty et al. 2005):
    pi*sqrt((J*(1-1/(2 sigma)))^2 - 0.8) with support width J = 2m+2."""
    J = 2 * m + 2
    arg = (J * (1.0 - 1.0 / (2.0 * sigma))) ** 2 - 0.8
    return math.pi * math.sqrt(max(arg, 0.25))


def _i0(x: torch.Tensor) -> torch.Tensor:
    """Modified Bessel I0 for x >= 0 in float32, Abramowitz-Stegun
    9.8.1/9.8.2 (|rel err| < 2e-7); the CUDA kernels use the same
    polynomials."""
    small = x < 3.75
    y = torch.where(small, x / 3.75, 0.0)
    y = y * y
    p_small = 1.0 + y * (3.5156229 + y * (3.0899424 + y * (
        1.2067492 + y * (0.2659732 + y * (0.0360768 + y * 0.0045813)))))
    ax = torch.clamp(x, min=3.75)  # keeps exp/rsqrt finite in the dead branch
    z = 3.75 / ax
    p_big = (0.39894228 + z * (0.01328592 + z * (0.00225319 + z * (
        -0.00157565 + z * (0.00916281 + z * (-0.02057706 + z * (
            0.02635537 + z * (-0.01647633 + z * 0.00392377))))))))
    big = torch.exp(ax) * torch.rsqrt(ax) * p_big
    return torch.where(small, p_small, big)


def window_value_fn(m: int, sigma: float = DEFAULT_SIGMA,
                    window: str = DEFAULT_WINDOW):
    """phi as a function of float32 tensors of the scaled argument t."""
    check_window(window)
    if window == "gaussian":
        inv_b = window_inv_b(m, sigma)
        amp = window_inv_sqrt_b_pi(m, sigma)

        def phi_gauss(t):
            return torch.exp(-(t * t) * inv_b) * amp

        return phi_gauss

    w = m + 1.0
    inv_w2 = 1.0 / (w * w)
    if window == "kb":
        beta = kb_beta(m, sigma)
        inv_i0b = 1.0 / float(np.i0(np.float64(beta)))

        def phi_kb(t):
            s2 = 1.0 - (t * t) * inv_w2
            inside = s2 > 0.0
            s = torch.sqrt(torch.where(inside, s2, 1.0))
            return torch.where(inside, _i0(beta * s) * inv_i0b, 0.0)

        return phi_kb

    beta = es_beta(m, sigma)

    def phi_es(t):
        s2 = 1.0 - (t * t) * inv_w2
        inside = s2 > 0.0
        s = torch.sqrt(torch.where(inside, s2, 1.0))
        return torch.where(inside, torch.exp(beta * (s - 1.0)), 0.0)

    return phi_es


def window_params(m: int, sigma: float = DEFAULT_SIGMA,
                  window: str = DEFAULT_WINDOW) -> tuple[int, float, float, float]:
    """(kind, p0, p1, p2) as the CUDA kernels take them:
    gaussian (0, inv_b, amp, 0); es (1, beta, 1/(m+1)^2, 0);
    kb (2, beta, 1/(m+1)^2, 1/I0(beta))."""
    check_window(window)
    if window == "gaussian":
        return 0, window_inv_b(m, sigma), window_inv_sqrt_b_pi(m, sigma), 0.0
    inv_w2 = 1.0 / ((m + 1.0) * (m + 1.0))
    if window == "es":
        return 1, es_beta(m, sigma), inv_w2, 0.0
    beta = kb_beta(m, sigma)
    return 2, beta, inv_w2, 1.0 / float(np.i0(np.float64(beta)))


@functools.lru_cache(maxsize=None)
def phi_hat_inv_np(N: int, m: int, sigma: float = DEFAULT_SIGMA,
                   window: str = DEFAULT_WINDOW) -> np.ndarray:
    """Centered inverse window Fourier coefficients, float64 numpy (N,).

    out[i] = 1 / (M * phi_hat(k)), k = i - N/2. Gaussian: closed form;
    es and kb: 300-node Gauss-Legendre quadrature of the compactly
    supported window."""
    check_window(window)
    k = np.arange(N, dtype=np.float64) - N // 2
    if window == "gaussian":
        return np.exp(k * k * phi_hat_inv_param(N, m, sigma))
    w = m + 1.0
    M = sigma * N
    nodes, weights = np.polynomial.legendre.leggauss(300)
    s = np.sqrt(1.0 - nodes * nodes)
    if window == "kb":
        beta = kb_beta(m, sigma)
        prof = np.i0(beta * s) / np.i0(np.float64(beta))
    else:
        beta = es_beta(m, sigma)
        prof = np.exp(beta * (s - 1.0))
    t = nodes * w
    vals = prof * (weights * w)
    ph = vals @ np.cos(2.0 * np.pi * np.outer(t, k / M))
    return 1.0 / ph


def phi_hat_inv_centered(N: int, m: int, sigma: float = DEFAULT_SIGMA,
                         window: str = DEFAULT_WINDOW, *,
                         device=None) -> torch.Tensor:
    """:func:`phi_hat_inv_np` as a float32 tensor on ``device``. The gaussian
    is evaluated in float32, as the reference does."""
    if window == "gaussian":
        k = torch.arange(N, dtype=torch.float32, device=device) - N // 2
        return torch.exp(k * k * phi_hat_inv_param(N, m, sigma))
    v = phi_hat_inv_np(N, m, float(sigma), window)
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def window_index_offsets(dim: int, m: int, *, device=None) -> torch.Tensor:
    """All window multi-indices, int32 (W, dim), W = (2m+2)**dim, row-major
    over (l_0, ..., l_{dim-1})."""
    L = 2 * m + 2
    ar = torch.arange(L, dtype=torch.int32, device=device)
    grids = torch.meshgrid(*([ar] * dim), indexing="ij")
    return torch.stack(grids, dim=-1).reshape(-1, dim)
