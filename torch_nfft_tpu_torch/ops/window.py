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
parameters of :func:`window_params`, and the derivative d phi / d pos =
M * phi'(t) (t = M*pos - cell, so d t / d pos = M) from
:func:`window_deriv_param`.
"""

from __future__ import annotations

import functools
import math
import warnings

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
    "window_value_and_deriv_fn",
    "window_params",
    "window_deriv_param",
    "phi_hat_inv_np",
    "phi_hat_inv_centered",
    "window_index_offsets",
    "compute_shifts",
    "compute_psi",
    "compute_psi_and_dpsi",
    "F32_PIPELINE_FLOOR",
    "suggest_window_parameters",
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


def _i1(x: torch.Tensor) -> torch.Tensor:
    """Modified Bessel I1 for x >= 0 in float32, Abramowitz-Stegun
    9.8.3/9.8.4 (|rel err| < 3e-7); the CUDA kernel uses the same
    polynomials."""
    small = x < 3.75
    y = torch.where(small, x / 3.75, 0.0)
    y = y * y
    p_small = x * (0.5 + y * (0.87890594 + y * (0.51498869 + y * (
        0.15084934 + y * (0.02658733 + y * (0.00301532 + y * 0.00032411))))))
    ax = torch.clamp(x, min=3.75)
    z = 3.75 / ax
    inner = 0.02282967 + z * (-0.02895312 + z * (0.01787654 - z * 0.00420059))
    p_big = 0.39894228 + z * (-0.03988024 + z * (-0.00362018 + z * (
        0.00163801 + z * (-0.01031555 + z * inner))))
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


def window_value_and_deriv_fn(m: int, sigma: float = DEFAULT_SIGMA,
                              window: str = DEFAULT_WINDOW, *, M: int):
    """(phi(t), d phi / d pos) as one function of float32 tensors of t.

    With c = :func:`window_deriv_param`: gaussian c*t*phi; es c*t/s*phi;
    kb c*t/s*I1(beta*s)/I0(beta), s = sqrt(1 - (t/(m+1))^2) with 1/s
    clamped at s = 1e-6 (the window vanishes at its support edge)."""
    phi = window_value_fn(m, sigma, window)
    c = window_deriv_param(m, sigma, window, M=M)
    if window == "gaussian":
        def pair_gauss(t):
            vals = phi(t)
            return vals, (c * t) * vals

        return pair_gauss

    inv_w2 = 1.0 / ((m + 1.0) * (m + 1.0))

    def support(t):
        s2 = 1.0 - (t * t) * inv_w2
        inside = s2 > 0.0
        return inside, torch.sqrt(torch.where(inside, s2, 1.0))

    if window == "kb":
        beta = kb_beta(m, sigma)
        inv_i0b = 1.0 / float(np.i0(np.float64(beta)))

        def pair_kb(t):
            inside, s = support(t)
            d = c * t / torch.clamp(s, min=1e-6) * _i1(beta * s) * inv_i0b
            return phi(t), torch.where(inside, d, 0.0)

        return pair_kb

    def pair_es(t):
        _, s = support(t)
        vals = phi(t)
        return vals, c * t / torch.clamp(s, min=1e-6) * vals

    return pair_es


def window_deriv_param(m: int, sigma: float = DEFAULT_SIGMA,
                       window: str = DEFAULT_WINDOW, *, M: int) -> float:
    """The factor c of the window derivative, d phi / d pos = c * t * ...
    (:func:`window_value_and_deriv_fn`): -2*inv_b*M for the gaussian,
    -beta*M/(m+1)^2 for es and kb."""
    check_window(window)
    if window == "gaussian":
        return -2.0 * window_inv_b(m, sigma) * M
    beta = es_beta(m, sigma) if window == "es" else kb_beta(m, sigma)
    return -beta * M * (1.0 / ((m + 1.0) * (m + 1.0)))


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


def compute_shifts(pos: torch.Tensor, N: int, m: int,
                   sigma: float = DEFAULT_SIGMA) -> torch.Tensor:
    """Smallest window grid index per point and axis, int32 (n, dim):
    floor(pos * M) - m, M = sigma*N. No gradient flows through it; the
    periodic wrap is applied downstream."""
    M = int(round(sigma * N))
    return (torch.floor(pos.detach() * M).to(torch.int32) - m)


def _psi_arg(pos: torch.Tensor, shifts: torch.Tensor, N: int, m: int,
             sigma: float) -> torch.Tensor:
    """t[i, d, l] = M*pos[i, d] - shifts[i, d] - l, in [m, m+1) - l."""
    M = int(round(sigma * N))
    l = torch.arange(2 * m + 2, dtype=pos.dtype, device=pos.device)
    return pos[..., None] * M - shifts[..., None].to(pos.dtype) - l


def compute_psi(pos: torch.Tensor, shifts: torch.Tensor, N: int, m: int,
                sigma: float = DEFAULT_SIGMA,
                window: str = DEFAULT_WINDOW) -> torch.Tensor:
    """Window values per point, axis and window cell, (n, dim, 2m+2):
    phi(M*pos[i, d] - shifts[i, d] - l). Differentiable in ``pos``."""
    return window_value_fn(m, sigma, window)(_psi_arg(pos, shifts, N, m, sigma))


def compute_psi_and_dpsi(pos: torch.Tensor, shifts: torch.Tensor, N: int, m: int,
                         sigma: float = DEFAULT_SIGMA, window: str = DEFAULT_WINDOW):
    """(window values, their derivatives in the position coordinate), each
    (n, dim, 2m+2): d psi / d pos[i, d] = M * phi'(t)."""
    M = int(round(sigma * N))
    return window_value_and_deriv_fn(m, sigma, window, M=M)(
        _psi_arg(pos, shifts, N, m, sigma))


# Accuracy floor of the port's float32 pipeline on the card: the largest
# rel-L2 against the float64 NDFT that chip_smoke.py phase 10e measures
# where window truncation is negligible (es and kb at m = 6-8, sigma = 2,
# the 3D N = 32 gate): 1.37e-6 (es, m = 6) rising to 5.16e-6 (kb, m = 8)
# on an NVIDIA H100 80GB HBM3 at 700 W, rounded up. It stands in the error
# model where the JAX package puts its TPU matmul floor (4e-5), which does
# not apply here.
F32_PIPELINE_FLOOR = 6e-6


@functools.lru_cache(maxsize=None)
def _window_error_model(window: str, m: int, sigma: float, floor: float) -> float:
    """Conservative rel-L2 error model at (window, m, sigma), the JAX
    package's: window truncation exp(-r(sigma) * beta) (es: r = 0.92 *
    (1 - 1/(2 sigma)); kb: r = 0.17 + 0.7565 * (1 - 1/(2 sigma))), plus the
    pipeline ``floor``, plus the deconvolution's amplification of float32
    rounding at low oversampling, 7e-9 * amp^3.2 with amp the dynamic range
    max/min of the inverse window coefficients."""
    if window == "kb":
        trunc = math.exp(-(0.17 + 0.7565 * (1.0 - 1.0 / (2.0 * sigma))) * kb_beta(m, sigma))
    else:
        trunc = math.exp(-0.92 * (1.0 - 1.0 / (2.0 * sigma)) * es_beta(m, sigma))
    v = phi_hat_inv_np(64, m, float(sigma), window)
    amp = float(v.max() / v.min())
    return trunc + floor + 7e-9 * amp**3.2


def suggest_window_parameters(tol: float, sigma: float = DEFAULT_SIGMA) -> dict:
    """The cheapest window reaching ``tol`` relative L2 error: the smallest
    cutoff m (1-8) of the es and kb families whose error model
    (:func:`_window_error_model`, at ``F32_PIPELINE_FLOOR``) meets ``tol``,
    es before kb at equal m. When none does, the most accurate one with a
    ``UserWarning`` naming the model's minimum. Returns ``{"window",
    "m", "sigma", "predicted_rel_l2"}``, to pass on as
    ``nfft_adjoint(x, pos, cutoff=p["m"], window=p["window"])``."""
    tol = float(tol)
    floor = F32_PIPELINE_FLOOR
    errs = {(w, m): _window_error_model(w, m, float(sigma), floor)
            for m in range(1, 9) for w in ("es", "kb")}
    feasible = [(m, w) for (w, m), e in errs.items() if e <= tol]
    if feasible:
        m, w = min(feasible)
    else:
        w, m = min(errs, key=errs.get)
        warnings.warn(
            f"tol={tol:g} is below the reachable error at sigma={sigma} (error model "
            f"minimum {errs[(w, m)]:.1e} at window={w!r} m={m}); returning the most "
            "accurate configuration. Raising sigma helps against the low-oversampling "
            f"amplification but not below the ~{floor:.0e} float32 pipeline floor",
            UserWarning, stacklevel=2)
    return {"window": w, "m": m, "sigma": sigma, "predicted_rel_l2": errs[(w, m)]}
