"""Plain reference of the ``pair`` configurations: the adjoint+forward
pair and its gradients as direct sums over every point.

The adjoint y_k = sum_s x_s exp(+2 pi i k.p_s) and the real-output
forward z_j = Re sum_k y_k exp(-2 pi i k.p_j), k in [-N/2, N/2)^dim,
give z_j = sum_s x_s K(p_j - p_s) with the real, even kernel
K(u) = cos(pi sum_d u_d) prod_d S(u_d), S(u) = sin(pi N u) / sin(pi u)
(S(0) = N; the Dirichlet kernel sum_k exp(2 pi i k u) is
exp(-i pi u) S(u)). For the training step L = <z, w>:
x.grad = K w at the rows, and
pos.grad_a = sum_s (x_a w_s + w_a x_s) grad K(p_a - p_s).
Everything in float64 from the benchmark's raw points; the window, the
oversampled grid and the plan do not enter.

``precision="tf32"``: the control, the same sums in float32 with the
contractions' operands (kernel values, x, w) rounded to TF32.
Imports nothing of the port.
"""

from __future__ import annotations

import math

import torch

from nfftb.check import tf32

CHUNK = 1 << 16


def grid_points(config: dict, points: torch.Tensor) -> torch.Tensor:
    """The points as the transform reads them, float64, in [-1/2, 1/2)."""
    return points.detach().double()


def dirichlet(u: torch.Tensor, N: int) -> tuple:
    """(S(u), S'(u)); a Taylor form within ``small`` of 0."""
    small = 1e-7 if u.dtype == torch.float64 else 1e-4
    c2 = math.pi**2 * N * (N * N - 1) / 6.0
    a = math.pi * u
    sa, ca, sn, cn = torch.sin(a), torch.cos(a), torch.sin(N * a), torch.cos(N * a)
    near = u.abs() < small
    S = torch.where(near, N - c2 * u * u, sn / sa)
    dS = torch.where(near, -2.0 * c2 * u, math.pi * (N * cn * sa - ca * sn) / (sa * sa))
    return S, dS


def outputs(config: dict, traffic: dict, points, rows, pool: list,
            precision: str = "float64") -> list:
    """For each pool entry: {"y": (rows, C)} for the pair, {"xgrad":
    (rows, C), "posgrad": (rows, dim)} for the step; float64."""
    low = precision == "tf32"
    dt = torch.float32 if low else torch.float64
    mm = (lambda a, b: tf32(a) @ tf32(b)) if low else (lambda a, b: a @ b)
    N = int(config["bandwidth"])
    step = traffic["call"] == "step"
    s = grid_points(config, points).to(dt)
    n, dim = s.shape
    P, C = len(pool), pool[0]["x"].shape[1]
    X = torch.cat([v["x"].detach() for v in pool], 1).to(dt)  # (n, P*C)
    W = torch.cat([v["w"].detach() for v in pool], 1).to(dt) if step else None
    t = s[rows]
    R = t.shape[0]
    f64 = dict(dtype=torch.float64, device=s.device)
    accK = torch.zeros((R, P * C), **f64)
    accGX = torch.zeros((dim, R, P * C), **f64)
    accGW = torch.zeros((dim, R, P * C), **f64)
    for c0 in range(0, n, CHUNK):
        sc = s[c0:c0 + CHUNK]
        parts = [dirichlet(t[:, d, None] - sc[None, :, d], N) for d in range(dim)]
        ang = math.pi * sum(t[:, d, None] - sc[None, :, d] for d in range(dim))
        prodS = math.prod(S for S, _ in parts)
        K = torch.cos(ang) * prodS
        accK += mm(K, (W if step else X)[c0:c0 + CHUNK]).double()
        if not step:
            continue
        del K
        sin_part = -math.pi * torch.sin(ang) * prodS
        cos_ang = torch.cos(ang)
        for d in range(dim):
            others = math.prod(parts[e][0] for e in range(dim) if e != d)
            G = sin_part + cos_ang * parts[d][1] * others
            accGX[d] += mm(G, X[c0:c0 + CHUNK]).double()
            accGW[d] += mm(G, W[c0:c0 + CHUNK]).double()
    out = []
    for k in range(P):
        cols = slice(k * C, (k + 1) * C)
        if not step:
            out.append({"y": accK[:, cols]})
            continue
        xr, wr = X[rows][:, cols].double(), W[rows][:, cols].double()
        pg = ((xr[None] * accGW[:, :, cols]).sum(-1)
              + (wr[None] * accGX[:, :, cols]).sum(-1)).T
        out.append({"xgrad": accK[:, cols], "posgrad": pg})
    return out
