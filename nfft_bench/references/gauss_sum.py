"""Plain reference of the ``gram`` configurations: the exact Gaussian sum.

The operator maps the points as ``GaussianKernel`` without a radius
does: the bounding box's centre to the origin, the largest infinity norm
to ``scale_factor``; the kernel is exp(-||t - s||^2 / width^2) with
width = scale_factor * kernel_sigma on the mapped points. The reference
works this out itself from the benchmark's raw points, in float64, and
sums over every source at the sampled targets:
y[t] = sum_s exp(-||t - s||^2 / width^2) x[s]. The trigonometric series
the port builds is an approximation of this kernel (its truncation at
the configured bandwidth is negligible at this width), so the sum
covers its coefficients too.

``precision="tf32"``: the control, the same sum in float32 with the
contraction's operands (kernel values and x) rounded to TF32.
Imports nothing of the port.
"""

from __future__ import annotations

import torch

from nfftb.check import tf32

CHUNK = 1 << 17


def grid_points(config: dict, points: torch.Tensor) -> torch.Tensor:
    """The points as the kernel maps them, float64, in [-1/2, 1/2)."""
    p = points.detach().double()
    c = p - 0.5 * (p.amin(0) + p.amax(0))
    return c * (float(config["scale_factor"]) / c.abs().amax())


def outputs(config: dict, traffic: dict, points, rows, pool: list,
            precision: str = "float64") -> list:
    """[{"y": (rows, columns)} for each pool entry], float64."""
    low = precision == "tf32"
    dt = torch.float32 if low else torch.float64
    s = grid_points(config, points).to(dt)
    width = float(config["scale_factor"]) * float(config["kernel_sigma"])
    X = torch.cat([v["x"].detach() for v in pool], 1).to(dt)
    C = pool[0]["x"].shape[1]
    t = s[rows]
    acc = torch.zeros((t.shape[0], X.shape[1]), dtype=torch.float64, device=s.device)
    for c0 in range(0, s.shape[0], CHUNK):
        sc = s[c0:c0 + CHUNK]
        d2 = torch.zeros((t.shape[0], sc.shape[0]), dtype=dt, device=s.device)
        for d in range(s.shape[1]):
            d2 += (t[:, d, None] - sc[None, :, d]) ** 2
        E = torch.exp(d2 * (-1.0 / width**2))
        Xc = X[c0:c0 + CHUNK]
        acc += (tf32(E) @ tf32(Xc) if low else E @ Xc).double()
    return [{"y": acc[:, k * C:(k + 1) * C]} for k in range(len(pool))]
