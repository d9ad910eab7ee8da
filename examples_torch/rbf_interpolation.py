"""Scattered-data RBF interpolation with the radial kernel family, on the
PyTorch port.

Port of examples/rbf_interpolation.py (same data, seeds, defaults and
assertion). Three parts of the port work together:

* ``MaternKernel`` (models/radial.py): a non-Gaussian kernel through the
  interpolated-coefficients workflow;
* ``GramMatrix.solve``: kernel-ridge CG iterating in the plan's slot layout
  (matvecs without the point-order permutations);
* ``suggest_window_parameters``: the window and cutoff for a tolerance.

Fits f(x) = sum_s K(||x - s||) z_s to noisy samples of a smooth target on
scattered 2D points, then predicts at held-out points by one asymmetric
fastsum; no dense matrix anywhere. Runs on the CUDA card; ``--device cpu``
runs the plain PyTorch path.

Usage: python examples_torch/rbf_interpolation.py [n_train] [n_test] [--device cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

import torch_nfft_tpu_torch as tp


def target(p):
    return np.sin(3.0 * p[:, 0]) * np.cos(2.0 * p[:, 1]) + 0.5 * p[:, 0] * p[:, 1]


def problem(n_train=20000, n_test=2000, device=None) -> tuple:
    """The data and the kernel: (kernel, train points, test points, noisy
    training values, exact test values) on the device, the values numpy."""
    dev = tp.resolve_device(device)
    rng = np.random.default_rng(3)

    pts = rng.random((n_train + n_test, 2)).astype(np.float32) * 2 - 1
    y = target(pts).astype(np.float32)
    y_train = y[:n_train] + 0.01 * rng.standard_normal(n_train).astype(np.float32)
    train = torch.from_numpy(pts[:n_train]).to(dev)
    test = torch.from_numpy(pts[n_train:]).to(dev)

    # accuracy-targeted window configuration (es m=2 for 1e-4)
    wp = tp.suggest_window_parameters(1e-4)
    print(f"window parameters for tol 1e-4: {wp}", flush=True)

    radius = float(np.abs(pts - pts.mean(0)).max()) * 1.01
    kernel = tp.MaternKernel(0.35, nu=1.5, dim=2, bandwidth=64, cutoff=wp["m"],
                             max_infinity_norm=radius, window=wp["window"], device=dev)
    return kernel, train, test, y_train, y[n_train:]


def main(n_train=20000, n_test=2000, device=None) -> dict:
    """Fit, predict and hold the held-out RMSE under a quarter of the
    constant predictor's; returns the readings."""
    dev = tp.resolve_device(device)
    kernel, train, test, y_train, y_test = problem(n_train, n_test, dev)

    # fit: (G + reg I) z = y_train, CG in slot layout
    G = kernel(train)
    t0 = time.perf_counter()
    z = G.solve(torch.from_numpy(y_train).to(dev), reg=1e-2, tol=1e-6, maxiter=200)
    z_inf = float(z.abs().max())
    solve_s = time.perf_counter() - t0
    print(f"CG solve: {solve_s:.2f}s, |z|_inf={z_inf:.3f}", flush=True)

    # predict at the held-out points: one asymmetric Gram matvec
    # (sources = train, targets = test)
    pred = (kernel.gram_matrix(train, test) @ z).cpu().numpy()

    rmse = float(np.sqrt(np.mean((pred - y_test) ** 2)))
    base = float(np.sqrt(np.mean((y_test - y_train.mean()) ** 2)))
    print(f"held-out RMSE {rmse:.4f} (constant-predictor baseline {base:.4f})", flush=True)
    assert rmse < 0.25 * base, "interpolation failed to beat the baseline"
    print("OK", flush=True)
    return dict(rmse=rmse, baseline=base, solve_s=solve_s)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_train", nargs="?", type=int, default=20000)
    ap.add_argument("n_test", nargs="?", type=int, default=2000)
    ap.add_argument("--device", default=None, help="'cpu' for the plain PyTorch path")
    a = ap.parse_args()
    main(a.n_train, a.n_test, a.device)
