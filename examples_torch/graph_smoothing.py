"""Graph-signal smoothing with an NFFT-approximated Gaussian adjacency, on
the PyTorch port.

Port of examples/graph_smoothing.py (same data, seeds, defaults and
assertion): build a dense-graph adjacency from a Gaussian kernel over point
positions without forming the O(n^2) matrix, then run normalised-adjacency
propagation steps, each one fastsum matvec, O(m^d n + N^d log N). Runs on
the CUDA card; ``--device cpu`` runs the plain PyTorch path.

Usage: python examples_torch/graph_smoothing.py [n] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

import torch_nfft_tpu_torch as tp


def problem(n=20000, device=None) -> tuple:
    """The graph and its signal: (the ``sym`` adjacency operator, the
    points, the noisy signal, the cluster labels), the last three numpy."""
    dev = tp.resolve_device(device)
    rng = np.random.default_rng(0)
    dim = 2

    # two noisy clusters + a noisy binary signal
    centers = np.array([[-0.6, -0.6], [0.6, 0.6]], np.float32)
    labels = rng.integers(0, 2, n)
    pos = centers[labels] + 0.25 * rng.standard_normal((n, dim)).astype(np.float32)
    signal = labels.astype(np.float32) + 0.8 * rng.standard_normal(n).astype(np.float32)

    # Gaussian kernel -> symmetric-normalised adjacency operator
    kernel = tp.GaussianKernel(sigma=0.35, dim=dim, bandwidth=32, cutoff=4,
                               max_euclidean_norm=1.5, device=dev)
    adj = kernel.adjacency_matrix(torch.from_numpy(pos).to(dev), normalization="sym")
    return adj, pos, signal, labels


def main(n=20000, device=None) -> dict:
    """Smooth the signal by 10 ``sym`` adjacency matvecs and hold the
    clusters' separation above 3 times the raw signal's; returns both."""
    dev = tp.resolve_device(device)
    adj, _, signal, labels = problem(n, dev)

    smoothed = torch.from_numpy(signal).to(dev)
    for _ in range(10):
        smoothed = adj @ smoothed
    smoothed = smoothed.cpu().numpy()

    # smoothing should separate the clusters far better than the raw signal
    def separation(v):
        a, b = v[labels == 0], v[labels == 1]
        return abs(a.mean() - b.mean()) / (a.std() + b.std() + 1e-9)

    raw, smooth = float(separation(signal)), float(separation(smoothed))
    print(f"cluster separation raw:      {raw:.2f}")
    print(f"cluster separation smoothed: {smooth:.2f}")
    assert smooth > 3 * raw
    print("ok")
    return dict(raw=raw, smoothed=smooth)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=20000)
    ap.add_argument("--device", default=None, help="'cpu' for the plain PyTorch path")
    a = ap.parse_args()
    main(a.n, a.device)
