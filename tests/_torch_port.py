"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: seeded inputs as numpy arrays, and a JAX plan carried across."""

import numpy as np

import torch_nfft_tpu_torch as tp


def points(rng, n, dim, B=1, full_box=False):
    """n float32 points (inside [-1/4, 1/4]^dim unless ``full_box``) and a
    sorted int32 batch vector with every batch non-empty."""
    pos = (rng.random((n, dim), dtype=np.float32) - 0.5)
    if not full_box:
        pos /= 4 * np.abs(pos).max()
    batch = np.repeat(np.arange(B, dtype=np.int32), -(-n // B))[:n]
    return pos, batch


def port_plan(jplan, device="cpu"):
    """The port's plan from a JAX BinnedPlan's fields, as numpy arrays."""
    arrays = {name: np.asarray(getattr(jplan, name)) for name in tp.convert.PLAN_ARRAYS}
    return tp.plan_from_numpy(
        arrays, n=jplan.n, dim=jplan.dim, N=jplan.N, m=jplan.m,
        sigma=jplan.sigma, T=jplan.T, K=jplan.K, batch_size=jplan.batch_size,
        window=jplan.window, active=jplan.active, device=device,
    )


def rel_l2(a, b) -> float:
    a = np.asarray(a, dtype=np.complex128)
    b = np.asarray(b, dtype=np.complex128)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))
