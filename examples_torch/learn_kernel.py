"""Learn a kernel's spectral coefficients from operator observations, on the
PyTorch port.

Port of examples/learn_kernel.py (same data, seeds, defaults and
assertion). The upstream library's fastsum refuses coefficients that
require grad (upstream nfft.py:66-73); the port's ``nfft_fastsum`` is
differentiable in them, so the kernel's spectral coefficients are a
trainable parameter like any other. The demo recovers an unseen Matern
kernel from input/output pairs of its Gram operator: it learns K such that
``y = K_coeffs @ x`` matches the observed matvecs, without forming an
O(n^2) matrix.

Parameterisation: coeffs = softplus(theta) on the centered spectral grid;
positive coefficients keep the learned Gram operator positive
semidefinite. The optimiser is ``torch.optim.Adam(lr=0.05)``, 200 steps.
At n = 2000 in 2D the fastsum runs the plan-free matmul engine (the
``"auto"`` rule), as in the JAX package. Runs on the CUDA card;
``--device cpu`` runs the plain PyTorch path.

Usage: python examples_torch/learn_kernel.py [n] [steps] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

import torch_nfft_tpu_torch as tp


def rel_l2(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def main(n=2000, steps=200, device=None) -> dict:
    """Learn the coefficients and hold the held-out operator error under
    3e-2; returns the errors and the losses."""
    dev = tp.resolve_device(device)
    rng = np.random.default_rng(3)
    dim, N, m = 2, 16, 4
    n_probe = 16  # observed matvec pairs (columns)

    pos = (rng.random((n, dim), dtype=np.float32) - 0.5)
    pos /= 4 * np.abs(pos).max()  # NFFT safe box
    pos = torch.from_numpy(pos).to(dev)

    # ground truth: a Matern(nu=1.5) kernel the learner never sees
    true_kernel = tp.MaternKernel(sigma=0.6, nu=1.5, dim=dim, bandwidth=N, cutoff=m,
                                  shift_by_center=False, max_infinity_norm=0.25, device=dev)
    true_coeffs = true_kernel.coeffs
    src = true_kernel.factor * pos

    x_probe = torch.from_numpy(rng.standard_normal((n, n_probe)).astype(np.float32)).to(dev)
    y_probe = tp.nfft_fastsum(x_probe, true_coeffs, src, cutoff=m, device=dev)

    # learnable spectral filter; init: a broad Gaussian guess (wrong family,
    # wrong width), through softplus^-1
    init = tp.gaussian_analytic_coeffs(0.05, dim=dim, N=N, device=dev)
    theta = torch.log(torch.expm1(init.clamp(min=1e-6))).requires_grad_()
    opt = torch.optim.Adam([theta], lr=0.05)

    losses = []
    for it in range(steps):
        opt.zero_grad()
        y = tp.nfft_fastsum(x_probe, torch.nn.functional.softplus(theta), src, cutoff=m,
                            device=dev)
        loss = torch.mean((y - y_probe) ** 2)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if it % 40 == 0:
            print(f"iter {it:3d}  mse {losses[-1]:.3e}")

    learned = torch.nn.functional.softplus(theta.detach())

    # evaluation: held-out matvecs against the true operator
    x_test = torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32)).to(dev)
    y_true = tp.nfft_fastsum(x_test, true_coeffs, src, cutoff=m, device=dev)
    y_learn = tp.nfft_fastsum(x_test, learned, src, cutoff=m, device=dev)
    op_err = rel_l2(y_learn, y_true)
    coeff_err = rel_l2(learned.to(true_coeffs.dtype), true_coeffs)
    print(f"held-out operator rel-L2 error: {op_err:.3e}")
    print(f"spectral coefficient rel-L2 error: {coeff_err:.3e}")
    assert op_err < 3e-2, "learned operator should match held-out matvecs"
    return dict(op_err=op_err, coeff_err=coeff_err, first_loss=losses[0],
                final_loss=losses[-1])


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=2000)
    ap.add_argument("steps", nargs="?", type=int, default=200)
    ap.add_argument("--device", default=None, help="'cpu' for the plain PyTorch path")
    a = ap.parse_args()
    main(a.n, a.steps, a.device)
