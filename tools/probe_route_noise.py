"""Run-to-run spread of the training-step gradients on one CUDA card.

    python tools/probe_route_noise.py [--reps 30] [--T 8]

Repeats the training step of ``tests/test_torch_cuda.py::
test_benes_training_step_launches_every_kernel`` (3D N=16, n=40000, es
m=2, sigma=1.625, the loss sum(pair(x, pos)), the same seeded inputs) and
prints, over ``--reps`` repetitions, the rel-L2 of x.grad and pos.grad
between the Benes route and the sort route, and between two runs of the
sort route, with the number of repetitions over each of several limits,
and the spread design that ran. The plan bins the points as the test's
does (T = 16, whose tiles take the spread's wide-tile design, whose float
atomics reorder its sums on every run) or, with ``--T 8``, in the
headline's tiles (the contraction design, which sums in slot order). The
second comparison is the floor any limit on the first must clear.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the checkout's port
import torch_nfft_tpu_torch as tp  # noqa: E402
from torch_nfft_tpu_torch.ops import contract  # noqa: E402

LIMITS = (1e-6, 2e-6, 3e-6)


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm((a - b).double()) / torch.linalg.vector_norm(b.double()))


def grads(plan, x, pos):
    xl = x.clone().requires_grad_()
    pl = pos.clone().requires_grad_()
    z = tp.nfft_pair_planar(xl, pl, None, plan, batch_size=1, N=16, m=2, sigma=1.625,
                            window="es")
    z.sum().backward()
    return xl.grad, pl.grad


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--T", type=int, default=None, help="tile edge (default: the builder's)")
    args = ap.parse_args()
    reps = args.reps
    if not torch.cuda.is_available():
        raise SystemExit("probe_route_noise: needs a CUDA card")
    dev = tp.resolve_device(None)
    rng = np.random.default_rng(1234)  # the test's fixture
    n = 40000
    pos = (rng.random((n, 3), dtype=np.float32) - 0.5)
    pos /= 4 * np.abs(pos).max()
    plan_b = tp.build_plan(pos, N=16, m=2, sigma=1.625, window="es",
                           T=args.T).with_benes_tables()
    plan_s = dataclasses.replace(plan_b, benes=None)
    x = torch.from_numpy(rng.standard_normal((n, 1)).astype(np.float32)).to(dev)
    p = torch.from_numpy(pos).to(dev)
    before = dict(contract.spread_tiles_dense.launches_by_design)
    grads(plan_s, x, p)
    design = [k for k, v in contract.spread_tiles_dense.launches_by_design.items()
              if v > before[k]]
    print(f"T={plan_s.T} H={plan_s.H}: the spread ran the {design} design", flush=True)
    out = {"T": plan_s.T, "spread_design": design}
    for label, first, second in (("benes_vs_sort", plan_b, plan_s),
                                 ("sort_vs_sort", plan_s, plan_s)):
        rx, rp = [], []
        for _ in range(reps):
            gx1, gp1 = grads(first, x, p)
            gx2, gp2 = grads(second, x, p)
            rx.append(rel(gx1, gx2))
            rp.append(rel(gp1, gp2))
        out[label] = {
            "x_grad": [min(rx), max(rx)], "pos_grad": [min(rp), max(rp)],
            "x_over": {f"{t:g}": sum(r > t for r in rx) for t in LIMITS},
            "pos_over": {f"{t:g}": sum(r > t for r in rp) for t in LIMITS},
        }
        print(f"{label}: x.grad rel-L2 {min(rx):.3e}..{max(rx):.3e}, pos.grad "
              f"{min(rp):.3e}..{max(rp):.3e}; over limits of {reps}: x "
              f"{out[label]['x_over']}, pos {out[label]['pos_over']}", flush=True)
    print(json.dumps({"reps": reps, "device": torch.cuda.get_device_name(0), **out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
