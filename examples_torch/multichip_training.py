"""Sharded kernel-regression training over a mesh of ranks, on the PyTorch
port.

Port of examples/multichip_training.py (same data, seeds, defaults and
assertion): the distributed training step (fastsum forward, MSE loss,
gradients through the all-reduce of the grid, Adam update) of
``parallel.make_fastsum_train_step`` with ``torch.optim.Adam(lr=0.02)`` on
a (data 2 x points P) mesh of ``world`` ranks. The ranks are processes of
``torch.distributed``, spawned by ``torch.multiprocessing``: NCCL where each
rank has a card of its own, gloo otherwise (on the CPU, or ranks sharing
one card, which checks the multi-process path but measures no multi-GPU
transport). At 2 x 256 points a rank the step runs the plan-free matmul
engine (the ``"auto"`` rule), as in the JAX package.

Usage: python examples_torch/multichip_training.py [world] [--device cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
import torch.distributed as dist

import torch_nfft_tpu_torch as tp
from torch_nfft_tpu_torch.parallel import make_fastsum_train_step, make_mesh

if __package__:
    from . import _world
else:
    import _world

B, n, dim, N, m, C = 4, 512, 2, 16, 4, 1


def train(rank, world, init, device, backend, steps, rank_report):
    """One rank: the mesh, the step and ``steps`` Adam steps; returns the
    losses (the same on every rank) and ``rank_report()`` if given."""
    dev = _world.device_of(rank, device, backend)
    _world.join(rank, world, init, backend)
    try:
        mesh = make_mesh({"data": 2, "points": -1}, device_type=dev.type)
        if rank == 0:
            print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} over {world} ranks "
                  f"({backend}, {dev})", flush=True)
        rng = np.random.default_rng(0)
        coeffs = tp.gaussian_analytic_coeffs(0.3, dim=dim, N=N, device=dev)
        pos = (rng.random((B, n, dim)) - 0.5).astype(np.float32) / 4
        # target: values of a smooth function at the points
        y = np.sin(6 * pos[..., :1].sum(-1, keepdims=True)).astype(np.float32)

        step, shard = make_fastsum_train_step(
            mesh, coeffs, batch_size=B, n_per_set=n, cutoff=m,
            optimizer=torch.optim.Adam, optimizer_kwargs=dict(lr=0.02))
        w = shard(torch.zeros((B, n, C)))
        pos_l, y_l = shard(pos), shard(y)
        state = step.init(w)
        losses = []
        t0 = time.perf_counter()
        for i in range(steps):
            w, loss, state = step(w, pos_l, y_l, state)
            losses.append(float(loss))
            if rank == 0 and i % 10 == 0:
                print(f"step {i:3d}  loss {losses[-1]:.5f}", flush=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out = dict(losses=losses, steps_s=time.perf_counter() - t0)
        if rank_report is not None:
            out["report"] = rank_report()
        return out
    finally:
        dist.destroy_process_group()


def main(world=4, steps=80, device=None, rank_report=None) -> dict:
    """Train on ``world`` ranks and hold the final loss under 0.05 times the
    first; returns the losses, the seconds and the backend.
    ``rank_report``: a function (importable by module path) whose result
    on rank 0 after the steps is returned under ``"report"``."""
    backend = _world.pick_backend(device, world)
    t0 = time.perf_counter()
    out = _world.run_world(train, world, (device, backend, steps, rank_report))
    first, final = out["losses"][0], out["losses"][-1]
    print(f"final loss {final:.5f} (from {first:.5f})")
    assert final < 0.05 * first
    print("ok")
    return dict(out, first=first, final=final, backend=backend,
                seconds=time.perf_counter() - t0)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("world", nargs="?", type=int, default=4)
    ap.add_argument("--device", default=None, help="'cpu' for gloo ranks on the CPU")
    a = ap.parse_args()
    main(a.world, device=a.device)
