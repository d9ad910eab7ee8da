"""Grid-sharded 3D adjoint at a large bandwidth, on the PyTorch port.

Port of examples/grid_sharded_large.py (same data, seeds, defaults and
assertion). At N = 512 (oversampled grid M = 1024) the planar oversampled
grid alone is 2 x 1024^3 x 4 B = 8 GiB and the dense tile array about 2x
more. ``build_grid_sharded_layout`` and ``nfft_adjoint_grid_sharded`` cut
the grid into axis-0 slabs, one a rank (spread, ring shift of the halo,
pruned DFT of the slab, one all-reduce of the spectrum). 32 sampled
frequencies of the output are held against the exact float64 sum.

The ranks are processes of ``torch.distributed``: a world of one runs in
this process; more ranks are spawned by ``torch.multiprocessing``, on NCCL
where each has a card of its own and on gloo otherwise (the CPU, or ranks
sharing one card). Runs on the CUDA card; ``--device cpu`` runs the plain
PyTorch path.

Usage: python examples_torch/grid_sharded_large.py [N] [n_points_log2] [world] [--device cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
import torch.distributed as dist

from torch_nfft_tpu_torch.parallel import (
    build_grid_sharded_layout,
    make_mesh,
    nfft_adjoint_grid_sharded,
)

if __package__:
    from . import _world
else:
    import _world

dim, m = 3, 4


def adjoint(rank, world, init, device, backend, N, logn):
    """One rank: the layout of every slab's plan and the grid-sharded
    adjoint; returns the 32 sampled frequencies, the exact sums and the
    readings."""
    dev = _world.device_of(rank, device, backend)
    _world.join(rank, world, init, backend)
    try:
        mesh = make_mesh({"grid": world}, device_type=dev.type)
        n = 1 << logn
        M = 2 * N
        if rank == 0:
            print(f"N={N} M={M}: full planar grid {2 * M**3 * 4 / 2**30:.2f} GiB "
                  f"(+ ~2x dense tiles); per slab 1/{world}th of that", flush=True)
        rng = np.random.default_rng(5)
        pos = (rng.random((n, dim)).astype(np.float32) - 0.5) / 2.0
        x = torch.from_numpy(rng.standard_normal((n, 1)).astype(np.float32)).to(dev)

        t0 = time.perf_counter()
        lay = build_grid_sharded_layout(pos, n_shards=world, N=N, m=m, device=dev)
        layout_s = time.perf_counter() - t0
        if rank == 0:
            print(f"layout+plans: {layout_s:.1f}s (T={lay.T}, A0_loc={lay.A0_loc})",
                  flush=True)

        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        yr, yi = nfft_adjoint_grid_sharded(x, lay, mesh)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        adjoint_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
        if rank == 0:
            print(f"grid-sharded adjoint: {adjoint_s:.1f}s out={tuple(yr.shape)}", flush=True)

        # sampled-frequency check against the exact float64 sum
        k = rng.integers(-(N // 2), N // 2, size=(32, dim))
        idx = (0,) + tuple(torch.from_numpy(k[:, d] + N // 2) for d in range(dim)) + (0,)
        got = torch.complex(yr[idx].double(), yi[idx].double()).cpu()
        kT = torch.from_numpy(k.astype(np.float64).T).to(dev)
        ref = torch.zeros(32, dtype=torch.complex128, device=dev)
        for lo in range(0, n, 1 << 20):
            p = torch.from_numpy(pos[lo:lo + (1 << 20)]).to(dev).double()
            w = x[lo:lo + (1 << 20), 0].double()
            ref += torch.exp(2j * np.pi * (p @ kT)).T @ w.to(torch.complex128)
        ref = ref.cpu()
        return dict(got=got, ref=ref, layout_s=layout_s, adjoint_s=adjoint_s, peak=peak,
                    T=lay.T, NT=lay.NT)
    finally:
        dist.destroy_process_group()


def main(N=512, logn=20, world=1, device=None) -> dict:
    """The grid-sharded adjoint on ``world`` slabs, held to rel-L2 1e-3 at
    32 sampled frequencies; returns the readings (``peak``: bytes allocated
    on rank 0's card at most during the adjoint, None on the CPU)."""
    backend = _world.pick_backend(device, world)
    out = _world.run_world(adjoint, world, (device, backend, N, logn))
    rel = float(torch.linalg.vector_norm(out["got"] - out["ref"])
                / torch.linalg.vector_norm(out["ref"]))
    print(f"rel_l2 (32 sampled freqs vs f64 oracle): {rel:.3e}", flush=True)
    assert rel < 1e-3, rel
    print("ok", flush=True)
    return dict(out, rel=rel, backend=backend)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("N", nargs="?", type=int, default=512)
    ap.add_argument("logn", nargs="?", type=int, default=20)
    ap.add_argument("world", nargs="?", type=int, default=1)
    ap.add_argument("--device", default=None, help="'cpu' for the plain PyTorch path")
    a = ap.parse_args()
    main(a.N, a.logn, a.world, a.device)
