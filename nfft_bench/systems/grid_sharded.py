"""System under test of the ``grid_sharded`` configurations: the port's
grid-sharded adjoint+forward pair on ``shards`` ranks, one card each.

The harness's process is rank 0, on ``device``; set-up spawns ranks
1..shards-1 and joins them in one process group (:mod:`nfftb.ranks`;
NCCL, rank r on ``cuda:r``). Rank 0 broadcasts the global points and the
value pool, and every rank builds the same
``parallel.build_grid_sharded_layout`` of the points (one axis-0 slab a
rank; ``plan_s``: host clock to rank 0's synchronised layout). A call:
rank 0 broadcasts which pool entry to take (or, for values from outside
the pool, the values themselves), and every rank runs

    z, _ = nfft_forward_grid_sharded(*nfft_adjoint_grid_sharded(x, layout, mesh),
                                     layout, mesh, real_output=True)

with the same global x; rank 0 returns {"y": z}, (n, columns) in user
point order. ``close()`` tells the ranks to end and waits for them. Each
rank prints its peak memory when it ends or fails.
"""

from __future__ import annotations

import sys
import time

import torch
import torch.distributed as dist
from nfftb import ranks

END, NEW_VALUES = -1, -2


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Rank:
    """What every rank holds: the points, the pool, the mesh, the layout."""

    def __init__(self, program, config: dict, traffic: dict, world: int, device, inputs=None):
        self.par, self.device = program.parallel, device
        n, dim = 1 << int(config["n_log2"]), int(config["dim"])
        if inputs is None:
            points = torch.empty((n, dim), device=device)
            pool = [{name: torch.empty((n, int(cols)), device=device)
                     for name, cols in traffic["values"].items()}
                    for _ in range(int(traffic["pool"]))]
        else:
            points, pool = inputs.points, inputs.pool
        dist.broadcast(points, 0)
        for values in pool:
            for name in sorted(values):
                dist.broadcast(values[name], 0)
        self.pool = pool
        self.mesh = self.par.make_mesh({"grid": world}, device_type=device.type)
        _sync(device)
        t0 = time.perf_counter()
        self.layout = self.par.build_grid_sharded_layout(
            points, n_shards=world, N=int(config["bandwidth"]), m=int(config["cutoff"]),
            sigma=float(config["oversampling"]), T=int(config["tile"]),
            window=config["window"], device=device)
        _sync(device)
        self.plan_s = time.perf_counter() - t0

    def command(self, k: int | None = None) -> int:
        """Rank 0 sends ``k``; every other rank receives it."""
        t = torch.tensor([0 if k is None else k], dtype=torch.int64, device=self.device)
        dist.broadcast(t, 0)
        return int(t.item()) if k is None else k

    def values(self, k: int, given: dict | None = None) -> dict:
        """Pool entry ``k``; for NEW_VALUES the values rank 0 broadcasts."""
        if k != NEW_VALUES:
            return self.pool[k]
        out = {}
        for name in sorted(self.pool[0]):
            t = given[name].detach().contiguous() if given is not None else \
                torch.empty_like(self.pool[0][name])
            dist.broadcast(t, 0)
            out[name] = t
        return out

    def pair(self, values: dict) -> torch.Tensor:
        yr, yi = self.par.nfft_adjoint_grid_sharded(values["x"], self.layout, self.mesh)
        return self.par.nfft_forward_grid_sharded(yr, yi, self.layout, self.mesh,
                                                  real_output=True)[0]


class GridShardedSystem:
    def __init__(self, program, config: dict, traffic: dict, inputs, device):
        self.device = torch.device(device)
        world = int(config["shards"])
        if self.device.type == "cuda":  # build the kernels once, before the ranks load them
            program._build.library()
        self.ranks = ranks.Ranks("grid_sharded", world, config, traffic, self.device)
        self.rank = _Rank(program, config, traffic, world, self.device, inputs)
        self.plan_s = self.rank.plan_s

    def call(self, values: dict) -> dict:
        k = next((i for i, v in enumerate(self.rank.pool) if v is values), NEW_VALUES)
        self.rank.command(k)
        try:
            return {"y": self.rank.pair(self.rank.values(k, values))}
        except BaseException:
            print(f"nfft_bench: rank 0 failed; peak memory {ranks.peak_gib(self.device)} GiB",
                  file=sys.stderr, flush=True)
            raise

    def spans(self) -> dict:
        """The spans recorded since the last call: none."""
        return {}

    def close(self) -> None:
        if self.rank is not None:
            self.rank.command(END)
            print(f"nfft_bench: rank 0 peak memory {ranks.peak_gib(self.device)} GiB",
                  file=sys.stderr, flush=True)
            self.rank = None
        self.ranks.close()


def serve(program, rank: int, world: int, config: dict, traffic: dict, device) -> None:
    """Ranks 1..: set up as rank 0 does, then run the pair on each pool
    entry rank 0 names, until it sends END."""
    state = _Rank(program, config, traffic, world, device)
    while (k := state.command()) != END:
        state.pair(state.values(k))


def build(program, config: dict, traffic: dict, inputs, device, record: bool = False):
    if traffic["call"] != "pair":
        raise ValueError(f"the grid_sharded system has no call {traffic['call']!r}")
    return GridShardedSystem(program, config, traffic, inputs, device)
