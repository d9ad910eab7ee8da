"""Ranks of ``torch.distributed`` for the multi-rank demos.

``run_world`` runs ``fn(rank, world, init, *args)`` on ``world`` ranks and
returns rank 0's result: in this process for a world of one, else in
processes spawned by ``torch.multiprocessing``, with a ``file://``
rendezvous in a fresh directory, a process-group timeout and a joined
deadline. ``join`` makes
this rank's process group (NCCL, or gloo) and ``device_of`` the device a
rank computes on: the CPU, its own card under NCCL, or the current card
that gloo ranks share.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_nfft_tpu_torch as tp

TIMEOUT_S = 120


def pick_backend(device, world: int) -> str:
    """NCCL where every rank has a card of its own, gloo otherwise (the
    CPU, or ranks sharing one card)."""
    dev = tp.resolve_device(device)
    return "nccl" if dev.type == "cuda" and torch.cuda.device_count() >= world else "gloo"


def device_of(rank: int, device, backend: str) -> torch.device:
    dev = tp.resolve_device(device)
    if dev.type == "cuda":
        dev = tp.resolve_device(f"cuda:{rank}" if backend == "nccl" else dev)
        torch.cuda.set_device(dev)
    return dev


def join(rank: int, world: int, init: str, backend: str) -> None:
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


def run_world(fn, world: int, args: tuple, deadline_s: float = 600.0):
    """``fn(rank, world, init, *args)`` on every rank; returns rank 0's
    result. A rank that raises, dies or outlives the deadline raises here."""
    rdv = tempfile.mkdtemp(prefix="tnt_world_")
    init = f"file://{os.path.join(rdv, 'rendezvous')}"
    out = os.path.join(rdv, "rank0.pt")
    try:
        if world == 1:
            return fn(0, 1, init, *args)
        ctx = mp.start_processes(_rank, args=(fn, world, init, args, out), nprocs=world,
                                 join=False, start_method="spawn")
        end = time.monotonic() + deadline_s
        while not ctx.join(timeout=1.0):
            if time.monotonic() > end:
                for p in ctx.processes:
                    p.terminate()
                raise TimeoutError(f"the {world} ranks outlived {deadline_s:.0f} s")
        return torch.load(out, weights_only=False)
    finally:
        shutil.rmtree(rdv, ignore_errors=True)


def _rank(rank: int, fn, world: int, init: str, args: tuple, out: str) -> None:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))  # the ranks share the host
    result = fn(rank, world, init, *args)
    if rank == 0:
        torch.save(result, out)
