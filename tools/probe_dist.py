"""Probe what torch.distributed does with one CUDA card (card only).

    python3 tools/probe_dist.py

Prints, for one NCCL rank and for four gloo ranks sharing ``cuda:0``:
whether ``init_device_mesh("cuda", ...)`` accepts the world, which device
each rank lands on and which backend its axis groups get; which collectives
take card tensors (``all_reduce``, ``all_gather_into_tensor``,
``batch_isend_irecv``, a ring of one sending to itself); and the gloo
all-reduce time of a host tensor of 2^27 floats (a 512^3 grid). Every world
has a 120 s process-group timeout and a joined deadline.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import socket
import sys
import time

import torch
import torch.distributed as dist


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def attempt(rank: int, what: str, fn) -> None:
    try:
        out = fn()
        print(f"[rank {rank}] {what}: ok {'' if out is None else out}", flush=True)
    except Exception as e:  # the probe reports what each call does
        print(f"[rank {rank}] {what}: FAILED {type(e).__name__}: {str(e)[:300]}", flush=True)


def ring(t: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    P, r = dist.get_world_size(group), dist.get_rank(group)
    out = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t, dist.get_global_rank(group, (r + shift) % P), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (r - shift) % P), group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return out


def worker(rank: int, world: int, backend: str, port: int) -> None:
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    from torch.distributed.device_mesh import init_device_mesh

    mesh = None

    def make():
        nonlocal mesh
        mesh = init_device_mesh("cuda", (1, world), mesh_dim_names=("data", "points"))
        return (f"device now cuda:{torch.cuda.current_device()}, points group backend "
                f"{dist.get_backend(mesh.get_group('points'))}, local rank "
                f"{mesh.get_local_rank('points')}")

    attempt(rank, f"{backend} init_device_mesh('cuda', (1, {world}))", make)
    group = mesh.get_group("points") if mesh is not None else dist.group.WORLD
    dev = torch.device("cuda", 0)
    t = torch.full((4,), float(rank + 1), device=dev)

    def all_reduce():
        u = t.clone()
        dist.all_reduce(u, group=group)
        return u.tolist()

    def all_gather():
        out = torch.empty((world * 4,), device=dev)
        dist.all_gather_into_tensor(out, t, group=group)
        return out.tolist()

    def all_gather_list():
        outs = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(outs, t, group=group)
        return [o[0].item() for o in outs]

    attempt(rank, f"{backend} all_reduce of a card tensor", all_reduce)
    attempt(rank, f"{backend} all_gather_into_tensor of card tensors", all_gather)
    attempt(rank, f"{backend} all_gather (list) of card tensors", all_gather_list)
    attempt(rank, f"{backend} ring shift (batch_isend_irecv) of a card tensor",
            lambda: ring(t, group).tolist())
    attempt(rank, f"{backend} ring shift of a host tensor",
            lambda: ring(t.cpu(), group).tolist())
    if backend == "gloo":
        big = torch.ones(1 << 27)
        dist.all_reduce(big, group=group)  # warm
        dist.barrier()
        t0 = time.perf_counter()
        dist.all_reduce(big, group=group)
        dt = time.perf_counter() - t0
        print(f"[rank {rank}] gloo all_reduce of 2^27 host floats (512 MB), {world} ranks: "
              f"{dt:.3f} s", flush=True)
    dist.barrier()
    dist.destroy_process_group()


def run(world: int, backend: str) -> int:
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=worker, args=(r, world, backend, port)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 180
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    bad = 0
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(10)
            bad += 1
        elif p.exitcode != 0:
            bad += 1
    print(f"world {world} {backend}: {'ok' if not bad else f'{bad} rank(s) failed'}", flush=True)
    return bad


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_dist: no CUDA device", file=sys.stderr)
        return 2
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]} {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()} nccl {dist.is_nccl_available()} gloo "
          f"{dist.is_gloo_available()}", flush=True)
    bad = run(1, "nccl") + run(4, "gloo")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
