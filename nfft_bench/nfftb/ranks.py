"""Ranks 1.. of a cell that takes several cards: one process a card.

Rank 0 is the harness's own process, on ``device`` (``cuda:0``).
:class:`Ranks` starts ranks 1..world-1 with multiprocessing's ``spawn``
context, rank r on ``cuda:r``, and joins every rank in one process group
(NCCL between cards, gloo where the cell runs on the CPU) through a TCP
rendezvous on localhost at a free port, with a timeout of ``TIMEOUT_S``.
Each spawned rank imports the port from the checkout, loads the cell's
system module from its file (``systems/<system>.py``) and runs its
``serve(program, rank, world, config, traffic, device)``, which returns
when rank 0 tells it to end.

How a run ends when a rank does not:

- a spawned rank that raises prints its traceback and its peak memory and
  exits 1; rank 0's watcher thread then stops the other ranks and ends the
  harness with exit code 1, printing no result;
- a spawned rank whose parent is gone exits at once;
- a collective that hangs ends at the process group's timeout, where the
  backend's watchdog aborts the process.

The spawned ranks are daemons, so the harness's exit, whatever its cause,
terminates them: no process outlives the run on any card.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import socket
import sys
import threading
import time
import traceback

TIMEOUT_S = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init(rank: int, world: int, port: int, device) -> None:
    """Join the process group of the cell's ranks."""
    import torch
    import torch.distributed as dist

    dist.init_process_group("nccl" if torch.device(device).type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))


def peak_gib(device) -> float | None:
    import torch

    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**30


class Ranks:
    """Ranks 1..world-1 of ``system``, spawned and joined to rank 0 here."""

    def __init__(self, system: str, world: int, config: dict, traffic: dict, device):
        import torch

        self.closing = False
        kind = torch.device(device).type
        port = free_port()
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=rank_main, name=f"rank {r}", daemon=True,
                                  args=(r, world, port, system, config, traffic, kind))
                      for r in range(1, world)]
        for p in self.procs:
            p.start()
        threading.Thread(target=self._watch, daemon=True).start()
        init(0, world, port, device)

    def _watch(self) -> None:
        while not self.closing:
            dead = [p for p in self.procs if p.exitcode is not None]
            if dead and not self.closing:
                print(f"nfft_bench: {dead[0].name} ended with exit code {dead[0].exitcode} "
                      f"during the run; stopping the others", file=sys.stderr, flush=True)
                self._stop()
                os._exit(1)
            time.sleep(0.2)

    def _stop(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.terminate()
        for p in self.procs:
            p.join(10)
            if p.is_alive():
                p.kill()

    def close(self) -> None:
        """Leave the process group together with the ranks that were told
        to end (NCCL's teardown waits for every rank), wait for them, and
        stop any that do not end."""
        import torch.distributed as dist

        self.closing = True
        if dist.is_initialized():
            dist.barrier()
            dist.destroy_process_group()
        deadline = time.monotonic() + TIMEOUT_S
        for p in self.procs:
            p.join(max(0.1, deadline - time.monotonic()))
        late = [p.name for p in self.procs if p.is_alive()]
        self._stop()
        codes = [p.exitcode for p in self.procs]
        if late or any(c != 0 for c in codes):
            raise RuntimeError(f"ranks ended badly: exit codes {codes}, stopped {late}")


def _orphan_watch(parent: int) -> None:
    while os.getppid() == parent:
        time.sleep(0.5)
    os._exit(1)


def rank_main(rank: int, world: int, port: int, system: str, config: dict, traffic: dict,
              kind: str) -> None:
    """A spawned rank: join the group, serve the cell's system, leave."""
    threading.Thread(target=_orphan_watch, args=(os.getppid(),), daemon=True).start()
    import torch
    import torch.distributed as dist

    from nfftb import guard, spec

    device = torch.device("cuda", rank) if kind == "cuda" else torch.device("cpu")
    try:
        if kind == "cuda":
            torch.cuda.set_device(device)
        init(rank, world, port, device)
        program = guard.import_program(spec.checkout_root())
        spec.module(spec.BENCH_DIR, "systems", system).serve(program, rank, world, config,
                                                             traffic, device)
        print(f"nfft_bench: rank {rank} peak memory {peak_gib(device)} GiB", file=sys.stderr,
              flush=True)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        print(f"nfft_bench: rank {rank} failed; peak memory {peak_gib(device)} GiB",
              file=sys.stderr, flush=True)
        os._exit(1)
