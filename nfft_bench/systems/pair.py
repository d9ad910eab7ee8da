"""System under test of the ``pair`` configurations: the adjoint+forward
pair ``nfft_pair_planar`` on one plan, and its training step.

Set-up builds the plan on the device (``build_plan_device``; ``plan_s``:
host clock to a synchronised plan). Calls, by the traffic's ``call``:

- ``pair``: z = nfft_pair_planar(x, pos), x (n, columns);
- ``step``: L = <nfft_pair_planar(x, pos), w>, then ``L.backward()``:
  x.grad and pos.grad (x and pos leaves that require grad, the plan
  built once from pos.detach()). With ``record``, CUDA events around
  ``backward()`` give the span ``backward_ms``.
"""

from __future__ import annotations

import time

import torch


class PairSystem:
    def __init__(self, program, config: dict, traffic: dict, inputs, device, record: bool):
        self.tp = program
        self.device = torch.device(device)
        self.kind = traffic["call"]
        self.kw = dict(batch_size=1, N=int(config["bandwidth"]), m=int(config["cutoff"]),
                       sigma=float(config["oversampling"]), window=config["window"],
                       strategy="binned", device=self.device)
        _sync(self.device)
        t0 = time.perf_counter()
        self.plan = program.build_plan_device(
            inputs.points, None, N=self.kw["N"], m=self.kw["m"], sigma=self.kw["sigma"],
            batch_size=1, window=self.kw["window"], device=self.device)
        _sync(self.device)
        self.plan_s = time.perf_counter() - t0
        self.pos = inputs.points
        if self.kind == "step":
            self.pos = inputs.points.detach().clone().requires_grad_(True)
            for values in inputs.pool:
                values["x"].requires_grad_(True)
        self.record = record
        self.events = []

    def pair(self, x, pos):
        return self.tp.nfft_pair_planar(x, pos, None, self.plan, **self.kw)

    def call(self, values: dict) -> dict:
        if self.kind == "pair":
            return {"y": self.pair(values["x"], self.pos)}
        x = values["x"]
        x.grad = self.pos.grad = None
        loss = (self.pair(x, self.pos) * values["w"]).sum()
        if self.record:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        loss.backward()
        if self.record:
            ev[1].record()
            self.events.append(ev)
        return {"xgrad": x.grad, "posgrad": self.pos.grad}

    def spans(self) -> dict:
        """The spans recorded since the last call of this method."""
        if not self.events:
            return {}
        _sync(self.device)
        out = {"backward_ms": [a.elapsed_time(b) for a, b in self.events]}
        self.events = []
        return out

    def close(self) -> None:
        self.plan = None
        self.events = []


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(program, config: dict, traffic: dict, inputs, device, record: bool = False):
    if traffic["call"] not in ("pair", "step"):
        raise ValueError(f"the pair system has no call {traffic['call']!r}")
    return PairSystem(program, config, traffic, inputs, device,
                      record and torch.device(device).type == "cuda")
