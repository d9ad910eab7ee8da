"""System under test of the ``batched_step`` configurations: the training
step over a batched point set, streamed one member at a time
(``nfft_pair_streamed`` with ``pos=``).

Set-up builds the streamed layout on the device as ``systems/batched.py``
does (``make_streamed_layout``, the members the configuration's
``member_counts``; ``plan_s``: host clock to a synchronised layout) and
makes ``pos`` (the cell's points) and every pool entry's ``x`` leaves that
require grad. Each call is L = <nfft_pair_streamed(x, layout, pos=pos), w>,
then ``L.backward()``, and returns x.grad and pos.grad in the flat layout.
With ``record``, CUDA events around ``backward()`` give the span
``backward_ms``.

A program whose ``nfft_pair_streamed`` takes no ``pos`` cannot run the
cell: the build raises at once.
"""

from __future__ import annotations

import inspect
import time

import torch

from nfftb import spec

batch_vector = spec.module(spec.BENCH_DIR, "systems", "batched").batch_vector


class BatchedStepSystem:
    def __init__(self, program, config: dict, inputs, device, record: bool):
        self.pair = program.nfft_pair_streamed
        self.device = torch.device(device)
        batch = batch_vector(config)
        _sync(self.device)
        t0 = time.perf_counter()
        self.layout = program.make_streamed_layout(
            inputs.points, batch, batch_size=int(config["batch_size"]),
            N=int(config["bandwidth"]), m=int(config["cutoff"]),
            sigma=float(config["oversampling"]), window=config["window"], device=self.device)
        _sync(self.device)
        self.plan_s = time.perf_counter() - t0
        self.pos = inputs.points.detach().clone().requires_grad_(True)
        for values in inputs.pool:
            values["x"].requires_grad_(True)
        self.record = record
        self.events = []

    def call(self, values: dict) -> dict:
        x = values["x"]
        x.grad = self.pos.grad = None
        loss = (self.pair(x, self.layout, pos=self.pos) * values["w"]).sum()
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
        self.layout = None
        self.events = []


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(program, config: dict, traffic: dict, inputs, device, record: bool = False):
    if traffic["call"] != "step_streamed":
        raise ValueError(f"the batched step system has no call {traffic['call']!r}")
    pair = getattr(program, "nfft_pair_streamed", None)
    if pair is None or "pos" not in inspect.signature(pair).parameters:
        raise TypeError(f"{program.__name__}.nfft_pair_streamed takes no pos: the streamed "
                        "pair is not differentiable in the positions")
    return BatchedStepSystem(program, config, inputs, device,
                             record and torch.device(device).type == "cuda")
