"""System under test of the ``gram`` configurations: the Gram matvec
``G @ x`` of ``GaussianKernel(kernel_sigma, dim, bandwidth, cutoff)`` on
the cell's points (sources = targets), as a solver calls it.

Set-up builds the kernel's coefficients, the operator and its host plan
(``plan_s``: host clock to a synchronised operator with its plan); each
call is one ``G @ x`` (``GramMatrix.__matmul__``), x (n, columns).
"""

from __future__ import annotations

import time

import torch


class GramSystem:
    def __init__(self, program, config: dict, inputs, device):
        self.device = torch.device(device)
        _sync(self.device)
        t0 = time.perf_counter()
        kernel = program.GaussianKernel(config["kernel_sigma"], dim=int(config["dim"]),
                                        bandwidth=int(config["bandwidth"]),
                                        cutoff=int(config["cutoff"]), device=self.device)
        self.G = kernel(inputs.points)
        plans = getattr(self.G, "_plans", None)
        if plans is not None:  # the operator plans at its first matvec otherwise
            plans()
        _sync(self.device)
        self.plan_s = time.perf_counter() - t0 if plans is not None else None

    def call(self, values: dict) -> dict:
        return {"y": self.G @ values["x"]}

    def spans(self) -> dict:
        """The spans recorded since the last call: none."""
        return {}

    def close(self) -> None:
        self.G = None


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(program, config: dict, traffic: dict, inputs, device, record: bool = False):
    if traffic["call"] != "matvec":
        raise ValueError(f"the gram system has no call {traffic['call']!r}")
    return GramSystem(program, config, inputs, device)
