"""System under test of the ``batched`` configurations: the adjoint+forward
pair of a batched point set, streamed one member at a time
(``nfft_pair_streamed``).

The members are the configuration's ``member_counts``: the cell's points
in order, member i taking the next ``member_counts[i]`` of them (a sorted
batch vector). Set-up builds the streamed layout on the device
(``make_streamed_layout``: the points split into members, one plan each;
``plan_s``: host clock to a synchronised layout). Each call is
z = nfft_pair_streamed(x, layout), x (n, columns) in the flat layout.

A program without ``nfft_pair_streamed`` cannot run the cell: the build
raises at once.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def batch_vector(config: dict) -> np.ndarray:
    """The sorted batch vector of the configuration's members."""
    counts = np.asarray(config["member_counts"], dtype=np.int64)
    if counts.size != int(config["batch_size"]) or int(counts.sum()) != 1 << int(config["n_log2"]):
        raise ValueError("member_counts must give batch_size members of 2^n_log2 points")
    return np.repeat(np.arange(counts.size, dtype=np.int32), counts)


class BatchedSystem:
    def __init__(self, program, config: dict, inputs, device):
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

    def call(self, values: dict) -> dict:
        return {"y": self.pair(values["x"], self.layout)}

    def spans(self) -> dict:
        """The spans recorded since the last call: none."""
        return {}

    def close(self) -> None:
        self.layout = None


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(program, config: dict, traffic: dict, inputs, device, record: bool = False):
    if traffic["call"] != "pair_streamed":
        raise ValueError(f"the batched system has no call {traffic['call']!r}")
    if not hasattr(program, "nfft_pair_streamed"):
        raise AttributeError(f"{program.__name__} has no nfft_pair_streamed")
    return BatchedSystem(program, config, inputs, device)
