"""Faults planted under the window, to show that the check catches them.

Each wraps a system's ``call`` (what the window drives):

- ``stale``: the call returns the previous call's outputs, as a step
  that leaves its state unchanged would;
- ``half``: half of the points left out of every value array (every
  other row zeroed), the rest doubled so the sums keep their mean;
- ``altered``: every output scaled by 1.01 where it is produced.

The exchange between chips does not exist in a one-card cell.
"""

from __future__ import annotations

KINDS = ("stale", "half", "altered")


class Faulty:
    def __init__(self, system, kind: str):
        if kind not in KINDS:
            raise ValueError(f"unknown fault {kind!r}")
        self.system, self.kind = system, kind
        self.plan_s = system.plan_s
        self.last = None

    def call(self, values: dict) -> dict:
        if self.kind == "half":
            values = {k: _halved(v) for k, v in values.items()}
        out = self.system.call(values)
        if self.kind == "altered":
            return {k: v.detach() * 1.01 for k, v in out.items()}
        if self.kind == "stale":
            prev, self.last = self.last, {k: v.detach().clone() for k, v in out.items()}
            return prev if prev is not None else out
        return out

    def spans(self) -> dict:
        return self.system.spans()

    def close(self) -> None:
        self.system.close()


def _halved(v):
    h = 2 * v.detach()
    h[1::2] = 0
    return h.requires_grad_(v.requires_grad)


def planted(build, kind: str):
    """A system module's ``build`` whose systems carry the fault."""
    def build_faulty(*args, **kwargs):
        return Faulty(build(*args, **kwargs), kind)
    return build_faulty
