"""Save a :class:`BinnedPlan` to a file and load it back.

Counterpart of the JAX package's ``ops/plan_io.py``, in the same ``.npz``
format, so that a plan file written by either package loads in the other:
the six plan tensors under their field names, the host builder's ``order``
and ``row_start`` when the plan has them, the routed Benes bits
(``benes_bits``, the router's per-pair words) when it has Benes tables, and
a JSON header ``__meta__`` with the format version and the static fields
(``active``, ``pos_fp`` and ``S_occ`` among them).

A loaded plan skips the host build and, with Benes tables, the routing:
the tables are rebuilt from the saved bits on the plan's device. The JAX
package also stores a block size ``b`` with the bits, which lays out its TPU
kernels' masks; the CUDA kernels read the bits as they are, so this module
writes JAX's default (``min(q, 18)``) for JAX to read and ignores it when
reading.
"""

from __future__ import annotations

import json

import numpy as np

from .._device import resolve_device
from ..convert import PLAN_ARRAYS, plan_from_numpy
from .benes import tables_from_pair_bits
from .binned import BinnedPlan, _count_row_groups

__all__ = ["save_plan", "load_plan"]

# version 2: the (n,) inv_slot array of version 1 became the (S*K,)
# fill_keys permutation (its head is inv_slot, its tail the empty slots)
_FORMAT_VERSION = 2
_HOST_FIELDS = ("order", "row_start")
# the JAX package's default Benes block (ops/pallas/benes.py:DEFAULT_BLOCK_LOG2)
_JAX_BLOCK_LOG2 = 18


def save_plan(path, plan: BinnedPlan) -> None:
    """Write ``plan`` to ``path`` (a ``.npz`` file name or a file object),
    its tensors copied to the host."""
    if not isinstance(plan, BinnedPlan):
        raise TypeError(f"save_plan expects a BinnedPlan, got {type(plan)!r}")
    meta = {
        "format_version": _FORMAT_VERSION,
        "n": plan.n, "dim": plan.dim, "N": plan.N, "m": plan.m, "sigma": plan.sigma,
        "T": plan.T, "K": plan.K, "batch_size": plan.batch_size, "pos_fp": plan.pos_fp,
        "window": plan.window, "active": plan.active, "S_occ": plan.S_occ,
    }
    arrays = {name: getattr(plan, name).cpu().numpy() for name in PLAN_ARRAYS}
    for name in _HOST_FIELDS:
        val = getattr(plan, name)
        if val is not None:
            arrays[name] = np.asarray(val)
    bt = plan.benes
    if bt is not None and bt.pair_bits is not None:
        arrays["benes_bits"] = np.asarray(bt.pair_bits)
        meta["benes"] = {"n": bt.n, "b": min(bt.q, _JAX_BLOCK_LOG2),
                         "compact": bool(bt.compact)}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_plan(path, *, device=None) -> BinnedPlan:
    """The plan saved in ``path`` by either package, on ``device`` (the card
    unless ``device="cpu"``). It keeps the saved bin-id fingerprint, so the
    entry points still refuse it for a point set that bins otherwise.
    Reads format versions 1 and 2; anything else raises ``ValueError``."""
    dev = resolve_device(device)
    with np.load(path) as data:
        if "__meta__" not in data:
            raise ValueError(f"{path!r} is not a torch_nfft_tpu plan file")
        meta = json.loads(bytes(data["__meta__"].tobytes()).decode("utf-8"))
        version = meta.get("format_version")
        if version not in (1, _FORMAT_VERSION):
            raise ValueError(
                f"Unsupported plan format version {version!r} (expected "
                f"{_FORMAT_VERSION}); re-save the plan with this version of the package")
        raw = {name: np.asarray(data[name]) for name in data.files if name != "__meta__"}
    if version == 1:
        # inv_slot (n,) -> fill_keys: append the empty slots' ids in order
        S, K = raw["slot_pt"].shape
        empty = (np.arange(K)[None, :] >= raw["row_count"][:, None]).reshape(-1)
        raw["fill_keys"] = np.concatenate([raw.pop("inv_slot").astype(np.int32),
                                           np.flatnonzero(empty).astype(np.int32)])
    S_occ = meta.get("S_occ")
    if S_occ is None:  # files from before S_occ: count it from the row tables
        S_occ = _count_row_groups(raw["origin"], raw["row_batch"], raw["row_count"])
    plan = plan_from_numpy(
        {name: raw[name] for name in PLAN_ARRAYS},
        n=meta["n"], dim=meta["dim"], N=meta["N"], m=meta["m"], sigma=meta["sigma"],
        T=meta["T"], K=meta["K"], batch_size=meta["batch_size"], window=meta["window"],
        active=meta["active"], pos_fp=meta["pos_fp"], S_occ=S_occ, device=dev,
        **{name: raw.get(name) for name in _HOST_FIELDS})
    if "benes_bits" in raw:
        bmeta = meta["benes"]
        plan.benes = tables_from_pair_bits(raw["benes_bits"], int(bmeta["n"]),
                                           compact=bool(bmeta.get("compact", False)),
                                           device=dev)
    return plan
