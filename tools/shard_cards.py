"""Phases 11-11d of chip_smoke.py with the four ranks on four cards (NCCL).

    python3 tools/shard_cards.py        # on a machine with four cards

chip_smoke.py runs its four-rank phases on one card over gloo, which
moves tensors through host memory; this runs the same phases (the slab
kernels, the world of one on card 0, then phases 11c-11d) with rank r on
``cuda:r`` and NCCL between the cards, against the same references.
Prints each phase, the card's name and power limit, and exits non-zero if
a check fails.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from torch_nfft_tpu_torch import _build, _native  # noqa: E402


def main() -> int:
    if torch.cuda.device_count() < cs.SHARD_P:
        print(f"shard_cards: needs {cs.SHARD_P} cards, found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    _build.build()
    _native.build_native()
    print(f"build {time.perf_counter() - t0:.1f} s; {cs.nvidia_smi_line()}; "
          f"{torch.cuda.device_count()} cards", flush=True)
    report = [{"name": k, "max_abs_err": 0.0} for k in cs.KERNELS]
    cs.shard_phases(cs.tp.resolve_device("cuda:0"), report, dict(ranks="cards"))
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
