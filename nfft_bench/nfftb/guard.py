"""What the benchmark may load: the port from its checkout, and no JAX.

The port's package name, ``torch_nfft_tpu_torch``, begins with the JAX
package's, ``torch_nfft_tpu``, so modules are compared by their whole
top-level name (the part before the first dot).
"""

from __future__ import annotations

import importlib
import sys
from pathlib import Path

PROGRAM = "torch_nfft_tpu_torch"
BANNED = frozenset({"jax", "jaxlib", "flax", "torch_nfft_tpu"})


def banned_modules(names=None) -> list:
    """Loaded modules whose top-level name is banned."""
    names = list(sys.modules) if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in BANNED)


def import_program(root: Path):
    """The port's package from the checkout at ``root``; raises
    ImportError when the checkout does not hold it."""
    root = Path(root).resolve()
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    mod = importlib.import_module(PROGRAM)
    where = Path(mod.__file__).resolve()
    if root not in where.parents:
        raise ImportError(f"{PROGRAM} was loaded from {where}, outside the checkout {root}")
    return mod
