"""Build and load the port's host C++ code: the plan builder and the Benes
router.

``g++`` compiles ``csrc/plan_builder.cpp`` and ``csrc/benes_router.cpp``
(copies of the JAX package's sources, kept unchanged so both packages plan
and route alike) into one shared library with a plain C interface, at
first use, into ``torch_nfft_tpu_torch/_build/`` (named by a hash of the
sources and flags, so an edited source rebuilds). ``ctypes`` loads it. A
failed build raises: the NumPy plan builder (``ops/binned.py``) and the
NumPy router (``ops/benes.py:route_benes_np``) are reference versions for
the tests and for tiny networks, not fallbacks.

``plan_tables`` and ``benes_route`` keep the signatures of the JAX
package's ``native.py``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np

from . import trace
from ._build import BUILD_DIR, CSRC, output_path

__all__ = ["CXX_FLAGS", "build_native", "native_library", "plan_tables", "benes_route"]

SOURCES = ("plan_builder.cpp", "benes_router.cpp")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
_FUNCTIONS = {
    # pos, batch, n, dim, M, m, T, nb, K, num_bins, bin_of_point, counts
    "nfft_plan_count": ([_P, _P, _I64] + [_I32] * 6 + [_I64, _P, _P], _I64),
    # bin_of_point, counts, n, dim, T, nb, K, num_bins, S, 8 output tables
    "nfft_plan_fill": ([_P, _P, _I64] + [_I32] * 4 + [_I64, _I64] + [_P] * 8, _I32),
    # perm, n, out_bits, n_threads
    "nfft_benes_route": ([_P, _I64, _P, _I32], _I32),
}


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found (set CXX or put g++ on PATH); the "
                           "host plan builder and Benes router need it")
    return cxx


@functools.lru_cache(maxsize=None)
def build_native() -> tuple[Path, float]:
    """Compile the host library once per source hash; returns its path and
    the build seconds (0.0 when it was already built)."""
    srcs = [CSRC / s for s in SOURCES]
    out = output_path(BUILD_DIR, "libtnt_host", CXX_FLAGS, srcs)
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    trace.count_build()
    return out, seconds


@functools.lru_cache(maxsize=None)
def native_library() -> ctypes.CDLL:
    """The loaded host library, built first if needed (span ``host library``)."""
    with trace.span("host library"):
        lib = ctypes.CDLL(str(build_native()[0]))
    for name, (argtypes, restype) in _FUNCTIONS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def _ptr(a) -> int | None:
    return None if a is None else a.ctypes.data


def plan_tables(pos, batch, M, m, T, nb, K, batch_size, pick_K=None):
    """Two-pass counting-sort plan construction. Returns ((slot_pt,
    slot_valid, origin, row_batch, inv_slot, order, row_start, row_count),
    K). ``pos`` is (n, dim) float32, ``batch`` (n,) int32 or None. When K is
    None, ``pick_K(counts)`` chooses the row capacity from the per-bin
    counts after the counting pass."""
    lib = native_library()
    pos = np.ascontiguousarray(pos, dtype=np.float32)
    n, dim = pos.shape
    num_bins = int(batch_size) * nb**dim
    if batch is not None:
        batch = np.ascontiguousarray(batch, dtype=np.int32)
    bin_of_point = np.empty(n, np.int64)
    counts = np.empty(num_bins, np.int64)
    S = lib.nfft_plan_count(_ptr(pos), _ptr(batch), n, dim, M, m, T, nb,
                            1 if K is None else int(K), num_bins,
                            _ptr(bin_of_point), _ptr(counts))
    if S < 0:
        raise ValueError("a point's bin lies outside the bin range (batch id "
                         "outside [0, batch_size)?)")
    if K is None:
        K = int(pick_K(counts))
        S = int(np.sum(-(-counts // K)))
    tables = (
        np.empty((S, K), np.int32),  # slot_pt
        np.empty((S, K), np.float32),  # slot_valid
        np.empty((S, dim), np.int32),  # origin
        np.empty(S, np.int32),  # row_batch
        np.empty(n, np.int32),  # inv_slot
        np.empty(n, np.int32),  # order
        np.empty(S, np.int32),  # row_start
        np.empty(S, np.int32),  # row_count
    )
    rc = lib.nfft_plan_fill(_ptr(bin_of_point), _ptr(counts), n, dim, T, nb,
                            int(K), num_bins, S, *map(_ptr, tables))
    if rc != 0:
        raise RuntimeError(f"nfft_plan_fill failed ({rc})")
    return tables, int(K)


def benes_route(perm, n_threads: int | None = None) -> np.ndarray:
    """Route ``perm`` (a permutation of [0, 2^q), 2^q >= 64) through the
    Benes network: the per-pair swap bits as a (2q-1, n/64) uint32 array,
    bit p & 31 of word p >> 5 being pair p of that stage."""
    perm = np.ascontiguousarray(perm, dtype=np.int32)
    n = perm.shape[0]
    q = int(n).bit_length() - 1
    if (1 << q) != n or n < 64:
        raise ValueError(f"benes_route needs a power-of-two length >= 64, got {n}")
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    out = np.zeros((2 * q - 1, n // 64), np.uint32)
    rc = native_library().nfft_benes_route(_ptr(perm), n, _ptr(out), int(n_threads))
    if rc != 0:
        raise RuntimeError(f"nfft_benes_route failed ({rc})")
    return out
