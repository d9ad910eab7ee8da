"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` for sm_90a into one shared library with
a plain C interface, at first CUDA use, into ``torch_nfft_tpu_torch/_build/``
(named by a hash of the sources and flags, so an edited source rebuilds).
``ctypes`` loads it: pointers and the stream pass as ``c_void_p``. The C
functions return the ``cudaError_t`` of their launch, and :func:`check`
raises on anything but 0. No PyTorch headers are compiled, which keeps the
build to seconds; a build or launch failure is an error, never a fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

__all__ = ["NVCC_FLAGS", "BuildResult", "build", "library", "check"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (pointers x6, S, K, C, NT, dim, H, M, m, kind, p0, p1, p2, device, stream)
_KERNEL_ARGTYPES = [_P] * 6 + [_I] * 9 + [_F] * 3 + [_I, _P]
_FUNCTIONS = ("tnt_spread_tiles_dense", "tnt_gather_points")


@dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output, with the -Xptxas -v register/shared-memory lines


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


@functools.lru_cache(maxsize=None)
def build() -> BuildResult:
    """Compile the kernels once per source hash; returns where they are."""
    sources = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / f"libtnt_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return BuildResult(out, 0.0, "")
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    return BuildResult(out, seconds, log)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build().path))
    for name in _FUNCTIONS:
        fn = getattr(lib, name)
        fn.argtypes = _KERNEL_ARGTYPES
        fn.restype = ctypes.c_int
    lib.tnt_error_string.argtypes = [ctypes.c_int]
    lib.tnt_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int) -> None:
    """Raise if a C launcher returned a CUDA error."""
    if code != 0:
        msg = library().tnt_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel launch failed: {msg} (cudaError {code})")
