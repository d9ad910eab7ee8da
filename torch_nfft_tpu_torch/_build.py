"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` for sm_90a (one ``nvcc -c`` per source,
all started together), then links the objects into one shared library with
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

from . import trace

__all__ = ["NVCC_FLAGS", "LINK_FLAGS", "BuildResult", "build", "library", "check"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ("-shared", "-gencode", "arch=compute_90a,code=sm_90a")

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int64
_U = ctypes.c_uint32
_FUNCTIONS = {
    # (pointers, S, K, C, NT, dim, H, M, m, kind, window floats, device, stream)
    "tnt_spread_tiles_dense": [_P] * 6 + [_I] * 9 + [_F] * 3 + [_I, _P],
    # (pointers, S, K, C, dim, H, M, m, kind, window floats, device, stream)
    "tnt_spread_tiles": [_P] * 5 + [_I] * 8 + [_F] * 3 + [_I, _P],
    # ... window floats, layout (int array, ops/contract.py:SpreadDesign), device, stream
    "tnt_spread_tiles_dense_contract": [_P] * 6 + [_I] * 9 + [_F] * 3 + [_P, _I, _P],
    "tnt_spread_tiles_contract": [_P] * 5 + [_I] * 8 + [_F] * 3 + [_P, _I, _P],
    "tnt_spread_tiles_dense_tensor": [_P] * 6 + [_I] * 9 + [_F] * 3 + [_P, _I, _P],
    "tnt_spread_tiles_tensor": [_P] * 5 + [_I] * 8 + [_F] * 3 + [_P, _I, _P],
    # ... window floats, layout (int array, ops/contract.py:PointsLayout), device, stream
    "tnt_gather_points": [_P] * 6 + [_I] * 9 + [_F] * 3 + [_P, _I, _P],
    # p0, p1, p2 and the derivative factor, layout, device, stream
    "tnt_pos_grad": [_P] * 7 + [_I] * 9 + [_F] * 4 + [_P, _I, _P],
    # stream, row_start, row_count, out, ld, L, S, K, C, R, K's divisor, device, stream
    "tnt_expand_rows": [_P] * 4 + [_L] * 2 + [_I] * 4 + [_U, _I, _I, _P],
    # padded, row_start, row_count, out, 3 strides, size, n, S, K, C, layout,
    # R, K's and C's divisors, device, stream
    "tnt_compact_rows": [_P] * 4 + [_L] * 5 + [_I] * 5 + [_U, _I, _U, _I, _I, _P],
    # v, bits, n, C, q, j0, j1, reverse, tile_log2, device, stream
    "tnt_benes_outer": [_P] * 2 + [_L] + [_I] * 7 + [_P],
    # v, bits, n, C, q, s, reverse, device, stream
    "tnt_benes_local": [_P] * 2 + [_L] + [_I] * 5 + [_P],
    # keys, vals, n, b, device, stream
    "tnt_bitonic_local_sort": [_P] * 2 + [_L] + [_I] * 2 + [_P],
    # keys, vals, n, jj, d_hi, d_lo, tile_log2, device, stream
    "tnt_bitonic_cross_round": [_P] * 2 + [_L] + [_I] * 5 + [_P],
    # keys, vals, n, jj, b, device, stream
    "tnt_bitonic_local_merge": [_P] * 2 + [_L] + [_I] * 3 + [_P],
    # tiles in, grid out, B, C, dim, M, T, H, nb, T's divisor, device, stream
    "tnt_fold_tiles": [_P] * 2 + [_I] * 7 + [_U, _I, _I, _P],
    # grid in, tiles out, B, C, dim, M, T, H, nb, the grid's 5 strides,
    # H's divisor, device, stream
    "tnt_unfold_grid": [_P] * 2 + [_I] * 7 + [_L] * 5 + [_U, _I, _I, _P],
    # tiles in, slab out, C, dim, M, T, H, nb, axis 0's tiles, T's divisor,
    # device, stream
    "tnt_fold_slab": [_P] * 2 + [_I] * 7 + [_U, _I, _I, _P],
    # slab and halo in, tiles out, C, dim, M, T, H, nb, axis 0's tiles, the
    # slab's 4 strides, the halo's 2, H's divisor, device, stream
    "tnt_unfold_slab": [_P] * 3 + [_I] * 7 + [_L] * 6 + [_U, _I, _I, _P],
}


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


def output_path(build_dir: Path, stem: str, flags, files) -> Path:
    """``build_dir/<stem>_<hash>.so``, the hash over the flags and the
    files' names and contents: an edited source or flag builds anew."""
    h = hashlib.sha256(" ".join(flags).encode())
    for p in files:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return build_dir / f"{stem}_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def build() -> BuildResult:
    """Compile the kernels once per source hash; returns where they are."""
    sources = _sources()
    out = output_path(BUILD_DIR, "libtnt_kernels", NVCC_FLAGS + LINK_FLAGS,
                      sources + sorted(CSRC.glob("*.cuh")))
    if out.exists():
        return BuildResult(out, 0.0, "")
    BUILD_DIR.mkdir(exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for c in cmds]
        logs = [p.communicate(timeout=900)[0] for p in procs]
        cmds.append([nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)])
        link = subprocess.run(cmds[-1], capture_output=True, text=True, timeout=900)
        logs.append(link.stdout + link.stderr)
        codes = [p.returncode for p in procs] + [link.returncode]
        log = "".join(logs)
        bad = [i for i, c in enumerate(codes) if c != 0]
        if bad:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({codes[bad[0]]}):\n"
                               f"{' '.join(cmds[bad[0]])}\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
        trace.count_build()
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return BuildResult(out, time.perf_counter() - t0, log)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (span ``kernel
    library``)."""
    with trace.span("kernel library"):
        lib = ctypes.CDLL(str(build().path))
    for name, argtypes in _FUNCTIONS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tnt_error_string.argtypes = [ctypes.c_int]
    lib.tnt_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int) -> None:
    """Raise if a C launcher returned a CUDA error."""
    if code != 0:
        msg = library().tnt_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel launch failed: {msg} (cudaError {code})")
