"""Batched one-dimensional FFTs over strided lines: cuFFT plans of the
port's own on the card, ``torch.fft`` on the CPU.

``torch.fft`` hands cuFFT a view without a copy only where every axis but
the transformed ones merges into one batch stride, and ``irfft`` always
copies its input, which cuFFT's C2R overwrites. The band-pruned
half-spectrum stages (``ops/fft.py``) transform lines that no such view
holds (one axis's lines whose other frequencies lie in the band), and
write each pass's output already laid out for the next pass's lines. So a
pass is described as cuFFT's advanced data layout describes it, one
arithmetic progression of lines:

    element x of source line b at  src_off + b * idist + x * istride,
    element k of output line b at  dst_off + b * odist + k * ostride,

in elements of each array's dtype from each tensor's first element, and
:func:`lines_fft` runs it: ``"r2c"`` (exp(-2 pi i x k / n), n reals to
n // 2 + 1 complex), ``"c2r"`` (the unnormalised inverse, n // 2 + 1
complex to n reals; the imaginary parts of the k = 0 and k = n / 2 terms
are not read) and ``"c2c"`` (the forward, or with ``inverse`` the
unnormalised inverse).

On the card a pass is one ``cufftExec*`` call on a plan made by
``cufftMakePlanMany64`` for exactly that layout, cached per device and
layout, with its work area from PyTorch's allocator and on the current
stream; the C2R may overwrite its source. The library is the shared cuFFT
that PyTorch loaded (a build with cuFFT linked statically cannot run these
stages on the card, and says so). On the CPU the same layout is read and written through
``torch.as_strided`` views around ``torch.fft``, so the CPU tests reach
every offset and stride the card is given.
"""

from __future__ import annotations

import collections
import ctypes
import os
import threading

import torch

__all__ = ["lines_fft"]

_KINDS = {  # kind -> (source complex, output complex)
    "r2c": (False, True),
    "c2r": (True, False),
    "c2c": (True, True),
}
# cufftType by (kind, double precision)
_CUFFT_TYPE = {("r2c", False): 0x2A, ("c2r", False): 0x2C, ("c2c", False): 0x29,
               ("r2c", True): 0x6A, ("c2r", True): 0x6C, ("c2c", True): 0x69}
_EXEC = {0x2A: "cufftExecR2C", 0x2C: "cufftExecC2R", 0x29: "cufftExecC2C",
         0x6A: "cufftExecD2Z", 0x6C: "cufftExecZ2D", 0x69: "cufftExecZ2Z"}
_FORWARD, _INVERSE = -1, 1
_PLANS_MAX = 64


def _check_layout(t: torch.Tensor, off: int, lines: int, length: int, dist: int,
                  stride: int, what: str) -> None:
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if min(off, dist, stride) < 0:
        raise ValueError(f"{what}: negative offset or stride")
    last = off + (lines - 1) * dist + (length - 1) * stride
    if last >= t.numel():
        raise ValueError(f"{what}: the lines reach element {last} of {t.numel()}")


def lines_fft(kind: str, src: torch.Tensor, src_off: int, dst: torch.Tensor, dst_off: int,
              n: int, lines: int, istride: int, idist: int, ostride: int, odist: int,
              inverse: bool = False) -> None:
    """Transform ``lines`` lines of n points from ``src`` into ``dst`` (see
    the module note for the layout). ``src`` and ``dst`` are contiguous
    buffers on one device; a ``"c2r"`` on the card may overwrite ``src``."""
    src_complex, dst_complex = _KINDS[kind]
    if src.is_complex() != src_complex or dst.is_complex() != dst_complex:
        raise ValueError(f"{kind}: source {src.dtype}, output {dst.dtype}")
    real = src.real.dtype if src_complex else src.dtype
    if real not in (torch.float32, torch.float64) or \
            (dst.real.dtype if dst_complex else dst.dtype) != real:
        raise ValueError(f"{kind}: source {src.dtype}, output {dst.dtype}")
    if src.device != dst.device:
        raise ValueError(f"source on {src.device}, output on {dst.device}")
    if lines == 0:
        return
    half = n // 2 + 1
    _check_layout(src, src_off, lines, half if kind == "c2r" else n, idist, istride, "source")
    _check_layout(dst, dst_off, lines, half if kind == "r2c" else n, odist, ostride, "output")
    if src.device.type == "cuda":
        _run_cuda(kind, real == torch.float64, src, src_off, dst, dst_off, n, lines,
                  istride, idist, ostride, odist, inverse)
        return
    s = torch.as_strided(src, (lines, half if kind == "c2r" else n), (idist, istride),
                         src.storage_offset() + src_off)
    if kind == "r2c":
        out = torch.fft.rfft(s, dim=-1)
    elif kind == "c2r":
        out = torch.fft.irfft(s, n=n, dim=-1, norm="forward")
    else:
        out = torch.fft.ifft(s, dim=-1, norm="forward") if inverse else torch.fft.fft(s, dim=-1)
    torch.as_strided(dst, out.shape, (odist, ostride), dst.storage_offset() + dst_off).copy_(out)


# ---------------------------------------------------------------------------
# cuFFT through ctypes
# ---------------------------------------------------------------------------


class _Cufft:
    """The loaded cuFFT library and this process's plans."""

    def __init__(self):
        self.lib = None
        self.lock = threading.Lock()
        self.plans = collections.OrderedDict()  # key -> (handle, work bytes)


_STATE = _Cufft()


def _loaded_paths() -> list:
    """The shared cuFFT libraries this process has mapped."""
    paths = []
    with open("/proc/self/maps") as f:
        for line in f:
            path = line.split()[-1]
            if "/libcufft.so" in path and path not in paths:
                paths.append(path)
    return paths


def _torch_cufft(paths: list) -> str | None:
    """Of the mapped cuFFT libraries, PyTorch's: the one beside its own
    libraries or in the ``nvidia/cufft`` package its wheels load, else the
    only one mapped; None where that leaves none or several."""
    torch_dir = os.path.dirname(os.path.realpath(torch.__file__))
    for where in (os.path.join(torch_dir, "lib"),
                  os.path.join(os.path.dirname(torch_dir), "nvidia", "cufft")):
        for path in paths:
            if os.path.realpath(path).startswith(where + os.sep):
                return path
    return paths[0] if len(paths) == 1 else None


def _library() -> ctypes.CDLL:
    if _STATE.lib is not None:
        return _STATE.lib
    if not _loaded_paths():  # PyTorch loads cuFFT at its first transform
        torch.fft.fft(torch.zeros(8, dtype=torch.complex64, device="cuda"))
    paths = _loaded_paths()
    path = _torch_cufft(paths)
    if path is None:
        raise RuntimeError(
            "the band-pruned spectral stages call the shared cuFFT library (libcufft.so) "
            "that PyTorch loads; " + (f"several are mapped ({', '.join(paths)}), none of them "
                                      "beside PyTorch's libraries" if paths else
                                      "this PyTorch build has mapped none (cuFFT linked "
                                      "statically?)"))
    lib = ctypes.CDLL(path)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    llp = ctypes.POINTER(ll)
    sigs = {
        "cufftCreate": [ctypes.POINTER(i)],
        "cufftDestroy": [i],
        "cufftSetAutoAllocation": [i, i],
        "cufftMakePlanMany64": [i, i, llp, llp, ll, ll, llp, ll, ll, i, ll,
                                ctypes.POINTER(ctypes.c_size_t)],
        "cufftSetStream": [i, p],
        "cufftSetWorkArea": [i, p],
        "cufftExecC2C": [i, p, p, i], "cufftExecZ2Z": [i, p, p, i],
        "cufftExecR2C": [i, p, p], "cufftExecD2Z": [i, p, p],
        "cufftExecC2R": [i, p, p], "cufftExecZ2D": [i, p, p],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    _STATE.lib = lib
    return lib


def _ok(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} failed: cufftResult {code}")


def _plan(lib, key: tuple) -> tuple:
    """The plan of ``key`` (made and cached on first use, on the current
    device): (handle, work bytes)."""
    hit = _STATE.plans.get(key)
    if hit is not None:
        _STATE.plans.move_to_end(key)
        return hit
    device, ctype, n, lines, istride, idist, ostride, odist = key
    if len(_STATE.plans) >= _PLANS_MAX:
        old, (old_handle, _) = _STATE.plans.popitem(last=False)
        torch.cuda.synchronize(old[0])  # no transform queued on its device still reads it
        _ok(lib.cufftDestroy(old_handle), "cufftDestroy")
    handle = ctypes.c_int()
    _ok(lib.cufftCreate(ctypes.byref(handle)), "cufftCreate")
    _ok(lib.cufftSetAutoAllocation(handle, 0), "cufftSetAutoAllocation")
    dims = (ctypes.c_longlong * 1)(n)
    work = ctypes.c_size_t()
    _ok(lib.cufftMakePlanMany64(handle, 1, dims, dims, istride, idist, dims, ostride, odist,
                                ctype, lines, ctypes.byref(work)),
        f"cufftMakePlanMany64 (type {ctype:#x}, n={n}, {lines} lines)")
    _STATE.plans[key] = hit = (handle.value, work.value)
    return hit


def _run_cuda(kind, double, src, src_off, dst, dst_off, n, lines, istride, idist, ostride,
              odist, inverse) -> None:
    lib = _library()
    ctype = _CUFFT_TYPE[kind, double]
    src_ptr = src.data_ptr() + src_off * src.element_size()
    dst_ptr = dst.data_ptr() + dst_off * dst.element_size()
    if kind == "r2c" and src_ptr % (2 * src.element_size()):
        raise ValueError("cuFFT's R2C reads reals aligned as complex values")
    device = src.device.index
    stream = torch.cuda.current_stream(src.device).cuda_stream
    with _STATE.lock, torch.cuda.device(device):
        handle, work_bytes = _plan(lib, (device, ctype, n, lines, istride, idist, ostride,
                                         odist))
        work = torch.empty(work_bytes, dtype=torch.uint8, device=src.device)
        _ok(lib.cufftSetStream(handle, stream), "cufftSetStream")
        _ok(lib.cufftSetWorkArea(handle, work.data_ptr() if work_bytes else None),
            "cufftSetWorkArea")
        args = (handle, src_ptr, dst_ptr)
        if kind == "c2c":
            args += (_INVERSE if inverse else _FORWARD,)
        _ok(getattr(lib, _EXEC[ctype])(*args), _EXEC[ctype])
