"""The band-pruned half-spectrum stages against the whole-grid ones on one
CUDA card, and cuFFT's time for one pass in each line layout.

    python tools/spectral_stages.py [--reps 5] [--skip-slab] [--out readings.json]

At each geometry the benchmark's cells run (a streamed member: 3D N = 256,
M = 512, C = 2; the headline pair: M = 416, C = 1 and 8; the Gram matvec:
M = 512, C = 1 and 8; a slab of the grid-sharded pair: 2D N = 1024,
M = 2048 over 512 rows), it prints the adjoint and the forward stage of
``ops/fft.py`` (``spectral_adjoint_half``, ``spectral_forward_half``) and
of the whole-grid formulation they replaced (``tests/_torch_port.py``:
``rfftn`` of the whole grid, cropped to the half spectrum; the half
spectrum embedded in a zeroed M x ... x (M // 2 + 1) array, ``irfftn``): CUDA-event ms a call (three calls
back to back, median of ``--reps``), the peak of each above what it was
handed, and the largest difference as a share of the largest entry (at
most 1e-6). At the member's geometry, the slab's and at 1024 points it
also times one C2C pass over the same lines in four layouts (lines
contiguous or side by side, in and out) and the R2C and the C2R in and out
of the turned layouts (``ops/fft.py:TURN_KERNEL_ABOVE`` rests on these),
and at the member and the slab lists the kernels one pruned round trip
launches (``torch.profiler``). ``--out`` writes the readings as JSON.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]  # the checkout's port and test helpers
from _torch_port import whole_adjoint, whole_forward  # noqa: E402

from torch_nfft_tpu_torch.ops import fft as pfft  # noqa: E402
from torch_nfft_tpu_torch.ops.cufft import lines_fft  # noqa: E402

# name, dim, N, M, leading shape, m, sigma, window
GEOMETRIES = (
    ("member C=2", 3, 256, 512, (1, 2), 4, 2.0, "gaussian"),
    ("headline C=1", 3, 256, 416, (1, 1), 2, 1.625, "es"),
    ("headline C=8", 3, 256, 416, (1, 8), 2, 1.625, "es"),
    ("Gram C=1", 3, 256, 512, (1, 1), 4, 2.0, "gaussian"),
    ("Gram C=8", 3, 256, 512, (1, 8), 4, 2.0, "gaussian"),
    ("slab", 2, 1024, 2048, (1, 1, 512), 4, 2.0, "gaussian"),
)


def time_ms(fn, reps: int, calls: int = 3) -> float:
    """Median over ``reps`` of the CUDA-event ms a call of ``calls`` calls
    run back to back (the host ahead of the card, as in a loop)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / calls)
    return sorted(out)[len(out) // 2]


def peak_gb(fn) -> float:
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def share(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


def geometry(name, dim, N, M, lead, m, sigma, window, reps) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    g = torch.randn(lead + (M,) * dim, device=dev, generator=gen)
    phi = pfft._phi_half(dim, N, m, sigma, window, dev)
    adj = {"pruned": lambda: pfft.spectral_adjoint_half(g, dim, N, m, sigma, window),
           "whole": lambda: whole_adjoint(g, dim, N, phi)}
    before = dict(pfft.spectral_lines)
    H = adj["pruned"]()
    run = pfft.spectral_lines["run"] - before["run"]
    skipped = pfft.spectral_lines["skipped"] - before["skipped"]
    H_ref = adj["whole"]()
    res = {"adjoint_share": share(H, H_ref), "lines_run": run, "lines_skipped": skipped}
    del H_ref
    fwd = {"pruned": lambda: pfft.spectral_forward_half(H, dim, N, M, m, sigma, window),
           "whole": lambda: whole_forward(H, dim, N, M, phi)}
    res["forward_share"] = share(fwd["pruned"](), fwd["whole"]())
    for stage, fns in (("adjoint", adj), ("forward", fwd)):
        for kind, fn in fns.items():
            res[f"{stage}_{kind}_ms"] = time_ms(fn, reps)
            res[f"{stage}_{kind}_peak_gb"] = peak_gb(fn)
    del g, H
    torch.cuda.empty_cache()
    print(f"{name} ({dim}D N={N} M={M} lead {lead}): adjoint pruned "
          f"{res['adjoint_pruned_ms']:.3f} ms (peak {res['adjoint_pruned_peak_gb']:.3f} GB), "
          f"whole {res['adjoint_whole_ms']:.3f} ms ({res['adjoint_whole_peak_gb']:.3f} GB); "
          f"forward pruned {res['forward_pruned_ms']:.3f} ms "
          f"({res['forward_pruned_peak_gb']:.3f} GB), whole {res['forward_whole_ms']:.3f} ms "
          f"({res['forward_whole_peak_gb']:.3f} GB); differences "
          f"{res['adjoint_share']:.2e} / {res['forward_share']:.2e} of the largest entry; "
          f"C2C lines run {run}, skipped {skipped} ({skipped / (run + skipped):.2%})",
          flush=True)
    assert res["adjoint_share"] <= 1e-6 and res["forward_share"] <= 1e-6, res
    return res


def layouts(M: int, P: int, R: int, reps: int) -> dict:
    """One C2C pass of n = M over P lines, and an R2C and a C2R over R, in
    each layout."""
    dev = torch.device("cuda")
    a = torch.randn(P * M, dtype=torch.complex64, device=dev)
    b = torch.empty_like(a)
    c2c = {
        "contiguous in, contiguous out": (1, M, 1, M),
        "contiguous in, side by side out (adjoint)": (1, M, P, 1),
        "side by side in, contiguous out (forward)": (P, 1, 1, M),
        "side by side in and out": (P, 1, P, 1),
    }
    res = {}
    for label, (i_s, i_d, o_s, o_d) in c2c.items():
        res[label] = time_ms(lambda: lines_fft("c2c", a, 0, b, 0, M, P, i_s, i_d, o_s, o_d),
                             reps)
    del a, b
    g = torch.randn(R * M, device=dev)
    A = torch.empty(R * (M // 2 + 1), dtype=torch.complex64, device=dev)
    res["r2c contiguous out"] = time_ms(lambda: lines_fft("r2c", g, 0, A, 0, M, R, 1, M, 1,
                                                          M // 2 + 1), reps)
    res["r2c side by side out (adjoint)"] = time_ms(
        lambda: lines_fft("r2c", g, 0, A, 0, M, R, 1, M, R, 1), reps)
    res["c2r contiguous in"] = time_ms(lambda: lines_fft("c2r", A, 0, g, 0, M, R, 1,
                                                         M // 2 + 1, 1, M), reps)
    res["c2r side by side in (forward)"] = time_ms(
        lambda: lines_fft("c2r", A, 0, g, 0, M, R, R, 1, 1, M), reps)
    print(f"layouts, n = {M}, {P} C2C lines, {R} R2C lines (ms, CUDA events): "
          + "; ".join(f"{k} {v:.3f}" for k, v in res.items()), flush=True)
    return res


def kernels(dim, N, M, lead) -> list:
    """The kernels of one pruned round trip, by device time."""
    dev = torch.device("cuda")
    g = torch.randn(lead + (M,) * dim, device=dev)

    def trip():
        H = pfft.spectral_adjoint_half(g, dim, N, 4, 2.0, "gaussian")
        return pfft.spectral_forward_half(H, dim, N, M, 4, 2.0, "gaussian")

    trip()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        trip()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if t and e.key and not e.key.startswith(("cuda", "aten::", "Activity")):
            rows.append((e.key, e.count, t / 1e3))
    rows.sort(key=lambda r: -r[2])
    print(f"one pruned round trip, {dim}D N={N} M={M} lead {lead}, device ms by kernel:")
    for key, count, ms in rows[:20]:
        print(f"  {ms:8.3f} ms  x{count:<3d} {key[:110]}")
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--skip-slab", action="store_true")
    ap.add_argument("--out", type=Path, help="write the readings here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"torch {torch.__version__} CUDA {torch.version.cuda}; {card.strip()}", flush=True)
    out = {"card": card.strip(), "layouts": {"member": layouts(512, 129 * 2 * 512,
                                                              2 * 512 * 512, args.reps)}}
    out["layouts"]["1024 points"] = layouts(1024, 257 * 2 * 1024, 2 * 128 * 1024, args.reps)
    if not args.skip_slab:
        out["layouts"]["slab"] = layouts(2048, 513 * 512, 512 * 2048, args.reps)
    out["kernels"] = {"member": kernels(3, 256, 512, (1, 2))}
    if not args.skip_slab:
        out["kernels"]["slab"] = kernels(2, 1024, 2048, (1, 1, 512))
    out["geometries"] = {}
    for geo in GEOMETRIES:
        if args.skip_slab and geo[0] == "slab":
            continue
        out["geometries"][geo[0]] = geometry(*geo, reps=args.reps)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
