"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Builds the CUDA kernels from ``torch_nfft_tpu_torch/csrc`` with nvcc, holds
each kernel against its plain PyTorch version at the headline shapes (the
position-gradient kernel with both of its weightings), runs the NDFT
accuracy gates, then runs the headline adjoint+forward pair (3D, N=256,
n=2^24 points in [-1/4, 1/4)^3, es window, m=2, sigma=1.625) through the
port's public entry points, checks the kernels were launched on that path
and the adjoint at 96 sampled frequencies against the direct sum. Then a
headline training step: forward and backward of L = <pair(x, pos), w> with
gradients for x and all positions, its launches (2 of each kernel) and
x.grad against pair(w) (the pair's operator is symmetric); and the same
loss at a small size on the card against the CPU's plain chain, for
pos.grad. Last it times each kernel with CUDA events, times the pair stage
by stage (the stages ``nfft_pair_planar`` runs) and reads the device's
busy share of three traced pairs and three traced steps with
``torch.profiler``.

Every phase prints its seconds; any failure exits non-zero. The line before
the last is a JSON object listing the kernels with their times and bounds;
the last line is ``{"ok": true, "device": {...}}``. Without a CUDA card it
exits with code 2 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

import torch_nfft_tpu_torch as tp
from torch_nfft_tpu_torch import _build
from torch_nfft_tpu_torch.ops import contract
from torch_nfft_tpu_torch.ops.binned import dense_tile_ids, run_stages, slot_values
from torch_nfft_tpu_torch.ops.planar import pair_stages
from torch_nfft_tpu_torch.ops.tilefold import row_tile_ids, unfold_grid_to_tiles

# headline configuration of the JAX bench (bench.py: BENCH_BENES=0 route)
N_LOG2, N, DIM, M_CUT, SIGMA, WINDOW = 24, 256, 3, 2, 1.625, "es"

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and float32 outside the
# tensor cores; the kernels do float32 arithmetic on the CUDA cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

KERNELS = {
    "spread_tiles_dense": "torch_nfft_tpu/ops/pallas/contract.py:369",
    "gather_points": "torch_nfft_tpu/ops/pallas/contract.py:662",
    "pos_grad": "torch_nfft_tpu/ops/pallas/contract.py:809",
}
SOURCE = "torch_nfft_tpu_torch/csrc/contract.cu"


class Phase:
    """Context manager that prints a phase's seconds after it ends."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            torch.cuda.synchronize()
            print(f"phase {self.name}: {time.perf_counter() - self.t0:.3f} s",
                  flush=True)
        return False


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    wide = torch.complex128 if a.is_complex() or b.is_complex() else torch.float64
    a, b = a.to(wide), b.to(wide)
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def headline_data(n: int, dev, seed: int = 7):
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, DIM), dtype=np.float32) - 0.5) / 2.0
    x = rng.standard_normal((n, 1)).astype(np.float32)
    return torch.from_numpy(pos).to(dev), torch.from_numpy(x).to(dev)


def reset_launches() -> None:
    for name in KERNELS:
        getattr(contract, name).launches = 0


def read_launches() -> dict:
    return {name: getattr(contract, name).launches for name in KERNELS}


def train_step(x, pos, w, plan, *, N: int, device=None):
    """One training step of L = <nfft_pair_planar(x, pos), w>: forward and
    backward, leaving the gradients in x.grad and pos.grad. Returns CUDA
    events recorded before the forward, between forward and backward, and
    after the backward."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    x.grad = pos.grad = None
    events[0].record()
    z = tp.nfft_pair_planar(x, pos, None, plan, batch_size=1, N=N, m=M_CUT,
                            sigma=SIGMA, window=WINDOW, device=device)
    loss = (z * w).sum()
    events[1].record()
    loss.backward()
    events[2].record()
    return events


def gate(dim: int, Ng: int, dev) -> float:
    """rel-L2 of the port's adjoint against its dense NDFT oracle in
    float64, at bench.py's gate configuration (n=400, two columns)."""
    rng = np.random.default_rng(0)
    n = 400
    pos = rng.random((n, dim), dtype=np.float32) - 0.5
    pos /= 4 * np.abs(pos).max()
    x = rng.standard_normal((n, 2)).astype(np.float32)
    yr, yi = tp.nfft_adjoint_planar(x, pos, None, batch_size=1, N=Ng, m=M_CUT,
                                    sigma=SIGMA, window=WINDOW, device=dev)
    got = torch.complex(yr, yi)[0].to(torch.complex128)
    ref = tp.ndft_adjoint(torch.from_numpy(x).double().to(dev),
                          torch.from_numpy(pos).double().to(dev), N=Ng)[0]
    return rel_l2(got, ref)


def sampled_frequency_check(plan, pos, x, dev, n_freq: int = 96) -> float:
    """The headline adjoint at ``n_freq`` random frequencies against the
    direct sum over all points. The phase k.pos splits pos into a part with
    12 fractional bits (k*p_hi is exact in float32 for |k| <= 2^11, and so is
    its reduction mod 1) plus a small remainder, so the angle is good to
    ~1e-7 rad (the method of bench.py:_headline_accuracy)."""
    rng = np.random.default_rng(11)
    k = rng.integers(-(N // 2), N // 2, size=(n_freq, DIM))
    yr, yi = tp.nfft_adjoint_planar(x, pos, None, plan, batch_size=1, N=N,
                                    m=M_CUT, sigma=SIGMA, window=WINDOW,
                                    device=dev)
    idx = (0,) + tuple(torch.as_tensor(k[:, d] + N // 2, device=dev) for d in range(DIM)) + (0,)
    got = torch.complex(yr[idx], yi[idx]).to(torch.complex128)
    kf = torch.as_tensor(k, dtype=torch.float32, device=dev)
    acc_r = torch.zeros(n_freq, dtype=torch.float64, device=dev)
    acc_i = torch.zeros(n_freq, dtype=torch.float64, device=dev)
    chunk = 1 << 21
    for c0 in range(0, pos.shape[0], chunk):
        p = pos[c0:c0 + chunk]
        w = x[c0:c0 + chunk, 0]
        p_hi = torch.round(p * 4096.0) / 4096.0
        p_lo = p - p_hi
        ph_hi = p_hi @ kf.T  # sums of exact products: exact in float32
        ph_lo = p_lo @ kf.T
        ang = 2.0 * np.pi * (ph_hi - torch.floor(ph_hi) + ph_lo)
        acc_r += (w[:, None] * torch.cos(ang)).sum(0, dtype=torch.float64)
        acc_i += (w[:, None] * torch.sin(ang)).sum(0, dtype=torch.float64)
    return rel_l2(got, torch.complex(acc_r, acc_i))


def bounds(plan, C: int, tiles_read: int):
    """(spread, gather, pos_grad) least times in ms and what bounds each:
    the bytes each must move (inputs read once, outputs written once) over
    the HBM rate, against its float32 operations over the float32 peak.
    Counts what this plan's data needs: the values, weights and coordinates
    of the n filled slots (no kernel reads a padded slot), the tiles the
    rows read, and the whole (S, C, K) gather and (S, dim, K) pos_grad
    outputs, whose padded slots they write as zeros."""
    S, K, dim, H, L, n = plan.S, plan.K, plan.dim, plan.H, 2 * plan.m + 2, plan.n
    cells = H**dim
    tables = 4 * S * (2 + dim)  # row_count, tile ids, origins
    coords = 4 * dim * n
    tiles = 4 * tiles_read * C * cells
    # per point: window values (~8 flops each) and 2 flops per cell, channel
    flops = n * (dim * L * 8 + L**dim * 2 * C)
    # pos_grad: window values and derivatives (~12 flops) and, per cell and
    # channel, 2 multiply-adds (the three axes share the innermost sums)
    flops_pg = n * (dim * L * 12 + L**dim * 4 * C)
    work = (
        (4 * C * n + coords + tables + 4 * plan.NT * C * cells, flops),
        (tiles + coords + tables + 4 * C * S * K, flops),
        (tiles + 4 * C * n + coords + tables + 4 * S * dim * K, flops_pg),
    )
    out = []
    for b, f in work:
        t_bytes, t_ops = b / PEAK_BYTES_PER_S * 1e3, f / PEAK_F32_FLOPS * 1e3
        out.append((max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"))
    return out


def stage_ms(stages, x, reps: int = 5) -> np.ndarray:
    """Median ms of each (name, function) stage over ``reps`` runs of the
    stages in order, by CUDA events between them, after a warm-up run."""
    runs = []
    for _ in range(reps + 1):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
        v = x
        events[0].record()
        for i, (_, fn) in enumerate(stages):
            v = fn(v)
            events[i + 1].record()
        torch.cuda.synchronize()
        runs.append([events[i].elapsed_time(events[i + 1]) for i in range(len(stages))])
    return np.median(np.array(runs[1:]), axis=0)


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def device_busy(pair, reps: int = 3):
    """Trace ``reps`` calls of ``pair`` with torch.profiler: returns the
    kernels' summed device ms, the host-clock ms around the calls, and the
    kernels by device time. Only device-side events count: an operator's
    own device time repeats the time of the kernels it launched."""
    pair()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            pair()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    return busy_ms, wall_ms, sorted(kernels, key=_device_us, reverse=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card",
              file=sys.stderr)
        return 2
    dev = tp.resolve_device(None)
    n = 1 << N_LOG2
    t_all = time.perf_counter()

    with Phase("0 device"):
        card = nvidia_smi_line()
        print(card)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
              f"count {torch.cuda.device_count()}", flush=True)

    with Phase("1 build"):
        res = _build.build()
        _build.library()
        print(f"nvcc build: {res.seconds:.2f} s -> {res.path.name}")
        for line in res.log.splitlines():
            if "ptxas" in line and ("registers" in line or "Compiling" in line
                                    or "spill" in line or "smem" in line):
                print("  " + line.strip())

    pos, x = headline_data(n, dev)

    with Phase("2 plan"):
        t0 = time.perf_counter()
        plan = tp.build_plan_device(pos, None, N=N, m=M_CUT, sigma=SIGMA,
                                    batch_size=1, window=WINDOW)
        torch.cuda.synchronize()
        t_plan = time.perf_counter() - t0
        print(f"plan built in {t_plan:.3f} s: rows={plan.S} K={plan.K} "
              f"T={plan.T} H={plan.H} NT={plan.NT} M={plan.M}")

    err = {}
    with Phase("3 kernels vs plain"):
        vals = slot_values(plan, x)
        tid_spread = dense_tile_ids(plan)
        tiles_k = contract.spread_tiles_dense(plan, vals, tid_spread, plan.NT)
        tiles_p = contract.spread_tiles_dense_plain(plan, vals, tid_spread, plan.NT)
        err["spread_tiles_dense"] = (float((tiles_k - tiles_p).abs().max()),
                                     rel_l2(tiles_k, tiles_p))
        del tiles_k, tiles_p
        gen = torch.Generator(device=dev).manual_seed(5)
        grid = torch.randn((1, 1) + (plan.M,) * DIM, device=dev, generator=gen)
        tiles = unfold_grid_to_tiles(grid, plan)
        del grid
        tid = row_tile_ids(plan)
        y_k = contract.gather_points(plan, tiles, tid)
        y_p = contract.gather_points_plain(plan, tiles, tid)
        err["gather_points"] = (float((y_k - y_p).abs().max()), rel_l2(y_k, y_p))
        del y_k, y_p
        # pos_grad, weighted as in the spread's backward (tiles of a grid
        # cotangent, w = the values x) and the gather's (tiles of the
        # pair's primal grid, w = a point cotangent)
        ybar = torch.randn((n, 1), device=dev, generator=gen)
        w_ybar = slot_values(plan, ybar)
        g_primal = run_stages(pair_stages(plan, N=N, m=M_CUT, sigma=SIGMA,
                                          window=WINDOW)[:5], x)
        tiles_primal = unfold_grid_to_tiles(g_primal, plan)
        del g_primal
        errs = []
        for label, tl, wt in (("w=x, cotangent tiles", tiles, vals),
                              ("w=ybar, primal tiles", tiles_primal, w_ybar)):
            d_k = contract.pos_grad(plan, tl, wt, tid)
            d_p = contract.pos_grad_plain(plan, tl, wt, tid)
            errs.append((float((d_k - d_p).abs().max()), rel_l2(d_k, d_p)))
            print(f"pos_grad ({label}): kernel vs plain max_abs={errs[-1][0]:.3e} "
                  f"(max |plain| {float(d_p.abs().max()):.3e}) rel_l2={errs[-1][1]:.3e}")
            del d_k, d_p
        err["pos_grad"] = tuple(map(max, zip(*errs)))  # the worse of the two
        del tiles_primal, w_ybar, ybar
        for name, (mx, rl) in err.items():
            print(f"{name}: kernel vs plain max_abs={mx:.3e} rel_l2={rl:.3e}")
            assert rl <= 1e-5, f"{name} disagrees with its plain version: {rl:.3e}"

    with Phase("4 accuracy gates"):
        g2 = gate(2, 16, dev)
        g3 = gate(3, 32, dev)
        print(f"gate 2D N=16 rel_l2={g2:.3e}; gate 3D N=32 rel_l2={g3:.3e}")
        assert g2 < 1e-3 and g3 < 1e-3, "accuracy gate failed"

    with Phase("5 headline pair"):
        reset_launches()
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            z = tp.nfft_pair_planar(x, pos, None, plan, batch_size=1, N=N,
                                    m=M_CUT, sigma=SIGMA, window=WINDOW)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches_pair = read_launches()
        t_pair = float(np.median(times[1:]))
        print(f"pair s: first {times[0]:.4f}, then {[round(t, 4) for t in times[1:]]}; "
              f"median {t_pair:.4f} s/pair = {n / t_pair / 1e6:.2f} M points/s")
        print(f"launches on the pair path (4 pairs): {launches_pair}")
        assert launches_pair["spread_tiles_dense"] > 0 and launches_pair["gather_points"] > 0, \
            f"a kernel was not launched: {launches_pair}"
        assert tuple(z.shape) == (n, 1) and bool(torch.isfinite(z).all()), "bad pair output"
        rel_h = sampled_frequency_check(plan, pos, x, dev)
        print(f"headline rel_l2 at 96 sampled frequencies: {rel_h:.3e}")
        assert rel_h < 1e-3, "headline accuracy check failed"

    with Phase("5b headline training step"):
        xl = x.clone().requires_grad_()
        pl = pos.clone().requires_grad_()
        w = torch.randn((n, 1), device=dev, generator=gen)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(xl, pl, w, plan, N=N)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        launches = read_launches()
        print(f"launches in one training step: {launches}")
        assert launches == {name: 2 for name in KERNELS}, \
            f"a training step must launch each kernel twice: {launches}"
        times, split = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev = train_step(xl, pl, w, plan, N=N)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            split.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])))
        t_step = float(np.median(times))
        fwd_ms, bwd_ms = np.median(np.array(split), axis=0)
        print(f"training step s: first {t_first:.4f}, then {[round(t, 4) for t in times]}; "
              f"median {t_step:.4f} s/step = {n / t_step / 1e6:.2f} M points/s "
              f"(CUDA events: forward {fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms)")
        zw = tp.nfft_pair_planar(w, pos, None, plan, batch_size=1, N=N, m=M_CUT,
                                 sigma=SIGMA, window=WINDOW)
        rel_x = rel_l2(xl.grad, zw)
        print(f"x.grad vs pair(w): rel_l2={rel_x:.3e}")
        assert rel_x <= 3e-5, f"x.grad disagrees with pair(w): {rel_x:.3e}"
        assert tuple(pl.grad.shape) == (n, DIM) and bool(torch.isfinite(pl.grad).all()), \
            "bad pos.grad"
        print(f"pos.grad: rms {float(pl.grad.square().mean().sqrt()):.4e}, "
              f"max abs {float(pl.grad.abs().max()):.4e}")
        del zw

    with Phase("5c small position gradients, card vs CPU"):
        grads = []
        for d in (dev, torch.device("cpu")):
            ps, xs = headline_data(1 << 14, d, seed=13)
            ws = torch.from_numpy(np.random.default_rng(17).standard_normal(
                (1 << 14, 1)).astype(np.float32)).to(d)
            xs.requires_grad_()
            ps.requires_grad_()
            train_step(xs, ps, ws, None, N=32, device=d)
            grads.append((xs.grad.cpu(), ps.grad.cpu()))
        (card_x, card_p), (cpu_x, cpu_p) = grads
        rel_sx, rel_sp = rel_l2(card_x, cpu_x), rel_l2(card_p, cpu_p)
        print(f"3D N=32 n=2^14: card vs CPU x.grad rel_l2={rel_sx:.3e}, "
              f"pos.grad rel_l2={rel_sp:.3e}")
        assert rel_sx <= 3e-5 and rel_sp <= 3e-5, "card and CPU gradients disagree"

    with Phase("6 kernel timing"):
        C = 1
        tiles_read = int(torch.unique(tid).numel())
        (b_spread, by_spread), (b_gather, by_gather), (b_pg, by_pg) = \
            bounds(plan, C, tiles_read)
        rows = [
            ("spread_tiles_dense",
             lambda: contract.spread_tiles_dense(plan, vals, tid_spread, plan.NT),
             lambda: contract.spread_tiles_dense_plain(plan, vals, tid_spread, plan.NT),
             b_spread, by_spread),
            ("gather_points",
             lambda: contract.gather_points(plan, tiles, tid),
             lambda: contract.gather_points_plain(plan, tiles, tid),
             b_gather, by_gather),
            ("pos_grad",
             lambda: contract.pos_grad(plan, tiles, vals, tid),
             lambda: contract.pos_grad_plain(plan, tiles, vals, tid),
             b_pg, by_pg),
        ]
        report = []
        for name, kern, plain, b_ms, b_by in rows:
            ms = time_ms(kern, 10)
            plain_ms = time_ms(plain, 2)
            print(f"{name}: {ms:.4f} ms (plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
                  f"by {b_by}, {b_ms / ms:.1%} of bound)")
            report.append({
                "name": name, "route": "cuda", "source": SOURCE,
                "replaces": KERNELS[name], "launches": launches[name],
                "launches_pair": launches_pair[name],
                "max_abs_err": err[name][0], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            })

    with Phase("7 stages and device busy share"):
        stages = pair_stages(plan, N=N, m=M_CUT, sigma=SIGMA, window=WINDOW)
        med = stage_ms(stages, x)
        print("headline pair by stage, ms (CUDA events, median of 5):")
        for (name, _), ms in zip(stages, med):
            print(f"  {name:18s} {ms:9.3f} ms  {ms / med.sum():6.1%}")
        print(f"  {'sum':18s} {med.sum():9.3f} ms")
        reps = 3
        busy_ms, wall_ms, kernels = device_busy(
            lambda: tp.nfft_pair_planar(x, pos, None, plan, batch_size=1, N=N,
                                        m=M_CUT, sigma=SIGMA, window=WINDOW), reps)
        if busy_ms == 0.0:
            print("profiler: no device time recorded")
        else:
            print(f"profiler: {reps} pairs in {wall_ms:.3f} ms wall, device busy "
                  f"{busy_ms:.3f} ms = {busy_ms / wall_ms:.1%}")
            for e in kernels[:12]:
                print(f"  {_device_us(e) / 1e3 / reps:9.3f} ms/pair  "
                      f"x{e.count // reps:<4d} {e.key[:90]}")
        busy_ms, wall_ms, kernels = device_busy(
            lambda: train_step(xl, pl, w, plan, N=N), reps)
        if busy_ms > 0.0:
            print(f"profiler: {reps} training steps in {wall_ms:.3f} ms wall, device "
                  f"busy {busy_ms:.3f} ms = {busy_ms / wall_ms:.1%}")
            for e in kernels[:16]:
                print(f"  {_device_us(e) / 1e3 / reps:9.3f} ms/step  "
                      f"x{e.count // reps:<4d} {e.key[:160]}")

    print(f"total {time.perf_counter() - t_all:.1f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card {card}")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
