"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Builds the CUDA kernels from ``torch_nfft_tpu_torch/csrc`` with nvcc (one
process per source) and, beside them, the host C++ plan builder and Benes
router with g++. Builds the headline plan on the device and on the host
(checked against each other field by field), routes the host plan's Benes
tables cold, holds each kernel against its plain PyTorch version at the
headline shapes (the position-gradient kernel with both of its weightings;
the permutation kernels bit for bit, also at q = 20 with rows of K = 8,
128 and 1024), runs the NDFT accuracy gates, then runs the headline
adjoint+forward pair (3D, N=256,
n=2^24 points in [-1/4, 1/4)^3, es window, m=2, sigma=1.625) through the
port's public entry points, checks the kernels were launched on that path
and the adjoint at 96 sampled frequencies against the direct sum. Then a
headline training step: forward and backward of L = <pair(x, pos), w> with
gradients for x and all positions, its launches (2 of each kernel) and
x.grad against pair(w) (the pair's operator is symmetric); and the same
loss at a small size on the card against the CPU's plain chain, for
pos.grad. Then the same pair and training step on the Benes route (the JAX
package's default headline route: ``with_benes_tables``), held against the
sort route's, and the slot-space Benes route at n = 2^20. Then the headline
pair and training step at C = 8 columns, where the dense tile array (9.9
GB) exceeds the memory budget of ``use_fold`` and the flat-grid route runs
(per-row tiles from the B7 kernel ``spread_tiles``): held column by column
against the one-column dense pair and by the sampled-frequency check, and
the flat route forced at C = 1 against the dense route. The bitonic sort's
three kernels (B8) run through ``sort_pairs``/``apply_permutation`` at 2^24
and are held against the plain network bit for bit, call by call. Last it
times each kernel with CUDA events beside its bound, its plain version and
one PyTorch call of the same function where there is one (the sort's
kernels call by call along its schedule; the ragged row passes also at C = 8
in the layouts the slot permutations pass them; the two spreads at C = 1 and
8 also beside the share of the float32 peak their issued flops reach and a
yardstick for the contraction alone, ``torch.bmm`` of preformed operands
over every row), times the sort, the Benes network, the ragged passes and
the spreads' contraction with other block, tile, row-group, chunk and band
sizes (each bitwise equal to the defaults), holds both spread designs
against the plain versions on the headline points binned at T = 8 and
T = 16, times the per-row spread's two designs at T = 8-24 and C = 1-8
(which set ``contract.DENSE_RATIO_MAX``), times the pair stage by stage on
every route (the stages ``nfft_pair_planar`` runs) and reads the device's
busy share of three traced pairs and three traced steps with
``torch.profiler``.

Every phase prints its seconds; any failure exits non-zero. The line before
the last is a JSON object listing the kernels with their times and bounds;
the last line is ``{"ok": true, "device": {...}}``. Without a CUDA card it
exits with code 2 and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import torch_nfft_tpu_torch as tp
from torch_nfft_tpu_torch import _build, _native
from torch_nfft_tpu_torch.ops import benes, binned, bitonic, contract, ragged
from torch_nfft_tpu_torch.ops.binned import (
    dense_tile_ids,
    run_stages,
    slot_values,
    unslot_values,
)
from torch_nfft_tpu_torch.ops.tilefold import FOLD_BUDGET, tile_array_bytes
from torch_nfft_tpu_torch.ops.planar import pair_stages
from torch_nfft_tpu_torch.ops.tilefold import row_tile_ids, unfold_grid_to_tiles

# headline configuration of the JAX bench (bench.py); the sort route is its
# BENCH_BENES=0 route, the Benes route its default
N_LOG2, N, DIM, M_CUT, SIGMA, WINDOW = 24, 256, 3, 2, 1.625, "es"
# the permutation kernels' checks on random permutations of 2^Q_CHECK, and
# the slot-space Benes route (a 2^25 network at the headline) at n = 2^SLOT_LOG2
Q_CHECK, SLOT_LOG2 = 20, 20
# columns of the flat-grid cells: the dense tile array of 8 columns (9.9 GB)
# exceeds use_fold's budget, that of one column (1.2 GB) does not
C_WIDE = 8
# the bitonic sort's ties-and-extremes check at 2^TIES_LOG2 keys
TIES_LOG2 = 20

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and float32 outside the
# tensor cores; the kernels do float32 arithmetic on the CUDA cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# kernel wrapper name -> (module holding its launch counter, the TPU kernel
# it replaces, its CUDA source)
CONTRACT_CU = "torch_nfft_tpu_torch/csrc/contract.cu"
PERMUTE_CU = "torch_nfft_tpu_torch/csrc/permute.cu"
BITONIC_CU = "torch_nfft_tpu_torch/csrc/bitonic.cu"
JAX_BITONIC = "torch_nfft_tpu/ops/pallas/bitonic.py"
KERNELS = {
    "spread_tiles_dense": (contract, "torch_nfft_tpu/ops/pallas/contract.py:369", CONTRACT_CU),
    "gather_points": (contract, "torch_nfft_tpu/ops/pallas/contract.py:662", CONTRACT_CU),
    "pos_grad": (contract, "torch_nfft_tpu/ops/pallas/contract.py:809", CONTRACT_CU),
    "expand_rows": (ragged, "torch_nfft_tpu/ops/pallas/ragged.py:78", PERMUTE_CU),
    "compact_rows": (ragged, "torch_nfft_tpu/ops/pallas/ragged.py:162", PERMUTE_CU),
    # the cross-block stages (_outer_fused, _cross_stage_pallas) of apply_benes
    "benes_outer": (benes, "torch_nfft_tpu/ops/pallas/benes.py:491", PERMUTE_CU),
    # the fused stages (_apply_benes_super's _fused_stages_kernel) of apply_benes
    "benes_local": (benes, "torch_nfft_tpu/ops/pallas/benes.py:539", PERMUTE_CU),
    # the per-row spread of the flat-grid route
    "spread_tiles": (contract, "torch_nfft_tpu/ops/pallas/contract.py:626", CONTRACT_CU),
    # sort_pairs's local rounds (_local_sort_loop_kernel, pallas_call :361/:373),
    # its cross stages (_cross_stage) and its merges (pallas_call :393)
    "bitonic_local_sort": (bitonic, f"{JAX_BITONIC}:224", BITONIC_CU),
    "bitonic_cross_round": (bitonic, f"{JAX_BITONIC}:285", BITONIC_CU),
    "bitonic_local_merge": (bitonic, f"{JAX_BITONIC}:248", BITONIC_CU),
}
SORT_PATH = ("spread_tiles_dense", "gather_points", "pos_grad")
BENES_PATH = SORT_PATH + ("expand_rows", "compact_rows", "benes_outer", "benes_local")
FLAT_PATH = ("spread_tiles", "gather_points", "pos_grad")
BITONIC = ("bitonic_local_sort", "bitonic_cross_round", "bitonic_local_merge")
# the spreads (B1, B7) have two designs (contract.spread_design)
SPREADS = ("spread_tiles_dense", "spread_tiles")
# pos.grad of the Benes and the sort route's training steps: held to the
# limit set when the spread's float atomics reordered its sums on every run
# (two runs of one route differed by rel-L2 up to 1.2e-6,
# tools/probe_route_noise.py)
POS_GRAD_ROUTES = 3e-6


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


def rel_l2_rows(a: torch.Tensor, b: torch.Tensor, rows: int = 1024) -> float:
    """rel_l2 of two large float32 arrays, in float64 a block of rows at a
    time."""
    num = den = 0.0
    for r0 in range(0, a.shape[0], rows):
        da, db = a[r0:r0 + rows].double(), b[r0:r0 + rows].double()
        num += float(torch.linalg.vector_norm(da - db)) ** 2
        den += float(torch.linalg.vector_norm(db)) ** 2
    return (num / den) ** 0.5


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
    for name, (mod, _, _) in KERNELS.items():
        getattr(mod, name).launches = 0
    for name in SPREADS:
        by = getattr(contract, name).launches_by_design
        for design in by:
            by[design] = 0


def read_launches() -> dict:
    return {name: getattr(mod, name).launches for name, (mod, _, _) in KERNELS.items()}


def read_designs() -> dict:
    """Launches of each spread per design since the last reset_launches."""
    return {name: dict(getattr(contract, name).launches_by_design) for name in SPREADS}


def issued_flops(plan, C: int) -> float:
    """Flops the contraction design issues for one spread of the plan's n
    points at C columns: each point's multiply-adds over every row and
    column of its bands' thread tiles, zero padding included (the operands'
    formation not counted)."""
    d = contract.spread_design(plan.dim, plan.H, plan.m, C, name="contraction")
    return 2.0 * plan.n * d.issued_macs


def spread_yardstick(plan, vals, chunk: int = 256) -> float:
    """ms of the 3D contraction alone by PyTorch calls: torch.bmm of the
    dense operands, (rows, C*H, K) x (rows, K, H^2) in full float32, over
    every row of the plan, ``chunk`` rows a call. Each chunk's operands are
    formed untimed, its bmm timed by CUDA events (mean of 3 after a
    warm-up), and the chunks' times added. A yardstick only: the port never
    calls it."""
    K, H = plan.K, plan.H
    C = vals.shape[0]
    keep = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    total = 0.0
    try:
        for r0 in range(0, plan.S, chunk):
            r1 = min(plan.S, r0 + chunk)
            A, kmask = contract._chunk_inputs(plan, r0, r1)
            xs = vals[:, r0 * K:r1 * K].reshape(C, r1 - r0, K).permute(1, 0, 2)
            xs = xs * kmask[:, None]
            X = (xs[:, :, None, :] * A[:, :, 0].permute(0, 2, 1)[:, None]).reshape(
                r1 - r0, C * H, K).contiguous()
            KR = (A[:, :, 1, :, None] * A[:, :, 2, None, :]).reshape(
                r1 - r0, K, H * H).contiguous()
            total += time_ms(lambda: torch.bmm(X, KR), 3)
            del A, kmask, xs, X, KR
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep
    return total


def ptxas_report(log: str, kernel: str) -> list:
    """(mangled name, registers, stack bytes, spill bytes) of each entry
    function of the nvcc -Xptxas -v log whose name holds ``kernel``."""
    out, name, stack, spill = [], None, None, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "bytes stack frame" in line:
            nums = [int(tok) for tok in line.replace(",", " ").split() if tok.isdigit()]
            stack, spill = nums[0], nums[1] + nums[2]
        elif name and "Used" in line and "registers" in line:
            regs = int(line.split("Used")[1].split()[0])
            if kernel in name:
                out.append((name, regs, stack, spill))
            name = None
    return out


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


def sampled_frequency_check(plan, pos, x, dev, n_freq: int = 96, col: int = 0) -> float:
    """Column ``col`` of the headline adjoint of x at ``n_freq`` random
    frequencies against the direct sum over all points. The phase k.pos splits pos into a part with
    12 fractional bits (k*p_hi is exact in float32 for |k| <= 2^11, and so is
    its reduction mod 1) plus a small remainder, so the angle is good to
    ~1e-7 rad (the method of bench.py:_headline_accuracy)."""
    rng = np.random.default_rng(11)
    k = rng.integers(-(N // 2), N // 2, size=(n_freq, DIM))
    yr, yi = tp.nfft_adjoint_planar(x, pos, None, plan, batch_size=1, N=N,
                                    m=M_CUT, sigma=SIGMA, window=WINDOW,
                                    device=dev)
    idx = (0,) + tuple(torch.as_tensor(k[:, d] + N // 2, device=dev) for d in range(DIM)) + (col,)
    got = torch.complex(yr[idx], yi[idx]).to(torch.complex128)
    kf = torch.as_tensor(k, dtype=torch.float32, device=dev)
    acc_r = torch.zeros(n_freq, dtype=torch.float64, device=dev)
    acc_i = torch.zeros(n_freq, dtype=torch.float64, device=dev)
    chunk = 1 << 21
    for c0 in range(0, pos.shape[0], chunk):
        p = pos[c0:c0 + chunk]
        w = x[c0:c0 + chunk, col]
        p_hi = torch.round(p * 4096.0) / 4096.0
        p_lo = p - p_hi
        ph_hi = p_hi @ kf.T  # sums of exact products: exact in float32
        ph_lo = p_lo @ kf.T
        ang = 2.0 * np.pi * (ph_hi - torch.floor(ph_hi) + ph_lo)
        acc_r += (w[:, None] * torch.cos(ang)).sum(0, dtype=torch.float64)
        acc_i += (w[:, None] * torch.sin(ang)).sum(0, dtype=torch.float64)
    return rel_l2(got, torch.complex(acc_r, acc_i))


def bounds(plan, C: int, tiles_read: int):
    """(spread, gather, pos_grad, per-row spread) least times in ms and what
    bounds each:
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
        # per-row tiles: no tile ids; every row's whole tile is written
        (4 * C * n + coords + 4 * S * (1 + dim) + 4 * S * C * cells, flops),
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


def permute_bounds(C: int, n: int, S: int, K: int, q: int, s: int, size: int,
                   outer_stages: int) -> dict:
    """Least ms of each permutation kernel: the bytes it must move (inputs
    read once, outputs written once) over the HBM rate; they do no
    arithmetic. The ragged passes read or write the n filled lanes of each
    column and the whole padded side; an outer pass of ``outer_stages``
    stages, the local pass (2s-1 stages) and the whole network (2q-1) read
    and write the (C, 2^q) array once and read 2^q/2 pair bits per stage."""
    bits = (1 << q) // 16  # 2^q / 2 pair bits per stage
    words = 2 * 4 * C * (1 << q)
    work = {
        "expand_rows": 4 * C * n + 8 * S + 4 * C * S * K,
        "compact_rows": 4 * C * n + 8 * S + 4 * C * size,
        "benes_outer": words + outer_stages * bits,
        "benes_local": words + (2 * min(s, q) - 1) * bits,
        "apply_benes": words + (2 * q - 1) * bits,
    }
    return {k: (b / PEAK_BYTES_PER_S * 1e3, "bytes") for k, b in work.items()}


def moved(k_in, v_in, k_out, v_out) -> int:
    """Elements whose key or value word changed between input and output."""
    return int(((k_in != k_out) | (v_in.view(torch.int32) != v_out.view(torch.int32))).sum())


def sort_bound(Q: int, stages: int, moves: int) -> tuple:
    """Least ms of ``stages`` stages of the bitonic network on Q int32 keys
    and 32-bit values: the bytes this run's data needs (every key read, and
    for each of the ``moves`` elements that change, its value read and its
    key and value written) over the HBM rate, against one comparison per
    pair and stage over the float32 peak (the CUDA cores' 32-bit rate)."""
    t_bytes = (4 * Q + 12 * moves) / PEAK_BYTES_PER_S * 1e3
    t_ops = (Q // 2) * stages / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sort_schedule(keys, vals):
    """The kernel calls ``sort_pairs`` makes on (keys, vals), run one by
    one: (name, kernel of (k, v), its plain version, stages, input k and v,
    the kernel's output k and v)."""
    q = keys.shape[0].bit_length() - 1
    b = min(q, bitonic.LOCAL_LOG2)
    calls = [("bitonic_local_sort", lambda k, v: bitonic.bitonic_local_sort(k, v, b),
              lambda k, v: bitonic.bitonic_local_sort_plain(k, v, b), b * (b + 1) // 2)]
    for jj in range(b + 1, q + 1):
        for a in bitonic.cross_passes(jj, b):
            calls.append(("bitonic_cross_round",
                          lambda k, v, a=a, jj=jj: bitonic.bitonic_cross_round(k, v, jj, *a),
                          lambda k, v, a=a, jj=jj: bitonic.bitonic_cross_round_plain(
                              k, v, jj, *a), a[0] - a[1] + 1))
        calls.append(("bitonic_local_merge",
                      lambda k, v, jj=jj: bitonic.bitonic_local_merge(k, v, jj, b),
                      lambda k, v, jj=jj: bitonic.bitonic_local_merge_plain(k, v, jj, b), b))
    out, k, v = [], keys, vals
    for name, fn, plain, st in calls:
        k2, v2 = fn(k.clone(), v.clone())
        out.append((name, fn, plain, st, k, v, k2, v2))
        k, v = k2, v2
    return out


def with_empty_row(plan):
    """The plan with one empty row (row_count 0, origin 0) appended, as plan
    stacks pad them."""
    S, K, dim, dev = plan.S, plan.K, plan.dim, plan.device
    cat = torch.cat
    return dataclasses.replace(
        plan,
        slot_pt=cat([plan.slot_pt, plan.slot_pt.new_zeros((1, K))]),
        slot_pos=cat([plan.slot_pos, plan.slot_pos.new_zeros((dim, K))], 1),
        origin=cat([plan.origin, plan.origin.new_zeros((1, dim))]),
        row_batch=cat([plan.row_batch, plan.row_batch.new_zeros(1)]),
        row_count=cat([plan.row_count, plan.row_count.new_zeros(1)]),
        fill_keys=cat([plan.fill_keys, torch.arange(S * K, (S + 1) * K, dtype=torch.int32,
                                                    device=dev)]),
        order=None, row_start=None, benes=None)


def time_on_copy(fn, srcs, reps: int) -> float:
    """Mean ms of the in-place ``fn(*bufs)`` on fresh copies ``bufs`` of
    ``srcs``: the time of copy and call, less the time of the copy."""
    bufs = [t.clone() for t in srcs]

    def copy():
        for b, t in zip(bufs, srcs):
            b.copy_(t)

    t_copy = time_ms(copy, reps)
    return time_ms(lambda: (copy(), fn(*bufs)), reps) - t_copy


def source_map(fn, length: int, dev) -> torch.Tensor:
    """int64 source index of every output word of the word permutation
    ``fn`` (1 + the index, 0 where fn writes a zero), from its run on an
    int32 ramp 1..length: one ``index_select`` with this map computes fn."""
    ramp = torch.arange(1, length + 1, dtype=torch.int32, device=dev)
    return fn(ramp).reshape(-1).long()


def check_host_plan(ph, pd) -> None:
    """The host plan against the device plan: every table equal, slot_pt and
    slot_pos on the filled slots (padded slots differ by construction)."""
    filled = (torch.arange(pd.K, device=pd.device)[None] < pd.row_count[:, None]).reshape(-1)
    assert torch.equal(ph.slot_pt.reshape(-1)[filled], pd.slot_pt.reshape(-1)[filled]), \
        "host and device slot_pt differ"
    assert torch.equal(ph.slot_pos[:, filled], pd.slot_pos[:, filled]), \
        "host and device slot_pos differ"
    for name in ("origin", "row_batch", "fill_keys", "row_count"):
        assert torch.equal(getattr(ph, name), getattr(pd, name)), f"host and device {name} differ"
    for name in ("n", "T", "K", "S_occ", "active"):
        assert getattr(ph, name) == getattr(pd, name), f"host and device {name} differ"


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
              f"count {torch.cuda.device_count()} host cores {os.cpu_count()}", flush=True)

    with Phase("1 build"):
        with ThreadPoolExecutor(2) as pool:  # nvcc and g++ side by side
            cuda_job = pool.submit(_build.build)
            host_job = pool.submit(_native.build_native)
            res, (host_so, host_s) = cuda_job.result(), host_job.result()
        _build.library()
        _native.native_library()
        print(f"nvcc build: {res.seconds:.2f} s -> {res.path.name}; "
              f"g++ build: {host_s:.2f} s -> {host_so.name}")
        for line in res.log.splitlines():
            if "ptxas" in line and ("registers" in line or "Compiling" in line
                                    or "spill" in line or "smem" in line):
                print("  " + line.strip())
        if res.log:  # a fresh build: the contraction spread keeps no stack
            rep_ptx = ptxas_report(res.log, "spread_contract_kernel")
            for name, regs, stack, spill in rep_ptx:
                print(f"spread_contract_kernel {name[-60:]}: {regs} registers, "
                      f"{stack} bytes stack, {spill} bytes spilled")
            assert rep_ptx and all(st == 0 and sp == 0 for _, _, st, sp in rep_ptx), \
                "the contraction spread uses stack or spills"

    pos, x = headline_data(n, dev)
    pos_np = pos.cpu().numpy()

    with Phase("2 plan"):
        t0 = time.perf_counter()
        plan = tp.build_plan_device(pos, None, N=N, m=M_CUT, sigma=SIGMA,
                                    batch_size=1, window=WINDOW)
        torch.cuda.synchronize()
        t_plan = time.perf_counter() - t0
        print(f"plan built in {t_plan:.3f} s: rows={plan.S} K={plan.K} "
              f"T={plan.T} H={plan.H} NT={plan.NT} M={plan.M}")

    with Phase("2b host plan"):
        t0 = time.perf_counter()
        plan_h = tp.build_plan(pos_np, None, N=N, m=M_CUT, sigma=SIGMA,
                               batch_size=1, window=WINDOW)
        torch.cuda.synchronize()
        t_host = time.perf_counter() - t0
        check_host_plan(plan_h, plan)
        print(f"host plan built in {t_host:.3f} s (native counting sort, slot_pos "
              f"gathered on the card); equals the device plan on every table "
              f"(slot_pt, slot_pos on the {n} filled slots); pos_fp={plan_h.pos_fp} "
              f"S_occ={plan_h.S_occ}")

    with Phase("2c Benes routing"):
        os.environ.pop(benes.CACHE_ENV, None)  # cold: no routing cache
        t0 = time.perf_counter()
        plan_b = plan_h.with_benes_tables()
        torch.cuda.synchronize()
        t_route = time.perf_counter() - t0
        bt = plan_b.benes
        print(f"compact rank network routed cold in {t_route:.3f} s: q={bt.q} "
              f"({2 * bt.q - 1} stages), pair bits {bt.pair_bits.nbytes / 1e6:.2f} MB "
              f"(host cores {os.cpu_count()})")
        # a device plan takes the rank from the host positions, checked
        # against the plan's fingerprint; the warning branch reads fill_keys
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            rank = benes._plan_rank(plan, pos_np)
            t_rank = time.perf_counter() - t0
        took_warning = any("disagrees" in str(w.message) for w in caught)
        assert np.array_equal(rank, benes._plan_rank(plan_h)), "device and host ranks differ"
        print(f"device plan's rank from host positions in {t_rank:.3f} s: "
              f"warning branch {'TAKEN' if took_warning else 'not taken'}")

    err = {}
    with Phase("3 kernels vs plain"):
        vals = slot_values(plan, x)
        tid_spread = dense_tile_ids(plan)
        reset_launches()
        tiles_k = contract.spread_tiles_dense(plan, vals, tid_spread, plan.NT)
        designs_b1 = read_designs()["spread_tiles_dense"]
        tiles_p = contract.spread_tiles_dense_plain(plan, vals, tid_spread, plan.NT)
        err["spread_tiles_dense"] = (float((tiles_k - tiles_p).abs().max()),
                                     rel_l2(tiles_k, tiles_p))
        del tiles_p
        again = contract.spread_tiles_dense(plan, vals, tid_spread, plan.NT)
        design_b1 = contract.spread_design(DIM, plan.H, plan.m, 1)
        print(f"spread_tiles_dense C=1: {design_b1.name} design ({designs_b1}; "
              f"ratio {design_b1.ratio:.2f}, R={design_b1.R}, "
              f"KC={design_b1.KC}); two launches "
              f"bitwise equal: {torch.equal(again, tiles_k)}")
        assert designs_b1["contraction"] == 1 and torch.equal(again, tiles_k), \
            "B1 at the headline must run the contraction and repeat bit for bit"
        del tiles_k, again
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

    with Phase("3b permutation kernels vs plain (bitwise)"):
        perm_err = dict.fromkeys(("expand_rows", "compact_rows", "benes_outer",
                                  "benes_local"), 0.0)

        def same(name, got, ref):
            ok = torch.equal(got, ref)
            if got.dtype == torch.float32 and got.shape == ref.shape:
                perm_err[name] = max(perm_err[name], float((got - ref).abs().max()))
            assert ok, f"{name} differs from its plain version"

        def network_cases(tables, vals_c):
            q, s = tables.q, benes.LOCAL_LOG2
            entry, exit_ = benes.outer_passes(q, min(s, q))
            for reverse in (False, True):
                same("benes_local", benes.benes_local(vals_c.clone(), tables, s, reverse),
                     benes.benes_local_plain(vals_c, tables, s, reverse))
                for js in entry + exit_:
                    same("benes_outer", benes.benes_outer(vals_c.clone(), tables, js, reverse),
                         benes.benes_outer_plain(vals_c, tables, js, reverse))
                same("benes_outer", benes.apply_benes(vals_c, tables, reverse),
                     benes.apply_benes_plain(vals_c, tables, reverse))

        rng = np.random.default_rng(21)
        q20 = Q_CHECK
        perm20 = rng.permutation(1 << q20).astype(np.int32)
        t20 = benes.tables_from_pair_bits(_native.benes_route(perm20), 1 << q20, device=dev)
        for C in (1, 3):
            v20 = torch.from_numpy(rng.standard_normal((C, 1 << q20)).astype(np.float32)).to(dev)
            network_cases(t20, v20)
            network_cases(t20, v20.view(torch.int32))
            want = torch.empty_like(v20)
            want[:, torch.from_numpy(perm20).long().to(dev)] = v20
            same("benes_outer", benes.apply_benes(v20, t20), want)
            # ~2^q20 filled lanes in rows of K, a run of empty rows across
            # a row-group boundary; the stream of exactly n words (no
            # spare tail); compaction of contiguous rows and, at C > 1, of
            # unslot_values's (S*K, C) slot array (the slab layout)
            for K in (8, 128, 1024):
                S20 = (2 << q20) // K + 5
                counts = rng.integers(0, K + 1, size=S20).astype(np.int32)
                counts[:3] = counts[-3:] = 0
                r_g = ragged.rows_per_group(K)
                counts[max(0, r_g - 2):r_g + 2] = 0
                cnt = torch.from_numpy(counts).to(dev)
                rs20 = ragged.row_start_from_counts(cnt)
                n20 = int(counts.sum())
                st = torch.from_numpy(rng.standard_normal((C, n20)).astype(np.float32)).to(dev)
                for stv in (st, st.view(torch.int32)):
                    same("expand_rows", ragged.expand_rows(stv, rs20, cnt, K),
                         ragged.expand_rows_plain(stv, rs20, cnt, K))
                flat = torch.from_numpy(rng.standard_normal((S20 * K, C)).astype(
                    np.float32)).to(dev)
                for pd in (flat.T.contiguous().reshape(C, S20, K), flat.T.reshape(C, S20, K)):
                    for size in (None, n20 + 9000):
                        got = ragged.compact_rows(pd, rs20, cnt, n20, size=size)
                        same("compact_rows", got,
                             ragged.compact_rows_plain(pd, rs20, cnt, n20, got.shape[1]))
                assert C == 1 or ragged.compact_layout(flat.T.reshape(C, S20, K)) == "slab"
        del t20, v20, want, st, flat, pd, got
        print(f"q={q20}, C=1 and 3, float32 and int32: every outer pass, the local pass "
              f"and the network (both directions); expand and compact at K=8, 128, 1024 "
              f"(~2^{q20} filled lanes, contiguous rows and the transposed slot array, "
              f"with and without a zero tail): bitwise equal")
        # the headline: the network, the ragged passes on the plan's rows
        rs_h = ragged.row_start_from_counts(plan.row_count)
        xb = torch.zeros((1, bt.n), device=dev)
        xb[:, :n] = x.T
        network_cases(bt, xb)
        net_out = benes.apply_benes(xb, bt)  # slot_values expands it as it is
        same("expand_rows", ragged.expand_rows(net_out, rs_h, plan.row_count, plan.K),
             ragged.expand_rows_plain(net_out, rs_h, plan.row_count, plan.K))
        rows_h = vals.reshape(1, plan.S, plan.K)
        same("compact_rows", ragged.compact_rows(rows_h, rs_h, plan.row_count, n, size=bt.n),
             ragged.compact_rows_plain(rows_h, rs_h, plan.row_count, n, bt.n))
        sv_b = slot_values(plan_b, x)
        assert torch.equal(sv_b, vals), "Benes slot_values differ from the sort route's"
        assert torch.equal(unslot_values(plan_b, vals.T), x), "Benes unslot_values != x"
        print(f"headline (q={bt.q}, C=1): network, expand, compact bitwise equal to plain; "
              "Benes slot_values == sort slot_values and unslot_values(slot) == x, bitwise")
        del xb, net_out, sv_b

    x8 = torch.randn((n, C_WIDE), device=dev, generator=gen)
    with Phase("3c per-row spread kernel (B7) vs plain"):
        plan_e = with_empty_row(plan)
        errs = []
        for xc in (x, x8):
            v_e = slot_values(plan_e, xc)
            reset_launches()
            t_k = contract.spread_tiles(plan_e, v_e)
            designs = read_designs()["spread_tiles"]
            t_p = contract.spread_tiles_plain(plan_e, v_e)
            errs.append((float((t_k - t_p).abs().max()), rel_l2(t_k, t_p)))
            empty_zero = bool((t_k[-1] == 0).all())
            del t_p
            same = torch.equal(contract.spread_tiles(plan_e, v_e), t_k)
            print(f"spread_tiles C={xc.shape[1]} (headline plan + one empty row): kernel vs "
                  f"plain max_abs={errs[-1][0]:.3e} rel_l2={errs[-1][1]:.3e}; "
                  f"empty row exactly zero: {empty_zero}; {designs}; two launches "
                  f"bitwise equal: {same}")
            assert errs[-1][1] <= 1e-5, f"spread_tiles disagrees: {errs[-1][1]:.3e}"
            assert empty_zero, "the empty row's tile is not zero"
            assert designs["contraction"] == 1 and same, \
                "B7 at the headline must run the contraction and repeat bit for bit"
            del v_e, t_k
        err["spread_tiles"] = tuple(map(max, zip(*errs)))
        del plan_e

    with Phase("3d bitonic sort kernels vs plain (bitwise)"):
        b_loc = bitonic.LOCAL_LOG2
        rng3 = np.random.default_rng(31)

        def same_sort(label, got, want):
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
                f"{label}: the kernels differ from the plain network"

        # the B8 entry points at 2^24, counts from zero: the kernels' own path
        dest = torch.from_numpy(rng3.permutation(n).astype(np.int32)).to(dev)
        vals_s = torch.randn(n, device=dev, generator=gen)
        reset_launches()
        sk, sv = bitonic.sort_pairs(dest, vals_s)
        perm_out = bitonic.apply_permutation(dest, vals_s)
        torch.cuda.synchronize()
        launches_sort = read_launches()
        print(f"launches of sort_pairs + apply_permutation at 2^{N_LOG2}: "
              f"{ {k: launches_sort[k] for k in BITONIC} }")
        assert all(launches_sort[k] > 0 for k in BITONIC), launches_sort
        same_sort("2^24 permutation", (sk, sv), bitonic.sort_pairs_plain(dest, vals_s))
        assert torch.equal(sk, torch.sort(dest).values), "keys are not sorted"
        assert torch.equal(perm_out, torch.empty_like(vals_s).index_copy_(
            0, dest.long(), vals_s)), "apply_permutation != index_copy_"
        del sk, sv, perm_out
        # many ties and the int32 extremes
        i32 = np.iinfo(np.int32)
        ext = np.array([i32.min, i32.min + 1, -1, 0, 1, i32.max - 1, i32.max], np.int64)
        nt = 1 << TIES_LOG2
        keys_t = np.where(rng3.random(nt) < 0.5, rng3.choice(ext, nt),
                          rng3.integers(-100, 100, nt)).astype(np.int32)
        k_t = torch.from_numpy(keys_t).to(dev)
        for v_t in (torch.randn(nt, device=dev, generator=gen),
                    torch.randint(i32.min, i32.max, (nt,), dtype=torch.int32, device=dev,
                                  generator=gen)):
            got = bitonic.sort_pairs(k_t, v_t)
            same_sort(f"2^{TIES_LOG2} ties and extremes, {v_t.dtype}", got,
                      bitonic.sort_pairs_plain(k_t, v_t))
            assert torch.equal(got[0], torch.sort(k_t).values)
        # each kernel on its own, call by call along the sort's schedule: q
        # around the card's block 2^b, at 2^Q_CHECK and at the headline's 2^24
        for q in (b_loc - 1, b_loc, b_loc + 3, Q_CHECK, N_LOG2):
            Q = 1 << q
            if q == N_LOG2:
                cases = [(dest, vals_s)]
            else:
                k_q = torch.from_numpy(rng3.integers(-40, 40, Q).astype(np.int32)).to(dev)
                cases = [(k_q, torch.randn(Q, device=dev, generator=gen)),
                         (k_q, torch.randint(-1000, 1000, (Q,), dtype=torch.int32,
                                             device=dev, generator=gen))]
            for k_q, v_q in cases:
                if q != N_LOG2:
                    same_sort(f"q={q}", bitonic.sort_pairs(k_q, v_q),
                              bitonic.sort_pairs_plain(k_q, v_q))
                for name, _, plain, st, k_in, v_in, k_out, v_out in sort_schedule(k_q, v_q):
                    same_sort(f"{name} ({st} stages) q={q}", (k_out, v_out), plain(k_in, v_in))
                del k_in, v_in, k_out, v_out
        print(f"sort_pairs and apply_permutation at 2^{N_LOG2} (float32 values), "
              f"2^{TIES_LOG2} ties and int32 extremes (float32, int32 values), and each "
              f"kernel call of the schedule at q={b_loc - 1}, {b_loc}, {b_loc + 3}, {Q_CHECK}, "
              f"{N_LOG2} (block 2^{b_loc}, cross tiles 2^{bitonic.CROSS_LOG2}): bitwise "
              "equal to the plain network; keys equal torch.sort")
        perm_err.update(dict.fromkeys(BITONIC, 0.0))  # bitwise equal
        del k_t, keys_t

    with Phase("4 accuracy gates"):
        g2 = gate(2, 16, dev)
        g3 = gate(3, 32, dev)
        print(f"gate 2D N=16 rel_l2={g2:.3e}; gate 3D N=32 rel_l2={g3:.3e}")
        assert g2 < 1e-3 and g3 < 1e-3, "accuracy gate failed"

    def pair_on(p, xv=x):
        return tp.nfft_pair_planar(xv, pos, None, p, batch_size=1, N=N, m=M_CUT,
                                   sigma=SIGMA, window=WINDOW)

    def timed_pairs(p, xv=x):
        times, z = [], None
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            z = pair_on(p, xv)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return z, times

    with Phase("5 headline pair"):
        reset_launches()
        z, times = timed_pairs(plan)
        launches_pair = read_launches()
        designs_pair = read_designs()
        t_pair = float(np.median(times[1:]))
        print(f"pair s: first {times[0]:.4f}, then {[round(t, 4) for t in times[1:]]}; "
              f"median {t_pair:.4f} s/pair = {n / t_pair / 1e6:.2f} M points/s")
        print(f"launches on the pair path (4 pairs): {launches_pair}; spread designs "
              f"{designs_pair['spread_tiles_dense']}")
        assert launches_pair["spread_tiles_dense"] > 0 and launches_pair["gather_points"] > 0, \
            f"a kernel was not launched: {launches_pair}"
        assert designs_pair["spread_tiles_dense"]["wide"] == 0, \
            "the headline dense pair must run the contraction design"
        assert tuple(z.shape) == (n, 1) and bool(torch.isfinite(z).all()), "bad pair output"
        rel_h = sampled_frequency_check(plan, pos, x, dev)
        print(f"headline rel_l2 at 96 sampled frequencies: {rel_h:.3e}")
        assert rel_h < 1e-3, "headline accuracy check failed"

    def run_steps(p, xl, pl, w, reps=3):
        times, split = [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev = train_step(xl, pl, w, p, N=N)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            split.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])))
        return times, np.median(np.array(split), axis=0)

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
        launches_step = read_launches()
        print(f"launches in one training step: {launches_step}")
        assert launches_step == {name: 2 if name in SORT_PATH else 0 for name in KERNELS}, \
            f"a sort-route training step must launch each kernel twice: {launches_step}"
        times, (fwd_ms, bwd_ms) = run_steps(plan, xl, pl, w)
        t_step = float(np.median(times))
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
        sort_grads = (xl.grad.clone(), pl.grad.clone())

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

    with Phase("5d headline pair, Benes route"):
        reset_launches()
        z_b, times = timed_pairs(plan_b)
        launches_bpair = read_launches()
        t_bpair = float(np.median(times[1:]))
        print(f"Benes-route pair s: first {times[0]:.4f}, then "
              f"{[round(t, 4) for t in times[1:]]}; median {t_bpair:.4f} s/pair = "
              f"{n / t_bpair / 1e6:.2f} M points/s (sort route {t_pair:.4f})")
        print(f"launches on the Benes-route pair path (4 pairs): {launches_bpair}")
        missing = [k for k in BENES_PATH if k != "pos_grad" and launches_bpair[k] == 0]
        assert not missing, f"not launched on the Benes-route pair: {missing}"
        rel_b = rel_l2(z_b, z)
        print(f"Benes-route pair vs sort-route pair: rel_l2={rel_b:.3e}")
        assert rel_b <= 1e-6, f"the Benes-route pair disagrees: {rel_b:.3e}"
        del z_b

    with Phase("5e headline training step, Benes route"):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(xl, pl, w, plan_b, N=N)
        torch.cuda.synchronize()
        t_bfirst = time.perf_counter() - t0
        launches_bstep = read_launches()
        print(f"launches in one Benes-route training step: {launches_bstep}")
        missing = [k for k in BENES_PATH if launches_bstep[k] == 0]
        assert not missing, f"not launched in the Benes-route training step: {missing}"
        rel_bx = rel_l2(xl.grad, sort_grads[0])
        rel_bp = rel_l2(pl.grad, sort_grads[1])
        times, (bfwd_ms, bbwd_ms) = run_steps(plan_b, xl, pl, w)
        t_bstep = float(np.median(times))
        print(f"Benes-route training step s: first {t_bfirst:.4f}, then "
              f"{[round(t, 4) for t in times]}; median {t_bstep:.4f} s/step = "
              f"{n / t_bstep / 1e6:.2f} M points/s (forward {bfwd_ms:.3f} ms, backward "
              f"{bbwd_ms:.3f} ms; sort route {t_step:.4f} s)")
        print(f"Benes vs sort route: x.grad rel_l2={rel_bx:.3e}, pos.grad rel_l2={rel_bp:.3e}")
        assert rel_bx <= 1e-6, f"Benes-route x.grad disagrees: {rel_bx:.3e}"
        assert rel_bp <= POS_GRAD_ROUTES, f"Benes-route pos.grad disagrees: {rel_bp:.3e}"

    with Phase(f"5f slot-space Benes route at n=2^{SLOT_LOG2}"):
        ns = 1 << SLOT_LOG2
        ps, xs = headline_data(ns, dev, seed=23)
        ps_np = ps.cpu().numpy()
        plan_s = tp.build_plan(ps_np, None, N=N, m=M_CUT, sigma=SIGMA, batch_size=1,
                               window=WINDOW)
        t0 = time.perf_counter()
        plan_ss = plan_s.with_benes_tables(compact=False)
        t_route_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        plan_sc = plan_s.with_benes_tables()
        t_route_c = time.perf_counter() - t0
        print(f"n=2^{SLOT_LOG2}: S*K={plan_s.S * plan_s.K}; slot-space network q={plan_ss.benes.q} "
              f"routed in {t_route_s:.3f} s, compact q={plan_sc.benes.q} in {t_route_c:.3f} s")
        xs2 = torch.cat([xs, -xs], dim=1)
        zs = tp.nfft_pair_planar(xs2, ps, None, plan_s, batch_size=1, N=N, m=M_CUT,
                                 sigma=SIGMA, window=WINDOW)
        for label, pb in (("slot space", plan_ss), ("compact", plan_sc)):
            assert torch.equal(slot_values(pb, xs2), slot_values(plan_s, xs2)), label
            zb = tp.nfft_pair_planar(xs2, ps, None, pb, batch_size=1, N=N, m=M_CUT,
                                     sigma=SIGMA, window=WINDOW)
            r = rel_l2(zb, zs)
            print(f"n=2^{SLOT_LOG2}, C=2, {label}: slot_values bitwise equal, pair rel_l2={r:.3e}")
            assert r <= 1e-6, f"{label} Benes pair disagrees: {r:.3e}"
        del plan_s, plan_ss, plan_sc, zs, xs2

    with Phase(f"5g headline pair at C={C_WIDE}, flat-grid route"):
        dense_bytes = {C: tile_array_bytes(plan, C, 4, 1) for C in (1, C_WIDE)}
        print(f"dense tile array: {dense_bytes[1] / 1e9:.3f} GB at C=1, "
              f"{dense_bytes[C_WIDE] / 1e9:.3f} GB at C={C_WIDE}; budget "
              f"{FOLD_BUDGET / 1e9:.3f} GB")
        assert binned.use_fold(plan, 1, 4, 1) and not binned.use_fold(plan, C_WIDE, 4, 1)
        reset_launches()
        z8, times = timed_pairs(plan, x8)
        launches_fpair = read_launches()
        designs_fpair = read_designs()
        t_fpair = float(np.median(times[1:]))
        print(f"C={C_WIDE} pair s: first {times[0]:.4f}, then {[round(t, 4) for t in times[1:]]}; "
              f"median {t_fpair:.4f} s/pair = {C_WIDE * n / t_fpair / 1e6:.2f} M column-points/s "
              f"(one column, dense route: {t_pair:.4f} s/pair = {n / t_pair / 1e6:.2f} M)")
        print(f"launches on the C={C_WIDE} pair path (4 pairs): {launches_fpair}; spread "
              f"designs {designs_fpair['spread_tiles']}")
        assert designs_fpair["spread_tiles"]["wide"] == 0 \
            and designs_fpair["spread_tiles"]["contraction"] > 0, \
            f"the C={C_WIDE} flat pair must run the contraction design"
        assert launches_fpair["spread_tiles"] > 0 and launches_fpair["gather_points"] > 0 \
            and launches_fpair["spread_tiles_dense"] == 0, \
            f"the C={C_WIDE} pair did not take the flat route: {launches_fpair}"
        assert tuple(z8.shape) == (n, C_WIDE) and bool(torch.isfinite(z8).all()), "bad pair output"
        worst = 0.0
        for c in range(C_WIDE):
            worst = max(worst, rel_l2(z8[:, c:c + 1], pair_on(plan, x8[:, c:c + 1].contiguous())))
        print(f"each column vs the one-column dense-route pair: worst rel_l2={worst:.3e}")
        assert worst <= 1e-5, f"the flat-route pair disagrees: {worst:.3e}"
        rel_h8 = sampled_frequency_check(plan, pos, x8, dev, col=0)
        print(f"C={C_WIDE} adjoint (flat route), column 0 at 96 sampled frequencies: "
              f"rel_l2={rel_h8:.3e}")
        assert rel_h8 < 1e-3, "headline accuracy check failed on the flat route"
        del z8

    peak_before = torch.cuda.max_memory_allocated()
    with Phase(f"5h headline training step at C={C_WIDE}, flat-grid route"):
        x8l = x8.clone().requires_grad_()
        p8l = pos.clone().requires_grad_()
        w8 = torch.randn((n, C_WIDE), device=dev, generator=gen)
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        train_step(x8l, p8l, w8, plan, N=N)
        torch.cuda.synchronize()
        t_ffirst = time.perf_counter() - t0
        launches_fstep = read_launches()
        print(f"launches in one C={C_WIDE} training step: {launches_fstep}")
        assert launches_fstep == {k: 2 if k in FLAT_PATH else 0 for k in KERNELS}, \
            f"a flat-route training step must launch B7, B2 and B5 twice: {launches_fstep}"
        times, (ffwd_ms, fbwd_ms) = run_steps(plan, x8l, p8l, w8)
        peak = torch.cuda.max_memory_allocated()
        t_fstep = float(np.median(times))
        print(f"C={C_WIDE} training step s: first {t_ffirst:.4f}, then "
              f"{[round(t, 4) for t in times]}; median {t_fstep:.4f} s/step = "
              f"{C_WIDE * n / t_fstep / 1e6:.2f} M column-points/s (CUDA events: forward "
              f"{ffwd_ms:.3f} ms, backward {fbwd_ms:.3f} ms); peak memory "
              f"{peak / 2**30:.2f} GiB ({(peak - base_mem) / 2**30:.2f} GiB above the "
              f"{base_mem / 2**30:.2f} GiB held before the step)")
        zw8 = pair_on(plan, w8)
        rel_x8 = rel_l2(x8l.grad, zw8)
        print(f"x.grad vs pair(w): rel_l2={rel_x8:.3e}")
        assert rel_x8 <= 3e-5, f"x.grad disagrees with pair(w): {rel_x8:.3e}"
        assert tuple(p8l.grad.shape) == (n, DIM) and bool(torch.isfinite(p8l.grad).all()), \
            "bad pos.grad"
        del zw8, x8l, p8l, w8

    with Phase("5i flat-grid route forced at C=1 vs the dense route"):
        st_dense = pair_stages(plan, N=N, m=M_CUT, sigma=SIGMA, window=WINDOW, C=1)
        st_flat = (binned.spread_flat_stages(plan) + st_dense[3:5]
                   + binned.gather_flat_stages(plan))
        rel_f1 = rel_l2(run_stages(st_flat, x), run_stages(st_dense, x))
        print(f"C=1 pair, flat vs dense route: rel_l2={rel_f1:.3e}")
        assert rel_f1 <= 1e-5, f"the forced flat route disagrees: {rel_f1:.3e}"
        for label, st in (("dense", st_dense), ("flat", st_flat)):
            med = stage_ms(st, x)
            print(f"C=1 pair by stage, {label} route, ms (CUDA events, median of 5):")
            for (name, _), ms in zip(st, med):
                print(f"  {name:20s} {ms:9.3f} ms  {ms / med.sum():6.1%}")
            print(f"  {'sum':20s} {med.sum():9.3f} ms")

    with Phase("6 kernel timing"):
        C = 1
        tiles_read = int(torch.unique(tid).numel())
        (b_spread, by_spread), (b_gather, by_gather), (b_pg, by_pg), _ = \
            bounds(plan, C, tiles_read)
        b_rows = {c: bounds(plan, c, tiles_read)[3] for c in (1, C_WIDE)}
        vals8 = slot_values(plan, x8)
        # every call of the sort's schedule at 2^24 on its own input, each
        # timed on a fresh copy less the copy, with the bound of its data
        sched = sort_schedule(dest, vals_s)
        sort_calls = {k: [] for k in BITONIC}  # (ms, bound ms, bound by, stages)
        for name, fn, _, st, k_in, v_in, k_out, v_out in sched:
            ms_c = time_on_copy(fn, (k_in, v_in), 5)
            sort_calls[name].append((ms_c, *sort_bound(n, st, moved(k_in, v_in, k_out, v_out)),
                                     st))
        print(f"sort_pairs at 2^{N_LOG2}, call by call (block 2^{bitonic.LOCAL_LOG2}, cross "
              f"tiles 2^{bitonic.CROSS_LOG2}), ms (bound ms, stages):")
        for name in BITONIC:
            print(f"  {name}: " + ", ".join(f"{m:.4f} ({bd:.4f}, {st})"
                                            for m, bd, _, st in sort_calls[name]))
        plain_sort = {name: next((plain, k_in, v_in) for nm, _, plain, _, k_in, v_in, _, _
                                 in sched if nm == name) for name in BITONIC}
        s_bound_all = sort_bound(n, N_LOG2 * (N_LOG2 + 1) // 2,
                                 moved(dest, vals_s, sched[-1][6], sched[-1][7]))
        del sched
        s_loc = benes.LOCAL_LOG2
        entry, exit_ = benes.outer_passes(bt.q, min(s_loc, bt.q))
        pb_bounds = permute_bounds(C, n, plan.S, plan.K, bt.q, s_loc, bt.n, len(entry[0]))
        # inputs of the permutation kernels at the headline, and the index
        # maps of one index_select computing the same function
        rs_h = ragged.row_start_from_counts(plan.row_count)
        v_h = torch.randn((1, bt.n), device=dev, generator=gen)
        work = v_h.clone()
        # the ragged passes in the layouts slot_values and unslot_values pass
        # them at C = 1 and C_WIDE: the network's (C, 2^q) output, and the
        # (S*K, C) slot array seen as (C, S, K) (contiguous rows at C = 1,
        # the slab at C > 1)
        SK = plan.S * plan.K
        map_e = source_map(lambda r: ragged.expand_rows(r[None], rs_h, plan.row_count,
                                                        plan.K), n, dev)
        map_c = source_map(lambda r: ragged.compact_rows(
            r[:, None].T.reshape(1, plan.S, plan.K), rs_h, plan.row_count, n, size=bt.n),
            SK, dev)
        ragged_in = {}
        for C_r in (1, C_WIDE):
            stream_r = torch.randn((C_r, bt.n), device=dev, generator=gen)
            slots_r = torch.randn((SK, C_r), device=dev, generator=gen)
            rows_r = slots_r.T.reshape(C_r, plan.S, plan.K)
            ragged_in[C_r] = (
                stream_r, rows_r,
                torch.cat([torch.zeros((C_r, 1), device=dev), stream_r[:, :n]], 1),
                torch.cat([torch.zeros((C_r, 1), device=dev), slots_r.T], 1),
                permute_bounds(C_r, n, plan.S, plan.K, bt.q, s_loc, bt.n, len(entry[0])))
        stream_h, rows_h, ext_e, ext_c = ragged_in[1][:4]
        print(f"compact_rows layouts: C=1 {ragged.compact_layout(rows_h)}, C={C_WIDE} "
              f"{ragged.compact_layout(ragged_in[C_WIDE][1])} (rows per group: "
              f"{ragged.rows_per_group(plan.K)} at C=1, "
              f"{ragged.rows_per_group(plan.K, C_WIDE)} in the slab)")
        q = bt.q
        map_s = source_map(lambda r: benes.benes_outer(
            r[None].contiguous(), bt, entry[0]), bt.n, dev) - 1
        map_l = source_map(lambda r: benes.benes_local(
            r[None].contiguous(), bt, s_loc), bt.n, dev) - 1
        map_f = source_map(lambda r: benes.apply_benes(r[None], bt), bt.n, dev) - 1
        rows = [
            ("spread_tiles_dense",
             lambda: contract.spread_tiles_dense(plan, vals, tid_spread, plan.NT),
             lambda: contract.spread_tiles_dense_plain(plan, vals, tid_spread, plan.NT),
             None, b_spread, by_spread),
            ("gather_points",
             lambda: contract.gather_points(plan, tiles, tid),
             lambda: contract.gather_points_plain(plan, tiles, tid),
             None, b_gather, by_gather),
            ("pos_grad",
             lambda: contract.pos_grad(plan, tiles, vals, tid),
             lambda: contract.pos_grad_plain(plan, tiles, vals, tid),
             None, b_pg, by_pg),
            ("expand_rows",
             lambda: ragged.expand_rows(stream_h, rs_h, plan.row_count, plan.K),
             lambda: ragged.expand_rows_plain(stream_h, rs_h, plan.row_count, plan.K),
             lambda: ext_e.index_select(1, map_e), *pb_bounds["expand_rows"]),
            ("compact_rows",
             lambda: ragged.compact_rows(rows_h, rs_h, plan.row_count, n, size=bt.n),
             lambda: ragged.compact_rows_plain(rows_h, rs_h, plan.row_count, n, bt.n),
             lambda: ext_c.index_select(1, map_c), *pb_bounds["compact_rows"]),
            ("benes_outer",  # the entry side's pass
             lambda: benes.benes_outer(work, bt, entry[0]),
             lambda: benes.benes_outer_plain(v_h, bt, entry[0]),
             lambda: v_h.index_select(1, map_s), *pb_bounds["benes_outer"]),
            ("benes_local",
             lambda: benes.benes_local(work, bt, s_loc),
             lambda: benes.benes_local_plain(v_h, bt, s_loc),
             lambda: v_h.index_select(1, map_l), *pb_bounds["benes_local"]),
            ("spread_tiles",  # at the flat route's C
             lambda: contract.spread_tiles(plan, vals8),
             lambda: contract.spread_tiles_plain(plan, vals8),
             None, *b_rows[C_WIDE]),
            # timed above, call by call: the mean per launch of the schedule
            *[(name, [c[0] for c in sort_calls[name]],
               lambda pk=plain_sort[name]: pk[0](pk[1], pk[2]), None,
               float(np.mean([c[1] for c in sort_calls[name]])), sort_calls[name][0][2])
              for name in BITONIC],
        ]
        max_err = {**{k: v[0] for k, v in err.items()}, **perm_err}
        report = []
        # each kernel's main-path launches: the Benes-route step (which runs
        # every dense-route kernel), the flat-route step, the sort's entry points
        main_launches = {**launches_bstep, "spread_tiles": launches_fstep["spread_tiles"],
                         **{k: launches_sort[k] for k in BITONIC}}
        for name, kern, plain, lib, b_ms, b_by in rows:
            ms = time_ms(kern, 10) if callable(kern) else float(np.mean(kern))
            plain_ms = time_ms(plain, 2)
            lib_ms = time_ms(lib, 10) if lib is not None else None
            lib_txt = f", index_select {lib_ms:.4f} ms" if lib is not None else ""
            print(f"{name}: {ms:.4f} ms (plain {plain_ms:.3f} ms{lib_txt}, bound "
                  f"{b_ms:.4f} ms by {b_by}, {b_ms / ms:.1%} of bound)")
            report.append({
                "name": name, "route": "cuda", "source": KERNELS[name][2],
                "replaces": KERNELS[name][1], "launches": main_launches[name],
                "launches_pair": launches_pair[name] // 4,
                "launches_step": launches_step[name],
                "launches_benes_pair": launches_bpair[name] // 4,
                "launches_benes_step": launches_bstep[name],
                "launches_flat_pair": launches_fpair[name] // 4,
                "launches_flat_step": launches_fstep[name],
                "launches_sort_pairs": launches_sort[name],
                "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            })
        # the ragged passes at C_WIDE columns in the layouts of slot_values
        # and unslot_values, bitwise against their plain versions
        stream_r, rows_r, ext_er, ext_cr, bnd_r = ragged_in[C_WIDE]
        for name, kern, plain, lib in (
                ("expand_rows",
                 lambda: ragged.expand_rows(stream_r, rs_h, plan.row_count, plan.K),
                 lambda: ragged.expand_rows_plain(stream_r, rs_h, plan.row_count, plan.K),
                 lambda: ext_er.index_select(1, map_e)),
                ("compact_rows",
                 lambda: ragged.compact_rows(rows_r, rs_h, plan.row_count, n, size=bt.n),
                 lambda: ragged.compact_rows_plain(rows_r, rs_h, plan.row_count, n, bt.n),
                 lambda: ext_cr.index_select(1, map_c))):
            assert torch.equal(kern(), plain()), f"{name} at C={C_WIDE} differs from plain"
            ms, plain_ms, lib_ms = time_ms(kern, 10), time_ms(plain, 2), time_ms(lib, 10)
            b_ms = bnd_r[name][0]
            print(f"{name} C={C_WIDE}: {ms:.4f} ms (plain {plain_ms:.3f} ms, index_select "
                  f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms by bytes, {b_ms / ms:.1%} of bound); "
                  f"bitwise equal to plain")
            next(r for r in report if r["name"] == name)[f"c{C_WIDE}"] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "library_ms": lib_ms}
        del stream_r, rows_r, ext_er, ext_cr, ragged_in
        # the two spreads: their design, the share of the float32 peak the
        # contraction's issued flops reach, and the yardstick of the
        # contraction alone (torch.bmm of preformed operands); B7 also at C=1
        ms1 = time_ms(lambda: contract.spread_tiles(plan, vals), 10)
        for name, C_s, ms_s, b_s in (
                ("spread_tiles_dense", 1, None, b_spread),
                ("spread_tiles", 1, ms1, b_rows[1][0]),
                ("spread_tiles", C_WIDE, None, b_rows[C_WIDE][0])):
            entry = next(r for r in report if r["name"] == name)
            ms_s = entry["ms"] if ms_s is None else ms_s
            d = contract.spread_design(DIM, plan.H, plan.m, C_s)
            share = issued_flops(plan, C_s) / (ms_s * 1e-3) / PEAK_F32_FLOPS
            yard = spread_yardstick(plan, vals if C_s == 1 else vals8)
            print(f"{name} C={C_s}: {ms_s:.4f} ms, {d.name} design (R={d.R}, KC={d.KC}, "
                  f"{d.row_bands} band(s) of {d.threads} threads), "
                  f"{b_s / ms_s:.1%} of its bound; issued flops {issued_flops(plan, C_s):.3e} "
                  f"= {share:.1%} of the float32 peak; yardstick (contraction alone, "
                  f"torch.bmm of preformed float32 operands over all {plan.S} rows, "
                  f"256 a call, times added) {yard:.4f} ms")
            info = {"design": d.name, "issued_flop_share": share, "yardstick_ms": yard,
                    "bound_share": b_s / ms_s}
            if name == "spread_tiles" and C_s == 1:
                entry["c1"] = {"ms": ms_s, "bound_ms": b_s, **info}
            else:
                entry.update(info)
        tiles8 = contract.spread_tiles(plan, vals8)
        g8 = binned.tiles_to_grid(plan, tiles8)
        cells8 = 4 * plan.S * C_WIDE * plan.H**DIM
        grid8 = 4 * C_WIDE * plan.M**DIM
        for label, fn in (("tiles to grid", lambda: binned.tiles_to_grid(plan, tiles8)),
                          ("grid to tiles", lambda: binned.grid_to_tiles(plan, g8))):
            ms_m = time_ms(fn, 5)
            bound_m = (cells8 + grid8) / PEAK_BYTES_PER_S * 1e3
            print(f"{label} C={C_WIDE}: {ms_m:.4f} ms (bound {bound_m:.4f} ms by bytes: "
                  f"{cells8 / 1e9:.3f} GB of tiles, {grid8 / 1e9:.3f} GB of grid)")
        del tiles8, g8, plain_sort
        # the whole sort and the permutation, against one PyTorch call each
        dest_l = dest.long()
        for label, fn, plain, lib, lib_name in (
                ("sort_pairs", lambda: bitonic.sort_pairs(dest, vals_s),
                 lambda: bitonic.sort_pairs_plain(dest, vals_s),
                 lambda: vals_s[torch.sort(dest).indices], "torch.sort + gather"),
                ("apply_permutation", lambda: bitonic.apply_permutation(dest, vals_s), None,
                 lambda: torch.empty_like(vals_s).index_copy_(0, dest_l, vals_s),
                 "index_copy_")):
            ms_s = time_ms(fn, 5)
            plain_txt = f"plain {time_ms(plain, 1):.3f} ms, " if plain is not None else ""
            print(f"{label} 2^{N_LOG2}: {ms_s:.4f} ms ({plain_txt}{lib_name} "
                  f"{time_ms(lib, 10):.4f} ms, bound {s_bound_all[0]:.4f} ms by "
                  f"{s_bound_all[1]})")
        # the whole network and both slot permutations per route
        net_f = time_ms(lambda: benes.apply_benes(v_h, bt), 10)
        net_r = time_ms(lambda: benes.apply_benes(v_h, bt, reverse=True), 10)
        net_lib = time_ms(lambda: v_h.index_select(1, map_f), 10)
        print(f"whole network (q={q}, {len(entry) + len(exit_)} outer passes + 1 local pass): "
              f"forward {net_f:.4f} ms, reverse {net_r:.4f} ms (index_select {net_lib:.4f} ms, "
              f"bound {pb_bounds['apply_benes'][0]:.4f} ms by bytes)")
        for label, p in (("sort", plan), ("Benes", plan_b)):
            for xv in (x, x8):
                flat = torch.randn((plan.S * plan.K, xv.shape[1]), device=dev, generator=gen)
                sv = time_ms(lambda: slot_values(p, xv), 10)
                us = time_ms(lambda: unslot_values(p, flat), 10)
                print(f"{label} route, C={xv.shape[1]}: slot_values {sv:.4f} ms, unslot_values "
                      f"{us:.4f} ms, both {sv + us:.4f} ms")
            del flat
        del stream_h, rows_h, v_h, work, map_e, map_c, map_s, map_l, map_f, ext_e, ext_c

    with Phase("6b block sizes"):
        # the sort and the network at the headline with other tiles: each
        # result bitwise equal to the defaults', times side by side
        xb = torch.randn((1, bt.n), device=dev, generator=gen)
        want_s = bitonic.sort_pairs(dest, vals_s)
        want_f = benes.apply_benes(xb, bt)
        for mod, names, grid in (
                (bitonic, ("LOCAL_LOG2", "CROSS_LOG2"),
                 ((11, 11), (12, 12), (12, 13), (13, 13), (13, 14), (14, 13))),
                (benes, ("LOCAL_LOG2", "OUTER_LOG2"), ((13, 13), (14, 14), (15, 13), (15, 14)))):
            keep = [getattr(mod, nm) for nm in names]
            for vals_g in grid:
                for nm, val in zip(names, vals_g):
                    setattr(mod, nm, val)
                if mod is bitonic:
                    fn = lambda: bitonic.sort_pairs(dest, vals_s)  # noqa: E731
                    got = fn()
                    ok = torch.equal(got[0], want_s[0]) and torch.equal(got[1], want_s[1])
                else:
                    fn = lambda: benes.apply_benes(xb, bt)  # noqa: E731
                    ok = torch.equal(fn(), want_f)
                assert ok, f"{mod.__name__} with {dict(zip(names, vals_g))} differs"
                print(f"{mod.__name__.split('.')[-1]} {dict(zip(names, vals_g))}: "
                      f"{time_ms(fn, 5):.4f} ms, bitwise equal to the defaults'")
            for nm, val in zip(names, keep):
                setattr(mod, nm, val)
        del want_s, want_f, xb
        # the ragged passes with other row groups, in the layouts of
        # slot_values and unslot_values at C = 1 and C_WIDE
        keep = ragged.GROUP_LOG2
        for C_r in (1, C_WIDE):
            stream_r = torch.randn((C_r, bt.n), device=dev, generator=gen)
            rows_r = torch.randn((SK, C_r), device=dev, generator=gen).T.reshape(
                C_r, plan.S, plan.K)
            fn_e = lambda: ragged.expand_rows(stream_r, rs_h, plan.row_count, plan.K)  # noqa: E731
            fn_c = lambda: ragged.compact_rows(rows_r, rs_h, plan.row_count, n,  # noqa: E731
                                               size=bt.n)
            want_e, want_c = fn_e(), fn_c()
            for g in (10, 11, 12, 13, 14):
                ragged.GROUP_LOG2 = g
                assert torch.equal(fn_e(), want_e) and torch.equal(fn_c(), want_c), \
                    f"ragged passes with GROUP_LOG2={g} at C={C_r} differ"
                layout = ragged.compact_layout(rows_r)
                rows_c = ragged.rows_per_group(plan.K, C_r if layout == "slab" else 1)
                print(f"ragged GROUP_LOG2={g} C={C_r}: expand_rows {time_ms(fn_e, 10):.4f} ms "
                      f"({ragged.rows_per_group(plan.K)} rows a block), compact_rows "
                      f"{time_ms(fn_c, 10):.4f} ms ({layout}, {rows_c} rows a block), "
                      f"bitwise equal to the defaults'")
            ragged.GROUP_LOG2 = keep
            del stream_r, rows_r, want_e, want_c
        # the spreads' contraction with other chunk sizes KC and bands of R
        # rows, each bitwise equal to the defaults'
        grid_sp = {1: ((8, None), (32, None), (16, 8)),
                   C_WIDE: ((16, None), (64, None), (32, 104), (32, 40))}
        for name, C_s, fn in (
                ("spread_tiles_dense", 1,
                 lambda d: contract.spread_tiles_dense(plan, vals, tid_spread, plan.NT, d)),
                ("spread_tiles", 1, lambda d: contract.spread_tiles(plan, vals, d)),
                ("spread_tiles", C_WIDE, lambda d: contract.spread_tiles(plan, vals8, d))):
            want = fn(None)
            for KC_g, R_g in ((None, None),) + grid_sp[C_s]:
                d = contract.spread_design(DIM, plan.H, plan.m, C_s, KC=KC_g, R=R_g)
                assert torch.equal(fn(d), want), \
                    f"{name} C={C_s} with KC={d.KC}, R={d.R} differs from the defaults'"
                print(f"{name} C={C_s} KC={d.KC} R={d.R} ({d.row_bands} band(s) of "
                      f"{d.threads} threads, {d.smem} B shared): "
                      f"{time_ms(lambda: fn(d), 5):.4f} ms, bitwise equal to the defaults'")
            del want
        # both designs on the headline points binned at T = 8 (the plan's) and
        # T = 16, each against the plain version on the same inputs
        plans_t = {8: plan, 16: tp.build_plan_device(
            pos, None, N=N, m=M_CUT, sigma=SIGMA, batch_size=1, window=WINDOW, T=16)}
        for T_t, p_t in plans_t.items():
            v1, v8, tid_t = slot_values(p_t, x), slot_values(p_t, x8), dense_tile_ids(p_t)
            for name, C_s, fn, plain in (
                    ("spread_tiles_dense", 1,
                     lambda d: contract.spread_tiles_dense(p_t, v1, tid_t, p_t.NT, d),
                     lambda: contract.spread_tiles_dense_plain(p_t, v1, tid_t, p_t.NT)),
                    ("spread_tiles", 1, lambda d: contract.spread_tiles(p_t, v1, d),
                     lambda: contract.spread_tiles_plain(p_t, v1)),
                    ("spread_tiles", C_WIDE, lambda d: contract.spread_tiles(p_t, v8, d),
                     lambda: contract.spread_tiles_plain(p_t, v8))):
                ref = plain()
                chosen = contract.spread_design(DIM, p_t.H, p_t.m, C_s)
                line = []
                for d_name in ("contraction", "wide"):
                    d = contract.spread_design(DIM, p_t.H, p_t.m, C_s, name=d_name)
                    out = fn(d)
                    rel_d = rel_l2_rows(out, ref)
                    del out
                    assert rel_d <= 1e-5, f"{name} C={C_s} T={T_t} {d_name}: {rel_d:.3e}"
                    ms_d = time_ms(lambda: fn(d), 1 if T_t > 8 and C_s > 1 else 3)
                    line.append(f"{d_name} {ms_d:.4f} ms (vs plain rel_l2={rel_d:.3e})")
                del ref
                print(f"{name} C={C_s} at T={T_t} (H={p_t.H}, ratio {chosen.ratio:.2f}, "
                      f"{p_t.S} rows): {'; '.join(line)}; the rule takes {chosen.name}")
            del v1, v8, tid_t
        del plans_t
        # the per-row spread under both designs at more tile sizes and
        # columns: the times behind contract.DENSE_RATIO_MAX (the two designs
        # held against each other)
        faster = {}
        for T_t in (8, 10, 12, 16, 20, 24):
            p_t = plan if T_t == plan.T else tp.build_plan_device(
                pos, None, N=N, m=M_CUT, sigma=SIGMA, batch_size=1, window=WINDOW, T=T_t)
            for C_s in (1, 2, 4, C_WIDE):
                v_t = slot_values(p_t, x8[:, :C_s].contiguous())
                designs = [contract.spread_design(DIM, p_t.H, p_t.m, C_s, name=d_name)
                           for d_name in ("contraction", "wide")]
                times_d = [time_ms(lambda: contract.spread_tiles(p_t, v_t, d),
                                   3 if T_t * C_s <= 16 else 1) for d in designs]
                outs = [contract.spread_tiles(p_t, v_t, d) for d in designs]
                rel_d = rel_l2_rows(outs[0], outs[1])
                del outs, v_t
                assert rel_d <= 1e-5, f"the two designs disagree: {rel_d:.3e}"
                chosen = contract.spread_design(DIM, p_t.H, p_t.m, C_s)
                won = "contraction" if times_d[0] < times_d[1] else "wide"
                faster.setdefault(C_s, []).append((chosen.ratio, won))
                print(f"spread_tiles C={C_s} at T={T_t} (H={p_t.H}, ratio {chosen.ratio:.2f}, "
                      f"{p_t.S} rows): contraction {times_d[0]:.4f} ms, wide {times_d[1]:.4f} "
                      f"ms, faster {won}, the rule takes {chosen.name}; designs agree to "
                      f"rel_l2={rel_d:.3e}")
            del p_t
        for C_s, runs in faster.items():
            won_c = ", ".join(f"{r:.2f}" for r, w in runs if w == "contraction")
            limit = contract.DENSE_RATIO_MAX[max(c for c in contract.DENSE_RATIO_MAX if c <= C_s)]
            print(f"C={C_s}: the contraction was faster at ratios [{won_c}]; "
                  f"contract.DENSE_RATIO_MAX takes it up to {limit}")
        del vals8

    with Phase("7 stages and device busy share"):
        reps = 3
        for label, p, xv in (("sort", plan, x), ("Benes", plan_b, x),
                             (f"C={C_WIDE} flat-grid", plan, x8)):
            stages = pair_stages(p, N=N, m=M_CUT, sigma=SIGMA, window=WINDOW, C=xv.shape[1])
            med = stage_ms(stages, xv)
            print(f"headline pair by stage, {label} route, ms (CUDA events, median of 5):")
            for (name, _), ms in zip(stages, med):
                print(f"  {name:20s} {ms:9.3f} ms  {ms / med.sum():6.1%}")
            print(f"  {'sum':20s} {med.sum():9.3f} ms")
            busy_ms, wall_ms, kernels = device_busy(lambda: pair_on(p, xv), reps)
            if busy_ms == 0.0:
                print("profiler: no device time recorded")
            else:
                print(f"profiler: {reps} {label}-route pairs in {wall_ms:.3f} ms wall, "
                      f"device busy {busy_ms:.3f} ms = {busy_ms / wall_ms:.1%}")
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

    peak_all = max(peak_before, torch.cuda.max_memory_allocated())
    print(f"total {time.perf_counter() - t_all:.1f} s; peak memory "
          f"{peak_all / 2**30:.2f} GiB; card {card}")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
