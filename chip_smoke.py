"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Builds the CUDA kernels from ``torch_nfft_tpu_torch/csrc`` with nvcc (one
process per source) and, beside them, the host C++ plan builder and Benes
router with g++. Builds the headline plan on the device and on the host
(checked against each other field by field), routes the host plan's Benes
tables cold, holds each kernel against its plain PyTorch version at the
headline shapes (the position-gradient kernel with both of its weightings,
the gather and the position gradient also at C = 8 on the flat route's
per-row tiles, each repeating bit for bit; the permutation kernels bit for
bit, also at q = 20 with rows of K = 8, 128 and 1024), runs the NDFT
accuracy gates, then runs the headline
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
8 also beside the share of the 67 TFLOP/s peak their issued flops reach and
a yardstick for the contraction alone, ``torch.bmm`` of preformed operands
over every row), times the sort, the Benes network, the ragged passes and
the spreads' contractions with other block, tile, row-group, chunk, band
and warp sizes (each equal to the defaults, bit for bit or, the tensor
design's, to a float32 ulp), holds the three spread designs against the
plain versions on the headline points binned at T = 8 and T = 16, times
the per-row spread's three designs at T = 8-24 and C = 1-8 (which set
``contract.DENSE_RATIO_MAX`` and the tensor design's rows and columns,
each time beside its share of the bound and the issued flops' share of
the peak), times the gather and the
position gradient at C = 1 and 8 in every launch layout (threads a
block, lanes sorted by bank or not: the times behind
``contract.POINTS_LAYOUT``; phase 1 requires every instantiation of their
kernel to keep no stack), times the pair stage by stage on
every route (the stages ``nfft_pair_planar`` runs) and reads the device's
busy share of three traced pairs and three traced steps with
``torch.profiler``. Then phases 8-8e drive the Gram matvec of the JAX
package's fastsum bench at full width through ``GaussianKernel(0.4,
dim=3, bandwidth=256, cutoff=4)`` on 2^22 points uniform in [-1, 1)^3
(gaussian window, m = 4, sigma = 2): the spread, gather and
position-gradient kernels against their plain versions at that geometry
(bit for bit across two launches) and the three spread designs timed; the
matvec at C = 1 (dense route) and 8 (flat route) with its launches, its
route (half spectra, ``rfftn``/``irfftn``, which ``nfft_fastsum`` takes
for a real x, counted by ``fastsum_route.half``), its stages and peak
memory, 96 sampled targets against the exact Gaussian
sum in float64 for the symmetric and an asymmetric operator, and C = 8
column by column against C = 1; 8 power-iteration steps in user and
slot order; the CG solve, its residual held to the CG's own; the ``sym``
adjacency operator against its composition from ``G @``; and a gradient
step in x and the points (x.grad against G w, B5 launched). Phases 9-9e
run the rest of the kernel-matrix user's path on the same points: a
``MaternKernel(0.4, nu=1.5)`` Gram matvec at C = 1 and 8 (its launches,
96 targets against the exact Matern sum in float64) and the four radial
classes on the card against the CPU at n = 2^14; ``eigsh_operator`` on
the ``sym`` adjacency in slot and user order (the Perron value 1, the top
Ritz residual); ``accuracy_check``; the half-spectrum stages
(``rfftn``/``irfftn``, which the pair and both Gram matvecs run) against
the C2C formulation (which ``nfft_fastsum`` keeps for a complex x) at the
headline and the Gram geometry, timed; and the
scatter and matmul engines against the NDFT gates, the binned engine and
its gradients, and a 1500-point Gram matrix (no plan) against the dense
Gaussian. Phases 10-10e run the batched configuration of BASELINE.json
(``configs[2]``, as examples/bench_batched.py builds it:
3D, 16 members, N = 256, two columns, gaussian window, m = 4, sigma = 2,
n = 2^21 points in [-1/4, 1/4)^3 with a sorted batch vector, seed 7)
through the streamed transforms: ``split_by_batch``, the 16 member plans
and their stack, ``make_streamed_layout``; B1, B2 and the unfold at member
0's shapes and the C columns of ``nfft_pair_streamed`` (B2 and the unfold
also at the composition's 2C) against their plain versions; B1 there
timed three ways (the wide design, the tensor design unculled and culled,
the rule's) with the culled bands' kept share of (point, band) pairs;
member 0's pass by stage, in ``nfft_pair_streamed`` (``pair_stages``: half spectra)
and in the composition; ``nfft_pair_streamed`` beside the composition
(streamed adjoint, then forward of its spectrum, whole and by single
columns), each with its seconds, points/s, peak memory, member passes
and launches (B1, B2, fold and unfold once per member and column chunk),
held to each other at 1e-5; member 0 at 96 sampled frequencies against
the direct sum; the streamed adjoint and ``nfft_pair_streamed`` against
the all-at-once batched transforms (groups of 8 members if 16 do not fit)
per member; the streamed fastsum, symmetric and
on 2^20 other targets, against the exact Gaussian sum; ``save_plan`` and
``load_plan`` of the Gram host plan with its Benes tables (the headline
plan's save takes over 30 s), the loaded plan's pairs bit for bit on both
routes; ``validate_inputs`` under debug;
the card's float32 pipeline floor (es and kb, m = 6-8, against
``window.F32_PIPELINE_FLOOR``) and ``suggest_window_parameters`` at three
tolerances against the NDFT. Phases 11-11d run the parallel package
(``torch.distributed``) at the Gram geometry: B1, B2 and B5 at a grid slab's
local tile space (slab 1 of 4 of 2^22 points uniform in [-1/2, 1/2)^3,
its plan padded by 0 and 300 empty rows) against their plain versions; on
one NCCL rank in this process, the point-sharded fastsum at C = 1 (dense
route) and 8 (flat route) against ``nfft_fastsum`` on the member plan and
96 targets against the exact Gaussian sum, its gradient, the sharded
adjoint and forward, the training step on 2 sets of 2^21 points (the loss
falls over 3 steps, the first update against one autograd step on
``nfft_fastsum``), and the grid-sharded adjoint, forward and fastsum on one
slab against the single-device planar transforms (2e-4); then four gloo
ranks in spawned processes sharing the card (NCCL refuses two ranks on one
card), each making its data from the seeds: the point-sharded fastsum and
its gradient against world 1 (1e-5), the gloo all-reduce of the 512^3
grid, the train step on data 2 x points 2 against world 1's first update,
and the grid-sharded transforms on 4 slabs against the planar transforms.
Each world has a 120 s process-group timeout and a joined deadline.
Phase 12 runs the compatibility layer (``torch_compat``) at the Gram
geometry: its fastsum, adjoint and forward with x requiring grad and
``GaussianKernel(0.4, dim=3, bandwidth=256, cutoff=4)(pts) @ x`` with a
backward, each output against the port's own entry point (bit for bit),
x.grad against the port's transposed transform (1e-5), with launches and
the layer's seconds beside the port's. Phase 12b runs the five demos of
examples_torch/ at the JAX demos' defaults, each with its own assertion:
the RBF fit, the graph smoothing, the learned kernel, the sharded training
on four gloo ranks sharing the card, and the grid-sharded 3D N = 512
adjoint on one NCCL slab with its peak memory. The RBF and graph demos
must launch B1 and B2, and one matvec of each of their operators, rebuilt
from the demo's data, is held against the plain one-hot matmul engine
(1e-5). Phase 13 holds the dense route's fold and unfold
(``csrc/tilefold.cu``) against their plain versions at the Gram and the
headline geometry (the unfold bit for bit, the fold to rel-L2 1e-5 and bit
for bit across launches) and times both beside the plain versions and the
byte bound; phase 10a holds them so at a streamed member's geometry. Every
phase that counts launches counts theirs too: one fold and one unfold per
dense-route transform pair or matvec, two folds and three unfolds per
training step, none on the flat route.

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
import tempfile
import time
import types
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import torch_nfft_tpu_torch as tp
from torch_nfft_tpu_torch import _build, _native
from torch_nfft_tpu_torch.ops import benes, binned, bitonic, contract, ragged
from torch_nfft_tpu_torch.ops import nfft as pnfft
from torch_nfft_tpu_torch.ops.binned import (
    dense_tile_ids,
    run_stages,
    slot_values,
    unslot_values,
)
from torch_nfft_tpu_torch.ops import tilefold
from torch_nfft_tpu_torch.ops.tilefold import FOLD_BUDGET, tile_array_bytes
from torch_nfft_tpu_torch.ops.planar import fastsum_stages, pair_stages
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
# the Gram matvec of the JAX package's fastsum bench (BASELINE.md,
# examples/bench_fastsum_slot.py): GaussianKernel(0.4, dim=3, bandwidth=256,
# cutoff=4) on n = 2^GRAM_LOG2 points uniform in [-1, 1)^3 (the asymmetric
# operator on 2^GRAM_TARGETS_LOG2 more), gaussian window, sigma = 2
GRAM_LOG2, GRAM_TARGETS_LOG2, GRAM_N, GRAM_M, GRAM_SIGMA = 22, 21, 256, 4, 0.4
# accuracy_check on the Gram operator's points (phase 9c): bandwidth, samples
ACC_N, ACC_SAMPLES = 64, 256
# the batched configuration of BASELINE.json configs[2] (built as
# examples/bench_batched.py builds it): 3D, batch_size = 16, N = 256, two
# trailing columns, gaussian window, m = 4, sigma = 2, n = 2^BATCH_LOG2
BATCH_LOG2, BATCH_B, BATCH_N, BATCH_M, BATCH_C = 21, 16, 256, 4, 2
# members per group of the comparison when all 16 at once do not fit
BATCH_GROUP = 8
# the streamed fastsum's kernel exp(-r^2 / width^2) (gaussian_analytic_coeffs
# at N = 256: the series has converged, exp(-(pi width N/2)^2) ~ e^-400, and
# periodic images, at least 1/2 away, weigh e^-100) and its asymmetric targets
FASTSUM_WIDTH, FASTSUM_TARGETS_LOG2 = 0.05, 20
# the longest save_plan phase 10d allows
SAVE_S_MAX = 30.0

# phases 11-11d: four ranks share the card (gloo), each world with a 120 s
# process-group timeout and a joined deadline; the grid-sharded cell bins
# at T = 16; the training cell is the Gram points as 2 sets of 2^21
SHARD_P, SHARD_TIMEOUT_S, SHARD_JOIN_S, GRID_T, TRAIN_B = 4, 120, 600, 16, 2

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and float32 outside the
# tensor cores, which is also the FP64 tensor cores' (the spread's tensor
# design); the other kernels do float32 arithmetic on the CUDA cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# kernel wrapper name -> (module holding its launch counter, the TPU kernel
# it replaces, its CUDA source)
CONTRACT_CU = "torch_nfft_tpu_torch/csrc/contract.cu"
GATHER_CU = "torch_nfft_tpu_torch/csrc/gather.cu"  # its body: csrc/points.cuh
POS_GRAD_CU = "torch_nfft_tpu_torch/csrc/pos_grad.cu"
PERMUTE_CU = "torch_nfft_tpu_torch/csrc/permute.cu"
BITONIC_CU = "torch_nfft_tpu_torch/csrc/bitonic.cu"
TILEFOLD_CU = "torch_nfft_tpu_torch/csrc/tilefold.cu"
JAX_BITONIC = "torch_nfft_tpu/ops/pallas/bitonic.py"
KERNELS = {
    "spread_tiles_dense": (contract, "torch_nfft_tpu/ops/pallas/contract.py:369", CONTRACT_CU),
    "gather_points": (contract, "torch_nfft_tpu/ops/pallas/contract.py:662", GATHER_CU),
    "pos_grad": (contract, "torch_nfft_tpu/ops/pallas/contract.py:809", POS_GRAD_CU),
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
    # the dense route's tile movement, XLA code in the JAX package
    "fold_tiles_to_grid": (tilefold, "none: torch_nfft_tpu/ops/tilefold.py is XLA code",
                           TILEFOLD_CU),
    "unfold_grid_to_tiles": (tilefold, "none: torch_nfft_tpu/ops/tilefold.py is XLA code",
                             TILEFOLD_CU),
    # a grid slab's tile movement (parallel/grid_sharded.py), XLA code in JAX too
    "fold_tiles_to_slab": (tilefold, "none: torch_nfft_tpu/parallel/grid_sharded.py is XLA "
                           "code", TILEFOLD_CU),
    "unfold_slab_to_tiles": (tilefold, "none: torch_nfft_tpu/parallel/grid_sharded.py is XLA "
                             "code", TILEFOLD_CU),
}
SORT_PATH = ("spread_tiles_dense", "gather_points", "pos_grad")
BENES_PATH = SORT_PATH + ("expand_rows", "compact_rows", "benes_outer", "benes_local")
FLAT_PATH = ("spread_tiles", "gather_points", "pos_grad")
BITONIC = ("bitonic_local_sort", "bitonic_cross_round", "bitonic_local_merge")
TILE_MOVES = ("fold_tiles_to_grid", "unfold_grid_to_tiles")
SLAB_MOVES = ("fold_tiles_to_slab", "unfold_slab_to_tiles")
# a dense-route training step: the pair folds and unfolds once; its backward
# folds the point cotangent and unfolds the grid cotangent and the primal grid
STEP_MOVES = {"fold_tiles_to_grid": 2, "unfold_grid_to_tiles": 3}
# the spreads (B1, B7) have three designs (contract.spread_design)
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


def matvec_launches(spread: str) -> dict:
    """Each kernel's launches in one matvec or transform pair: the spread
    (B1 dense, B7 flat) and B2 once, and on the dense route one fold and
    one unfold."""
    ran = (spread, "gather_points") + (TILE_MOVES if spread == "spread_tiles_dense" else ())
    return {k: int(k in ran) for k in KERNELS}


def read_designs() -> dict:
    """Launches of each spread per design since the last reset_launches."""
    return {name: dict(getattr(contract, name).launches_by_design) for name in SPREADS}


def issued_flops(plan, C: int, name: str | None = None) -> float:
    """Flops a dense spread design (the default for the geometry, or
    ``name``) issues for one spread of the plan's n points at C columns:
    each point's multiply-adds over every row and column of its bands'
    thread tiles or m16 x n8 tiles, zero padding included (the operands'
    formation not counted)."""
    d = contract.spread_design(plan.dim, plan.H, plan.m, C, name=name)
    if d.name == "wide":
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


DESIGNS = ("contraction", "tensor", "wide")


def design_ms(spread, plan, C: int, reps: int):
    """({design: ms}, largest rel-L2 of a design against the contraction):
    ``spread(d)``, a spread of C columns on ``plan`` under the design
    ``d``, timed and run once under each of DESIGNS, the outputs held
    against the contraction's (1e-5)."""
    designs = {d_name: contract.spread_design(plan.dim, plan.H, plan.m, C, name=d_name)
               for d_name in DESIGNS}
    times = {k: time_ms(lambda: spread(d), reps) for k, d in designs.items()}
    want = spread(designs["contraction"])
    rel = max(rel_l2_rows(spread(designs[k]), want) for k in DESIGNS[1:])
    del want
    assert rel <= 1e-5, f"the designs disagree: {rel:.3e}"
    return times, rel


def design_line(times: dict, plan, C: int, bound_ms: float) -> str:
    """Each design's time, its share of the bound and, for the two dense
    designs, the issued flops' share of the 67 TFLOP/s peak."""
    parts = []
    for k, ms in times.items():
        share = "" if k == "wide" else (
            f", issued {issued_flops(plan, C, k) / (ms * 1e-3) / PEAK_F32_FLOPS:.1%} of peak")
        parts.append(f"{k} {ms:.4f} ms ({bound_ms / ms:.1%} of bound{share})")
    return "; ".join(parts)


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


def points_instance(mangled: str) -> str:
    """The template arguments L, CW, kSmem, kGrad of a mangled
    points_kernel name ('...points_kernelILi6ELi1ELb1ELb0EE...')."""
    args = mangled.split("points_kernelI", 1)[1]
    nums, flags = [], []
    for tok in args.split("E")[:4]:
        (nums if tok.startswith("Li") else flags).append(tok[2:])
    return ", ".join(nums + ["true" if f == "1" else "false" for f in flags])


def train_step(x, pos, w, plan, *, N: int, device=None):
    """One training step of L = <nfft_pair_planar(x, pos), w>: forward and
    backward, leaving the gradients in x.grad and pos.grad. Returns CUDA
    events recorded before the forward, between forward and backward, and
    after the backward."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    x.grad = pos.grad = None
    events[0].record()
    z = tp.nfft_pair_planar(x, pos, None, plan, batch_size=1, N=N, m=M_CUT,
                            sigma=SIGMA, window=WINDOW, strategy="binned", device=device)
    loss = (z * w).sum()
    events[1].record()
    loss.backward()
    events[2].record()
    return events


def gate_data(dim: int):
    """bench.py's gate inputs: n=400 points inside [-1/4, 1/4]^dim, two
    columns."""
    rng = np.random.default_rng(0)
    n = 400
    pos = rng.random((n, dim), dtype=np.float32) - 0.5
    pos /= 4 * np.abs(pos).max()
    return pos, rng.standard_normal((n, 2)).astype(np.float32)


def gate_adjoint(dim: int, Ng: int, dev, strategy: str = "binned", *, m: int = M_CUT,
                 sigma: float = SIGMA, window: str = WINDOW) -> torch.Tensor:
    """The port's adjoint of the gate inputs by ``strategy``, complex128."""
    pos, x = gate_data(dim)
    yr, yi = tp.nfft_adjoint_planar(x, pos, None, batch_size=1, N=Ng, m=m,
                                    sigma=sigma, window=window, strategy=strategy, device=dev)
    return torch.complex(yr, yi)[0].to(torch.complex128)


def gate(dim: int, Ng: int, dev, strategy: str = "binned", **window_kw) -> float:
    """rel-L2 of the port's adjoint against its dense NDFT oracle in
    float64, at bench.py's gate configuration (n=400, two columns); the
    headline window unless ``m``, ``sigma``, ``window`` are given."""
    pos, x = gate_data(dim)
    ref = tp.ndft_adjoint(torch.from_numpy(x).double().to(dev),
                          torch.from_numpy(pos).double().to(dev), N=Ng)[0]
    return rel_l2(gate_adjoint(dim, Ng, dev, strategy, **window_kw), ref)


def sampled_frequency_check(plan, pos, x, dev, n_freq: int = 96, col: int = 0) -> float:
    """Column ``col`` of the headline adjoint of x at ``n_freq`` random
    frequencies against the direct sum over all points
    (:func:`direct_adjoint_sum`)."""
    rng = np.random.default_rng(11)
    k = rng.integers(-(N // 2), N // 2, size=(n_freq, DIM))
    yr, yi = tp.nfft_adjoint_planar(x, pos, None, plan, batch_size=1, N=N,
                                    m=M_CUT, sigma=SIGMA, window=WINDOW,
                                    device=dev)
    idx = (0,) + tuple(torch.as_tensor(k[:, d] + N // 2, device=dev) for d in range(DIM)) + (col,)
    got = torch.complex(yr[idx], yi[idx]).to(torch.complex128)
    return rel_l2(got, direct_adjoint_sum(pos, x[:, col], k))


def direct_adjoint_sum(pos, w, k) -> torch.Tensor:
    """sum_i w_i exp(+2 pi i k.pos_i) at the integer frequencies k (F, dim),
    complex128, accumulated in float64. The phase k.pos splits pos into a
    part with 12 fractional bits (k*p_hi is exact in float32 for
    |k| <= 2^11, and so is its reduction mod 1) plus a small remainder, so
    the angle is good to ~1e-7 rad (the method of
    bench.py:_headline_accuracy)."""
    kf = torch.as_tensor(k, dtype=torch.float32, device=pos.device)
    acc_r = torch.zeros(kf.shape[0], dtype=torch.float64, device=pos.device)
    acc_i = torch.zeros_like(acc_r)
    chunk = 1 << 21
    for c0 in range(0, pos.shape[0], chunk):
        p = pos[c0:c0 + chunk]
        wc = w[c0:c0 + chunk]
        p_hi = torch.round(p * 4096.0) / 4096.0
        p_lo = p - p_hi
        ph_hi = p_hi @ kf.T  # sums of exact products: exact in float32
        ph_lo = p_lo @ kf.T
        ang = 2.0 * np.pi * (ph_hi - torch.floor(ph_hi) + ph_lo)
        acc_r += (wc[:, None] * torch.cos(ang)).sum(0, dtype=torch.float64)
        acc_i += (wc[:, None] * torch.sin(ang)).sum(0, dtype=torch.float64)
    return torch.complex(acc_r, acc_i)


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


def exact_gauss_sum(sources, targets, x, width: float, chunk: int = 1 << 18):
    """sum_s exp(-||t - s||^2 / width^2) x_s at each target t, in float64,
    over every source: the exact Gaussian sum the Gram matvec approximates."""
    t = targets.double()
    acc = torch.zeros((t.shape[0], x.shape[1]), dtype=torch.float64, device=t.device)
    for c0 in range(0, sources.shape[0], chunk):
        s = sources[c0:c0 + chunk].double()
        d2 = ((t[:, None, :] - s[None, :, :]) ** 2).sum(-1)
        acc += torch.exp(-d2 / width**2) @ x[c0:c0 + chunk].double()
    return acc


def host_median(fn, reps: int = 3):
    """(result, median seconds) of ``reps`` calls of ``fn`` after a warm-up
    call, host clock to torch.cuda.synchronize()."""
    out = fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, float(np.median(times))


def gram_phases(dev, gen, report: list) -> torch.Tensor:
    """Phases 8-8e: the Gram matvec of the JAX package's fastsum bench at
    full width (3D, N = 256, n = 2^22 points, gaussian window, m = 4,
    sigma = 2) through GaussianKernel and its operators. Adds each kernel's
    launches per Gram matvec and per gradient step, and its times at the
    Gram geometry, to ``report``; returns the points."""
    n = 1 << GRAM_LOG2
    rng = np.random.default_rng(41)
    pts = torch.from_numpy(rng.random((n, DIM), dtype=np.float32) * 2 - 1).to(dev)
    x1 = torch.randn((n, 1), device=dev, generator=gen)
    x8 = torch.randn((n, C_WIDE), device=dev, generator=gen)
    entry = {r["name"]: r for r in report}

    with Phase("8 Gram kernels vs plain"):
        t0 = time.perf_counter()
        kernel = tp.GaussianKernel(GRAM_SIGMA, dim=DIM, bandwidth=GRAM_N, cutoff=GRAM_M)
        G = kernel(pts)
        plan = G._plans()[0]
        torch.cuda.synchronize()
        width = kernel.factor * kernel.sigma
        S, H = plan.S, plan.H
        print(f"Gram operator built in {time.perf_counter() - t0:.3f} s (coefficients "
              f"{tuple(kernel.coeffs.shape)} {kernel.coeffs.dtype}, host plan): n=2^{GRAM_LOG2}, "
              f"window {plan.window} m={plan.m} (L={2 * plan.m + 2}) sigma={plan.sigma} M={plan.M}, "
              f"rows={S} K={plan.K} T={plan.T} H={H} NT={plan.NT}; kernel width "
              f"{width:.4f} on the scaled points (max |p| {float(G.sources.abs().max()):.4f})")
        assert (plan.window, plan.m, plan.M, plan.H) == ("gaussian", GRAM_M, 2 * GRAM_N, 25)
        dense = {C: tile_array_bytes(plan, C, 4, 1) for C in (1, C_WIDE)}
        tid_s, tid = dense_tile_ids(plan), row_tile_ids(plan)
        tiles_read = int(torch.unique(tid).numel())
        print(f"dense tile array {dense[1] / 1e9:.3f} GB at C=1, {dense[C_WIDE] / 1e9:.3f} GB at "
              f"C={C_WIDE} (budget {FOLD_BUDGET / 1e9:.3f} GB), {tiles_read} of its {plan.NT} "
              f"tiles holding points; per-row tiles at C={C_WIDE}: "
              f"{4 * S * C_WIDE * H**DIM / 1e9:.3f} GB")
        assert binned.use_fold(plan, 1, 4, 1) and not binned.use_fold(plan, C_WIDE, 4, 1)
        vals1, vals8 = slot_values(plan, x1), slot_values(plan, x8)
        rows_id = torch.arange(S, dtype=torch.int32, device=dev)
        tiles1 = unfold_grid_to_tiles(
            torch.randn((1, 1) + (plan.M,) * DIM, device=dev, generator=gen), plan)
        tiles8 = binned.grid_to_tiles(
            plan, torch.randn((1, C_WIDE) + (plan.M,) * DIM, device=dev, generator=gen))
        # B5 as the gather's backward weights it: the tiles of the grid the
        # target gather reads, w = a point cotangent
        stages1 = fastsum_stages(plan, plan, G.coeffs, m=GRAM_M, sigma=2.0,
                                 window="gaussian", C=1)
        tiles_primal = unfold_grid_to_tiles(run_stages(stages1[:6], x1), plan)
        w_ybar = slot_values(plan, torch.randn((n, 1), device=dev, generator=gen))
        b1, b8 = bounds(plan, 1, tiles_read), bounds(plan, C_WIDE, S)
        checks = [  # (what, wrapper, columns, kernel, plain version, bound)
            ("", "spread_tiles_dense", 1,
             lambda: contract.spread_tiles_dense(plan, vals1, tid_s, plan.NT),
             lambda: contract.spread_tiles_dense_plain(plan, vals1, tid_s, plan.NT), b1[0]),
            ("", "spread_tiles", 1, lambda: contract.spread_tiles(plan, vals1),
             lambda: contract.spread_tiles_plain(plan, vals1), b1[3]),
            ("", "spread_tiles", C_WIDE, lambda: contract.spread_tiles(plan, vals8),
             lambda: contract.spread_tiles_plain(plan, vals8), b8[3]),
            ("", "gather_points", 1, lambda: contract.gather_points(plan, tiles1, tid),
             lambda: contract.gather_points_plain(plan, tiles1, tid), b1[1]),
            ("", "gather_points", C_WIDE, lambda: contract.gather_points(plan, tiles8, rows_id),
             lambda: contract.gather_points_plain(plan, tiles8, rows_id), b8[1]),
            (" (w=x, cotangent tiles)", "pos_grad", 1,
             lambda: contract.pos_grad(plan, tiles1, vals1, tid),
             lambda: contract.pos_grad_plain(plan, tiles1, vals1, tid), b1[2]),
            (" (w=ybar, primal tiles)", "pos_grad", 1,
             lambda: contract.pos_grad(plan, tiles_primal, w_ybar, tid),
             lambda: contract.pos_grad_plain(plan, tiles_primal, w_ybar, tid), b1[2]),
        ]
        for what, name, C, kern, plain, (b_ms, b_by) in checks:
            reset_launches()
            got = kern()
            design = read_designs().get(name)
            ref = plain()
            mx, rl = float((got - ref).abs().max()), rel_l2_rows(got, ref)
            del ref
            same = torch.equal(kern(), got)
            del got
            ms = time_ms(kern, 5)
            label = f"{name} C={C}{what}"
            ran = "" if design is None else f"; design {design}"
            print(f"{label} at the Gram geometry: kernel vs plain max_abs={mx:.3e} "
                  f"rel_l2={rl:.3e}; two launches bitwise equal: {same}{ran}; {ms:.4f} ms "
                  f"(bound {b_ms:.4f} ms by {b_by}, {b_ms / ms:.1%} of bound)")
            assert rl <= 1e-5 and same, f"{label} at the Gram geometry: {rl:.3e}, {same}"
            gram = entry[name].setdefault("gram", {})
            if f"c{C}" not in gram:
                gram[f"c{C}"] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                                 "max_abs_err": mx}
            entry[name]["max_abs_err"] = max(entry[name]["max_abs_err"], mx)
        del tiles1, tiles8, tiles_primal, w_ybar
        # the spread designs at this ratio: the first reading of the rule at m = 4
        for name, C, fn, b_d in (
                ("spread_tiles_dense", 1,
                 lambda d: contract.spread_tiles_dense(plan, vals1, tid_s, plan.NT, d), b1[0][0]),
                ("spread_tiles", 1, lambda d: contract.spread_tiles(plan, vals1, d), b1[3][0]),
                ("spread_tiles", C_WIDE, lambda d: contract.spread_tiles(plan, vals8, d),
                 b8[3][0])):
            times_d, rel_d = design_ms(fn, plan, C, 3)
            chosen = contract.spread_design(DIM, H, plan.m, C)
            print(f"{name} C={C} at the Gram geometry (H={H}, L={2 * plan.m + 2}, ratio "
                  f"{chosen.ratio:.2f}, bound {b_d:.4f} ms): "
                  f"{design_line(times_d, plan, C, b_d)}; faster "
                  f"{min(times_d, key=times_d.get)}, the rule takes {chosen.name}; designs "
                  f"agree to rel_l2={rel_d:.3e}")
        del vals1, vals8

    launches = {}
    with Phase("8b Gram matvec"):
        ys = {}
        for C, xv, spread in ((1, x1, "spread_tiles_dense"), (C_WIDE, x8, "spread_tiles")):
            G @ xv  # warm-up
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            routes = dict(pnfft.fastsum_routes)
            y = G @ xv
            torch.cuda.synchronize()
            launches[C] = read_launches()
            assert pnfft.fastsum_routes == {"half": routes["half"] + 1, "c2c": routes["c2c"]}, \
                f"a C={C} Gram matvec of a real x must take the half-spectrum route: " \
                f"{routes} -> {pnfft.fastsum_routes}"
            peak = torch.cuda.max_memory_allocated()
            assert launches[C] == matvec_launches(spread), \
                f"a C={C} Gram matvec must launch {spread} and gather_points once (and on " \
                f"the dense route fold and unfold once): {launches[C]}"
            y, t_mv = host_median(lambda: G @ xv)
            assert tuple(y.shape) == (n, C) and y.dtype == torch.float32 \
                and bool(torch.isfinite(y).all()), "bad Gram output"
            ys[C] = y
            print(f"Gram matvec C={C}: median {t_mv * 1e3:.3f} ms (of 3 after a warm-up) = "
                  f"{C * n / t_mv / 1e6:.2f} M column-points/s; launches {launches[C]}; peak "
                  f"memory {peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} GiB above the "
                  f"{base / 2**30:.2f} GiB held)")
            # the stages G @ runs (nfft_fastsum: half spectra for a real x)
            stages = fastsum_stages(plan, plan, G.coeffs, m=GRAM_M, sigma=2.0,
                                    window="gaussian", C=C)
            # bit for bit on the dense route; on the flat route tiles_to_grid's
            # index_add_ adds in another order on every run
            rel_st = rel_l2(run_stages(stages, xv), y)
            assert rel_st <= (0.0 if C == 1 else 1e-6), f"the stages are not the matvec: {rel_st}"
            med = stage_ms(stages, xv, reps=3)
            print(f"Gram matvec C={C} by stage, ms (CUDA events, median of 3):")
            for (name, _), ms in zip(stages, med):
                print(f"  {name:20s} {ms:9.3f} ms  {ms / med.sum():6.1%}")
            print(f"  {'sum':20s} {med.sum():9.3f} ms")
        idx = torch.from_numpy(rng.choice(n, 96, replace=False)).to(dev)
        exact = exact_gauss_sum(G.sources, G.targets[idx], x1, width)
        rel_g = rel_l2(ys[1][idx], exact)
        print(f"Gram C=1 at 96 sampled targets vs the exact Gaussian sum over all 2^{GRAM_LOG2} "
              f"sources (float64): rel_l2={rel_g:.3e}")
        assert rel_g <= 1e-3, f"the Gram matvec is off the Gaussian sum: {rel_g:.3e}"
        worst = max(rel_l2(ys[C_WIDE][:, c:c + 1], G @ x8[:, c:c + 1].contiguous())
                    for c in range(C_WIDE))
        print(f"Gram C={C_WIDE} (flat route) column by column vs C=1 (dense route): worst "
              f"rel_l2={worst:.3e}")
        assert worst <= 1e-5, f"the C={C_WIDE} Gram matvec disagrees: {worst:.3e}"
        del ys
        tgts = torch.from_numpy(rng.random((1 << GRAM_TARGETS_LOG2, DIM), dtype=np.float32)
                                * 2 - 1).to(dev)
        t0 = time.perf_counter()
        Ga = kernel(pts, tgts)
        Ga._plans()
        torch.cuda.synchronize()
        t_pa = time.perf_counter() - t0
        assert not Ga.is_symmetric() and Ga._plans()[0] is not Ga._plans()[1]
        reset_launches()
        ya = Ga @ x1
        torch.cuda.synchronize()
        launches_a = read_launches()
        ya, t_a = host_median(lambda: Ga @ x1)
        idx_a = torch.from_numpy(rng.choice(1 << GRAM_TARGETS_LOG2, 96, replace=False)).to(dev)
        rel_a = rel_l2(ya[idx_a], exact_gauss_sum(Ga.sources, Ga.targets[idx_a], x1, width))
        print(f"asymmetric Gram ({n} sources, {1 << GRAM_TARGETS_LOG2} targets; two plans in "
              f"{t_pa:.3f} s): matvec {t_a * 1e3:.3f} ms, launches {launches_a}; 96 sampled "
              f"targets vs the exact sum: rel_l2={rel_a:.3e}")
        assert launches_a["spread_tiles_dense"] == 1 and launches_a["gather_points"] == 1
        assert rel_a <= 1e-3, f"the asymmetric Gram matvec is off: {rel_a:.3e}"
        del Ga, ya, tgts

    with Phase("8c slot order and solve"):
        def power(step, v, iters=8):
            for _ in range(iters):
                v = step(v)
                v = v / torch.linalg.vector_norm(v)
            return v

        u, t_user = host_median(lambda: power(lambda v: G @ v, x1))
        v, t_slot = host_median(lambda: G.from_slot(power(G.apply_slot, G.to_slot(x1))))
        rel_s = rel_l2(v, u)
        print(f"8 power-iteration steps: user order {t_user * 1e3:.3f} ms "
              f"({t_user / 8 * 1e3:.3f} ms a matvec), slot order {t_slot * 1e3:.3f} ms "
              f"({t_slot / 8 * 1e3:.3f} ms a matvec, conversions included): "
              f"{t_user / t_slot:.3f}x; slot vs user rel_l2={rel_s:.3e}")
        assert rel_s <= 1e-5, f"slot and user order disagree: {rel_s:.3e}"
        # G.solve's CG with its own account (G._solve: solve's z, the steps
        # taken and the recursively updated residual): the true residual is
        # held to the one the iteration reached, and the CG's objective
        # 1/2 z.(G + reg I)z - b.z must fall as the steps grow
        b = torch.randn(n, device=dev, generator=gen)
        phi = {}
        for iters in (10, 20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            z, steps, rec = G._solve(b, reg=1e-2, tol=1e-5, maxiter=iters)
            torch.cuda.synchronize()
            t_cg = time.perf_counter() - t0
            Az = (G @ z) + 1e-2 * z
            true = rel_l2(Az, b)
            phi[iters] = float(0.5 * torch.dot(z.double(), Az.double()) - torch.dot(
                b.double(), z.double()))
            print(f"G.solve(b, reg=1e-2, maxiter={iters}): {t_cg:.3f} s, {steps} CG steps; "
                  f"||(G + reg I) z - b|| / ||b|| = {true:.6e} (the CG's own residual "
                  f"{rec:.6e}); objective {phi[iters]:.6e}")
            assert steps == iters and abs(true / rec - 1.0) <= 1e-3, \
                f"the solve's residual {true:.6e} is not the CG's {rec:.6e}"
        assert phi[20] < phi[10] < 0.0, f"the CG's objective did not fall: {phi}"
        del u, v, z, b

    with Phase("8d adjacency"):
        t0 = time.perf_counter()
        A = kernel.adjacency_matrix(pts, normalization="sym")
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        ya, t_adj = host_median(lambda: A @ x1)
        va, t_adj_s = host_median(lambda: A.apply_slot(A.gram_matrix.to_slot(x1)))
        d = torch.rsqrt(G.row_sums())[:, None]
        rel_c = rel_l2(ya, d * (G @ (d * x1)))
        rel_as = rel_l2(A.gram_matrix.from_slot(va), ya)
        print(f"adjacency (sym) built in {t_build:.3f} s (plan and degrees); matvec "
              f"{t_adj * 1e3:.3f} ms, apply_slot {t_adj_s * 1e3:.3f} ms (slot conversion of x "
              f"included); vs D^-1/2 G D^-1/2 from G @: rel_l2={rel_c:.3e}; slot vs user "
              f"rel_l2={rel_as:.3e}")
        assert rel_c <= 1e-5 and rel_as <= 1e-5, f"adjacency: {rel_c:.3e}, {rel_as:.3e}"
        del A, ya, va, d

    with Phase("8e Gram gradient"):
        pl = pts.clone().requires_grad_()
        xl = x1.clone().requires_grad_()
        w = torch.randn((n, 1), device=dev, generator=gen)
        # the operator's scaled points are a function of pl, so its graph
        # is backpropagated once; the plans are built before the clock
        # starts, and the matvec's kernels and FFT sizes ran warm in 8b
        Gg = kernel(pl)
        Gg._plans()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        loss = ((Gg @ xl) * w).sum()
        ev[1].record()
        loss.backward()
        ev[2].record()
        torch.cuda.synchronize()
        fwd_ms, bwd_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
        launches_g = read_launches()
        peak = torch.cuda.max_memory_allocated()
        rel_x = rel_l2(xl.grad, G @ w)
        print(f"Gram gradient step (x and the points): forward {fwd_ms:.3f} ms, backward "
              f"{bwd_ms:.3f} ms (CUDA events); launches {launches_g}; peak memory "
              f"{peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} above the "
              f"{base / 2**30:.2f} held); x.grad vs G w rel_l2={rel_x:.3e}; points grad rms "
              f"{float(pl.grad.square().mean().sqrt()):.4e}")
        assert launches_g["pos_grad"] > 0, "the Gram backward did not launch B5"
        assert rel_x <= 3e-5, f"x.grad disagrees with G w: {rel_x:.3e}"
        assert tuple(pl.grad.shape) == (n, DIM) and bool(torch.isfinite(pl.grad).all()), \
            "bad points gradient"
    for name in KERNELS:
        entry[name]["launches_gram_c1"] = launches[1][name]
        entry[name][f"launches_gram_c{C_WIDE}"] = launches[C_WIDE][name]
        entry[name]["launches_gram_step"] = launches_g[name]
    return pts


def exact_matern_sum(sources, targets, x, width: float, chunk: int = 1 << 18):
    """sum_s (1 + a) exp(-a) x_s, a = sqrt(3) ||t - s|| / width, at each
    target t over every source, in float64: the Matern (nu = 3/2) sum."""
    t = targets.double()
    acc = torch.zeros((t.shape[0], x.shape[1]), dtype=torch.float64, device=t.device)
    for c0 in range(0, sources.shape[0], chunk):
        s = sources[c0:c0 + chunk].double()
        a = (3.0 ** 0.5 / width) * torch.cdist(t, s)
        acc += ((1.0 + a) * torch.exp(-a)) @ x[c0:c0 + chunk].double()
    return acc


def radial_kernels(bandwidth: int, device=None) -> dict:
    """One kernel of each radial class, width 0.4, 3D, m = GRAM_M."""
    kw = dict(dim=DIM, bandwidth=bandwidth, cutoff=GRAM_M, device=device)
    return {
        "MaternKernel": tp.MaternKernel(GRAM_SIGMA, nu=1.5, **kw),
        "LaplaceKernel": tp.LaplaceKernel(GRAM_SIGMA, **kw),
        "InverseMultiquadricKernel": tp.InverseMultiquadricKernel(GRAM_SIGMA, **kw),
        "RadialKernel": tp.RadialKernel(lambda r: np.exp(-(r / GRAM_SIGMA) ** 2), **kw),
    }


def radial_phases(dev, gen, report: list, pts: torch.Tensor) -> None:
    """Phases 9-9c on the Gram points: a Matern kernel's Gram matvec at
    C = 1 and 8 against the exact sum and the four radial classes on the
    card against the CPU; the Lanczos eigensolve of the sym adjacency in
    slot and user order; accuracy_check. Adds each kernel's launches per
    radial matvec and per eigensolve to ``report``."""
    n = pts.shape[0]
    rng = np.random.default_rng(43)
    x1 = torch.randn((n, 1), device=dev, generator=gen)
    x8 = torch.randn((n, C_WIDE), device=dev, generator=gen)
    entry = {r["name"]: r for r in report}

    launches = {}
    with Phase("9 radial Gram matvec"):
        t0 = time.perf_counter()
        kernel = tp.MaternKernel(GRAM_SIGMA, nu=1.5, dim=DIM, bandwidth=GRAM_N, cutoff=GRAM_M)
        torch.cuda.synchronize()
        t_coeffs = time.perf_counter() - t0
        t0 = time.perf_counter()
        G = kernel(pts)
        G._plans()
        torch.cuda.synchronize()
        t_op = time.perf_counter() - t0
        print(f"MaternKernel({GRAM_SIGMA}, nu=1.5, dim={DIM}, bandwidth={GRAM_N}, "
              f"cutoff={GRAM_M}): coefficients {tuple(kernel.coeffs.shape)} "
              f"{kernel.coeffs.dtype} in {t_coeffs:.3f} s (float64 samples on the host, the "
              f"FFT on the card); operator (scaling, host plan) in {t_op:.3f} s")
        for C, xv, spread in ((1, x1, "spread_tiles_dense"), (C_WIDE, x8, "spread_tiles")):
            G @ xv  # warm-up
            torch.cuda.synchronize()
            reset_launches()
            G @ xv
            torch.cuda.synchronize()
            launches[C] = read_launches()
            assert launches[C] == matvec_launches(spread), \
                f"a C={C} radial matvec must launch {spread} and gather_points once (and on " \
                f"the dense route fold and unfold once): {launches[C]}"
            y, t_mv = host_median(lambda: G @ xv)
            assert tuple(y.shape) == (n, C) and bool(torch.isfinite(y).all()), \
                "bad radial output"
            print(f"radial Gram matvec C={C}: median {t_mv * 1e3:.3f} ms (of 3 after a "
                  f"warm-up); launches {launches[C]}")
            if C == 1:
                y1 = y
        idx = torch.from_numpy(rng.choice(n, 96, replace=False)).to(dev)
        exact = exact_matern_sum(G.sources, G.targets[idx], x1, kernel.factor * GRAM_SIGMA)
        rel_m = rel_l2(y1[idx], exact)
        print(f"radial C=1 at 96 sampled targets vs the exact Matern sum over all {n} sources "
              f"(float64, norm-scaled points): rel_l2={rel_m:.3e}")
        assert rel_m <= 2e-2, f"the radial matvec is off the Matern sum: {rel_m:.3e}"
        del G, y, y1
        # the four classes on the card against the CPU's plain chain
        ps = pts[:1 << 14]
        xs = torch.randn((ps.shape[0], 1), device=dev, generator=gen)
        cards, cpus = radial_kernels(32), radial_kernels(32, "cpu")
        for name, kc in cards.items():
            kh = cpus[name]
            rel_c = rel_l2(kc.coeffs.cpu(), kh.coeffs)
            rel_y = rel_l2((kc(ps) @ xs).cpu(), kh(ps.cpu()) @ xs.cpu())
            print(f"{name} (bandwidth 32) at n=2^14: card vs CPU coefficients "
                  f"rel_l2={rel_c:.3e}, matvec rel_l2={rel_y:.3e}")
            assert rel_c <= 1e-5 and rel_y <= 1e-5, f"{name}: {rel_c:.3e}, {rel_y:.3e}"

    with Phase("9b Lanczos eigensolve"):
        iters = 40
        t0 = time.perf_counter()
        A = tp.GaussianKernel(GRAM_SIGMA, dim=DIM, bandwidth=GRAM_N,
                              cutoff=GRAM_M).adjacency_matrix(pts, normalization="sym")
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        res = {}
        for slot in (True, False):
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            w, Y = tp.eigsh_operator(A, 4, num_iters=iters, use_slot=slot)
            torch.cuda.synchronize()
            t_e = time.perf_counter() - t0
            if slot:
                launches["eigsh"] = read_launches()
            res[slot] = (w, Y, t_e)
            print(f"eigsh_operator(sym adjacency, 4, num_iters={iters}, use_slot={slot}): "
                  f"{t_e:.3f} s, {t_e / (iters + 1) * 1e3:.3f} ms a step ({iters} steps and "
                  f"the warm-up matvec); eigenvalues {[f'{v:.6f}' for v in w.tolist()]}")
        w, Y, _ = res[True]
        top = float(w[-1])
        y = Y[:, -1:]
        resid = rel_l2(A @ y, top * y)
        gap = float((res[True][0] - res[False][0]).abs().max())
        print(f"adjacency built in {t_build:.3f} s; launches in the slot-order eigensolve "
              f"({iters + 1} matvecs): {launches['eigsh']}; top eigenvalue {top:.7f} (the "
              f"Perron value 1); top Ritz residual {resid:.3e}; slot vs user eigenvalues max "
              f"|diff| {gap:.3e}")
        assert abs(top - 1.0) <= 1e-3 and float(w.max()) <= 1.0 + 1e-3, f"eigenvalues {w}"
        assert resid <= 1e-2 and gap <= 1e-4, f"Ritz residual {resid:.3e}, gap {gap:.3e}"
        assert launches["eigsh"]["spread_tiles_dense"] > 0, "the eigensolve launched no B1"
        del A, res, w, Y, y

    with Phase("9c accuracy_check"):
        scaled = tp.GaussianKernel(GRAM_SIGMA, dim=DIM, bandwidth=GRAM_N, cutoff=GRAM_M)(pts)
        acc = tp.accuracy_check(scaled.sources, ACC_N, 4, sample_points=ACC_SAMPLES)
        print(f"accuracy_check on the Gram operator's points (bandwidth {ACC_N}, cutoff 4, "
              f"{ACC_SAMPLES} samples): {acc:.3e}")
        assert acc <= 1e-3, f"accuracy_check: {acc:.3e}"
        del scaled
    for name in KERNELS:
        entry[name]["launches_radial_c1"] = launches[1][name]
        entry[name][f"launches_radial_c{C_WIDE}"] = launches[C_WIDE][name]
        entry[name]["launches_eigsh"] = launches["eigsh"][name]


def spectral_and_strategy_phases(dev, gen, coeffs: torch.Tensor) -> None:
    """Phases 9d-9e: the half-spectrum stages against the C2C formulation
    at the headline and the Gram geometry, and the plan-free engines
    against the NDFT gates, the binned engine and the dense Gaussian."""
    from torch_nfft_tpu_torch.ops import fft as pfft
    from torch_nfft_tpu_torch.ops.planar import fastsum_spectral_stages

    with Phase("9d half-spectrum stages vs C2C"):
        M_h = int(round(SIGMA * N))
        w_band = pfft.band_filter_half(DIM, N, dev)
        for C in (1, C_WIDE):
            g = torch.randn((1, C) + (M_h,) * DIM, device=dev, generator=gen)

            def half(g=g):
                return pfft.spectral_forward_half(
                    pfft.spectral_adjoint_half(g, DIM, N, M_CUT, SIGMA, WINDOW) * w_band,
                    DIM, N, M_h, M_CUT, SIGMA, WINDOW)

            def c2c(g=g):
                return pfft.spectral_forward(
                    pfft.spectral_adjoint(g, DIM, N, M_CUT, SIGMA, WINDOW), DIM, M_h, M_CUT,
                    SIGMA, WINDOW).real

            rel = rel_l2(half(), c2c())
            t_h, t_c = time_ms(half, 5), time_ms(c2c, 5)
            print(f"headline (3D N={N} M={M_h} {WINDOW} m={M_CUT}) C={C}: rfftn+irfftn "
                  f"{t_h:.3f} ms, ifftn+fftn {t_c:.3f} ms ({t_c / t_h:.2f}x); rel_l2={rel:.3e}")
            steps = (("rfftn", lambda v: pfft.spectral_adjoint_half(
                          v, DIM, N, M_CUT, SIGMA, WINDOW)),
                     ("band filter", lambda h: h * w_band),
                     ("irfftn", lambda h: pfft.spectral_forward_half(
                         h, DIM, N, M_h, M_CUT, SIGMA, WINDOW)))
            print("  by step (CUDA events, median of 5): " + ", ".join(
                f"{name} {ms:.3f} ms" for (name, _), ms in zip(steps, stage_ms(steps, g))))
            assert rel <= 1e-6, f"half vs C2C at the headline, C={C}: {rel:.3e}"
            del g
        M_g = 2 * GRAM_N
        kw = dict(dim=DIM, N=GRAM_N, M=M_g, m=GRAM_M, sigma=2.0, window="gaussian")
        st_h = fastsum_spectral_stages(coeffs, **kw)
        st_c = fastsum_spectral_stages(coeffs, hermitian=False, **kw)
        for C in (1, C_WIDE):
            g = torch.randn((1, C) + (M_g,) * DIM, device=dev, generator=gen)
            rel = rel_l2(run_stages(st_h, g), run_stages(st_c, g))
            t_h = time_ms(lambda: run_stages(st_h, g), 3)
            t_c = time_ms(lambda: run_stages(st_c, g), 3)
            print(f"Gram geometry (3D N={GRAM_N} M={M_g}, interpolated coefficients) C={C}: "
                  f"rfftn+filter+irfftn {t_h:.3f} ms, ifftn+filter+fftn {t_c:.3f} ms "
                  f"({t_c / t_h:.2f}x); rel_l2={rel:.3e}")
            for label, st in (("half", st_h), ("C2C", st_c)):
                print(f"  {label} by stage (CUDA events, median of 5): " + ", ".join(
                    f"{name} {ms:.3f} ms" for (name, _), ms in zip(st, stage_ms(st, g))))
            assert rel <= 1e-6, f"half vs C2C at the Gram geometry, C={C}: {rel:.3e}"
            del g

    with Phase("9e plan-free strategies"):
        for dim, Ng in ((2, 16), (3, 32)):
            binned_y = gate_adjoint(dim, Ng, dev)
            for strategy in ("matmul", "scatter"):
                reset_launches()
                g_err = gate(dim, Ng, dev, strategy)
                rel_b = rel_l2(gate_adjoint(dim, Ng, dev, strategy), binned_y)
                ran = {k: v for k, v in read_launches().items() if v}
                print(f"gate {dim}D N={Ng} by {strategy}: rel_l2={g_err:.3e} against the NDFT, "
                      f"{rel_b:.3e} against binned; kernel launches {ran}")
                assert g_err < 1e-3 and rel_b <= 1e-5 and not ran, \
                    f"{strategy} at {dim}D: {g_err:.3e}, {rel_b:.3e}, {ran}"
        # bench.py's 3D gate inputs through the pair: gradients in x and the
        # points by each engine against the binned engine's
        pos, x = gate_data(3)
        w = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
        grads = {}
        for strategy in ("binned", "matmul", "scatter"):
            xl = torch.from_numpy(x).to(dev).requires_grad_()
            pl = torch.from_numpy(pos).to(dev).requires_grad_()
            z = tp.nfft_pair_planar(xl, pl, None, batch_size=1, N=32, m=M_CUT, sigma=SIGMA,
                                    window=WINDOW, strategy=strategy)
            (z * torch.from_numpy(w).to(dev)).sum().backward()
            grads[strategy] = (xl.grad, pl.grad)
        for strategy in ("matmul", "scatter"):
            rx = rel_l2(grads[strategy][0], grads["binned"][0])
            rp = rel_l2(grads[strategy][1], grads["binned"][1])
            print(f"pair gradients by {strategy} vs binned (3D N=32 n=400): x.grad "
                  f"rel_l2={rx:.3e}, pos.grad rel_l2={rp:.3e}")
            assert rx <= 3e-5 and rp <= 3e-5, f"{strategy} gradients: {rx:.3e}, {rp:.3e}"
        # a small operator does not plan: its matvecs run the plan-free engines
        rng = np.random.default_rng(51)
        p2 = ((rng.random((1500, 2)) * 2 - 1) * 3).astype(np.float32)
        kernel = tp.GaussianKernel(1.0, dim=2, bandwidth=16, cutoff=4)
        G = kernel(p2)
        reset_launches()
        A = G.to_dense()
        ran = {k: v for k, v in read_launches().items() if v}
        src, _ = tp.shift_points_by_center(p2)
        src, _ = tp.scale_points_by_norm(src, factor=1.0, norm=kernel.scale_by_norm)
        err = float((A.double() - tp.exact_gaussian_matrix(1.0, src.double())).abs().max())
        print(f"GramMatrix of 1500 points (GaussianKernel(1.0, dim=2, bandwidth=16, cutoff=4)):"
              f" plans {G._plans()[0] is not None}, kernel launches {ran}; max |G - exact| "
              f"{err:.3e}")
        assert G._plans()[0] is None and not ran and err < 5e-3, \
            f"small Gram: plan {G._plans()[0]}, {ran}, {err:.3e}"


def batched_data(seed: int = 7, log2: int | None = None):
    """examples/bench_batched.py's inputs: n = 2^log2 (BATCH_LOG2) points
    uniform in [-1/4, 1/4)^3, a sorted random batch vector whose first id is
    0 and last BATCH_B - 1, and x (n, BATCH_C), from ``seed``."""
    rng = np.random.default_rng(seed)
    n = 1 << (BATCH_LOG2 if log2 is None else log2)
    pos = (rng.random((n, DIM), dtype=np.float32) - 0.5) / 2.0
    batch = np.sort(rng.integers(0, BATCH_B, n)).astype(np.int32)
    batch[0], batch[-1] = 0, BATCH_B - 1
    x = rng.standard_normal((n, BATCH_C)).astype(np.float32)
    return pos, batch, x


def streamed_pair(layout, x, chunk=None) -> torch.Tensor:
    """The streamed adjoint, then the streamed forward of its spectrum: the
    real plane, (n, C) in the flat layout."""
    yr, yi = tp.nfft_adjoint_streamed(x, layout, column_chunk=chunk)
    return tp.nfft_forward_streamed(yr, yi, layout, column_chunk=chunk)[0]


def culled_kept_share(plan, d) -> float:
    """Share of (point, band) pairs of the culled tensor design ``d`` on
    ``plan`` whose window meets the band's cells on axes 0 (rows in (u, c)
    order) and 1 (columns (v, w)): the pairs its blocks multiply."""
    S, K, H, M, m, C = plan.S, plan.K, plan.H, plan.M, plan.m, d.C
    L = 2 * m + 2
    fl = torch.floor(plan.slot_pos[:2].reshape(2, S, K) * M).to(torch.int64)
    o = torch.remainder(torch.remainder(fl - m, M) - plan.origin.T[:2, :, None].long(), M)
    filled = torch.arange(K, device=o.device)[None] < plan.row_count[:, None]
    o0, o1 = o[0][filled], o[1][filled]
    kept = 0
    for r0 in range(0, C * H, d.R):
        u_lo, u_hi = r0 // C, (min(r0 + d.R, C * H) - 1) // C
        meets_u = (o0 <= u_hi) & (o0 + L > u_lo)
        for p0 in range(0, H * H, d.PB):
            v_lo, v_hi = p0 // H, (min(p0 + d.PB, H * H) - 1) // H
            kept += int((meets_u & (o1 <= v_hi) & (o1 + L > v_lo)).sum())
    return kept / (o0.numel() * d.row_bands * d.col_bands)


def worst_member(got, ref, bounds) -> float:
    """Largest rel-L2 over the members of the flat layout's ranges."""
    return max(rel_l2(got[lo:hi], ref[lo:hi]) for lo, hi in zip(bounds[:-1], bounds[1:]))


def reference_groups(pos_np, batch_np, x, streamed: dict, bounds, group: int, kw: dict):
    """The all-at-once batched adjoint and pair (``nfft_adjoint_planar``,
    ``nfft_pair_planar`` with ``batch_size=group``) over groups of ``group``
    members, against the streamed results in ``streamed`` (``yr``, ``yi``,
    ``zr``; the adjoint's are dropped from it once compared, to make room
    for the pair): (worst member's rel-L2 of the streamed adjoint, of the
    streamed pair, peak bytes of each above what was held, launches of each
    for the first group, the route, seconds)."""
    rel = [0.0, 0.0]
    peaks, launches, route = [0, 0], [None, None], None
    t0 = time.perf_counter()
    plans = {}
    for i in range(2):  # every group's adjoint, then every group's pair
        for g0 in range(0, BATCH_B, group):
            lo, hi = int(bounds[g0]), int(bounds[g0 + group])
            if g0 not in plans:
                plans[g0] = tp.build_plan(pos_np[lo:hi], batch_np[lo:hi] - g0,
                                          batch_size=group, **kw)
            plan = plans[g0]
            route = "dense" if binned.use_fold(plan, BATCH_C, 4, group) else "flat"
            pos_g = torch.from_numpy(pos_np[lo:hi]).to(x.device)
            entry = tp.nfft_adjoint_planar if i == 0 else tp.nfft_pair_planar
            torch.cuda.empty_cache()  # one large grid at a time: no cached fragments
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            out = entry(x[lo:hi], pos_g, None, plan, batch_size=group, **kw)
            torch.cuda.synchronize()
            peaks[i] = max(peaks[i], torch.cuda.max_memory_allocated() - base)
            if launches[i] is None:
                launches[i] = read_launches()
            if i == 0:
                for b in range(group):
                    rel[0] = max(rel[0], rel_l2(
                        torch.complex(streamed["yr"][g0 + b], streamed["yi"][g0 + b]),
                        torch.complex(out[0][b], out[1][b])))
            else:
                rel[1] = max(rel[1], worst_member(streamed["zr"][lo:hi], out,
                                                  bounds[g0:g0 + group + 1] - lo))
            del out, pos_g
        if i == 0:
            del streamed["yr"], streamed["yi"]
    return rel[0], rel[1], peaks, launches, route, time.perf_counter() - t0


def batched_phases(dev, gen, report: list, head_pos: torch.Tensor,
                   gram_pts: torch.Tensor) -> None:
    """Phases 10-10e: the batched configuration of BASELINE.json (3D, 16 members,
    N = 256, m = 4, two columns, n = 2^21) through the streamed transforms,
    held against the direct sum and the all-at-once batched transforms;
    the streamed fastsum; saved plans; debug validation,
    the card's float32 pipeline floor and the window suggestion. Saved
    plans run on the Gram plan of ``gram_pts`` (phase 8's points),
    ``validate_inputs`` on the headline points ``head_pos``. Adds each
    kernel's launches per streamed pair and per reference run to
    ``report``."""
    from torch_nfft_tpu_torch.ops import fft as pfft
    from torch_nfft_tpu_torch.ops import window as pwindow
    from torch_nfft_tpu_torch.utils.debug import debug_enabled, validate_inputs

    entry = {r["name"]: r for r in report}
    pos_np, batch_np, x_np = batched_data()
    n = pos_np.shape[0]
    x = torch.from_numpy(x_np).to(dev)
    kw = dict(N=BATCH_N, m=BATCH_M, sigma=2.0, window="gaussian")

    with Phase("10 streamed layout"):
        tp.clear_plan_cache()
        torch.cuda.empty_cache()
        print(f"held on the card before the batched phases: "
              f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
        t0 = time.perf_counter()
        pos_stack, _, counts, member_bounds = tp.split_by_batch(pos_np, None, batch_np, BATCH_B)
        t_split = time.perf_counter() - t0
        t0 = time.perf_counter()
        plans = tp.build_plan_stack(pos_stack, **kw)
        torch.cuda.synchronize()
        t_stack = time.perf_counter() - t0
        rows = (plans.row_count > 0).sum(1).tolist()
        print(f"split_by_batch in {t_split:.3f} s: n=2^{BATCH_LOG2} into {BATCH_B} members of "
              f"{counts.min()}-{counts.max()} points, n_max={pos_stack.shape[1]}; {BATCH_B} host "
              f"plans and the stack in {t_stack:.3f} s: S={plans.slot_pt.shape[1]} (filled rows "
              f"{min(rows)}-{max(rows)}) K={plans.K} T={plans.T} H={plans.H} "
              f"M={plans.M} active={plans.active}")
        del plans, pos_stack
        t0 = time.perf_counter()
        layout = tp.make_streamed_layout(pos_np, batch_np, batch_size=BATCH_B, **kw)
        torch.cuda.synchronize()
        t_layout = time.perf_counter() - t0
        plan0 = tp.index_plan(layout.plans, 0)
        dense = {C: tile_array_bytes(plan0, C, 4, 1) for C in (BATCH_C, 2 * BATCH_C)}
        print(f"make_streamed_layout end to end in {t_layout:.3f} s; a member's dense tile "
              f"array {dense[BATCH_C] / 1e9:.3f} GB at C={BATCH_C} (the adjoint), "
              f"{dense[2 * BATCH_C] / 1e9:.3f} GB at {2 * BATCH_C} columns (the forward's two "
              f"planes), budget {FOLD_BUDGET / 1e9:.3f} GB: "
              f"{'dense' if binned.use_fold(plan0, 2 * BATCH_C, 4, 1) else 'flat'} route")
        assert binned.use_fold(plan0, 2 * BATCH_C, 4, 1), "a member must take the dense route"

    with Phase("10a streamed pair"):
        # B1 and B2 at member 0's shapes against their plain versions: the
        # C columns of nfft_pair_streamed (the cell's path), and B2 at the
        # 2C columns of the composition's forward (its two planes)
        vals = slot_values(plan0, layout.pack(x)[0])
        tid_s, tid = dense_tile_ids(plan0), row_tile_ids(plan0)
        tiles = {C: unfold_grid_to_tiles(torch.randn((1, C) + (plan0.M,) * DIM, device=dev,
                                                     generator=gen), plan0)
                 for C in (BATCH_C, 2 * BATCH_C)}
        checks = [("spread_tiles_dense", BATCH_C,
                   lambda: contract.spread_tiles_dense(plan0, vals, tid_s, plan0.NT),
                   lambda: contract.spread_tiles_dense_plain(plan0, vals, tid_s, plan0.NT))]
        checks += [("gather_points", C, lambda t=tiles[C]: contract.gather_points(plan0, t, tid),
                    lambda t=tiles[C]: contract.gather_points_plain(plan0, t, tid))
                   for C in (BATCH_C, 2 * BATCH_C)]
        for name, C, kern, plain in checks:
            reset_launches()
            got = kern()
            design = read_designs().get(name)
            ref = plain()
            mx, rl = float((got - ref).abs().max()), rel_l2_rows(got, ref)
            same = torch.equal(kern(), got)
            del got, ref
            ms = time_ms(kern, 5)
            ran = "" if design is None else f"; design {design}"
            print(f"{name} C={C} at member 0 (S={plan0.S}, K={plan0.K}, T={plan0.T}, "
                  f"H={plan0.H}): kernel vs plain max_abs={mx:.3e} rel_l2={rl:.3e}; two launches "
                  f"bitwise equal: {same}{ran}; {ms:.4f} ms")
            # the wide spread design sums by float atomics: no bitwise repeat;
            # every other design (the member's B1: tensor, culled) repeats
            must_repeat = design is None or design.get("wide", 0) == 0
            assert rl <= 1e-5 and (same or not must_repeat), \
                f"{name} C={C} at member 0: {rl:.3e}, repeat {same}"
            entry[name]["max_abs_err"] = max(entry[name]["max_abs_err"], mx)
            key = "batched_member" if C == BATCH_C else "batched_member_2c"
            entry[name][key] = {"C": C, "ms": ms, "max_abs_err": mx}
        # B1 at member 0's plan three ways, each with its fill: the wide
        # design (global atomics: 2 x 41^3 floats exceed shared memory), the
        # tensor design unculled, and the rule's, culled, beside the bound
        # and the share of (point, band) pairs the culled bands keep
        culled = contract.spread_design(DIM, plan0.H, plan0.m, BATCH_C)
        assert culled.name == "tensor" and culled.cull, \
            f"a member's B1 must take the culled tensor design, not {culled}"
        b1_bound = bounds(plan0, BATCH_C, plan0.S)[0][0]
        three = {"wide": contract.spread_design(DIM, plan0.H, plan0.m, BATCH_C, name="wide"),
                 "tensor unculled": contract.spread_design(DIM, plan0.H, plan0.m, BATCH_C,
                                                           name="tensor", cull=False),
                 "tensor culled": culled}
        times = {label: time_ms(lambda d=d: contract.spread_tiles_dense(
            plan0, vals, tid_s, plan0.NT, design=d), 5) for label, d in three.items()}
        kept = culled_kept_share(plan0, culled)
        print(f"B1 C={BATCH_C} at member 0, with its fill (bound {b1_bound:.4f} ms): "
              + "; ".join(f"{k} {ms:.4f} ms ({b1_bound / ms:.1%} of bound)"
                          for k, ms in times.items())
              + f"; the culled bands ({culled.row_bands} x {culled.col_bands} of {culled.R} rows "
              f"by {culled.PB} columns) keep {kept:.2%} of (point, band) pairs")
        entry["spread_tiles_dense"]["batched_member_designs"] = {**times, "kept_share": kept}
        del vals, tiles
        # the fold at C columns; the unfold at the pair's C and at the
        # composition forward's 2C
        for name, C in ((TILE_MOVES[0], BATCH_C), (TILE_MOVES[1], BATCH_C),
                        (TILE_MOVES[1], 2 * BATCH_C)):
            print("at member 0: ", end="")
            key = "batched_member" if C == BATCH_C else "batched_member_2c"
            entry[name][key] = tile_move_check(name, plan0, C, dev, gen)
        # one member's pass by stage: what nfft_pair_streamed runs for it
        # (nfft_pair_planar's stages: half spectra, the band filter inside
        # irfftn), and what the composition's nfft_adjoint_planar and
        # nfft_forward_planar run for it
        sk = dict(m=BATCH_M, sigma=2.0, window="gaussian")
        assert binned.use_fold(plan0, BATCH_C, 4, 1), "the pair's member must take the dense route"
        route0 = binned.TileRoute(plan0, "dense")
        tables = (
            ("nfft_pair_streamed", pair_stages(plan0, N=BATCH_N, C=BATCH_C, **sk)),
            ("the composition", route0.spreading
             + (("rfftn + mirror", lambda g: pfft.half_spectrum_to_full(
                 pfft.spectral_adjoint_half(g, DIM, BATCH_N, **sk), DIM, BATCH_N)),
                ("fftn (C2C)", lambda y: pfft.spectral_forward(y, DIM, plan0.M, **sk)),
                ("two planes", lambda g: torch.cat([g.real, g.imag], dim=1)))
             + route0.gathering))
        for label, stages in tables:
            med = stage_ms(stages, layout.pack(x)[0])
            print(f"member 0's pass in {label} by stage, C={BATCH_C}, ms (CUDA events, "
                  f"median of 5):")
            for (name, _), ms in zip(stages, med):
                print(f"  {name:16s} {ms:9.3f} ms  {ms / med.sum():6.1%}")
            print(f"  {'sum':16s} {med.sum():9.3f} ms; x {BATCH_B} members = "
                  f"{BATCH_B * med.sum() / 1e3:.4f} s")
        # the pair and the composition on the same layout: time, peak and
        # launches of one call each (counters set to 0 just before it)
        calls = (("nfft_pair_streamed", None, lambda: tp.nfft_pair_streamed(x, layout)),
                 ("composition", None, lambda: streamed_pair(layout, x)),
                 ("composition", 1, lambda: streamed_pair(layout, x, 1)))
        launches, peaks, zr = {}, {}, {}
        for label, chunk, fn in calls:
            _, t_pair = host_median(fn, 3)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            before = tp.trace.counters()["streamed_members"]
            zr[label, chunk] = fn()
            torch.cuda.synchronize()
            members = tp.trace.counters()["streamed_members"] - before
            launches[label, chunk] = read_launches()
            peaks[label, chunk] = torch.cuda.max_memory_allocated() - base
            ran = {k: v for k, v in launches[label, chunk].items() if v}
            print(f"{label}, column_chunk={chunk}: {t_pair:.4f} s (median of 3 after a warm-up, "
                  f"host clock to synchronize) = {n / t_pair / 1e6:.3f} M points/s; peak "
                  f"{peaks[label, chunk] / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB held; "
                  f"{members} member passes; launches {ran}")
            # the pair runs each member once at C columns; the composition
            # runs two passes a member (adjoint, forward) per column chunk
            per = BATCH_B * (1 if chunk is None else BATCH_C)
            passes = per * (1 if label == "nfft_pair_streamed" else 2)
            assert ran == {k: per for k in ("spread_tiles_dense", "gather_points", *TILE_MOVES)} \
                and members == passes, \
                f"{label} launched {ran} in {members} passes, not B1, B2, fold and unfold " \
                f"{per} times each in {passes}"
        zp = zr["nfft_pair_streamed", None]
        rel_c = rel_l2(zr["composition", 1], zr["composition", None])
        rel_p = rel_l2(zp, zr["composition", None])
        print(f"composition column_chunk=1 vs whole: rel_l2={rel_c:.3e}; nfft_pair_streamed vs "
              f"the composition: rel_l2={rel_p:.3e}")
        assert rel_c <= 1e-5 and rel_p <= 1e-5, \
            f"column chunks disagree: {rel_c:.3e}; pair vs composition: {rel_p:.3e}"
        zr, pair_peak = zp, peaks["nfft_pair_streamed", None]
        for name in KERNELS:
            entry[name]["launches_streamed_pair"] = launches["nfft_pair_streamed", None][name]
            entry[name]["launches_streamed_composition"] = launches["composition", None][name]
            entry[name]["launches_streamed_composition_chunk1"] = launches["composition", 1][name]
        del zp

    with Phase("10b streamed vs direct sum and all-at-once"):
        yr, yi = tp.nfft_adjoint_streamed(x, layout)
        rng = np.random.default_rng(11)
        k = rng.integers(-(BATCH_N // 2), BATCH_N // 2, size=(96, DIM))
        idx = (0,) + tuple(torch.as_tensor(k[:, d] + BATCH_N // 2, device=dev)
                           for d in range(DIM))
        p0 = torch.from_numpy(pos_np[member_bounds[0]:member_bounds[1]]).to(dev)
        for col in range(BATCH_C):
            got = torch.complex(yr[idx + (col,)], yi[idx + (col,)]).to(torch.complex128)
            rel = rel_l2(got, direct_adjoint_sum(p0, x[member_bounds[0]:member_bounds[1], col], k))
            print(f"member 0 column {col}, streamed adjoint at 96 sampled frequencies vs the "
                  f"direct sum in float64: rel_l2={rel:.3e}")
            assert rel <= 1e-3, f"member 0 column {col}: {rel:.3e}"
        streamed = dict(yr=yr, yi=yi, zr=zr)
        del yr, yi
        try:
            res, group = reference_groups(pos_np, batch_np, x, streamed, member_bounds, BATCH_B,
                                          kw), BATCH_B
        except torch.OutOfMemoryError as exc:
            oom = str(exc).split(". ")[0]
        else:
            oom = None
        if oom is not None:  # after the except block: its frames are gone
            print(f"the all-at-once batch of {BATCH_B} does not fit on the card ({oom}); "
                  f"comparing against groups of {BATCH_GROUP} members instead")
            torch.cuda.empty_cache()
            streamed = dict(zr=zr)
            streamed["yr"], streamed["yi"] = tp.nfft_adjoint_streamed(x, layout)
            res, group = reference_groups(pos_np, batch_np, x, streamed, member_bounds, BATCH_GROUP,
                                          kw), BATCH_GROUP
        rel_a, rel_p, peaks_r, launches_r, route, t_ref = res
        what = "all at once" if group == BATCH_B else f"in groups of {group}"
        print(f"batched reference {what} (batch_size={group}, {route} route) in {t_ref:.3f} s: "
              f"adjoint peak {peaks_r[0] / 2**30:.3f} GiB, launches "
              f"{ {k: v for k, v in launches_r[0].items() if v} }; pair peak "
              f"{peaks_r[1] / 2**30:.3f} GiB, launches "
              f"{ {k: v for k, v in launches_r[1].items() if v} } (nfft_pair_streamed's peak "
              f"{pair_peak / 2**30:.3f} GiB); worst member rel_l2: streamed adjoint "
              f"{rel_a:.3e}, nfft_pair_streamed {rel_p:.3e}")
        assert rel_a <= 1e-5 and rel_p <= 1e-5, \
            f"streamed vs batched: adjoint {rel_a:.3e}, pair {rel_p:.3e}"
        for name in KERNELS:
            entry[name]["launches_batched_ref_adjoint"] = launches_r[0][name]
            entry[name]["launches_batched_ref_pair"] = launches_r[1][name]
        del streamed, zr

    with Phase("10c streamed fastsum"):
        coeffs = tp.gaussian_analytic_coeffs(FASTSUM_WIDTH, dim=DIM, N=BATCH_N)
        t_pos, t_batch, _ = batched_data(seed=8, log2=FASTSUM_TARGETS_LOG2)
        t0 = time.perf_counter()
        t_layout = tp.make_streamed_layout(t_pos, t_batch, batch_size=BATCH_B, **kw)
        torch.cuda.synchronize()
        t_tl = time.perf_counter() - t0
        t_bounds = np.searchsorted(t_batch, np.arange(BATCH_B + 1))
        sample = np.random.default_rng(13)
        for label, tl, tpos, tb in (("symmetric", None, pos_np, member_bounds),
                                    (f"asymmetric (2^{FASTSUM_TARGETS_LOG2} targets)", t_layout,
                                     t_pos, t_bounds)):
            y, t_fs = host_median(lambda: tp.nfft_fastsum_streamed(x, coeffs, layout, tl), 3)
            reset_launches()
            y = tp.nfft_fastsum_streamed(x, coeffs, layout, tl)
            torch.cuda.synchronize()
            launches_fs = read_launches()
            ran = {k: v for k, v in launches_fs.items() if v}
            pick = sample.choice(tb[1] - tb[0], 96, replace=False)
            tgt = torch.from_numpy(tpos[tb[0] + pick]).to(dev)
            ref = exact_gauss_sum(p0, tgt, x[member_bounds[0]:member_bounds[1]], FASTSUM_WIDTH)
            rel = rel_l2(y[torch.as_tensor(tb[0] + pick, device=dev)], ref)
            print(f"streamed fastsum {label}, exp(-r^2/{FASTSUM_WIDTH}^2) by "
                  f"gaussian_analytic_coeffs at N={BATCH_N}, C={BATCH_C}: {t_fs:.4f} s (median "
                  f"of 3); launches {ran}; member 0 at 96 sampled targets vs the exact Gaussian "
                  f"sum in float64: rel_l2={rel:.3e}")
            assert rel <= 1e-3, f"streamed fastsum {label}: {rel:.3e}"
            assert ran == {k: BATCH_B for k in ("spread_tiles_dense", "gather_points",
                                                *TILE_MOVES)}, \
                f"the streamed fastsum launched {ran}"
            if tl is None:
                for name in KERNELS:
                    entry[name]["launches_streamed_fastsum"] = launches_fs[name]
            del y
        print(f"target layout built in {t_tl:.3f} s")
        del t_layout, layout, plan0, p0

    with Phase("10d saved plans"):
        # the Gram plan (2^22 points), not the headline's: np.savez_compressed
        # took 32.7 s for the headline plan with its Benes tables (389 MB;
        # load 5.5 s against a 5.4 s host build and 9.3 s of cold routing),
        # over the 30 s this phase allows a save
        t0 = time.perf_counter()
        G = tp.GaussianKernel(GRAM_SIGMA, dim=DIM, bandwidth=GRAM_N, cutoff=GRAM_M)(gram_pts)
        plan_h = G._plans()[0]
        torch.cuda.synchronize()
        t_host = time.perf_counter() - t0
        os.environ.pop(benes.CACHE_ENV, None)  # cold: no routing cache
        t0 = time.perf_counter()
        plan_b = plan_h.with_benes_tables()
        torch.cuda.synchronize()
        t_route = time.perf_counter() - t0
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
            path = os.path.join(tmp, "gram_plan.npz")
            t0 = time.perf_counter()
            tp.save_plan(path, plan_b)
            t_save = time.perf_counter() - t0
            size = os.path.getsize(path)
            t0 = time.perf_counter()
            loaded = tp.load_plan(path)
            torch.cuda.synchronize()
            t_load = time.perf_counter() - t0
        print(f"Gram host plan with Benes tables (n=2^{GRAM_LOG2}, S={plan_b.S}, K={plan_b.K}, "
              f"T={plan_b.T}, q={plan_b.benes.q}): save_plan {t_save:.3f} s, {size / 1e6:.1f} MB; "
              f"load_plan {t_load:.3f} s, onto {loaded.device}; the Gram operator and its host "
              f"plan took {t_host:.3f} s, the cold routing {t_route:.3f} s")
        assert t_save <= SAVE_S_MAX, f"save_plan took {t_save:.1f} s"
        assert loaded.device == dev and loaded.benes.bits.device == dev, "not loaded on the card"
        for name in ("slot_pt", "slot_pos", "origin", "row_batch", "fill_keys", "row_count"):
            assert torch.equal(getattr(loaded, name), getattr(plan_b, name)), name
        for name in ("n", "T", "K", "window", "active", "pos_fp", "S_occ"):
            assert getattr(loaded, name) == getattr(plan_b, name), name
        assert np.array_equal(loaded.order, plan_b.order) and torch.equal(
            loaded.benes.bits, plan_b.benes.bits), "host order or Benes bits differ"
        kwg = dict(batch_size=1, N=GRAM_N, m=GRAM_M, sigma=2.0, window="gaussian")
        xg = torch.randn((plan_b.n, 1), device=dev, generator=gen)
        for label, a, b in (("Benes", loaded, plan_b),
                            ("sort", dataclasses.replace(loaded, benes=None), plan_h)):
            reset_launches()
            got = tp.nfft_pair_planar(xg, G.sources, None, a, **kwg)
            design = read_designs()["spread_tiles_dense"]
            same = torch.equal(got, tp.nfft_pair_planar(xg, G.sources, None, b, **kwg))
            print(f"Gram-geometry pair on the {label} route, loaded plan vs the original: "
                  f"bitwise equal: {same} (B1 design {design})")
            assert same, f"the loaded plan's {label}-route pair differs"
        del loaded, G, plan_h, plan_b, xg, got

    with Phase("10e debug, pipeline floor and window suggestion"):
        os.environ["TORCH_NFFT_TPU_DEBUG"] = "1"
        try:
            assert debug_enabled()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            validate_inputs(head_pos, None, 1)
            t_val = time.perf_counter() - t0
            bad = head_pos[:4096].clone()
            bad[5, 0] = float("nan")
            try:
                validate_inputs(bad)
                raised = False
            except ValueError:
                raised = True
        finally:
            del os.environ["TORCH_NFFT_TPU_DEBUG"]
        print(f"validate_inputs on the headline points (2^{N_LOG2}, on the card): {t_val:.4f} s; "
              f"a NaN position raises: {raised}")
        assert raised, "validate_inputs passed a NaN position"
        errs = {(w, m): gate(DIM, 32, dev, m=m, sigma=2.0, window=w)
                for w in ("es", "kb") for m in (6, 7, 8)}
        floor = max(errs.values())
        print("float32 pipeline floor, 3D N=32 gate vs the NDFT in float64, sigma=2: " + ", ".join(
            f"{w} m={m} {e:.3e}" for (w, m), e in errs.items())
            + f"; max {floor:.3e} (window.F32_PIPELINE_FLOOR = {pwindow.F32_PIPELINE_FLOOR:g})")
        assert floor <= pwindow.F32_PIPELINE_FLOOR, \
            f"measured floor {floor:.3e} above F32_PIPELINE_FLOOR"
        for tol in (1e-3, 1e-4, 1e-5):
            p = tp.suggest_window_parameters(tol)
            meas = gate(DIM, 32, dev, m=p["m"], sigma=p["sigma"], window=p["window"])
            print(f"suggest_window_parameters({tol:g}): window {p['window']} m={p['m']} "
                  f"sigma={p['sigma']}, predicted {p['predicted_rel_l2']:.3e}, measured "
                  f"{meas:.3e} (3D N=32 gate)")
            assert meas <= p["predicted_rel_l2"] <= tol, f"tol {tol:g}: {p}, measured {meas:.3e}"


# ---------------------------------------------------------------------------
# Phases 11-11d: the parallel package over torch.distributed at the Gram
# geometry. World 1 runs in this process on NCCL; four ranks share the one
# card over gloo in spawned processes (NCCL refuses two ranks on one card),
# each making its data from the seeds itself.
# ---------------------------------------------------------------------------


def shard_config() -> dict:
    """What the spawned ranks need of this module's settings."""
    return dict(device=None, backend="nccl", ranks="shared", log2=GRAM_LOG2, N=GRAM_N,
                m=GRAM_M, width=GRAM_SIGMA, T=GRID_T, train_b=TRAIN_B,
                timeout=SHARD_TIMEOUT_S)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def gram_sharded_data(cfg: dict, dev):
    """The Gram cell (phase 8's points, seed 41, scaled by the kernel) with
    its coefficients and kernel width, and values x (n, 1) from seed 43."""
    n = 1 << cfg["log2"]
    pts = torch.from_numpy(np.random.default_rng(41).random((n, DIM), dtype=np.float32)
                           * 2 - 1).to(dev)
    kernel = tp.GaussianKernel(cfg["width"], dim=DIM, bandwidth=cfg["N"], cutoff=cfg["m"],
                               device=dev)
    src = kernel(pts).sources
    x1 = torch.from_numpy(np.random.default_rng(43).standard_normal((n, 1))
                          .astype(np.float32)).to(dev)
    return kernel, src, x1


def train_data(cfg: dict, src: torch.Tensor):
    """The training cell: the Gram points as train_b sets, targets from seed 44."""
    pos = src.reshape(cfg["train_b"], -1, DIM)
    y = np.random.default_rng(44).standard_normal(pos.shape[:2] + (1,)).astype(np.float32)
    return pos, torch.from_numpy(y).to(src.device)


def grid_data(cfg: dict, dev):
    """The grid-sharded cell: 2^log2 points uniform in [-1/2, 1/2)^3 and
    values from seed 45, a planar spectrum (1, N^3, 1) from seed 46."""
    n = 1 << cfg["log2"]
    rng = np.random.default_rng(45)
    pos = rng.random((n, DIM), dtype=np.float32) - 0.5
    x = torch.from_numpy(rng.standard_normal((n, 1)).astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(46)
    shape = (1,) + (cfg["N"],) * DIM + (1,)
    sr = torch.randn(shape, generator=gen, device=dev)
    si = torch.randn(shape, generator=gen, device=dev)
    return pos, x, sr, si


def grid_calls(par, lay, mesh, x, sr, si, coeffs) -> dict:
    """The grid-sharded transforms of phase 11d by name."""
    return {
        "adjoint": lambda: par.nfft_adjoint_grid_sharded(x, lay, mesh),
        "forward": lambda: par.nfft_forward_grid_sharded(sr, si, lay, mesh),
        "forward_real": lambda: par.nfft_forward_grid_sharded(sr, si, lay, mesh,
                                                              real_output=True)[0],
        "fastsum": lambda: par.nfft_fastsum_grid_sharded(x, coeffs, lay, mesh),
    }


def _flat(t) -> torch.Tensor:
    """A result (a tensor, or planes side by side) as one tensor."""
    return torch.cat([u.reshape(-1) for u in t]) if isinstance(t, tuple) else t.reshape(-1)


def grid_phase(par, cfg: dict, dev, lay, mesh, refs: dict, coeffs) -> dict:
    """Each grid-sharded transform on this rank: launches, median seconds,
    rel-L2 against the single-device planar reference."""
    pos, x, sr, si = grid_data(cfg, dev)
    out = {}
    for name, fn in grid_calls(par, lay, mesh, x, sr, si, coeffs).items():
        fn()
        torch.cuda.synchronize()
        reset_launches()
        got = fn()
        torch.cuda.synchronize()
        launches = read_launches()
        got, t = host_median(fn)
        out[name] = dict(s=t, launches=launches,
                         rel=rel_l2(_flat(got), refs[name].to(dev)))
        del got
    return out


def shard_rank(rank: int, world: int, port: int, tmpdir: str, cfg: dict) -> None:
    """One of ``world`` ranks: gloo ranks sharing the card, or with
    ``cfg["ranks"] == "cards"`` NCCL ranks on a card each
    (tools/shard_cards.py). Phase 11c (the point-sharded fastsum, its
    gradient, the all-reduce of the grid, the train step on data 2 x points
    world/2) and phase 11d (the grid-sharded transforms on world slabs).
    Writes its readings to ``tmpdir/rank<r>.json``."""
    import datetime
    import traceback

    import torch.distributed as dist

    from torch_nfft_tpu_torch import parallel as par
    from torch_nfft_tpu_torch.parallel import _comm

    cards = cfg["ranks"] == "cards"
    dev = tp.resolve_device(f"cuda:{rank}" if cards else cfg["device"])
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if cards else "gloo",
                            init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=cfg["timeout"]))
    res = {}
    try:
        mesh = par.make_mesh({"points": world}, device_type=dev.type)
        kernel, src, x1 = gram_sharded_data(cfg, dev)
        coeffs = kernel.coeffs
        t0 = time.perf_counter()
        plans = par.build_sharded_plans(src, n_shards=world, N=cfg["N"], m=cfg["m"],
                                        sigma=2.0, window="gaussian", device=dev)
        res["plans_s"] = time.perf_counter() - t0

        def fastsum(x):
            return par.nfft_fastsum_sharded(x, coeffs, src, cutoff=cfg["m"], mesh=mesh,
                                            sigma=2.0, window="gaussian", source_plans=plans,
                                            target_plans=plans)

        fastsum(x1)
        torch.cuda.synchronize()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        y = fastsum(x1)
        torch.cuda.synchronize()
        res["fastsum_launches"] = read_launches()
        y, res["fastsum_s"] = host_median(lambda: fastsum(x1))
        res["fastsum_rel"] = rel_l2(y, torch.load(os.path.join(tmpdir, "y1.pt")).to(dev))
        del y
        xg = x1.clone().requires_grad_()
        (fastsum(xg) ** 2).sum().backward()
        res["grad_rel"] = rel_l2(xg.grad, torch.load(os.path.join(tmpdir, "g1.pt")).to(dev))
        del xg
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        free, total = torch.cuda.mem_get_info()
        res["device_used_gib"] = (total - free) / 2**30
        grid = torch.zeros((1, 1) + (2 * cfg["N"],) * DIM, device=dev)
        group = mesh.get_group("points")
        _, res["allreduce_s"] = host_median(lambda: _comm.all_reduce_(grid, group))
        res["allreduce_bytes"] = grid.numel() * 4
        del grid, plans

        mesh2 = par.make_mesh({"data": 2, "points": world // 2}, device_type=dev.type)
        pos_t, y_t = train_data(cfg, src)
        lr = float(torch.load(os.path.join(tmpdir, "lr.pt")))
        step, shard = par.make_fastsum_train_step(
            mesh2, coeffs, batch_size=cfg["train_b"], n_per_set=pos_t.shape[1], cutoff=cfg["m"],
            learning_rate=lr, sigma=2.0, strategy="binned", window="gaussian")
        pos_l, y_l = shard(pos_t), shard(y_t)
        w1, loss0 = step(torch.zeros_like(y_l), pos_l, y_l)
        res["train_rel"] = rel_l2(w1, shard(torch.load(os.path.join(tmpdir, "w1.pt"))))
        res["train_loss0"] = float(loss0)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(w1, pos_l, y_l)
        torch.cuda.synchronize()
        res["train_step_s"] = time.perf_counter() - t0
        res["train_launches"] = read_launches()
        del step, pos_l, y_l, w1, src, x1
        torch.cuda.empty_cache()

        gmesh = par.make_mesh({"grid": world}, device_type=dev.type)
        t0 = time.perf_counter()
        lay = par.build_grid_sharded_layout(grid_data(cfg, dev)[0], n_shards=world,
                                            N=cfg["N"], m=cfg["m"], T=cfg["T"], device=dev)
        res["layout_s"] = time.perf_counter() - t0
        res["layout"] = dict(n_loc=int(lay.pos_stack.shape[1]), A0_loc=lay.A0_loc, NT=lay.NT,
                             S=int(lay.plans.S), K=lay.plans.K)
        refs = {k: torch.load(os.path.join(tmpdir, f"ref_{k}.pt"))
                for k in ("adjoint", "forward", "forward_real", "fastsum")}
        res["grid"] = grid_phase(par, cfg, dev, lay, gmesh, refs, coeffs)
        with open(os.path.join(tmpdir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
        dist.barrier()
    except BaseException:
        with open(os.path.join(tmpdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def shard_phases(dev, report: list, cfg: dict | None = None) -> None:
    """Phases 11-11d: the kernels at a grid slab's local tile space against
    their plain versions; the point-sharded fastsum, adjoint and forward and
    the training step on one NCCL rank against the single-device entry
    points; the grid-sharded transforms on one NCCL rank; then four gloo
    ranks on the card: the point-sharded fastsum and its gradient against
    world 1, the train step against world 1's first update, the
    grid-sharded transforms against the single-device planar transforms.
    Adds each kernel's launches on these paths to ``report``."""
    import datetime
    import multiprocessing as mp
    import shutil

    import torch.distributed as dist

    from torch_nfft_tpu_torch import parallel as par
    from torch_nfft_tpu_torch.parallel import grid_sharded as gs

    cfg = dict(shard_config(), **(cfg or {}))
    entry = {r["name"]: r for r in report}
    N, m, P = cfg["N"], cfg["m"], SHARD_P
    tmpdir = tempfile.mkdtemp(prefix="chip_smoke_shard_")
    try:
        with Phase("11 kernels vs plain at a slab's tile space"):
            pos_g, x_g, _, _ = grid_data(cfg, dev)
            t0 = time.perf_counter()
            lay = par.build_grid_sharded_layout(pos_g, n_shards=P, N=N, m=m, T=cfg["T"],
                                                device=dev)
            t_lay = time.perf_counter() - t0
            print(f"grid-sharded layout of 2^{cfg['log2']} points in [-1/2, 1/2)^3 on {P} slabs "
                  f"built in {t_lay:.3f} s: n_loc={lay.pos_stack.shape[1]} A0_loc={lay.A0_loc} "
                  f"NT={lay.NT} rows (padded)={lay.plans.S} K={lay.plans.K} T={lay.T}")
            gen = torch.Generator(device=dev).manual_seed(47)
            for pad in (0, 300):
                plan = tp.index_plan(lay.plans, 1)
                plan = tp.pad_plan_rows(plan, plan.S + pad) if pad else plan
                tid = gs._local_tile_ids(plan, lay.A0_loc, 1)
                idx = lay.point_index[1].long()
                xs = torch.cat([x_g, x_g.new_zeros((1, 1))]).index_select(0, idx)
                vals = slot_values(plan, xs)
                tiles = torch.randn((lay.NT, 1, plan.H, plan.H ** 2), generator=gen, device=dev)
                pl = lay.pos_stack[1].clone().requires_grad_()
                reset_launches()
                (binned.dense_tiles_local(lay.NT, plan, xs, pl, tid) * tiles).sum().backward()
                torch.cuda.synchronize()
                assert read_launches()["pos_grad"] == 1, "dense_tiles_local's backward ran no B5"
                dp = contract.pos_grad_plain(plan, tiles, vals, tid)
                dp = unslot_values(plan, dp.transpose(1, 2).reshape(-1, DIM))
                checks = (
                    ("spread_tiles_dense",
                     lambda: contract.spread_tiles_dense(plan, vals, tid, lay.NT),
                     lambda: contract.spread_tiles_dense_plain(plan, vals, tid, lay.NT)),
                    ("gather_points", lambda: contract.gather_points(plan, tiles, tid),
                     lambda: contract.gather_points_plain(plan, tiles, tid)),
                    ("pos_grad", lambda: pl.grad, lambda: dp))
                for name, kern, plain in checks:
                    got, ref = kern(), plain()
                    mx, rl = float((got - ref).abs().max()), rel_l2_rows(got, ref)
                    ms = time_ms(kern, 5) if name != "pos_grad" else None
                    print(f"{name} at slab 1's local tiles (rows padded by {pad}): kernel vs "
                          f"plain max_abs={mx:.3e} rel_l2={rl:.3e}"
                          + ("" if ms is None else f"; {ms:.4f} ms"))
                    assert rl <= 1e-5, f"{name} at the slab's tiles, pad {pad}: {rl:.3e}"
                    entry[name]["max_abs_err"] = max(entry[name]["max_abs_err"], mx)
                    if ms is not None and not pad:
                        entry[name]["slab_ms"] = ms
                del vals, tiles, pl, dp, xs
            del lay, pos_g, x_g

        torch.cuda.set_device(dev)
        dist.init_process_group(cfg["backend"], init_method=f"tcp://localhost:{free_port()}",
                                rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=cfg["timeout"]))
        try:
            shard_world_of_one(par, cfg, dev, entry, tmpdir)
        finally:
            dist.destroy_process_group()
        torch.cuda.empty_cache()

        where = "NCCL ranks, a card each" if cfg["ranks"] == "cards" else \
            "gloo ranks on the card"
        with Phase(f"11c-11d {P} {where}"):
            ctx = mp.get_context("spawn")
            port = free_port()
            procs = [ctx.Process(target=shard_rank, args=(r, P, port, tmpdir, cfg))
                     for r in range(P)]
            for proc in procs:
                proc.start()
            deadline = time.monotonic() + SHARD_JOIN_S
            for proc in procs:
                proc.join(max(1.0, deadline - time.monotonic()))
            hung = [r for r, proc in enumerate(procs) if proc.is_alive()]
            for proc in procs:
                if proc.is_alive():
                    proc.terminate()
                    proc.join(30)
            errs = "".join(open(os.path.join(tmpdir, f), encoding="utf-8").read()
                           for f in sorted(os.listdir(tmpdir)) if f.endswith(".err"))
            codes = [proc.exitcode for proc in procs]
            assert not hung and all(c == 0 for c in codes), \
                f"the {P}-rank world failed: exit codes {codes}, past the deadline {hung}\n{errs}"
            ranks = []
            for r in range(P):
                with open(os.path.join(tmpdir, f"rank{r}.json"), encoding="utf-8") as f:
                    ranks.append(json.load(f))
            report_ranks(ranks, entry, cfg["ranks"] == "cards")
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def shard_world_of_one(par, cfg: dict, dev, entry: dict, tmpdir: str) -> None:
    """Phases 11a, 11b and 11d's world of one, on one NCCL rank; saves what
    the four ranks are held to into ``tmpdir``."""
    n, N, m = 1 << cfg["log2"], cfg["N"], cfg["m"]
    kw = dict(sigma=2.0, window="gaussian")
    dk = dict(kw, device=dev)
    mesh = par.make_mesh({"data": 1, "points": 1}, device_type=cfg["device"])
    with Phase("11a point-sharded transforms, one NCCL rank"):
        kernel, src, x1 = gram_sharded_data(cfg, dev)
        coeffs, width = kernel.coeffs, kernel.factor * kernel.sigma
        x8 = torch.from_numpy(np.random.default_rng(48).standard_normal((n, C_WIDE))
                              .astype(np.float32)).to(dev)
        t0 = time.perf_counter()
        plans = par.build_sharded_plans(src, n_shards=1, N=N, m=m, **dk)
        torch.cuda.synchronize()
        member = tp.index_plan(plans, 0)
        print(f"build_sharded_plans(n_shards=1) in {time.perf_counter() - t0:.3f} s: "
              f"rows={member.S} K={member.K} T={member.T}")
        for C, xv in ((1, x1), (C_WIDE, x8)):
            def sharded(x=xv):
                return par.nfft_fastsum_sharded(x, coeffs, src, cutoff=m, mesh=mesh,
                                                source_plans=plans, target_plans=plans, **kw)

            def single(x=xv):
                return tp.nfft_fastsum(x, coeffs, src, cutoff=m, source_plan=member, **dk)

            sharded()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            sharded()
            torch.cuda.synchronize()
            launches = read_launches()
            peak = torch.cuda.max_memory_allocated()
            y, t_sh = host_median(sharded)
            ref, t_1 = host_median(single)
            rel = rel_l2(y, ref)
            print(f"nfft_fastsum_sharded C={C} on one NCCL rank: median {t_sh * 1e3:.3f} ms (of 3 "
                  f"after a warm-up); nfft_fastsum on the member plan {t_1 * 1e3:.3f} ms; vs it "
                  f"rel_l2={rel:.3e}; launches {launches}; peak memory {peak / 2**30:.2f} GiB "
                  f"({(peak - base) / 2**30:.2f} GiB above the {base / 2**30:.2f} held)")
            assert rel <= 1e-5, f"the sharded fastsum C={C} disagrees: {rel:.3e}"
            spread = "spread_tiles_dense" if C == 1 else "spread_tiles"
            assert launches[spread] == 1 and launches["gather_points"] == 1, launches
            for name in KERNELS:
                entry[name][f"launches_sharded_fastsum_c{C}"] = launches[name]
            if C == 1:
                idx = torch.from_numpy(np.random.default_rng(49).choice(n, 96, replace=False)
                                       ).to(dev)
                rel_g = rel_l2(y[idx], exact_gauss_sum(src, src[idx], x1, width))
                print(f"sharded fastsum C=1 at 96 targets vs the exact Gaussian sum: "
                      f"rel_l2={rel_g:.3e}")
                assert rel_g <= 1e-3, f"the sharded fastsum is off the Gaussian sum: {rel_g:.3e}"
                torch.save(y.cpu(), os.path.join(tmpdir, "y1.pt"))
            del y, ref
        xg = x1.clone().requires_grad_()
        (par.nfft_fastsum_sharded(xg, coeffs, src, cutoff=m, mesh=mesh, source_plans=plans,
                                  target_plans=plans, **kw) ** 2).sum().backward()
        xr = x1.clone().requires_grad_()
        (tp.nfft_fastsum(xr, coeffs, src, cutoff=m, source_plan=member, **dk) ** 2
         ).sum().backward()
        rel_gr = rel_l2(xg.grad, xr.grad)
        print(f"d/dx sum(y^2) through the sharded fastsum vs the single-device one: "
              f"rel_l2={rel_gr:.3e}")
        assert rel_gr <= 1e-5, f"the sharded gradient disagrees: {rel_gr:.3e}"
        torch.save(xg.grad.cpu(), os.path.join(tmpdir, "g1.pt"))
        del xg, xr, x8
        a, t_a = host_median(lambda: par.nfft_adjoint_sharded(x1, src, bandwidth=N, cutoff=m,
                                                              mesh=mesh, plans=plans, **kw))
        ra = rel_l2(a, tp.nfft_adjoint(x1, src, bandwidth=N, cutoff=m, plan=member, **dk))
        f, t_f = host_median(lambda: par.nfft_forward_sharded(a, src, cutoff=m, mesh=mesh,
                                                              plans=plans, **kw))
        rf = rel_l2(f, tp.nfft_forward(a, src, cutoff=m, plan=member, **dk))
        print(f"nfft_adjoint_sharded {t_a * 1e3:.3f} ms, rel_l2={ra:.3e}; nfft_forward_sharded "
              f"{t_f * 1e3:.3f} ms, rel_l2={rf:.3e} (vs the single-device entry points)")
        assert ra <= 1e-5 and rf <= 1e-5, f"sharded adjoint/forward: {ra:.3e}, {rf:.3e}"
        del a, f, plans, member

    with Phase("11b training step, one NCCL rank"):
        pos_t, y_t = train_data(cfg, src)
        B, n_set = pos_t.shape[:2]
        posf = pos_t.reshape(-1, DIM)
        bvec = torch.arange(B, dtype=torch.int32, device=dev).repeat_interleave(n_set)
        plan_t = tp.build_plan(posf, bvec, N=N, m=m, batch_size=B, **dk)
        rows = tp.nfft_fastsum(torch.ones((n, 1), device=dev), coeffs, posf, batch=bvec,
                               batch_size=B, cutoff=m, source_plan=plan_t, **dk)
        # G >= 0 elementwise: its norm is at most its largest row sum, and
        # gradient descent on |G w - y|^2 / (B n) falls for lr < B n / |G|^2
        lam = float(rows.max())
        lr = 0.5 * B * n_set / lam**2
        step, shard = par.make_fastsum_train_step(
            mesh, coeffs, batch_size=B, n_per_set=n_set, cutoff=m, learning_rate=lr,
            strategy="binned", **kw)
        pos_l, y_l = shard(pos_t), shard(y_t)
        w1, loss0 = step(torch.zeros_like(y_l), pos_l, y_l)
        torch.cuda.synchronize()
        reset_launches()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        w2, loss1 = step(w1, pos_l, y_l)
        ev[1].record()
        torch.cuda.synchronize()
        launches = read_launches()
        t_step = ev[0].elapsed_time(ev[1])
        _, loss2 = step(w2, pos_l, y_l)
        wr = torch.zeros_like(y_l).requires_grad_()
        pred = tp.nfft_fastsum(wr.reshape(-1, 1), coeffs, posf, batch=bvec, batch_size=B,
                               cutoff=m, source_plan=plan_t, **dk)
        (((pred.reshape(wr.shape) - y_l) ** 2).sum() / (B * n_set)).backward()
        rel_w = rel_l2(w1, -lr * wr.grad)
        losses = [float(v) for v in (loss0, loss1, loss2)]
        print(f"train step ({B} sets of {n_set} points, C=1, lr={lr:.4e} from the largest row "
              f"sum {lam:.1f}): {t_step:.3f} ms (CUDA events, the second step); launches "
              f"{launches}; losses {losses}; first update vs one autograd step on "
              f"nfft_fastsum rel_l2={rel_w:.3e}")
        assert losses[2] < losses[1] < losses[0], f"the loss did not fall: {losses}"
        assert rel_w <= 1e-5, f"the train step's update disagrees: {rel_w:.3e}"
        for name in KERNELS:
            entry[name]["launches_sharded_train_step"] = launches[name]
        torch.save(w1.cpu(), os.path.join(tmpdir, "w1.pt"))
        torch.save(torch.tensor(lr), os.path.join(tmpdir, "lr.pt"))
        del step, pos_l, y_l, w1, w2, wr, pred, plan_t, rows, src, x1, kernel

    with Phase("11d grid-sharded transforms, one NCCL rank"):
        pos_g, x_g, sr, si = grid_data(cfg, dev)
        coeffs_g = coeffs
        t0 = time.perf_counter()
        lay = tp.parallel.build_grid_sharded_layout(pos_g, n_shards=1, N=N, m=m, T=cfg["T"],
                                                    device=dev)
        t_lay = time.perf_counter() - t0
        pk = dict(batch_size=1, m=m, strategy="binned", **dk)
        refs = {
            "adjoint": _flat(tp.nfft_adjoint_planar(x_g, pos_g, None, N=N, **pk)),
            "forward": _flat(tp.nfft_forward_planar(sr, si, pos_g, None, dim=DIM, **pk)),
            "forward_real": _flat(tp.nfft_forward_planar(sr, si, pos_g, None, dim=DIM,
                                                         real_output=True, **pk)[0]),
            "fastsum": _flat(tp.nfft_fastsum_real(x_g, coeffs_g, pos_g, pos_g, N=N, **pk)),
        }
        for k, v in refs.items():
            torch.save(v.cpu(), os.path.join(tmpdir, f"ref_{k}.pt"))
        gmesh = tp.parallel.make_mesh({"grid": 1}, device_type=cfg["device"])
        res = grid_phase(tp.parallel, cfg, dev, lay, gmesh, refs, coeffs_g)
        print(f"grid-sharded layout on one slab in {t_lay:.3f} s (NT={lay.NT}, rows {lay.plans.S})")
        report_grid(res, entry, "w1")
        del lay, refs, pos_g, x_g, sr, si


def report_grid(res: dict, entry: dict, tag: str) -> None:
    """Print phase 11d's readings and hold them to JAX's 2e-4 bar."""
    for name, r in res.items():
        print(f"  {name} ({tag}): median {r['s'] * 1e3:.3f} ms (of 3 after a warm-up); "
              f"vs the single-device planar transform rel_l2={r['rel']:.3e}; launches "
              f"{r['launches']}")
        assert r["rel"] <= 2e-4, f"grid-sharded {name} ({tag}): {r['rel']:.3e}"
        for k in KERNELS:
            entry[k][f"launches_grid_{name}_{tag}"] = r["launches"][k]


def report_ranks(ranks: list, entry: dict, cards: bool = False) -> None:
    """Print the four ranks' readings of phases 11c-11d and hold them."""
    P = len(ranks)
    r0 = ranks[0]
    where = "NCCL ranks, a card each" if cards else "gloo ranks sharing the card"
    print(f"11c point-sharded fastsum C=1 on {P} {where} (stack of {P} "
          f"plans, {max(r['plans_s'] for r in ranks):.3f} s a rank): rank 0 median "
          f"{r0['fastsum_s'] * 1e3:.3f} ms (of 3 after a warm-up); launches "
          f"{r0['fastsum_launches']}; vs world 1 rel_l2 " + ", ".join(
              f"{r['fastsum_rel']:.3e}" for r in ranks)
          + "; d/dx sum(y^2) vs world 1 rel_l2 " + ", ".join(f"{r['grad_rel']:.3e}" for r in ranks))
    if "peak_gib" in r0:
        print(f"  peak allocated per rank " + ", ".join(f"{r['peak_gib']:.2f}" for r in ranks)
              + f" GiB; device memory in use {max(r['device_used_gib'] for r in ranks):.2f} GiB "
              "(all processes, caching allocators included)")
    transport = "NCCL between the cards" if cards else (
        "a transport through host memory among processes that share one card, not a "
        "multi-GPU figure")
    print(f"  all-reduce of the {r0['allreduce_bytes'] / 2**20:.0f} MiB grid: rank 0 median "
          f"{r0['allreduce_s'] * 1e3:.3f} ms — {transport}")
    print(f"  train step on data 2 x points {P // 2}: first update vs world 1's rel_l2 "
          + ", ".join(f"{r['train_rel']:.3e}" for r in ranks)
          + f"; loss {r0['train_loss0']:.6e}; rank 0's second step {r0['train_step_s'] * 1e3:.3f} "
          f"ms, launches {r0['train_launches']}")
    for r in ranks:
        assert r["fastsum_rel"] <= 1e-5 and r["grad_rel"] <= 1e-5, \
            f"11c: a rank disagrees with world 1: {r['fastsum_rel']:.3e}, {r['grad_rel']:.3e}"
        assert r["train_rel"] <= 1e-5, f"11c: a rank's update disagrees: {r['train_rel']:.3e}"
    assert r0["fastsum_launches"]["spread_tiles_dense"] == 1 \
        and r0["fastsum_launches"]["gather_points"] == 1, r0["fastsum_launches"]
    for k in KERNELS:
        entry[k][f"launches_sharded_fastsum_p{P}"] = r0["fastsum_launches"][k]
        entry[k][f"launches_sharded_train_step_p{P}"] = r0["train_launches"][k]
    lay = r0["layout"]
    print(f"11d grid-sharded on {P} slabs (layout {max(r['layout_s'] for r in ranks):.3f} s a "
          f"rank: n_loc={lay['n_loc']} A0_loc={lay['A0_loc']} NT={lay['NT']} rows={lay['S']}); "
          f"halo {GRAM_M * 2 + 1} x {2 * GRAM_N}^2 floats a plane a shift "
          f"({(2 * GRAM_M + 1) * (2 * GRAM_N) ** 2 * 4 / 2**20:.2f} MiB), half-spectrum "
          f"all-reduce {2 * (GRAM_N // 2) + 1} x {GRAM_N} x {GRAM_N // 2 + 1} complex64 "
          f"({(2 * (GRAM_N // 2) + 1) * GRAM_N * (GRAM_N // 2 + 1) * 8 / 2**20:.0f} MiB)")
    report_grid(r0["grid"], entry, f"p{P}")
    for name in r0["grid"]:
        rels = [rr["grid"][name]["rel"] for rr in ranks]
        print(f"  {name} (p{P}) on every rank: rel_l2 " + ", ".join(f"{v:.3e}" for v in rels))
        assert max(rels) <= 2e-4, f"grid-sharded {name} (p{P}): {rels}"


# phase 13: the dense route's fold and unfold (csrc/tilefold.cu) at the
# Gram geometry (M = 512, T = 16, H = 25) and the headline's (M = 416, T = 8,
# H = 13), one column
TILEFOLD_GEOMETRIES = {"gram": (512, 16, 25), "headline": (416, 8, 13)}
# the slab of grid3d-n26 (3D N = 1024, gaussian m = 4, sigma = 2, four
# slabs): M = 2048, T = 16, H = 25, 32 axis-0 tiles a slab (M, T, H, nb0)
SLAB_GEOMETRY = (2048, 16, 25, 32)


def tile_move_check(name: str, plan, C: int, dev, gen) -> dict:
    """The fold (of C columns of tiles) or the unfold (of a grid of C
    columns) against its plain version: the unfold bit for bit, the fold to
    rel-L2 1e-5 (the same float32 terms summed in another order), each bit
    for bit across two launches, one launch a call; its time by CUDA events
    (mean of 10) beside the plain version's and the byte bound."""
    B, dim, M, H = plan.batch_size, plan.dim, plan.M, plan.H
    NT = B * tilefold.tiles_per_axis(plan) ** dim
    fold = name == "fold_tiles_to_grid"
    shape = (NT, C, H, H ** (dim - 1)) if fold else (B, C) + (M,) * dim
    arg = torch.randn(shape, device=dev, generator=gen)
    wrapper, plain = getattr(tilefold, name), getattr(tilefold, f"{name}_plain")
    before = wrapper.launches
    got, again = wrapper(arg, plan), wrapper(arg, plan)
    assert wrapper.launches == before + 2, f"{name}: one launch a call"
    assert torch.equal(got, again), f"{name} differs between two launches"
    ref = plain(arg, plan)
    err, mx = rel_l2(got, ref), float((got - ref).abs().max())
    assert fold or torch.equal(got, ref), f"unfold differs from plain: {err:.3e}"
    assert err <= 1e-5, f"{name} against plain: rel_l2 {err:.3e}"
    del got, again, ref
    ms = time_ms(lambda: wrapper(arg, plan), 10)
    plain_ms = time_ms(lambda: plain(arg, plan), 10)
    bound_ms = 4.0 * C * (NT * H**dim + B * M**dim) / PEAK_BYTES_PER_S * 1e3
    print(f"{name} C={C} (M={M} T={plan.T} H={H}): {ms:.4f} ms (plain {plain_ms:.3f} ms, "
          f"bound {bound_ms:.4f} ms by bytes, {bound_ms / ms:.1%} of bound); rel_l2 against "
          f"plain {err:.3e}, max_abs {mx:.3e}", flush=True)
    return {"C": C, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None, "rel_l2": err, "max_abs_err": mx}


def slab_move_check(dev, gen, M: int, T: int, H: int, nb0: int) -> dict:
    """A grid slab's fold and unfold (one column, 3D) against their plain
    versions: the fold to rel-L2 1e-5 and bit for bit across two launches,
    the unfold bit for bit at the first, a middle and the last tile row
    (the last reads the halo); each timed by CUDA events (mean of 10)
    beside the byte bound: the tiles and the slab with its E extra rows,
    each once."""
    plan = types.SimpleNamespace(dim=3, M=M, T=T, H=H, batch_size=1)
    nb, E, L0 = M // T, H - T, nb0 * T
    NT = nb0 * nb * nb
    bound_ms = 4.0 * (NT * H**3 + (L0 + E) * M * M) / PEAK_BYTES_PER_S * 1e3
    fold, unfold = tilefold.fold_tiles_to_slab, tilefold.unfold_slab_to_tiles
    tiles = torch.randn((NT, 1, H, H * H), device=dev, generator=gen)
    before = fold.launches
    got, again = fold(tiles, plan, nb0), fold(tiles, plan, nb0)
    assert fold.launches == before + 2, "slab fold: one launch a call"
    assert torch.equal(got, again), "the slab fold differs between two launches"
    del again
    ref = tilefold.fold_tiles_to_slab_plain(tiles, plan, nb0)
    err = rel_l2_rows(got.reshape(-1, M), ref.reshape(-1, M), 1 << 16)
    assert err <= 1e-5, f"slab fold against plain: rel_l2 {err:.3e}"
    del got, ref
    fold_ms = time_ms(lambda: fold(tiles, plan, nb0), 10)
    del tiles
    torch.cuda.empty_cache()
    g = torch.randn((1, 1, L0, M, M), device=dev, generator=gen)
    halo = torch.randn((1, 1, E, M, M), device=dev, generator=gen)
    before = unfold.launches
    tt = unfold(g, halo, plan, nb0)
    assert unfold.launches == before + 1, "slab unfold: one launch a call"
    for t in (0, nb0 // 2, nb0 - 1):
        nxt = halo if t == nb0 - 1 else g[:, :, (t + 1) * T:(t + 1) * T + E]
        ref_t = tilefold.unfold_slab_to_tiles_plain(g[:, :, t * T:(t + 1) * T], nxt, plan, 1)
        assert torch.equal(tt[t * nb * nb:(t + 1) * nb * nb], ref_t), \
            f"slab unfold differs from plain at tile row {t}"
    del tt, ref_t
    unfold_ms = time_ms(lambda: unfold(g, halo, plan, nb0), 10)
    print(f"slab fold / unfold (M={M} T={T} H={H}, {nb0} axis-0 tiles): {fold_ms:.3f} / "
          f"{unfold_ms:.3f} ms, bound {bound_ms:.3f} ms by bytes ({bound_ms / fold_ms:.1%} / "
          f"{bound_ms / unfold_ms:.1%} of bound); fold rel_l2 against plain {err:.3e}, "
          f"unfold bit for bit", flush=True)
    return {"fold_tiles_to_slab": {"ms": fold_ms, "bound_ms": bound_ms, "rel_l2": err},
            "unfold_slab_to_tiles": {"ms": unfold_ms, "bound_ms": bound_ms, "rel_l2": 0.0}}


def tilefold_phase(dev, report: list) -> None:
    """Phase 13: the fold and the unfold by :func:`tile_move_check` at the
    Gram and the headline geometry; the headline's numbers are each
    kernel's entry in ``report``, the Gram's its ``gram`` sub-entry. Then
    the slab fold and unfold at the slab of ``grid3d-n26``
    (:func:`slab_move_check`)."""
    entry = {r["name"]: r for r in report}
    gen = torch.Generator(device=dev).manual_seed(61)
    for geo, (M, T, H) in TILEFOLD_GEOMETRIES.items():
        with Phase(f"13 fold and unfold, {geo} geometry"):
            plan = types.SimpleNamespace(dim=3, M=M, T=T, H=H, batch_size=1)
            for name in TILE_MOVES:
                res = tile_move_check(name, plan, 1, dev, gen)
                if geo == "headline":
                    entry[name].update(res)
                else:
                    entry[name][geo] = res
            torch.cuda.empty_cache()
    with Phase("13b slab fold and unfold, 3D N = 1024 on four slabs"):
        for name, res in slab_move_check(dev, gen, *SLAB_GEOMETRY).items():
            entry[name].update(res)
        torch.cuda.empty_cache()


def compat_phases(dev, report: list) -> None:
    """Phase 12: the compatibility layer (``torch_compat``) at the Gram
    geometry (phase 8's 2^22 points, ``GaussianKernel(0.4, dim=3,
    bandwidth=256, cutoff=4)``, C = 1). Its fastsum, adjoint and forward
    with x requiring grad, and ``kernel(pts) @ x`` with a backward: each
    output against the port's own entry point on the same inputs (the same
    cached plan and coefficients: bit for bit), x.grad against the
    port's transposed transform of the same cotangent (1e-5), launches
    over the forward and backward, and the layer's seconds beside the
    port's (host clock, median of 3, forward only). Adds the launches to
    ``report``."""
    from torch_nfft_tpu_torch import torch_compat as tc

    entry = {r["name"]: r for r in report}
    n = 1 << GRAM_LOG2
    with Phase("12 torch_compat at the Gram geometry"):
        pts = torch.from_numpy(np.random.default_rng(41).random((n, DIM), dtype=np.float32)
                               * 2 - 1).to(dev)
        x1 = torch.from_numpy(np.random.default_rng(43).standard_normal((n, 1))
                              .astype(np.float32)).to(dev)
        ck = tc.GaussianKernel(GRAM_SIGMA, dim=DIM, bandwidth=GRAM_N, cutoff=GRAM_M)
        pk = tp.GaussianKernel(GRAM_SIGMA, dim=DIM, bandwidth=GRAM_N, cutoff=GRAM_M)
        G_c, G_p = ck(pts), pk(pts)
        src, coeffs = G_p.sources, pk.coeffs
        # the front end builds its kernel on the device of the points it is given
        assert ck.coeffs.device == dev and torch.equal(ck.coeffs, coeffs), \
            "the compat kernel's coefficients differ from the port's"
        print(f"compat GaussianKernel: coefficients built on {ck.coeffs.device}, equal to "
              f"the port's bit for bit")
        spectrum = tp.nfft_adjoint(x1, src, bandwidth=GRAM_N, cutoff=GRAM_M)
        kw = dict(cutoff=GRAM_M)
        # name: (input, compat call, port call, port transposed call)
        calls = {
            "fastsum": (x1, lambda v: tc.nfft_fastsum(v, coeffs, src, **kw),
                        lambda v: tp.nfft_fastsum(v, coeffs, src, **kw),
                        lambda dy: tp.nfft_fastsum(dy, coeffs, src, **kw)),
            "adjoint": (x1, lambda v: tc.nfft_adjoint(v, src, bandwidth=GRAM_N, **kw),
                        lambda v: tp.nfft_adjoint(v, src, bandwidth=GRAM_N, **kw),
                        lambda dy: tp.nfft_forward(dy, src, real_output=True, **kw)),
            "forward": (spectrum, lambda v: tc.nfft_forward(v, src, **kw),
                        lambda v: tp.nfft_forward(v, src, **kw),
                        lambda dy: tp.nfft_adjoint(dy, src, bandwidth=GRAM_N, **kw)),
            "gram": (x1, lambda v: G_c @ v, lambda v: G_p @ v, lambda dy: G_p.T @ dy),
        }
        for name, (xin, compat, port, port_t) in calls.items():
            xg = xin.clone().requires_grad_()
            torch.cuda.synchronize()
            reset_launches()
            y = compat(xg)
            (y.abs() ** 2).sum().backward()
            torch.cuda.synchronize()
            launches = read_launches()
            with torch.no_grad():
                ref = port(xin)
                bits = torch.equal(y.detach(), ref)
                rel = rel_l2(torch.view_as_real(y.detach()) if y.is_complex() else y.detach(),
                             torch.view_as_real(ref) if ref.is_complex() else ref)
                g_ref = port_t(2 * ref)
                rel_g = rel_l2(torch.view_as_real(xg.grad) if xg.grad.is_complex() else xg.grad,
                               torch.view_as_real(g_ref) if g_ref.is_complex() else g_ref)
                _, t_c = host_median(lambda: compat(xin))
                _, t_p = host_median(lambda: port(xin))
            print(f"compat {name}: vs the port's {'bit for bit' if bits else 'not bitwise'}, "
                  f"rel_l2={rel:.3e}; x.grad vs the port's transposed transform "
                  f"rel_l2={rel_g:.3e}; compat {t_c * 1e3:.3f} ms, port {t_p * 1e3:.3f} ms "
                  f"(host clock, median of 3, forward only); launches over the forward and "
                  f"backward {launches}")
            assert bits, f"compat {name} is not bitwise the port's: rel_l2 {rel:.3e}"
            assert rel_g <= 1e-5, f"compat {name}'s x.grad disagrees: {rel_g:.3e}"
            assert launches["spread_tiles_dense"] >= 1 and launches["gather_points"] >= 1 \
                and launches["pos_grad"] == 0, f"compat {name}: launches {launches}"
            for k in KERNELS:
                entry[k][f"launches_compat_{name}"] = launches[k]
            del xg, y, ref, g_ref
        del calls, G_c, G_p, ck, pk, src, coeffs, pts, x1, spectrum
    tp.clear_plan_cache()
    torch.cuda.empty_cache()


def check_demo_operators(name: str, dev) -> None:
    """The Gram operators of the ``rbf_interpolation`` or ``graph_smoothing``
    demo, rebuilt on the card from the demo's own data (its ``problem``):
    one matvec of each (B1 and B2 at the demo's dim, window and cutoff,
    launched) against the plain one-hot matmul engine on the same points
    and coefficients (no launch), rel_l2 <= 1e-5."""
    from examples_torch import graph_smoothing, rbf_interpolation

    if name == "rbf_interpolation":
        kernel, train, test, _, _ = rbf_interpolation.problem(device=dev)
        ops = {"gram": kernel(train), "predict": kernel.gram_matrix(train, test)}
    else:
        ops = {"gram": graph_smoothing.problem(device=dev)[0].gram_matrix}
    for op_name, G in ops.items():
        v = torch.from_numpy(np.random.default_rng(53).standard_normal(G.shape[1])
                             .astype(np.float32)).to(dev)
        reset_launches()
        y = G @ v
        torch.cuda.synchronize()
        ran = read_launches()
        reset_launches()
        ref = tp.nfft_fastsum(v, G.coeffs, G.sources, G.targets, cutoff=G.cutoff,
                              window=G.window, strategy="matmul")
        torch.cuda.synchronize()
        plain_ran = {k: c for k, c in read_launches().items() if c}
        rel = rel_l2(y, ref)
        print(f"  {name} {op_name} matvec ({G.shape[0]} x {G.shape[1]}, {G.sources.shape[1]}D "
              f"N={G.coeffs.shape[0]} m={G.cutoff} {G.window}) vs the one-hot matmul engine: "
              f"rel_l2={rel:.3e}; launches {ran}, plain {plain_ran}")
        assert ran["spread_tiles_dense"] >= 1 and ran["gather_points"] >= 1 and not plain_ran, \
            f"{name} {op_name}: launches {ran}, plain {plain_ran}"
        assert rel <= 1e-5, f"{name} {op_name} matvec vs the plain engine: {rel:.3e}"


def demo_phases(report: list, dev) -> None:
    """Phase 12b: the five demos of examples_torch/ on the card at the JAX
    demos' defaults, each with its own assertion: their seconds and
    launches. ``rbf_interpolation`` and ``graph_smoothing`` must launch B1
    and B2, and their operators are held against the plain engine
    (:func:`check_demo_operators`). ``multichip_training`` runs four gloo
    ranks that share the card (a check of the multi-process path, no
    multi-GPU figure; rank 0 counts its launches); ``grid_sharded_large``
    the N = 512 adjoint on one NCCL slab in this process, with its peak
    memory against the card's."""
    from examples_torch import (
        graph_smoothing,
        grid_sharded_large,
        learn_kernel,
        multichip_training,
        rbf_interpolation,
    )

    entry = {r["name"]: r for r in report}
    demos = {
        "rbf_interpolation": rbf_interpolation.main,
        "graph_smoothing": graph_smoothing.main,
        "learn_kernel": learn_kernel.main,
        "multichip_training": lambda: multichip_training.main(
            world=SHARD_P, rank_report=read_launches),
        "grid_sharded_large": grid_sharded_large.main,
    }
    with Phase("12b the five demos at their defaults"):
        for name, run in demos.items():
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = out.get("report") or read_launches()
            where = f"rank 0 of {SHARD_P} {out['backend']} ranks" \
                if name == "multichip_training" else "this process"
            print(f"demo {name}: {seconds:.3f} s, assertion held; launches ({where}) "
                  f"{launches}; " + ", ".join(
                      f"{k}={v:.4g}" for k, v in out.items()
                      if isinstance(v, float) and k != "seconds"))
            if name in ("rbf_interpolation", "graph_smoothing"):
                assert launches["spread_tiles_dense"] >= 1 and launches["gather_points"] >= 1, \
                    f"demo {name}: launches {launches}"
                check_demo_operators(name, dev)
            if name == "grid_sharded_large":
                total = torch.cuda.get_device_properties(0).total_memory
                fits = out["peak"] < total
                print(f"  N=512 (M=1024) on one slab: T={out['T']}, {out['NT']} tiles; "
                      f"layout {out['layout_s']:.3f} s, adjoint {out['adjoint_s']:.3f} s; peak "
                      f"memory {out['peak'] / 2**30:.2f} GiB of the card's "
                      f"{total / 2**30:.2f} GiB: the whole oversampled grid "
                      f"{'fits' if fits else 'does not fit'} one card")
                assert launches["spread_tiles_dense"] == 1, launches
            for k in KERNELS:
                entry[k][f"launches_demo_{name}"] = launches[k]
    torch.cuda.empty_cache()


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def single_device_phases(dev) -> tuple:
    """Phases 0-10e; returns (report, card, peak bytes). What they hold on
    the card is freed on return, before the ranks of phases 11c-11d share
    it."""
    n = 1 << N_LOG2

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
        if res.log:  # a fresh build: the FP32 contraction spread keeps no stack
            rep_ptx = ptxas_report(res.log, "spread_contract_kernel")
            for name, regs, stack, spill in rep_ptx:
                print(f"spread_contract_kernel {name[-60:]}: {regs} registers, "
                      f"{stack} bytes stack, {spill} bytes spilled")
            # <kPerRow, kMT = 0, 1, false>: the contraction; the tensor
            # design's 32 and 40 doubles a lane, culled or not, spill a few
            # words at 128 registers
            fp32 = [r for r in rep_ptx if "ELi0ELi1ELb0EE" in r[0]]
            assert len(fp32) == 2 and len(rep_ptx) == 10, rep_ptx
            assert all(st == 0 and sp == 0 for _, _, st, sp in fp32), \
                "the contraction spread uses stack or spills"
            # nor does any instantiation of the gather and the position
            # gradient (L = 2..20, staged at C = 1 / C > 1, or global)
            rep_pts = ptxas_report(res.log, "points_kernel")
            for name, regs, stack, spill in rep_pts:
                print(f"points_kernel<{points_instance(name)}>: {regs} registers, "
                      f"{stack} bytes stack, {spill} bytes spilled")
            assert len(rep_pts) == 60, f"{len(rep_pts)} points_kernel instantiations, not 60"
            assert all(st == 0 and sp == 0 for _, _, st, sp in rep_pts), \
                "a gather or position-gradient kernel uses stack or spills"

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
        assert designs_b1["tensor"] == 1 and torch.equal(again, tiles_k), \
            "B1 at the headline must run the tensor design and repeat bit for bit"
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
        same_pts = (torch.equal(contract.gather_points(plan, tiles, tid),
                                contract.gather_points(plan, tiles, tid))
                    and torch.equal(contract.pos_grad(plan, tiles, vals, tid),
                                    contract.pos_grad(plan, tiles, vals, tid)))
        print(f"gather_points C=1 ({contract.points_layout('gather_points', DIM, plan.H, 1, plan.K)}) "
              f"and pos_grad C=1 ({contract.points_layout('pos_grad', DIM, plan.H, 1, plan.K)}): "
              f"two launches bitwise equal: {same_pts}")
        assert same_pts, "B2 or B5 at C=1 differs from one launch to the next"
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
            want_d = contract.spread_design(DIM, plan.H, plan.m, xc.shape[1]).name
            assert want_d != "wide" and designs[want_d] == 1 and same, \
                f"B7 at the headline must run the {want_d} design and repeat bit for bit"
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

    with Phase(f"3e gather and pos_grad at C={C_WIDE} on per-row tiles vs plain"):
        # the flat route's tiles (binned.grid_to_tiles), each row its own
        rows_id = torch.arange(plan.S, dtype=torch.int32, device=dev)
        g8 = torch.randn((1, C_WIDE) + (plan.M,) * DIM, device=dev, generator=gen)
        tiles_r8 = binned.grid_to_tiles(plan, g8)
        del g8
        vals8 = slot_values(plan, x8)
        y_k = contract.gather_points(plan, tiles_r8, rows_id)
        y_p = contract.gather_points_plain(plan, tiles_r8, rows_id)
        e_g = (float((y_k - y_p).abs().max()), rel_l2(y_k, y_p))
        same = torch.equal(contract.gather_points(plan, tiles_r8, rows_id), y_k)
        print(f"gather_points C={C_WIDE} "
              f"({contract.points_layout('gather_points', DIM, plan.H, C_WIDE, plan.K)}): "
              f"kernel vs plain max_abs={e_g[0]:.3e} rel_l2={e_g[1]:.3e}; two launches "
              f"bitwise equal: {same}")
        assert e_g[1] <= 1e-5 and same, f"gather_points at C={C_WIDE}: {e_g[1]:.3e}, {same}"
        err["gather_points"] = tuple(map(max, zip(err["gather_points"], e_g)))
        del y_k, y_p
        ybar8 = torch.randn((n, C_WIDE), device=dev, generator=gen)
        w_ybar8 = slot_values(plan, ybar8)
        g_primal8 = run_stages(pair_stages(plan, N=N, m=M_CUT, sigma=SIGMA, window=WINDOW,
                                           C=C_WIDE)[:5], x8)
        tiles_primal8 = binned.grid_to_tiles(plan, g_primal8)
        del g_primal8, ybar8
        for label, tl, wt in (("w=x, cotangent tiles", tiles_r8, vals8),
                              ("w=ybar, primal tiles", tiles_primal8, w_ybar8)):
            d_k = contract.pos_grad(plan, tl, wt, rows_id)
            d_p = contract.pos_grad_plain(plan, tl, wt, rows_id)
            e_p = (float((d_k - d_p).abs().max()), rel_l2(d_k, d_p))
            same = torch.equal(contract.pos_grad(plan, tl, wt, rows_id), d_k)
            print(f"pos_grad C={C_WIDE} ({label}; "
                  f"{contract.points_layout('pos_grad', DIM, plan.H, C_WIDE, plan.K)}): "
                  f"kernel vs plain max_abs={e_p[0]:.3e} "
                  f"(max |plain| {float(d_p.abs().max()):.3e}) rel_l2={e_p[1]:.3e}; two "
                  f"launches bitwise equal: {same}")
            assert e_p[1] <= 1e-5 and same, f"pos_grad at C={C_WIDE}: {e_p[1]:.3e}, {same}"
            err["pos_grad"] = tuple(map(max, zip(err["pos_grad"], e_p)))
            del d_k, d_p
        del tiles_primal8, w_ybar8

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
        assert all(launches_pair[k] == 4 for k in TILE_MOVES), \
            f"each dense pair must fold and unfold once: {launches_pair}"
        assert designs_pair["spread_tiles_dense"]["wide"] == 0 \
            and designs_pair["spread_tiles_dense"]["tensor"] > 0, \
            "the headline dense pair must run the tensor design"
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
        assert launches_step == {**{k: 2 if k in SORT_PATH else 0 for k in KERNELS},
                                 **STEP_MOVES}, \
            f"a sort-route training step must launch B1, B2 and B5 twice, fold twice and " \
            f"unfold three times: {launches_step}"
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
        assert all(launches_bpair[k] == 4 for k in TILE_MOVES), \
            f"each Benes-route pair must fold and unfold once: {launches_bpair}"
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
        assert {k: launches_bstep[k] for k in TILE_MOVES} == STEP_MOVES, \
            f"a Benes-route training step must fold twice and unfold three times: " \
            f"{launches_bstep}"
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
            and launches_fpair["spread_tiles_dense"] == 0 \
            and all(launches_fpair[k] == 0 for k in TILE_MOVES), \
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
        flat = binned.TileRoute(plan, "flat")
        st_flat = (flat.spreading + tuple(s for s in st_dense if s[0] in ("rfftn", "irfftn"))
                   + flat.gathering)
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

        def path_launches(name: str) -> dict:
            return {"launches": main_launches[name],
                    "launches_pair": launches_pair[name] // 4,
                    "launches_step": launches_step[name],
                    "launches_benes_pair": launches_bpair[name] // 4,
                    "launches_benes_step": launches_bstep[name],
                    "launches_flat_pair": launches_fpair[name] // 4,
                    "launches_flat_step": launches_fstep[name],
                    "launches_sort_pairs": launches_sort[name]}

        for name, kern, plain, lib, b_ms, b_by in rows:
            ms = time_ms(kern, 10) if callable(kern) else float(np.mean(kern))
            plain_ms = time_ms(plain, 2)
            lib_ms = time_ms(lib, 10) if lib is not None else None
            lib_txt = f", index_select {lib_ms:.4f} ms" if lib is not None else ""
            print(f"{name}: {ms:.4f} ms (plain {plain_ms:.3f} ms{lib_txt}, bound "
                  f"{b_ms:.4f} ms by {b_by}, {b_ms / ms:.1%} of bound)")
            report.append({
                "name": name, "route": "cuda", "source": KERNELS[name][2],
                "replaces": KERNELS[name][1], **path_launches(name),
                "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            })
        # the fold and the unfold are held and timed in phases 10a and 13,
        # the slab's in 13b
        report += [{"name": name, "route": "cuda", "source": KERNELS[name][2],
                    "replaces": KERNELS[name][1], **path_launches(name)}
                   for name in TILE_MOVES + SLAB_MOVES]
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
        # B2 and B5 at C_WIDE on the per-row tiles of phase 3e
        b8 = bounds(plan, C_WIDE, plan.S)
        for name, kern, plain, (b_ms, b_by) in (
                ("gather_points", lambda: contract.gather_points(plan, tiles_r8, rows_id),
                 lambda: contract.gather_points_plain(plan, tiles_r8, rows_id), b8[1]),
                ("pos_grad", lambda: contract.pos_grad(plan, tiles_r8, vals8, rows_id),
                 lambda: contract.pos_grad_plain(plan, tiles_r8, vals8, rows_id), b8[2])):
            ms, plain_ms = time_ms(kern, 10), time_ms(plain, 1)
            print(f"{name} C={C_WIDE} (per-row tiles): {ms:.4f} ms (plain {plain_ms:.3f} ms, "
                  f"bound {b_ms:.4f} ms by {b_by}, {b_ms / ms:.1%} of bound)")
            next(r for r in report if r["name"] == name)[f"c{C_WIDE}"] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None}
        # the two spreads: their design, the share of the 67 TFLOP/s peak
        # (FP32 CUDA cores, FP64 tensor cores) the design's issued flops
        # reach, and the yardstick of the contraction alone (torch.bmm of
        # preformed operands); B7 also at C=1
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
                  f"= {share:.1%} of the 67 TFLOP/s peak; yardstick (contraction alone, "
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
        # the spreads' contractions with other chunk sizes KC, bands of R rows
        # and (the tensor design) most warps a block, each equal to the
        # design's defaults: the contraction bit for bit, the tensor design
        # to a float32 ulp
        grid_sp = {("contraction", 1): ((8, None, None), (32, None, None), (16, 8, None)),
                   ("contraction", C_WIDE): ((16, None, None), (64, None, None),
                                             (32, 104, None), (32, 40, None)),
                   ("tensor", 1): ((16, None, None), (128, None, None), (64, 8, None),
                                   (64, None, 4)),
                   ("tensor", C_WIDE): ((32, None, None), (64, 64, None), (64, 40, 8))}
        for name, C_s, fn in (
                ("spread_tiles_dense", 1,
                 lambda d: contract.spread_tiles_dense(plan, vals, tid_spread, plan.NT, d)),
                ("spread_tiles", 1, lambda d: contract.spread_tiles(plan, vals, d)),
                ("spread_tiles", C_WIDE, lambda d: contract.spread_tiles(plan, vals8, d))):
            for d_name in ("contraction", "tensor"):
                want = fn(contract.spread_design(DIM, plan.H, plan.m, C_s, name=d_name))
                for KC_g, R_g, w_g in ((None, None, None),) + grid_sp[d_name, C_s]:
                    kw = dict(warps=w_g) if d_name == "tensor" else {}
                    d = contract.spread_design(DIM, plan.H, plan.m, C_s, name=d_name, KC=KC_g,
                                               R=R_g, **kw)
                    got = fn(d)
                    same = torch.equal(got, want)
                    big = torch.maximum(got.abs(), want.abs())
                    ulp = bool(((got - want).abs() <= torch.nextafter(big, big + 1) - big).all())
                    del got, big
                    assert same or (d_name == "tensor" and ulp), \
                        f"{name} C={C_s} {d_name} with KC={d.KC}, R={d.R} differs from its defaults'"
                    print(f"{name} C={C_s} {d_name} KC={d.KC} R={d.R} ({d.row_bands}x{d.col_bands} "
                          f"band(s) of {d.threads} threads, {d.smem} B shared): "
                          f"{time_ms(lambda: fn(d), 5):.4f} ms, "
                          f"{'bitwise equal to' if same else 'within a float32 ulp of'} the defaults'")
                del want
        # the three designs on the headline points binned at T = 8 (the
        # plan's) and T = 16, each against the plain version on the same inputs
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
                for d_name in DESIGNS:
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
        # the per-row spread under the three designs at more tile sizes and
        # columns: the times behind contract.DENSE_RATIO_MAX and the tensor
        # design's contract.TENSOR_ROWS / TENSOR_COLUMNS (the designs held
        # against each other), each beside its share of the bound and the
        # issued flops' share of the peak
        faster = {}
        for T_t in (8, 10, 12, 16, 20, 24):
            p_t = plan if T_t == plan.T else tp.build_plan_device(
                pos, None, N=N, m=M_CUT, sigma=SIGMA, batch_size=1, window=WINDOW, T=T_t)
            for C_s in (1, 2, 4, C_WIDE):
                v_t = slot_values(p_t, x8[:, :C_s].contiguous())
                times_d, rel_d = design_ms(lambda d: contract.spread_tiles(p_t, v_t, d),
                                           p_t, C_s, 3 if T_t * C_s <= 16 else 1)
                del v_t
                chosen = contract.spread_design(DIM, p_t.H, p_t.m, C_s)
                won = min(times_d, key=times_d.get)
                faster.setdefault(C_s, []).append((chosen.ratio, p_t.H, won))
                b_t = bounds(p_t, C_s, p_t.S)[3][0]
                print(f"spread_tiles C={C_s} at T={T_t} (H={p_t.H}, ratio {chosen.ratio:.2f}, "
                      f"{p_t.S} rows, bound {b_t:.4f} ms): {design_line(times_d, p_t, C_s, b_t)}; "
                      f"faster {won}, the rule takes {chosen.name}; designs agree to "
                      f"rel_l2={rel_d:.3e}")
            del p_t
        for C_s, runs in faster.items():
            won_d = {k: ", ".join(f"{r:.2f} (H={h})" for r, h, w in runs if w == k)
                     for k in DESIGNS}
            limit = contract.DENSE_RATIO_MAX[max(c for c in contract.DENSE_RATIO_MAX if c <= C_s)]
            print(f"C={C_s}: faster at ratios: " + "; ".join(f"{k} [{v}]" for k, v in won_d.items())
                  + f"; contract.DENSE_RATIO_MAX takes the dense designs up to {limit}")
        # the gather's and the position gradient's launch layouts: threads a
        # block, the lanes' order sorted by bank or not, at C = 1 (dense
        # tiles) and C_WIDE (per-row tiles); every layout gives the same
        # bits. The times behind contract.POINTS_LAYOUT.
        for C_s, tl_s, tid_s, w_s in ((1, tiles, tid, vals), (C_WIDE, tiles_r8, rows_id, vals8)):
            for name, fn in (
                    ("gather_points",
                     lambda lay: contract.gather_points(plan, tl_s, tid_s, lay)),
                    ("pos_grad", lambda lay: contract.pos_grad(plan, tl_s, w_s, tid_s, lay))):
                want, best = fn(None), None
                for threads_l, sort_l in ((256, True), (128, True), (256, False), (128, False)):
                    lay = contract.points_layout(name, DIM, plan.H, C_s, plan.K,
                                                 threads=threads_l, sort=sort_l)
                    out = fn(lay)
                    same = torch.equal(out, want)
                    del out
                    assert same, f"{name} C={C_s} threads={threads_l} sorted={sort_l}: " \
                                 f"not bitwise equal to the default"
                    ms_l = time_ms(lambda: fn(lay), 5)
                    best = min(best or (ms_l, lay), (ms_l, lay), key=lambda b: b[0])
                    print(f"{name} C={C_s} threads={threads_l} sorted={sort_l}: {ms_l:.4f} ms "
                          f"(bitwise equal to the default)")
                del want
                print(f"{name} C={C_s}: fastest threads={best[1].threads} "
                      f"sorted={best[1].sorted} ({best[0]:.4f} ms); the default is "
                      f"{contract.points_layout(name, DIM, plan.H, C_s, plan.K)}")
        del vals8, tiles_r8

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
    # the headline's arrays make room for the Gram phases; phase 10e keeps
    # its points
    head_pos = pos
    del tiles, plan, plan_b, plan_h, pos, x, xl, pl, w, x8, dest, vals_s, vals
    torch.cuda.empty_cache()
    pts = gram_phases(dev, gen, report)
    radial_phases(dev, gen, report, pts)
    coeffs = tp.GaussianKernel(GRAM_SIGMA, dim=DIM, bandwidth=GRAM_N, cutoff=GRAM_M).coeffs
    torch.cuda.empty_cache()
    spectral_and_strategy_phases(dev, gen, coeffs)
    peak_all = max(peak_all, torch.cuda.max_memory_allocated())
    del coeffs
    torch.cuda.empty_cache()
    batched_phases(dev, gen, report, head_pos, pts)
    del head_pos, pts
    return report, card, max(peak_all, torch.cuda.max_memory_allocated())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card",
              file=sys.stderr)
        return 2
    dev = tp.resolve_device(None)
    t_all = time.perf_counter()
    report, card, peak_all = single_device_phases(dev)
    tilefold_phase(dev, report)
    tp.clear_plan_cache()
    torch.cuda.empty_cache()
    print(f"held on the card before the sharded phases: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    shard_phases(dev, report)
    peak_all = max(peak_all, torch.cuda.max_memory_allocated())
    compat_phases(dev, report)
    demo_phases(report, dev)
    peak_all = max(peak_all, torch.cuda.max_memory_allocated())
    print(f"total {time.perf_counter() - t_all:.1f} s; peak memory "
          f"{peak_all / 2**30:.2f} GiB; card {card}")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
