// Gather and position-gradient window contractions of the binned NFFT, for
// Hopper: one kernel body (points_kernel), compiled for the gather in
// gather.cu (tnt_gather_points) and for the position gradient in
// pos_grad.cu (tnt_pos_grad). Two kernels, two launches.
//
// Replaces the TPU kernels of the JAX package's ops/pallas/contract.py:
//   tnt_gather_points <- gather_points_pallas (kernel _gather_kernel) and
//       its row-batched twin gather_points_rb_pallas;
//   tnt_pos_grad      <- pos_grad_pallas (kernel _pos_grad_kernel).
//
// What they compute. Plan row s holds row_count[s] <= K points and reads
// the tile tile_index[s] of edge H (C columns of H^dim cells). Point k has,
// per axis d, a window start cell (floor(M x_kd) - m) mod M, offset o in
// the tile (o < T, so o + L <= H) and window values A_d[l] = phi(frac + m -
// l) on the L = 2m + 2 cells o + l. The gather writes, per column c,
//   y[s, c, k] = sum over the L^dim cells of A_0 A_1 A_2 tile[c, cell];
// the position gradient, with D_d = M phi' the derivative windows and w the
// per-point weights (the values for the spread's backward, the point
// cotangent for the gather's),
//   dpos[s, d, k] = sum_c w[c, k] sum_cells tile[c, cell] D_d prod_{e!=d} A_e.
// Padded slots (k >= row_count[s]) and rows whose tile lies outside [0, NT)
// get exact zeros.
//
// Design. A block owns one plan row; a thread computes one point at a time.
//   Staging: it copies the row's tile once into dynamic shared memory with
//   cp.async, as it lies at C = 1 (16-byte copies, the tile shifted by up
//   to 3 floats so that they align), cell-major at C > 1: the Cp (C rounded
//   up to 4; the rest zero) columns of a cell side by side, so a point
//   reads 4 columns of a cell with one 16-byte shared load. A tile larger
//   than the opt-in shared memory is read from global memory, column by
//   column, as the tiles lie (the wrapper picks by size before the launch).
//   Windows of compile-time width: the body is a template on L, with the
//   axes in three roles: I, the innermost axis (dim - 1), and Mi, the middle
//   one (axis 1 in 3D), are unrolled loops over registers; O (axis 0 from 2D
//   on) is a loop over the point's cells, its window value picked from
//   registers by a chain of selects. No window lives on the stack.
//   Every output sums its terms in one fixed order, so two launches, and
//   every launch layout (threads, lane order), give the same bits.
//   (Splitting a point's O cells over 2, 4 or 8 lanes with shuffle sums
//   measured slower on the H100 once the lanes were sorted by bank.)
//   Banks: all lanes of a warp add the same offset to their point's first
//   cell at each load, so two lanes meet on a bank when their first cells
//   do (32 random points: ~3.5 wavefronts a 4-byte load). With the tile
//   staged and the layout's lane order on (points_layout), the block sorts
//   the row's points by that bank (C = 1; the quad
//   of banks of a 16-byte load at C > 1) and gives a warp one point from
//   each bank's run (sort_lanes). At Cp = 8 a cell's first 4 columns lie on
//   4 of the 8 quads, so the passes over 4 columns start at chunk k mod
//   nq. Neither changes a sum's order.
//   Position gradient: the three axes share one pass over the cells: the
//   innermost sums s = sum A_I T and d = sum D_I T, then per O cell the sums
//   A_Mi s, D_Mi s, A_Mi d, then D_O (A_Mi s), A_O (D_Mi s), A_O (A_Mi d).
//   At C > 1 a cell's columns are first weighted by the point's w (read
//   once per point, coalesced): T = sum_c w_c tile[c, cell].
//
// Bound on the H100 at the 3D headline (n = 2^24, m = 2, T = 8, H = 13,
// 19,860 rows of K = 1024): the gather reads the tiles its rows name
// (~0.17 GB at C = 1) and the coordinates, and writes its (S, C, K)
// output: ~0.14 ms of bytes against ~0.14 ms of float32 operations (~2 C
// flops per cell, 216 cells a point, and the window values): bound by
// operations; pos_grad ~4 C flops a cell (0.27 ms). chip_smoke.py prints
// the bounds from its run's plan. What holds the kernels back: the
// shared-memory pipe, one load per cell and 4 columns, and its bank
// conflicts, most of which the lane order (Banks, above) removes (at C = 8
// it took both kernels from ~9.2 to ~6.2 ms on the H100); at C = 1 the
// rest is unmeasured (the cell loop's issue, the window evaluation: expf,
// sqrtf per point and axis).

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "tile.cuh"
#include "window.cuh"

namespace tnt {
namespace points {

constexpr int kMaxThreads = 256;     // __launch_bounds__: up to 255 registers
constexpr size_t kSmemOptIn = 232448;  // 227 KB, the H100's per-block limit

struct Args {
  const float* tiles;     // (NT, C, H^dim)
  const float* wts;       // (C, S K), the position gradient's weights
  const float* slot_pos;  // (dim, S K)
  const int* row_count;
  const int* origin;      // (S, dim)
  const int* tile_index;  // (S,)
  float* out;             // (S, C, K) gather; (S, dim, K) position gradient
  int S, K, C, NT, dim, H, M;
  Window w;
  float dcoef;            // ops/window.py:window_deriv_param
  int Cp;                 // columns a staged cell
  int order_at;           // the lane order's place in shared memory (floats), 0: none
};

// The window (and derivative) values of one coordinate on its L cells,
// phi(frac + m - l) with m = L / 2 - 1.
template <int L, bool kGrad>
__device__ __forceinline__ void role_window(const Window& w, float dcoef, float frac,
                                            float (&v)[L], float (&dv)[L]) {
  constexpr int m = L / 2 - 1;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const float t = __fadd_rn(frac, static_cast<float>(m - l));
    if (kGrad) {
      phi_and_deriv(w, dcoef, t, &v[l], &dv[l]);
    } else {
      v[l] = phi(w, t);
      dv[l] = 0.0f;
    }
  }
}

// The window of an axis the tile lacks: one cell of value 1.
template <int L>
__device__ __forceinline__ void unit_window(float (&v)[L], float (&dv)[L]) {
#pragma unroll
  for (int l = 0; l < L; ++l) {
    v[l] = l == 0 ? 1.0f : 0.0f;
    dv[l] = 0.0f;
  }
}

// v[l] for a run-time l, by selects: the array stays in registers.
template <int L>
__device__ __forceinline__ float pick(const float (&v)[L], int l) {
  float r = v[0];
#pragma unroll
  for (int i = 1; i < L; ++i) r = l == i ? v[i] : r;
  return r;
}

// One point's windows on the roles O, Mi, I; base is its first cell, lim0
// and lim1 the O and Mi cells the loops visit (L, or 1 for an axis the
// tile lacks).
template <int L>
struct PointWindows {
  float vO[L], vM[L], vI[L], dO[L], dM[L], dI[L];
  int base, lim0, lim1;
};

// The fractional parts f and the tile offsets o of slot j's coordinates.
// The _rn intrinsics keep the window argument free of fused multiply-adds,
// so it rounds as the plain PyTorch version's does.
__device__ __forceinline__ void cell_offsets(const Args& a, int m, size_t SK, size_t j,
                                             const int (&org)[3], float (&f)[3], int (&o)[3]) {
  const int M = a.M;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    f[d] = 0.0f;
    o[d] = 0;
    if (d < a.dim) {
      const float scaled = __fmul_rn(__ldg(a.slot_pos + d * SK + j), static_cast<float>(M));
      const float fl = floorf(scaled);
      f[d] = __fsub_rn(scaled, fl);
      int st = (static_cast<int>(fl) - m) % M;
      if (st < 0) st += M;
      int od = (st - org[d]) % M;
      if (od < 0) od += M;
      o[d] = od;
    }
  }
}

// The index of a point's first cell in the tile (cells of axis dim - 1
// adjacent).
__device__ __forceinline__ int first_cell(int dim, int H, const int (&o)[3]) {
  return dim == 3 ? (o[0] * H + o[1]) * H + o[2] : (dim == 2 ? o[0] * H + o[1] : o[0]);
}

template <int L, bool kGrad>
__device__ __forceinline__ void point_windows(const Args& a, size_t SK, size_t j,
                                              const int (&org)[3], PointWindows<L>& p) {
  const int dim = a.dim, H = a.H;
  float f[3];
  int o[3];
  cell_offsets(a, L / 2 - 1, SK, j, org, f, o);
  role_window<L, kGrad>(a.w, a.dcoef, dim == 3 ? f[2] : (dim == 2 ? f[1] : f[0]), p.vI, p.dI);
  if (dim == 3) {
    role_window<L, kGrad>(a.w, a.dcoef, f[1], p.vM, p.dM);
  } else {
    unit_window<L>(p.vM, p.dM);
  }
  if (dim >= 2) {
    role_window<L, kGrad>(a.w, a.dcoef, f[0], p.vO, p.dO);
  } else {
    unit_window<L>(p.vO, p.dO);
  }
  int oI = dim == 3 ? o[2] : (dim == 2 ? o[1] : o[0]);
  const int oO = dim >= 2 ? o[0] : 0, oM = dim == 3 ? o[1] : 0;
  const int HO = dim >= 2 ? H : 1, HM = dim == 3 ? H : 1;
  // A window past the tile's edge (no builder makes one) keeps the cells
  // inside: O and Mi stop at the edge; I moves back to H - L, its values
  // shifted up and zero below.
  if (oI + L > H) {
    const int shift = oI + L - H;
    oI = H - L;
#pragma unroll 1
    for (int q = 0; q < shift; ++q) {
#pragma unroll
      for (int l = L - 1; l > 0; --l) {
        p.vI[l] = p.vI[l - 1];
        p.dI[l] = p.dI[l - 1];
      }
      p.vI[0] = 0.0f;
      p.dI[0] = 0.0f;
    }
  }
  p.lim0 = min(dim >= 2 ? L : 1, HO - oO);
  p.lim1 = min(dim == 3 ? L : 1, HM - oM);
  p.base = (oO * HM + oM) * H + oI;
}

// A cell of the column (CW = 1: a float, from shared or, through the
// read-only cache, global memory) or of 4 columns (CW = 4: shared memory).
template <int CW, bool kSmem>
struct Cell;

template <bool kSmem>
struct Cell<1, kSmem> {
  using V = float;
  static __device__ __forceinline__ float load(const float* p) {
    if (kSmem) return *p;
    return __ldg(p);
  }
  static __device__ __forceinline__ float zero() { return 0.0f; }
  static __device__ __forceinline__ float fma(float a, float b, float c) { return fmaf(a, b, c); }
};

template <>
struct Cell<4, true> {
  using V = float4;
  static __device__ __forceinline__ float4 load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ float4 zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
  static __device__ __forceinline__ float4 fma(float a, float4 b, float4 c) {
    return make_float4(fmaf(a, b.x, c.x), fmaf(a, b.y, c.y), fmaf(a, b.z, c.z),
                       fmaf(a, b.w, c.w));
  }
};

// The gather's sum over the point's cells, t at its first cell; cells cs
// floats apart along I, sM along Mi, sO along O.
template <int L, int CW, bool kSmem>
__device__ __forceinline__ typename Cell<CW, kSmem>::V gather_cells(
    const float* t, const PointWindows<L>& p, int cs, int sO, int sM) {
  using X = Cell<CW, kSmem>;
  typename X::V acc = X::zero();
  for (int l0 = 0; l0 < p.lim0; ++l0) {
    const float* r1 = t + l0 * sO;
    typename X::V s1 = X::zero();
#pragma unroll
    for (int l1 = 0; l1 < L; ++l1) {
      if (l1 == p.lim1) break;
      const float* r = r1 + l1 * sM;
      typename X::V s2 = X::zero();
#pragma unroll
      for (int l2 = 0; l2 < L; ++l2) s2 = X::fma(p.vI[l2], X::load(r + l2 * cs), s2);
      s1 = X::fma(p.vM[l1], s2, s1);
    }
    acc = X::fma(pick(p.vO, l0), s1, acc);
  }
  return acc;
}

struct Sums3 {
  float o, m, i;  // the derivative sums on the roles O, Mi, I
};

// The cell's value for the position gradient: the column (CW = 1) or the
// 4 columns weighted by the point's w (CW = 4).
template <int CW, bool kSmem>
__device__ __forceinline__ float grad_cell(const float* p, const float4& w) {
  if constexpr (CW == 1) {
    return Cell<1, kSmem>::load(p);
  } else {
    const float4 c = Cell<4, true>::load(p);
    return fmaf(w.w, c.w, fmaf(w.z, c.z, fmaf(w.y, c.y, w.x * c.x)));
  }
}

template <int L, int CW, bool kSmem>
__device__ __forceinline__ Sums3 grad_cells(const float* t, const PointWindows<L>& p,
                                            const float4& w, int cs, int sO, int sM) {
  Sums3 acc{0.0f, 0.0f, 0.0f};
  for (int l0 = 0; l0 < p.lim0; ++l0) {
    const float* r1 = t + l0 * sO;
    float sv = 0.0f, sd1 = 0.0f, sd2 = 0.0f;
#pragma unroll
    for (int l1 = 0; l1 < L; ++l1) {
      if (l1 == p.lim1) break;
      const float* r = r1 + l1 * sM;
      float s2 = 0.0f, d2 = 0.0f;
#pragma unroll
      for (int l2 = 0; l2 < L; ++l2) {
        const float tv = grad_cell<CW, kSmem>(r + l2 * cs, w);
        s2 = fmaf(p.vI[l2], tv, s2);
        d2 = fmaf(p.dI[l2], tv, d2);
      }
      sv = fmaf(p.vM[l1], s2, sv);
      sd1 = fmaf(p.dM[l1], s2, sd1);
      sd2 = fmaf(p.vM[l1], d2, sd2);
    }
    const float a0 = pick(p.vO, l0);
    acc.o = fmaf(pick(p.dO, l0), sv, acc.o);
    acc.m = fmaf(a0, sd1, acc.m);
    acc.i = fmaf(a0, sd2, acc.i);
  }
  return acc;
}

// Copies the row's tile tl into shared memory; returns where it starts.
template <int CW>
__device__ __forceinline__ const float* stage(float* smem, const float* tl, int C, int Cp,
                                              int cells) {
  if constexpr (CW == 1) {
    // one column as it lies; 16-byte copies between a head and a tail of 4-byte ones
    const int shift = static_cast<int>((reinterpret_cast<uintptr_t>(tl) >> 2) & 3);
    float* dst = smem + shift;
    const int head = min(cells, (4 - shift) & 3);
    const int nvec = (cells - head) >> 2;
    for (int i = threadIdx.x; i < head; i += blockDim.x) cp_async4(dst + i, tl + i);
    for (int i = threadIdx.x; i < nvec; i += blockDim.x)
      cp_async16(dst + head + 4 * i, tl + head + 4 * i);
    for (int i = head + 4 * nvec + threadIdx.x; i < cells; i += blockDim.x)
      cp_async4(dst + i, tl + i);
    return dst;
  } else {
    // cell-major: column c of cell i at i Cp + c; columns C..Cp-1 zero
    for (int c = 0; c < Cp; ++c) {
      const float* src = tl + static_cast<size_t>(c) * cells;
      for (int i = threadIdx.x; i < cells; i += blockDim.x) {
        if (c < C) {
          cp_async4(smem + i * Cp + c, src + i);
        } else {
          smem[i * Cp + c] = 0.0f;
        }
      }
    }
    return smem;
  }
}

// The bank (C = 1: one of 32) or quad of banks (C > 1: one of 8; the first
// pass reads chunk k mod nq) that point k's first cell lies on; every load
// of the point adds the same offset to it.
template <int CW>
__device__ __forceinline__ int bank_key(int base, int k, int nq) {
  if constexpr (CW == 1) {
    return base & 31;
  } else {
    return (base * nq + k % nq) & 7;
  }
}

// The lane order of a row's cnt points in shared memory: order holds them
// sorted by bank_key (counts: 32 ints of scratch). A warp then takes the
// points at sorted positions i * stride + v, stride = ceil(cnt / KB), one
// from each key's run, so its lanes' loads fall on different banks (KB =
// 32 lanes, or 8: the lanes of one 16-byte phase). Only the lanes' order
// changes: each point's sums, and so the results, are the same bits.
template <int CW>
__device__ __forceinline__ void sort_lanes(const Args& a, int m, size_t SK, int s, int cnt,
                                           const int (&org)[3], int* order, int* counts) {
  constexpr int KB = CW == 1 ? 32 : 8;
  const int nq = a.Cp / 4, tid = threadIdx.x;
  const size_t row = static_cast<size_t>(s) * a.K;
  auto key = [&](int k) {
    float f[3];
    int o[3];
    cell_offsets(a, m, SK, row + k, org, f, o);
    return bank_key<CW>(first_cell(a.dim, a.H, o), k, nq);
  };
  if (tid < KB) counts[tid] = 0;
  __syncthreads();
  for (int k = tid; k < cnt; k += blockDim.x) atomicAdd(counts + key(k), 1);
  __syncthreads();
  if (tid == 0) {
    for (int b = 0, run = 0; b < KB; ++b) {
      const int c = counts[b];
      counts[b] = run;
      run += c;
    }
  }
  __syncthreads();
  for (int k = tid; k < cnt; k += blockDim.x) order[atomicAdd(counts + key(k), 1)] = k;
}

// (minBlocks = 1 lets ptxas take the registers a body needs: with the
// default it stopped some instantiations at 64, 80 or 128 registers and
// spilled the rest to the stack)
template <int L, int CW, bool kSmem, bool kGrad>
__global__ void __launch_bounds__(kMaxThreads, 1) points_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, s = blockIdx.x;
  const int dim = a.dim, H = a.H, K = a.K, C = a.C;
  const int HM = dim == 3 ? H : 1;
  const int cells = H * (dim >= 2 ? H : 1) * HM;
  const size_t SK = static_cast<size_t>(a.S) * K;
  const int cs = CW == 1 ? 1 : a.Cp;
  const int sM = H * cs, sO = HM * H * cs;
  const int n_out = kGrad ? dim : C;  // output planes of a row
  const int n_col = kSmem && CW == 1 ? 1 : C;  // column planes the CW = 1 path walks
  const int tile = a.tile_index[s];
  const int cnt = (tile >= 0 && tile < a.NT) ? a.row_count[s] : 0;
  float* out = a.out + static_cast<size_t>(s) * n_out * K;
  for (int c = 0; c < n_out; ++c)
    for (int k = cnt + tid; k < K; k += blockDim.x) out[c * K + k] = 0.0f;
  if (cnt == 0) return;  // (the whole block: cnt is the row's)
  const float* t = a.tiles + static_cast<size_t>(tile) * C * cells;
  int org[3] = {0, 0, 0};
#pragma unroll
  for (int d = 0; d < 3; ++d)
    if (d < dim) org[d] = a.origin[s * dim + d];
  const bool sorted = kSmem && a.order_at > 0;
  int* order = reinterpret_cast<int*>(smem + a.order_at);
  if constexpr (kSmem) {
    t = stage<CW>(smem, t, C, a.Cp, cells);
    // the lane order while the copies fly
    if (sorted) sort_lanes<CW>(a, L / 2 - 1, SK, s, cnt, org, order, order + K);
    cp_async_wait_all();
    __syncthreads();
  }
  // virtual points v: sorted, v = i KB + b takes sorted position b stride + i
  constexpr int KB = CW == 1 ? 32 : 8;
  const int stride = (cnt + KB - 1) / KB;
  const int V = sorted ? KB * stride : cnt;
  // At C > 1 the passes over 4 columns start at chunk k mod nq: at Cp = 8
  // a cell's chunk 0 lies on 4 of the 8 quads of banks, chunk 1 on the
  // other 4, so neighbouring points read both halves at once.
  const int nq = a.Cp / 4;
  for (int v = tid; v < V; v += blockDim.x) {
    int k = v;
    if (sorted) {
      const int pos = (v % KB) * stride + v / KB;
      if (pos >= cnt) continue;
      k = order[pos];
    }
    const size_t jg = static_cast<size_t>(s) * K + k;
    PointWindows<L> p;
    point_windows<L, kGrad>(a, SK, jg, org, p);
    const float* tp = t + static_cast<size_t>(p.base) * cs;
    if constexpr (!kGrad) {
      if constexpr (CW == 1) {
        for (int c = 0; c < n_col; ++c)
          out[c * K + k] =
              gather_cells<L, 1, kSmem>(tp + static_cast<size_t>(c) * cells, p, 1, sO, sM);
      } else {
        for (int i = 0; i < nq; ++i) {
          const int q = (i + k) % nq;
          const float4 e = gather_cells<L, 4, true>(tp + 4 * q, p, cs, sO, sM);
          const float ev[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (4 * q + u < C) out[(4 * q + u) * K + k] = ev[u];
        }
      }
    } else {
      Sums3 g{0.0f, 0.0f, 0.0f};
      if constexpr (CW == 1) {
        const float4 none = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int c = 0; c < n_col; ++c) {
          const Sums3 sc = grad_cells<L, 1, kSmem>(tp + static_cast<size_t>(c) * cells, p,
                                                   none, 1, sO, sM);
          const float wc = __ldg(a.wts + c * SK + jg);
          g.o = fmaf(wc, sc.o, g.o);
          g.m = fmaf(wc, sc.m, g.m);
          g.i = fmaf(wc, sc.i, g.i);
        }
      } else {
        for (int i = 0; i < nq; ++i) {
          const int q = (i + k) % nq;
          float wq[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            wq[u] = 4 * q + u < C ? __ldg(a.wts + (4 * q + u) * SK + jg) : 0.0f;
          const Sums3 sc = grad_cells<L, 4, true>(
              tp + 4 * q, p, make_float4(wq[0], wq[1], wq[2], wq[3]), cs, sO, sM);
          g.o += sc.o;
          g.m += sc.m;
          g.i += sc.i;
        }
      }
      if (dim >= 2) out[k] = g.o;
      if (dim == 3) out[K + k] = g.m;
      out[(dim - 1) * K + k] = g.i;
    }
  }
}

template <int L, int CW, bool kSmem, bool kGrad>
cudaError_t go(const Args& a, int blocks, int threads, size_t smem, cudaStream_t stream) {
  cudaError_t err = set_smem(points_kernel<L, CW, kSmem, kGrad>, smem);
  if (err != cudaSuccess) return err;
  points_kernel<L, CW, kSmem, kGrad><<<blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int L, bool kGrad>
cudaError_t go_L(const Args& a, bool staged, int blocks, int threads, size_t smem,
                 cudaStream_t stream) {
  if (!staged) return go<L, 1, false, kGrad>(a, blocks, threads, 0, stream);
  if (a.C == 1) return go<L, 1, true, kGrad>(a, blocks, threads, smem, stream);
  return go<L, 4, true, kGrad>(a, blocks, threads, smem, stream);
}

// Launches points_kernel, a block a plan row, as ops/contract.py:points_layout
// laid it out; layout holds threads, staged, Cp, shared bytes, sorted (the
// lane order after the staged tile: K + 32 ints).
template <bool kGrad>
int launch(Args a, int m, const int* layout, int device, void* stream_) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || a.S == 0) return static_cast<int>(err);
  const int threads = layout[0], Cp = layout[2];
  const bool staged = layout[1] != 0, sorted = layout[4] != 0;
  const size_t smem = static_cast<size_t>(layout[3]);
  size_t cells = a.H;
  for (int d = 1; d < a.dim; ++d) cells *= a.H;
  // floats of the staged tile (shifted by up to 3 at C = 1), 16-byte aligned
  const size_t tile = a.C == 1 ? (cells + 3 + 3) / 4 * 4 : Cp * cells;
  const size_t need = (tile + (sorted ? a.K + 32 : 0)) * sizeof(float);
  if (threads % 32 != 0 || threads < 32 || threads > kMaxThreads || a.dim < 1 || a.dim > 3 ||
      (sorted && !staged))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (staged && (smem < need || smem > kSmemOptIn ||
                 (a.C == 1 ? Cp != 1 : (Cp % 4 != 0 || Cp < a.C))))
    return static_cast<int>(cudaErrorInvalidValue);
  a.Cp = Cp;
  a.order_at = sorted ? static_cast<int>(tile) : 0;
  const int blocks = a.S;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  switch (2 * m + 2) {
    case 2: err = go_L<2, kGrad>(a, staged, blocks, threads, smem, stream); break;
    case 4: err = go_L<4, kGrad>(a, staged, blocks, threads, smem, stream); break;
    case 6: err = go_L<6, kGrad>(a, staged, blocks, threads, smem, stream); break;
    case 8: err = go_L<8, kGrad>(a, staged, blocks, threads, smem, stream); break;
    case 10: err = go_L<10, kGrad>(a, staged, blocks, threads, smem, stream); break;
    case 12: err = go_L<12, kGrad>(a, staged, blocks, threads, smem, stream); break;
    case 14: err = go_L<14, kGrad>(a, staged, blocks, threads, smem, stream); break;
    case 16: err = go_L<16, kGrad>(a, staged, blocks, threads, smem, stream); break;
    case 18: err = go_L<18, kGrad>(a, staged, blocks, threads, smem, stream); break;
    case 20: err = go_L<20, kGrad>(a, staged, blocks, threads, smem, stream); break;
    default: err = cudaErrorInvalidValue;  // ops/contract.py:MAX_L
  }
  return static_cast<int>(err);
}

}  // namespace points
}  // namespace tnt
