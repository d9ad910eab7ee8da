// Dense-tile fold and unfold for Hopper: the overlap-add of the halo tiles
// (NT, C, H, H^{dim-1}) onto the oversampled grid (B, C, M^dim), and its
// transpose.
//
// Replaces no Pallas kernel: the JAX package folds with XLA code
// (torch_nfft_tpu/ops/tilefold.py: fold_tiles_to_grid, unfold_grid_to_tiles).
// The port's plain versions (ops/tilefold.py: fold_tiles_to_grid_plain,
// unfold_grid_to_tiles_plain) are chains of PyTorch ops whose strided add_
// passes, cat copies and permutes write extended intermediates of up to
// 1.35 GB; on the card they took 9 to 14 times the byte bound.
//
// Geometry (ops/tilefold.py): nb = ceil(M / T) tiles per axis; cell u
// (0 <= u < H) of tile t lies on grid cell (t*T + u) mod M of its axis.
// Tile ids run row-major over (b, t_0, ..., t_{dim-1}), a tile's cells
// row-major over (c, u_0, ..., u_{dim-1}). Any M, T and H: M % T != 0, an
// extended axis (nb - 1) T + H that wraps more than once, J = ceil(H/T) >= 2.
//
// Bound on the H100: bytes. Each direction reads one array once and writes
// the other once, NT*C*H^dim + B*C*M^dim floats: 2.59 GB at the Gram
// geometry (M = 512, T = 16, H = 25, nb = 32) and 1.52 GB at the headline
// (M = 416, T = 8, H = 13, nb = 52), 0.77 and 0.455 ms at 3.35 TB/s.
//
// Fold, in gather form, with no atomics. Block q = tile * C + c owns the
// output block of tile (b, k_0, ..., k_{dim-1}), column c: cells
// [k_d T, k_d T + T) of each axis that lie below M. It first lists in
// shared memory, per axis d and offset r, the tile cells (t, u) that land on
// cell i = k_d T + r, as element offsets, in a fixed order (e = i, i + M, ...
// below the extended length, t falling); then each thread sums its cells'
// terms in that order, the last axis fastest, and writes each cell once.
// The order is fixed, so repeated calls agree bit for bit. A warp reads
// runs of T floats of a tile's rows (u in [0, T) of tile k_d, [T, H) of
// tile k_d - 1): each tile element is read once, and the neighbouring
// blocks that read the rest of its sectors run beside it (blocks run in
// tile order), so L2 serves those. Where no list holds more than two terms
// (nb T = M and J = 2, both benchmark geometries) a cell's 2^dim loads issue
// together, predicated; otherwise a loop takes any number.
//
// Unfold, one pass and a pure copy (bit for bit the plain unfold). Block
// q = tile * C + c writes that tile's column in order, four consecutive
// elements a thread as one 16-byte store (the column's unaligned ends a word
// at a time), so writes coalesce. It first tabulates in shared memory each
// axis's wrapped grid offset ((t_d T + u) mod M) * stride_d for u < H; each
// element then reads grid[sum_d offset_d(u_d)], the four of a store together.
// The grid is read through its strides (any layout, a view of a larger array
// or of a cotangent included), so no caller copies it first.
// A tile overlaps its neighbours' cells (H/T)^dim-fold (3.8 at the Gram
// geometry, 4.3 at the headline); blocks run in tile order, so the re-reads
// hit L2.

#include <cstdint>
#include <vector>

#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

using namespace tnt;

constexpr int kThreads = 256;
constexpr size_t kSmemMax = 232448;  // the H100's opt-in limit per block

__host__ __device__ __forceinline__ int64_t ipow(int64_t x, int n) {
  int64_t r = 1;
  for (int i = 0; i < n; ++i) r *= x;
  return r;
}

// kPair: no cell of an axis gets more than two terms.
template <int DIM, bool kPair>
__global__ void __launch_bounds__(kThreads) fold_kernel(
    const float* __restrict__ tiles, float* __restrict__ grid, int C, int M,
    int T, int H, int nb, int P, FastDiv div_t) {
  extern __shared__ int64_t fold_terms[];
  int64_t* off = fold_terms;  // [DIM][T][P] element offsets of the terms
  int* cnt = reinterpret_cast<int*>(off + DIM * T * P);  // [DIM][T] terms
  // 32-bit index arithmetic below (the launch keeps blocks under 2^31)
  const int q = blockIdx.x;
  const int c = q % C;
  int rest = q / C;
  int k[DIM];
#pragma unroll
  for (int d = DIM - 1; d >= 0; --d) {
    k[d] = rest % nb;
    rest /= nb;
  }
  const int64_t b = rest;
  const int64_t HD = ipow(H, DIM);
  const int ext = (nb - 1) * T + H;
  for (int j = threadIdx.x; j < DIM * T; j += blockDim.x) {
    const int d = j / T, r = j - d * T;
    const int64_t tile_stride = ipow(nb, DIM - 1 - d) * C * HD;
    const int64_t cell_stride = ipow(H, DIM - 1 - d);
    const int i = q / C / static_cast<int>(ipow(nb, DIM - 1 - d)) % nb * T + r;
    int64_t* o = off + static_cast<int64_t>(j) * P;
    int n = 0;
    if (i < M) {
      for (int e = i; e < ext; e += M) {
        const int lo = e < H ? 0 : (e - H) / T + 1;
        for (int t = min(nb - 1, e / T); t >= lo; --t) {
          o[n++] = t * tile_stride + (e - t * T) * cell_stride;
        }
      }
    }
    cnt[j] = n;
  }
  __syncthreads();
  // tile (b, 0, ..., 0), column c; and the grid of (b, c)
  const float* src = tiles + (b * ipow(nb, DIM) * C + c) * HD;
  float* dst = grid + (b * C + c) * ipow(M, DIM);
  const int cells = static_cast<int>(ipow(T, DIM));
  for (int idx = threadIdx.x; idx < cells; idx += blockDim.x) {
    int r[DIM];
    int left = idx;
#pragma unroll
    for (int d = DIM - 1; d > 0; --d) {
      const int qd = div_t(left);
      r[d] = left - qd * T;
      left = qd;
    }
    r[0] = left;
    bool inside = true;
    int64_t cell = 0;
    const int64_t* o[DIM];
    int n[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      const int i = k[d] * T + r[d];
      inside = inside && i < M;
      cell = cell * M + i;
      o[d] = off + static_cast<int64_t>(d * T + r[d]) * P;
      n[d] = cnt[d * T + r[d]];
    }
    if (!inside) continue;
    float acc = 0.f;
    if constexpr (kPair) {
      int64_t a[DIM][2];
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        a[d][0] = o[d][0];
        a[d][1] = n[d] > 1 ? o[d][1] : 0;
      }
      // every load first, then the sum in order: acc stays +0 or nonzero,
      // so adding 0 for a missing term changes no bit, and the order is the
      // loop's below
      float v[1 << DIM];
#pragma unroll
      for (int p = 0; p < (1 << DIM); ++p) {
        bool ok = true;
        int64_t at = 0;
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          const int pd = (p >> (DIM - 1 - d)) & 1;
          ok = ok && pd < n[d];
          at += a[d][pd];
        }
        v[p] = ok ? __ldg(src + at) : 0.f;
      }
#pragma unroll
      for (int p = 0; p < (1 << DIM); ++p) acc += v[p];
    } else {
      int total = 1;
#pragma unroll
      for (int d = 0; d < DIM; ++d) total *= n[d];
      for (int p = 0; p < total; ++p) {
        int pr = p;
        int64_t at = 0;
#pragma unroll
        for (int d = DIM - 1; d >= 0; --d) {
          at += o[d][pr % n[d]];
          pr /= n[d];
        }
        acc += __ldg(src + at);
      }
    }
    dst[cell] = acc;
  }
}

// Cell u of the next element of a tile, row-major: the last axis first.
template <int DIM>
__device__ __forceinline__ void next_cell(int* u, int H) {
#pragma unroll
  for (int d = DIM - 1; d > 0; --d) {
    if (++u[d] < H) return;
    u[d] = 0;
  }
  ++u[0];
}

// The grid's strides in elements: batch, column, then each axis.
struct GridStrides {
  int64_t b, c, axis[3];
};

template <int DIM>
__global__ void __launch_bounds__(kThreads) unfold_kernel(
    const float* __restrict__ grid, float* __restrict__ tiles, int C, int M,
    int T, int H, int nb, GridStrides st, FastDiv div_h) {
  extern __shared__ int64_t unfold_cells[];  // [DIM][H] wrapped grid offsets
  // 32-bit index arithmetic below (the launch keeps blocks under 2^31)
  const int q = blockIdx.x;
  const int c = q % C;
  const int tile = q / C;
  const int64_t b = tile / static_cast<int>(ipow(nb, DIM));
  for (int j = threadIdx.x; j < DIM * H; j += blockDim.x) {
    const int d = j / H, u = j - d * H;
    const int t = tile / static_cast<int>(ipow(nb, DIM - 1 - d)) % nb;
    // constant indices: a dynamic one would copy the strides to local memory
    const int64_t stride = d == 0 ? st.axis[0] : d == 1 ? st.axis[1] : st.axis[2];
    unfold_cells[j] = (t * T + u) % M * stride;
  }
  __syncthreads();
  const float* src = grid + b * st.b + c * st.c;
  const int HD = static_cast<int>(ipow(H, DIM));
  auto cell_of = [&](int j, int* u) {
#pragma unroll
    for (int d = DIM - 1; d > 0; --d) {
      const int qd = div_h(j);
      u[d] = j - qd * H;
      j = qd;
    }
    u[0] = j;
  };
  auto read = [&](const int* u) {
    int64_t at = 0;
#pragma unroll
    for (int d = 0; d < DIM; ++d) at += unfold_cells[d * H + u[d]];
    return __ldg(src + at);
  };
  // this column of the tile is tiles[base, base + HD): 16-byte vectors
  // [v_lo, v_hi) of the (16-byte aligned) array inside it, words at its ends
  const int64_t base = static_cast<int64_t>(q) * HD;
  const int64_t v_lo = (base + 3) >> 2;
  const int64_t v_hi = (base + HD) >> 2 > v_lo ? (base + HD) >> 2 : v_lo;
  const int head = static_cast<int>(4 * v_lo - base < HD ? 4 * v_lo - base : HD);
  const int tail = static_cast<int>(4 * v_hi - base > head ? 4 * v_hi - base : head);
  int u[DIM];
  if (threadIdx.x < head) {
    cell_of(threadIdx.x, u);
    tiles[base + threadIdx.x] = read(u);
  }
  if (threadIdx.x < HD - tail) {
    cell_of(tail + threadIdx.x, u);
    tiles[base + tail + threadIdx.x] = read(u);
  }
  float4* out = reinterpret_cast<float4*>(tiles);
  for (int64_t v = v_lo + threadIdx.x; v < v_hi; v += blockDim.x) {
    cell_of(static_cast<int>(4 * v - base), u);
    float x[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      x[s] = read(u);
      next_cell<DIM>(u, H);
    }
    out[v] = make_float4(x[0], x[1], x[2], x[3]);
  }
}

// Terms of the fullest grid cell of one axis: tile cells per grid cell.
int most_terms(int M, int T, int H, int nb) {
  std::vector<int> n(M, 0);
  int most = 0;
  for (int t = 0; t < nb; ++t) {
    for (int u = 0; u < H; ++u) {
      const int i = static_cast<int>((static_cast<int64_t>(t) * T + u) % M);
      most = ++n[i] > most ? n[i] : most;
    }
  }
  return most;
}

bool bad_geometry(int B, int C, int dim, int M, int T, int H, int nb) {
  return B < 0 || C < 0 || dim < 1 || dim > 3 || M < 1 || T < 1 || H < 1 ||
         nb != (M + T - 1) / T;
}

template <class Kernel, class... Args>
cudaError_t run(Kernel kernel, int64_t blocks, int threads, size_t smem,
                void* stream, Args... args) {
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}

// Threads a block for ``work`` items: four or more a thread, in whole warps,
// at most kThreads (phase 13 of chip_smoke.py: at the headline geometry 128
// threads a block beat 256 by a fifth in both kernels, at the Gram geometry
// they tie).
int threads_for(int64_t work) {
  const int64_t w = ((work + 3) / 4 + 31) / 32 * 32;
  return static_cast<int>(w < kThreads ? w : kThreads);
}

}  // namespace

extern "C" {

// T's divisor (mul_t, shift_t) from ops/ragged.py:fast_divisor.
int tnt_fold_tiles(const float* tiles, float* grid, int B, int C, int dim,
                   int M, int T, int H, int nb, uint32_t mul_t, int shift_t,
                   int device, void* stream) {
  if (bad_geometry(B, C, dim, M, T, H, nb)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  const int64_t blocks = B * ipow(nb, dim) * C;
  if (err != cudaSuccess || blocks == 0) return static_cast<int>(err);
  const int P = most_terms(M, T, H, nb);
  const size_t smem = static_cast<size_t>(dim) * T * (P * sizeof(int64_t) + sizeof(int));
  if (blocks > INT32_MAX || smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = threads_for(ipow(T, dim));
  const FastDiv div_t{mul_t, shift_t};
#define TNT_FOLD(D)                                                              \
  case D:                                                                        \
    err = P <= 2 ? run(fold_kernel<D, true>, blocks, threads, smem, stream,      \
                       tiles, grid, C, M, T, H, nb, P, div_t)                    \
                 : run(fold_kernel<D, false>, blocks, threads, smem, stream,     \
                       tiles, grid, C, M, T, H, nb, P, div_t);                   \
    break;
  switch (dim) {
    TNT_FOLD(1)
    TNT_FOLD(2)
    TNT_FOLD(3)
  }
#undef TNT_FOLD
  return static_cast<int>(err);
}

// The grid's strides in elements (batch, column, axes 0-2; 0 past dim), H's
// divisor (mul_h, shift_h) from ops/ragged.py:fast_divisor.
int tnt_unfold_grid(const float* grid, float* tiles, int B, int C, int dim,
                    int M, int T, int H, int nb, int64_t stride_b,
                    int64_t stride_c, int64_t stride_0, int64_t stride_1,
                    int64_t stride_2, uint32_t mul_h, int shift_h, int device,
                    void* stream) {
  if (bad_geometry(B, C, dim, M, T, H, nb)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  const int64_t blocks = B * ipow(nb, dim) * C;
  if (err != cudaSuccess || blocks == 0) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(dim) * H * sizeof(int64_t);
  if (blocks > INT32_MAX || smem > kSmemMax || ipow(H, dim) > INT32_MAX ||
      reinterpret_cast<uintptr_t>(tiles) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = threads_for((ipow(H, dim) + 3) / 4);
  const FastDiv div_h{mul_h, shift_h};
  const GridStrides st{stride_b, stride_c, {stride_0, stride_1, stride_2}};
#define TNT_UNFOLD(D)                                                            \
  case D:                                                                        \
    err = run(unfold_kernel<D>, blocks, threads, smem, stream, grid, tiles, C,   \
              M, T, H, nb, st, div_h);                                           \
    break;
  switch (dim) {
    TNT_UNFOLD(1)
    TNT_UNFOLD(2)
    TNT_UNFOLD(3)
  }
#undef TNT_UNFOLD
  return static_cast<int>(err);
}

}  // extern "C"
