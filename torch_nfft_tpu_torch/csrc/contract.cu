// Spread and gather window contractions of the binned NFFT, for Hopper.
//
// Replaces the TPU kernels of the JAX package's ops/pallas/contract.py:
//   tnt_spread_tiles_dense  <- spread_tiles_dense_pallas (kernel
//       _spread_dense_kernel) and its row-batched twin spread_tiles_rb_pallas;
//   tnt_gather_points       <- gather_points_pallas (kernel _gather_kernel)
//       and its row-batched twin gather_points_rb_pallas.
//
// What they compute. A plan row s holds row_count[s] <= K points of one
// tile (origin o_s, halo edge H = T + 2m + 1). Point k has, per axis d, a
// window start cell w = (floor(M x_kd) - m) mod M, offset o = (w - o_sd) mod M
// in [0, T), and window values phi(frac + m - l), l in [0, 2m+2), at tile
// cells u = o + l. Spread adds x_k * prod_d phi_d into those L^dim cells of
// the row's dense tile; gather sums the same cells of the tile weighted by
// the same products.
//
// Design. The TPU kernels evaluate each window over all H cells of an axis
// and contract densely on the matrix unit; only L = 2m+2 of the H cells are
// non-zero. Here every thread takes one point and loops over its L^dim
// support only (216 cells at m = 2 in 3D), 8x fewer products than the
// dense H^3 = 2197 at the 3D headline.
//   spread: the dense tile array has no grid order to lean on, so each tile
//   is owned by exactly one block: the block of the first row of the tile's
//   run of rows (rows are sorted by tile). It walks the run, accumulates in
//   shared memory with atomicAdd (2197 floats per channel at the headline),
//   and stores the finished tile with plain stores — no global atomics, and
//   tiles no row visits keep the zeros the wrapper wrote. Blocks of the
//   other rows of a run exit at once. A tile larger than the shared memory
//   a block may use accumulates with atomicAdd straight in global memory
//   (still one block per tile). The float sums follow the atomics' order,
//   so results agree with the plain version to float32 rounding, not bits.
//   gather: one block per row; each thread sums the support cells of its
//   point from the row's tile (read through the read-only cache; the 8.8 KB
//   tile stays in L1 for the block) and writes y[s, c, k]; empty slots get 0.
//
// Bound on the H100 at the 3D headline (n = 2^24, N = 256, sigma = 1.625,
// m = 2, T = 8, K = 1024, 19,860 rows, NT = 52^3 tiles of H^3 = 2197 cells),
// counting only the n filled slots' values and coordinates (neither kernel
// reads a padded slot):
//   spread reads ~0.27 GB (values and coordinates) and writes the 1.24 GB
//   dense tile array: bytes bound, ~0.45 ms at 3.35 TB/s; its ~9.7e9 flops
//   (per point 3 x 6 window values at ~8 flops, 216 cells at 2 flops) take
//   ~0.14 ms at 67 TFLOP/s float32.
//   gather reads the ~0.17 GB of tiles the rows name and ~0.2 GB of
//   coordinates, and writes its (S, C, K) output, padded zeros included
//   (~0.08 GB): ~0.14 ms of bytes against ~0.14 ms of the same flops, so
//   it is bound by operations, by a hair. Both kernels lose most to the
//   per-point window evaluation (expf, sqrtf) and, in spread, to
//   shared-memory atomic contention. chip_smoke.py computes both bounds
//   from its run's plan (bounds()) and prints them beside the times.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (torch_nfft_tpu_torch/_build.py). Plain C interface:
// every function returns the cudaError_t of its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxL = 20;  // window cells per axis: 2m + 2 <= 20
constexpr int kThreads = 256;
constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kSmemOptIn = 232448;  // 227 KB, the H100's per-block limit

struct Window {
  int kind;  // 0 gaussian, 1 es, 2 kb (ops/window.py:window_params)
  float p0, p1, p2;
};

// Modified Bessel I0 for x >= 0, Abramowitz-Stegun 9.8.1/9.8.2.
__device__ __forceinline__ float bessel_i0(float x) {
  if (x < 3.75f) {
    float y = x / 3.75f;
    y = y * y;
    return 1.0f + y * (3.5156229f + y * (3.0899424f + y * (1.2067492f +
           y * (0.2659732f + y * (0.0360768f + y * 0.0045813f)))));
  }
  const float z = 3.75f / x;
  const float p = 0.39894228f + z * (0.01328592f + z * (0.00225319f + z * (
      -0.00157565f + z * (0.00916281f + z * (-0.02057706f + z * (
      0.02635537f + z * (-0.01647633f + z * 0.00392377f)))))));
  return expf(x) * rsqrtf(x) * p;
}

__device__ __forceinline__ float phi(const Window& w, float t) {
  const float t2 = __fmul_rn(t, t);
  if (w.kind == 0) return expf(-t2 * w.p0) * w.p1;
  const float s2 = __fsub_rn(1.0f, __fmul_rn(t2, w.p1));
  if (!(s2 > 0.0f)) return 0.0f;
  const float s = sqrtf(s2);
  if (w.kind == 1) return expf(w.p0 * (s - 1.0f));
  return bessel_i0(w.p0 * s) * w.p2;
}

// Window values of one coordinate on its L cells; returns the offset o of
// the first cell inside the row's tile. The _rn intrinsics keep the window
// argument free of fused multiply-adds, so it rounds exactly as the plain
// PyTorch version does (frac would otherwise move by up to an ulp of M*x).
__device__ __forceinline__ int axis_window(float p, int org, int M, int m,
                                           int L, const Window& w, float* v) {
  const float scaled = __fmul_rn(p, static_cast<float>(M));
  const float fl = floorf(scaled);
  const float frac = __fsub_rn(scaled, fl);
  int s = (static_cast<int>(fl) - m) % M;
  if (s < 0) s += M;
  int o = (s - org) % M;
  if (o < 0) o += M;
  for (int l = 0; l < L; ++l) v[l] = phi(w, __fadd_rn(frac, static_cast<float>(m - l)));
  return o;
}

struct Geometry {
  int dim, H, H1, H2, L, L1, L2, cells;
  __device__ Geometry(int dim_, int H_, int m) : dim(dim_), H(H_) {
    H1 = dim >= 2 ? H : 1;
    H2 = dim >= 3 ? H : 1;
    L = 2 * m + 2;
    L1 = dim >= 2 ? L : 1;
    L2 = dim >= 3 ? L : 1;
    cells = H * H1 * H2;
  }
};

// Windows of slot j of row s on every axis; o[d] the cell offsets.
__device__ __forceinline__ void point_windows(
    const float* __restrict__ slot_pos, const int* __restrict__ origin,
    size_t SK, size_t j, int s, const Geometry& g, int M, int m,
    const Window& w, int* o, float (*v)[kMaxL]) {
  o[1] = o[2] = 0;
  v[1][0] = v[2][0] = 1.0f;
  for (int d = 0; d < g.dim; ++d)
    o[d] = axis_window(slot_pos[d * SK + j], origin[s * g.dim + d], M, m,
                       g.L, w, v[d]);
}

__global__ void __launch_bounds__(kThreads) spread_dense_kernel(
    const float* __restrict__ vals, const float* __restrict__ slot_pos,
    const int* __restrict__ row_count, const int* __restrict__ origin,
    const int* __restrict__ tile_id, float* __restrict__ out, int S, int K,
    int C, int NT, int dim, int H, int M, int m, Window w, int use_smem) {
  const int first = blockIdx.x;
  const int tile = tile_id[first];
  if (tile < 0 || tile >= NT) return;
  if (first > 0 && tile_id[first - 1] == tile) return;  // not the run's owner
  const Geometry g(dim, H, m);
  const size_t SK = static_cast<size_t>(S) * K;
  extern __shared__ float smem[];
  float* dst = out + static_cast<size_t>(tile) * C * g.cells;
  float* acc = use_smem ? smem : dst;
  if (use_smem) {
    for (int i = threadIdx.x; i < C * g.cells; i += blockDim.x) smem[i] = 0.0f;
    __syncthreads();
  }
  for (int s = first; s < S && tile_id[s] == tile; ++s) {
    const int cnt = row_count[s];
    for (int k = threadIdx.x; k < cnt; k += blockDim.x) {
      const size_t j = static_cast<size_t>(s) * K + k;
      int o[3];
      float v[3][kMaxL];
      point_windows(slot_pos, origin, SK, j, s, g, M, m, w, o, v);
      for (int c = 0; c < C; ++c) {
        const float x = vals[c * SK + j];
        float* a = acc + c * g.cells;
        for (int l0 = 0; l0 < g.L && o[0] + l0 < g.H; ++l0) {
          const float x0 = x * v[0][l0];
          for (int l1 = 0; l1 < g.L1 && o[1] + l1 < g.H1; ++l1) {
            const float x01 = x0 * v[1][l1];
            float* r = a + ((o[0] + l0) * g.H1 + o[1] + l1) * g.H2 + o[2];
            for (int l2 = 0; l2 < g.L2 && o[2] + l2 < g.H2; ++l2)
              atomicAdd(r + l2, x01 * v[2][l2]);
          }
        }
      }
    }
  }
  if (use_smem) {
    __syncthreads();
    for (int i = threadIdx.x; i < C * g.cells; i += blockDim.x) dst[i] = smem[i];
  }
}

__global__ void __launch_bounds__(kThreads) gather_kernel(
    const float* __restrict__ tiles, const float* __restrict__ slot_pos,
    const int* __restrict__ row_count, const int* __restrict__ origin,
    const int* __restrict__ tile_index, float* __restrict__ y, int S, int K,
    int C, int NT, int dim, int H, int M, int m, Window w) {
  const int s = blockIdx.x;
  const int tile = tile_index[s];
  const int cnt = (tile >= 0 && tile < NT) ? row_count[s] : 0;
  const Geometry g(dim, H, m);
  const size_t SK = static_cast<size_t>(S) * K;
  float* ys = y + static_cast<size_t>(s) * C * K;
  const float* tl = tiles + static_cast<size_t>(cnt > 0 ? tile : 0) * C * g.cells;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    if (k >= cnt) {
      for (int c = 0; c < C; ++c) ys[c * K + k] = 0.0f;
      continue;
    }
    int o[3];
    float v[3][kMaxL];
    point_windows(slot_pos, origin, SK, static_cast<size_t>(s) * K + k, s, g,
                  M, m, w, o, v);
    for (int c = 0; c < C; ++c) {
      const float* a = tl + c * g.cells;
      float sum = 0.0f;
      for (int l0 = 0; l0 < g.L && o[0] + l0 < g.H; ++l0) {
        float s1 = 0.0f;
        for (int l1 = 0; l1 < g.L1 && o[1] + l1 < g.H1; ++l1) {
          const float* r = a + ((o[0] + l0) * g.H1 + o[1] + l1) * g.H2 + o[2];
          float s2 = 0.0f;
          for (int l2 = 0; l2 < g.L2 && o[2] + l2 < g.H2; ++l2)
            s2 += v[2][l2] * __ldg(r + l2);
          s1 += v[1][l1] * s2;
        }
        sum += v[0][l0] * s1;
      }
      ys[c * K + k] = sum;
    }
  }
}

}  // namespace

extern "C" {

int tnt_spread_tiles_dense(const float* vals, const float* slot_pos,
                           const int* row_count, const int* origin,
                           const int* tile_id, float* out, int S, int K, int C,
                           int NT, int dim, int H, int M, int m, int kind,
                           float p0, float p1, float p2, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || S == 0) return static_cast<int>(err);
  size_t cells = H;
  for (int d = 1; d < dim; ++d) cells *= H;
  const size_t smem = cells * C * sizeof(float);
  const int use_smem = smem <= kSmemOptIn;
  if (use_smem && smem > kSmemDefault) {
    err = cudaFuncSetAttribute(spread_dense_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  spread_dense_kernel<<<S, kThreads, use_smem ? smem : 0,
                        static_cast<cudaStream_t>(stream)>>>(
      vals, slot_pos, row_count, origin, tile_id, out, S, K, C, NT, dim, H, M,
      m, Window{kind, p0, p1, p2}, use_smem);
  return static_cast<int>(cudaGetLastError());
}

int tnt_gather_points(const float* tiles, const float* slot_pos,
                      const int* row_count, const int* origin,
                      const int* tile_index, float* y, int S, int K, int C,
                      int NT, int dim, int H, int M, int m, int kind, float p0,
                      float p1, float p2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || S == 0) return static_cast<int>(err);
  gather_kernel<<<S, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tiles, slot_pos, row_count, origin, tile_index, y, S, K, C, NT, dim, H,
      M, m, Window{kind, p0, p1, p2});
  return static_cast<int>(cudaGetLastError());
}

const char* tnt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
