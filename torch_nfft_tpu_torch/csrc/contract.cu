// Spread, gather and position-gradient window contractions of the binned
// NFFT, for Hopper.
//
// Replaces the TPU kernels of the JAX package's ops/pallas/contract.py:
//   tnt_spread_tiles_dense_contract, tnt_spread_tiles_dense
//                           <- spread_tiles_dense_pallas (kernel
//       _spread_dense_kernel) and its row-batched twin spread_tiles_rb_pallas;
//   tnt_gather_points       <- gather_points_pallas (kernel _gather_kernel)
//       and its row-batched twin gather_points_rb_pallas;
//   tnt_pos_grad            <- pos_grad_pallas (kernel _pos_grad_kernel);
//   tnt_spread_tiles_contract, tnt_spread_tiles
//                           <- spread_tiles_pallas (kernel _spread_kernel),
//       the per-row tiles of the flat-grid route.
//
// What they compute. A plan row s holds row_count[s] <= K points of one
// tile (origin o_s, halo edge H = T + 2m + 1). Point k has, per axis d, a
// window start cell w = (floor(M x_kd) - m) mod M, offset o = (w - o_sd) mod M
// in [0, T), and window values phi(frac + m - l), l in [0, 2m+2), at tile
// cells u = o + l. Spread adds x_k * prod_d phi_d into those L^dim cells of
// the row's dense tile; gather sums the same cells of the tile weighted by
// the same products.
//
// Design of the spreads: two designs, chosen per call by the tile's
// geometry (ops/contract.py:spread_design).
//   contraction (spread_contract_kernel; tnt_*_contract): the TPU kernels'
//   dense form. The tile is the matrix OUT[(c,u), (v,w)] = sum_k x_c A0 (x)
//   (A1 A2), a register-tiled FP32 contraction over the row's points with
//   every output in one thread's register: no atomics, and each output sums
//   its points in slot order, so the result is the same bits on every run
//   and for every chunk and band size. It does H^dim / L^dim
//   times the sparse work (10.2x at the 3D headline, T = 8: 2197 against
//   216 multiply-adds per point and column), on FMA units that are far
//   faster than contended shared-memory atomics. It runs while that ratio
//   is at most ops/contract.py:DENSE_RATIO_MAX. Both routes share it: per
//   row (B7) every block stores its band of its row's tile (a row with no
//   points stores zeros); dense tiles (B1) are owned by the block of the
//   first row of each tile's run of rows (rows are sorted by tile), which
//   walks the run and stores the tile once; tiles no row visits keep the
//   zeros the wrapper wrote.
//   wide (spread_kernel; tnt_spread_tiles, tnt_spread_tiles_dense): the
//   sparse form for wider tiles. Every thread takes one point and adds its
//   L^dim support (216 cells at m = 2 in 3D) into the tile in shared memory
//   with atomicAdd, one owning block per tile as above; a tile larger than
//   the shared memory a block may use accumulates with atomicAdd straight
//   in global memory (B7 zeroes its tile first). The float sums follow the
//   atomics' order, so results agree with the plain version to float32
//   rounding, not bits, and vary from run to run.
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
//   per-row spread (B7) at C columns reads the values and coordinates of
//   the n filled slots (0.2 + 0.07 C GB) and writes S C H^3 floats
//   (0.175 C GB): ~0.64 ms of bytes at C = 8, against ~6.0e10 flops
//   (~0.90 ms): bound by operations (at C = 1, 0.13 against 0.14 ms).
//   The contraction issues more: n points x (C H rows, each band padded
//   to a multiple of the thread tile's 8 rows) x (H^{dim-1} columns,
//   padded to 8) multiply-adds, 16 x 176 per point at C = 1 (one band of
//   13 rows) and 112 x 176 at C = 8 (bands of R = 56 rows, the second
//   holding 48, each issuing 7 x 8) (9.4e10 and 6.6e11 flops: 1.4 and 9.9
//   ms at 67 TFLOP/s), besides forming each point's operands once per band. chip_smoke.py prints both the share of the bound and the
//   issued flops' share of the float32 peak.
//   gather reads the ~0.17 GB of tiles the rows name and ~0.2 GB of
//   coordinates, and writes its (S, C, K) output, padded zeros included
//   (~0.08 GB): ~0.14 ms of bytes against ~0.14 ms of the same flops, so
//   it is bound by operations, by a hair. chip_smoke.py computes the
//   bounds from its run's plan (bounds()) and prints them beside the times.
// What holds the kernels back: the wide spread, its shared-memory atomics
// (about 1.7 a clock per SM at C = 8); the contraction, the issue of its
// FMAs and 16-byte shared loads (8 x 8 outputs a thread: 4 loads per 64
// FMAs) and, at C = 1 where the band has only 13 rows, forming each
// point's operands (its windows, one row of X and of KR); the gather, the
// per-point window evaluation (expf, sqrtf).
//
// Position gradient (the position cotangent of both spread and gather).
// For each filled slot k of row s, with D_d = M phi'(t) the derivative
// window on axis d and w the per-point weights (the values x for the
// spread's backward, the point cotangent for the gather's):
//   dpos[s, d, k] = sum_c w[c, k] sum_cells T[c, cells] D_d prod_{e!=d} A_e
// The kernel takes the gather's design: one block per row, one thread per
// point, A and D built once per axis in registers, the row's tile read
// through __ldg. The three axes share one pass over the L^dim support: the
// innermost sums s = sum_w A_2 T and d = sum_w D_2 T (2 multiply-adds per
// cell), then per (u, v) A_1 s, D_1 s, A_1 d, and per u D_0 (A_1 s),
// A_0 (D_1 s), A_0 (A_1 d). Padded slots are written as 0. At the 3D
// headline it reads the same tiles and coordinates as the gather, plus the
// n weights, and writes the (S, 3, K) output (~0.24 GB): ~4 flops per cell
// and channel against the gather's 2, so it is bound by operations
// (chip_smoke.py:bounds).
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

// Modified Bessel I1 for x >= 0, Abramowitz-Stegun 9.8.3/9.8.4.
__device__ __forceinline__ float bessel_i1(float x) {
  if (x < 3.75f) {
    float y = x / 3.75f;
    y = y * y;
    return x * (0.5f + y * (0.87890594f + y * (0.51498869f + y * (
        0.15084934f + y * (0.02658733f + y * (0.00301532f + y * 0.00032411f))))));
  }
  const float z = 3.75f / x;
  const float inner = 0.02282967f + z * (-0.02895312f + z * (0.01787654f - z * 0.00420059f));
  const float p = 0.39894228f + z * (-0.03988024f + z * (-0.00362018f + z * (
      0.00163801f + z * (-0.01031555f + z * inner))));
  return expf(x) * rsqrtf(x) * p;
}

// phi(t) and d phi / d pos = c t phi (gaussian), c t / s phi (es),
// c t / s I1(beta s) / I0(beta) (kb), with c = dcoef
// (ops/window.py:window_deriv_param) and 1/s clamped at s = 1e-6.
__device__ __forceinline__ void phi_and_deriv(const Window& w, float dcoef,
                                              float t, float* val,
                                              float* der) {
  const float t2 = __fmul_rn(t, t);
  if (w.kind == 0) {
    const float v = expf(-t2 * w.p0) * w.p1;
    *val = v;
    *der = dcoef * t * v;
    return;
  }
  const float s2 = __fsub_rn(1.0f, __fmul_rn(t2, w.p1));
  if (!(s2 > 0.0f)) {
    *val = 0.0f;
    *der = 0.0f;
    return;
  }
  const float s = sqrtf(s2);
  const float q = dcoef * t / fmaxf(s, 1e-6f);
  if (w.kind == 1) {
    const float v = expf(w.p0 * (s - 1.0f));
    *val = v;
    *der = q * v;
    return;
  }
  const float bs = w.p0 * s;
  *val = bessel_i0(bs) * w.p2;
  *der = q * bessel_i1(bs) * w.p2;
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

// axis_window with the derivative windows dv beside the values v.
__device__ __forceinline__ int axis_window_deriv(float p, int org, int M,
                                                 int m, int L, const Window& w,
                                                 float dcoef, float* v,
                                                 float* dv) {
  const float scaled = __fmul_rn(p, static_cast<float>(M));
  const float fl = floorf(scaled);
  const float frac = __fsub_rn(scaled, fl);
  int s = (static_cast<int>(fl) - m) % M;
  if (s < 0) s += M;
  int o = (s - org) % M;
  if (o < 0) o += M;
  for (int l = 0; l < L; ++l)
    phi_and_deriv(w, dcoef, __fadd_rn(frac, static_cast<float>(m - l)), v + l,
                  dv + l);
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

// The spread of both routes. kPerRow = false (B1): each tile's run of rows
// accumulates into the dense tile tile_id[s], owned by the block of the
// run's first row. kPerRow = true (B7): block s forms row s's own tile,
// out[s]. Accumulation is in shared memory when use_smem, else by global
// atomics on the owned slice (which B7 zeroes first; B1's wrapper zeroes
// the whole array).
template <bool kPerRow>
__global__ void __launch_bounds__(kThreads) spread_kernel(
    const float* __restrict__ vals, const float* __restrict__ slot_pos,
    const int* __restrict__ row_count, const int* __restrict__ origin,
    const int* __restrict__ tile_id, float* __restrict__ out, int S, int K,
    int C, int NT, int dim, int H, int M, int m, Window w, int use_smem) {
  const int first = blockIdx.x;
  int tile = first;
  if (!kPerRow) {
    tile = tile_id[first];
    if (tile < 0 || tile >= NT) return;
    if (first > 0 && tile_id[first - 1] == tile) return;  // not the run's owner
  }
  const Geometry g(dim, H, m);
  const size_t SK = static_cast<size_t>(S) * K;
  extern __shared__ float smem[];
  float* dst = out + static_cast<size_t>(tile) * C * g.cells;
  float* acc = use_smem ? smem : dst;
  if (use_smem || kPerRow) {
    for (int i = threadIdx.x; i < C * g.cells; i += blockDim.x) acc[i] = 0.0f;
    __syncthreads();
  }
  const int last = kPerRow ? first + 1 : S;
  for (int s = first; s < last && (kPerRow || tile_id[s] == tile); ++s) {
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

// The spread of both routes as a register-tiled contraction (the
// "contraction" design; the kernel above is the "wide" design). A row's
// tile is the matrix OUT[(c,u), (v,w)] = sum_k X[k,(c,u)] KR[k,(v,w)] with
// X[k,(c,u)] = x_c[k] A0[k,u] and KR[k,(v,w)] = A1[k,v] A2[k,w] (KR = A1 in
// 2D, 1 in 1D). Block (s, y) owns band y of OUT: rows [r0, r0 + R) and
// columns [p0, p0 + PB). Thread t (< RG * CG; ty = t % RG, tx = t / RG)
// holds kTM rows (float4 groups ty + g RG) by kTN columns (float4 groups
// tx + g CG) of the band in registers for the whole row (kPerRow) or the
// whole run of rows of its tile (B1, owned by the block of the run's first
// row). Points go in chunks of KC through two shared-memory buffers. Before
// the block contracts one chunk, each warp starts cp.async copies of the
// next chunk's coordinates and values for its own run of points; after,
// it turns them into that chunk's operands (per point and axis the window
// as a dense row of H values, then the points' rows of X and KR, each
// entry one product looked up through the band's row and column tables),
// so the loads' latency hides behind the products and one barrier a chunk
// orders both. Each thread adds its kTM x kTN outer products point by
// point, in slot order (an 8 x 8 tile: one 16-byte shared load per 16
// FMAs). No atomics: every output is one thread's register, summed over
// the points in slot order whatever KC, R and PB are, so results are the
// same bits from run to run and from one band or chunk size to another.
// Last the band goes through shared memory to global memory in 16-byte
// stores.
// The launch's layout comes whole from ops/contract.py:spread_design (its
// TM, TN, MAX_THREADS are kTM, kTN, kMaxThreadsRT; the launch refuses
// another thread tile).
constexpr int kMaxThreadsRT = 512;  // 128 registers a thread
constexpr int kTM = 8, kTN = 8;      // rows, columns of OUT a thread holds

struct Band {
  int R, PB, KC;   // rows and columns of a band, points per chunk
  int RG, CG;      // thread rows (R / kTM) and columns (PB / kTN), rounded up
  int col_bands;   // bands across the columns (blockIdx.y = rb * col_bands + cb)
  int NCH;         // most channels the rows of one band touch
  int buf;         // floats a chunk buffer: at least
                   // KC (RG kTM + CG kTN + dim H + 2 + dim + NCH), 16 B aligned
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <bool kPerRow>
__global__ void __launch_bounds__(kMaxThreadsRT) spread_contract_kernel(
    const float* __restrict__ vals, const float* __restrict__ slot_pos,
    const int* __restrict__ row_count, const int* __restrict__ origin,
    const int* __restrict__ tile_id, float* __restrict__ out, int S, int K,
    int C, int NT, int dim, int H, int M, int m, Window w, Band b) {
  const int first = blockIdx.x;
  int tile = first;
  if (!kPerRow) {
    tile = tile_id[first];
    if (tile < 0 || tile >= NT) return;
    if (first > 0 && tile_id[first - 1] == tile) return;  // not the run's owner
  }
  const Geometry g(dim, H, m);
  const int L = g.L;
  const int P = g.H1 * g.H2;  // columns of OUT
  const int rb = blockIdx.y / b.col_bands;
  const int r0 = rb * b.R, p0 = (blockIdx.y - rb * b.col_bands) * b.PB;
  const int Rv = min(b.R, C * H - r0), PBv = min(b.PB, P - p0);
  const int Rpad = b.RG * kTM, Ppad = b.CG * kTN, KC = b.KC;
  const int rq = Rpad / 4, pq = Ppad / 4;
  const size_t SK = static_cast<size_t>(S) * K;
  // channels the band's rows touch
  const int c_lo = r0 / H, n_ch = (r0 + Rv - 1) / H - c_lo + 1;

  // the band's row and column tables, then two chunk buffers. A point's
  // windows are ADS = dim H + 2 floats: dense rows (0 outside its L cells)
  // per axis, then a 0 and a 1. X[k, r] = x_{c_lo + row_c[r]} A0[row_u[r]]
  // (0 where row_c < 0); KR[k, p] = win[col_i1[p]] win[col_i2[p]], the
  // indices pointing at the 1 for an axis the geometry lacks and at the 0
  // past the band. A buffer holds [KC][Rpad] X, [KC][Ppad] KR, [KC][ADS]
  // windows, and the staged [dim][KC] coordinates and [NCH][KC] values.
  extern __shared__ __align__(16) float smem[];
  const int ADS = dim * H + 2, kZero = dim * H, kOne = dim * H + 1;
  int* row_c = reinterpret_cast<int*>(smem);
  int* row_u = row_c + Rpad;
  int* col_i1 = row_u + Rpad;
  int* col_i2 = col_i1 + Ppad;
  float* bufs = smem + 2 * (Rpad + Ppad);
  const int buf_floats = b.buf;
  for (int i = threadIdx.x; i < Rpad; i += blockDim.x) {
    const int r = r0 + i, c = r / H;
    row_c[i] = i < Rv ? c - c_lo : -1;
    row_u[i] = r - c * H;
  }
  for (int i = threadIdx.x; i < Ppad; i += blockDim.x) {
    const int p = p0 + i;
    int i1 = kOne, i2 = kOne;
    if (i >= PBv) {
      i1 = kZero;
    } else if (dim == 3) {
      i1 = H + p / H;
      i2 = 2 * H + p % H;
    } else if (dim == 2) {
      i1 = H + p;
    }
    col_i1[i] = i1;
    col_i2[i] = i2;
  }
  __syncthreads();

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n_warps = blockDim.x >> 5;
  const bool active = t < b.RG * b.CG;
  const int ty = t % b.RG, tx = t / b.RG;

  // A chunk of nk points from slot j0 of row s: each warp takes the run
  // [ka, ka + cw) of it.
  struct Chunk {
    int s, ka, cw;
    size_t j0;
  };
  auto chunk = [&](int s, size_t j0, int nk) {
    const int per = (nk + n_warps - 1) / n_warps;
    const int ka = min(nk, warp * per);
    return Chunk{s, ka, min(nk, ka + per) - ka, j0};
  };
  // start the copies of the warp's coordinates and values into buffer bi
  auto stage = [&](const Chunk& ch, int bi) {
    float* pos_s = bufs + bi * buf_floats + KC * (Rpad + Ppad + ADS);
    float* val_s = pos_s + KC * dim;
    for (int e = lane; e < dim * ch.cw; e += 32) {
      const int d = e / ch.cw, q = ch.ka + e - d * ch.cw;
      cp_async4(pos_s + d * KC + q, slot_pos + d * SK + ch.j0 + q);
    }
    for (int e = lane; e < n_ch * ch.cw; e += 32) {
      const int ci = e / ch.cw, q = ch.ka + e - ci * ch.cw;
      cp_async4(val_s + ci * KC + q, vals + (c_lo + ci) * SK + ch.j0 + q);
    }
  };
  // wait for them and form the warp's rows of X and KR in buffer bi
  auto form = [&](const Chunk& ch, int bi) {
    float* xs = bufs + bi * buf_floats;
    float* kr = xs + KC * Rpad;
    float* ad = kr + KC * Ppad;
    const float* pos_s = ad + KC * ADS;
    const float* val_s = pos_s + KC * dim;
    cp_async_wait_all();
    __syncwarp();
    // dense windows, one (point, axis) a lane
    for (int e = lane; e < ch.cw * dim; e += 32) {
      const int q = e / dim, d = e - q * dim, k = ch.ka + q;
      const float scaled = __fmul_rn(pos_s[d * KC + k], static_cast<float>(M));
      const float fl = floorf(scaled);
      const float frac = __fsub_rn(scaled, fl);
      int st = static_cast<int>(fl) - m;  // (floor - m) mod M, (st - origin) mod M
      if (st < 0) st += M;
      if (st < 0 || st >= M) st = (st % M + M) % M;
      int o = st - origin[ch.s * dim + d];
      if (o < 0) o += M;
      if (o < 0 || o >= M) o = (o % M + M) % M;
      float* a = ad + k * ADS;
      if (d == 0) {
        a[kZero] = 0.0f;
        a[kOne] = 1.0f;
      }
      a += d * H;
      for (int u = 0; u < H; ++u) a[u] = 0.0f;
#pragma unroll 4
      for (int l = 0; l < L; ++l)
        if (o + l < H) a[o + l] = phi(w, __fadd_rn(frac, static_cast<float>(m - l)));
    }
    __syncwarp();
    const int4* i1s = reinterpret_cast<const int4*>(col_i1);
    const int4* i2s = reinterpret_cast<const int4*>(col_i2);
    for (int gq = lane; gq < pq; gq += 32) {
      const int4 i1 = i1s[gq], i2 = i2s[gq];
      for (int k = ch.ka; k < ch.ka + ch.cw; ++k) {
        const float* a = ad + k * ADS;
        reinterpret_cast<float4*>(kr + k * Ppad)[gq] =
            make_float4(a[i1.x] * a[i2.x], a[i1.y] * a[i2.y], a[i1.z] * a[i2.z],
                        a[i1.w] * a[i2.w]);
      }
    }
    for (int r = lane; r < Rpad; r += 32) {
      const int ci = row_c[r], u = row_u[r];
      for (int k = ch.ka; k < ch.ka + ch.cw; ++k)
        xs[k * Rpad + r] = ci >= 0 ? val_s[ci * KC + k] * ad[k * ADS + u] : 0.0f;
    }
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  // the chunks of the block's rows, in slot order: (row s, first slot k0)
  const int last = kPerRow ? first + 1 : S;
  auto valid = [&](int s) { return s < last && (kPerRow || tile_id[s] == tile); };
  int s = first, k0 = 0;
  while (valid(s) && k0 >= row_count[s]) ++s;
  int nk = valid(s) ? min(KC, row_count[s] - k0) : 0;
  if (nk > 0) {
    const Chunk ch = chunk(s, static_cast<size_t>(s) * K, nk);
    stage(ch, 0);
    form(ch, 0);
  }
  __syncthreads();
  for (int bi = 0; nk > 0; bi ^= 1) {
    int s2 = s, k2 = k0 + KC;
    while (valid(s2) && k2 >= row_count[s2]) {
      ++s2;
      k2 = 0;
    }
    const int nk2 = valid(s2) ? min(KC, row_count[s2] - k2) : 0;
    const Chunk next = chunk(s2, static_cast<size_t>(s2) * K + k2, nk2);
    if (nk2 > 0) stage(next, bi ^ 1);
    if (active) {
      const float4* xa = reinterpret_cast<const float4*>(bufs + bi * buf_floats) + ty;
      const float4* ka = reinterpret_cast<const float4*>(bufs + bi * buf_floats + KC * Rpad) + tx;
#pragma unroll 2
      for (int k = 0; k < nk; ++k) {
        float av[kTM], bv[kTN];
#pragma unroll
        for (int gq = 0; gq < kTM / 4; ++gq) {
          const float4 a = xa[k * rq + gq * b.RG];
          av[4 * gq] = a.x;
          av[4 * gq + 1] = a.y;
          av[4 * gq + 2] = a.z;
          av[4 * gq + 3] = a.w;
        }
#pragma unroll
        for (int gq = 0; gq < kTN / 4; ++gq) {
          const float4 q = ka[k * pq + gq * b.CG];
          bv[4 * gq] = q.x;
          bv[4 * gq + 1] = q.y;
          bv[4 * gq + 2] = q.z;
          bv[4 * gq + 3] = q.w;
        }
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    if (nk2 > 0) form(next, bi ^ 1);
    __syncthreads();
    s = s2;
    k0 = k2;
    nk = nk2;
  }

  // the band through shared memory (buf[i] 16-byte aligned where dst[i] is)
  float* dst = out + static_cast<size_t>(tile) * C * g.cells +
               static_cast<size_t>(r0) * P + p0;
  const int shift = static_cast<int>((reinterpret_cast<size_t>(dst) / sizeof(float)) & 3);
  float* buf = smem + shift;
  if (active) {
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int rl = 4 * (ty + (i / 4) * b.RG) + (i & 3);
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int cl = 4 * (tx + (j / 4) * b.CG) + (j & 3);
        if (rl < Rv && cl < PBv) buf[rl * PBv + cl] = acc[i][j];
      }
    }
  }
  __syncthreads();
  const int count = Rv * PBv;
  if (PBv == P) {  // the band is one contiguous run of the tile
    const int head = min(count, (4 - shift) & 3);
    const int nvec = (count - head) / 4;
    for (int i = t; i < head; i += blockDim.x) dst[i] = buf[i];
    float4* d4 = reinterpret_cast<float4*>(dst + head);
    const float4* b4 = reinterpret_cast<const float4*>(buf + head);
    for (int i = t; i < nvec; i += blockDim.x) d4[i] = b4[i];
    for (int i = head + 4 * nvec + t; i < count; i += blockDim.x) dst[i] = buf[i];
  } else {
    for (int i = t; i < count; i += blockDim.x) {
      const int r = i / PBv;
      dst[static_cast<size_t>(r) * P + i - r * PBv] = buf[i];
    }
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

__global__ void __launch_bounds__(kThreads) pos_grad_kernel(
    const float* __restrict__ tiles, const float* __restrict__ wts,
    const float* __restrict__ slot_pos, const int* __restrict__ row_count,
    const int* __restrict__ origin, const int* __restrict__ tile_index,
    float* __restrict__ dpos, int S, int K, int C, int NT, int dim, int H,
    int M, int m, Window w, float dcoef) {
  const int s = blockIdx.x;
  const int tile = tile_index[s];
  const int cnt = (tile >= 0 && tile < NT) ? row_count[s] : 0;
  const Geometry g(dim, H, m);
  const size_t SK = static_cast<size_t>(S) * K;
  float* out = dpos + static_cast<size_t>(s) * dim * K;
  const float* tl = tiles + static_cast<size_t>(cnt > 0 ? tile : 0) * C * g.cells;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    if (k >= cnt) {
      for (int d = 0; d < dim; ++d) out[d * K + k] = 0.0f;
      continue;
    }
    const size_t j = static_cast<size_t>(s) * K + k;
    int o[3] = {0, 0, 0};
    float v[3][kMaxL], dv[3][kMaxL];
    v[1][0] = v[2][0] = 1.0f;  // absent axes: value 1, derivative 0
    dv[1][0] = dv[2][0] = 0.0f;
    for (int d = 0; d < dim; ++d)
      o[d] = axis_window_deriv(slot_pos[d * SK + j], origin[s * dim + d], M, m,
                               g.L, w, dcoef, v[d], dv[d]);
    float grad[3] = {0.0f, 0.0f, 0.0f};
    for (int c = 0; c < C; ++c) {
      const float* a = tl + c * g.cells;
      float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
      for (int l0 = 0; l0 < g.L && o[0] + l0 < g.H; ++l0) {
        float sv = 0.0f, sd1 = 0.0f, sd2 = 0.0f;
        for (int l1 = 0; l1 < g.L1 && o[1] + l1 < g.H1; ++l1) {
          const float* r = a + ((o[0] + l0) * g.H1 + o[1] + l1) * g.H2 + o[2];
          float s2 = 0.0f, d2 = 0.0f;
          for (int l2 = 0; l2 < g.L2 && o[2] + l2 < g.H2; ++l2) {
            const float tv = __ldg(r + l2);
            s2 += v[2][l2] * tv;
            d2 += dv[2][l2] * tv;
          }
          sv += v[1][l1] * s2;
          sd1 += dv[1][l1] * s2;
          sd2 += v[1][l1] * d2;
        }
        acc0 += dv[0][l0] * sv;
        acc1 += v[0][l0] * sd1;
        acc2 += v[0][l0] * sd2;
      }
      const float wc = wts[c * SK + j];
      grad[0] += wc * acc0;
      grad[1] += wc * acc1;
      grad[2] += wc * acc2;
    }
    for (int d = 0; d < dim; ++d) out[d * K + k] = grad[d];
  }
}

// Launches spread_kernel<kPerRow> with S blocks, the accumulator in
// dynamic shared memory when C * H^dim floats fit the opt-in limit.
template <bool kPerRow>
int launch_spread(const float* vals, const float* slot_pos,
                  const int* row_count, const int* origin, const int* tile_id,
                  float* out, int S, int K, int C, int NT, int dim, int H,
                  int M, int m, int kind, float p0, float p1, float p2,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || S == 0) return static_cast<int>(err);
  size_t cells = H;
  for (int d = 1; d < dim; ++d) cells *= H;
  const size_t smem = cells * C * sizeof(float);
  const int use_smem = smem <= kSmemOptIn;
  if (use_smem && smem > kSmemDefault) {
    err = cudaFuncSetAttribute(spread_kernel<kPerRow>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  spread_kernel<kPerRow><<<S, kThreads, use_smem ? smem : 0,
                           static_cast<cudaStream_t>(stream)>>>(
      vals, slot_pos, row_count, origin, tile_id, out, S, K, C, NT, dim, H, M,
      m, Window{kind, p0, p1, p2}, use_smem);
  return static_cast<int>(cudaGetLastError());
}

// Launches spread_contract_kernel<kPerRow> on a grid of (row, band) as
// ops/contract.py:spread_design laid it out; layout holds TM, TN, R, PB,
// KC, RG, CG, row_bands, col_bands, NCH, buf, threads, shared bytes.
template <bool kPerRow>
int launch_spread_contract(const float* vals, const float* slot_pos,
                           const int* row_count, const int* origin,
                           const int* tile_id, float* out, int S, int K, int C,
                           int NT, int dim, int H, int M, int m, int kind,
                           float p0, float p1, float p2, const int* layout,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || S == 0) return static_cast<int>(err);
  const Band b{layout[2], layout[3], layout[4], layout[5],
               layout[6], layout[8], layout[9], layout[10]};
  const int row_bands = layout[7], threads = layout[11];
  const size_t smem = static_cast<size_t>(layout[12]);
  if (layout[0] != kTM || layout[1] != kTN || b.RG * kTM < b.R || b.CG * kTN < b.PB)
    return static_cast<int>(cudaErrorInvalidValue);
  if (threads < b.RG * b.CG || threads > kMaxThreadsRT || threads % 32 != 0 ||
      row_bands * b.col_bands > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (smem > kSmemOptIn) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kSmemDefault) {
    err = cudaFuncSetAttribute(spread_contract_kernel<kPerRow>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  spread_contract_kernel<kPerRow>
      <<<dim3(S, row_bands * b.col_bands), threads, smem,
         static_cast<cudaStream_t>(stream)>>>(
          vals, slot_pos, row_count, origin, tile_id, out, S, K, C, NT, dim, H,
          M, m, Window{kind, p0, p1, p2}, b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int tnt_spread_tiles_dense(const float* vals, const float* slot_pos,
                           const int* row_count, const int* origin,
                           const int* tile_id, float* out, int S, int K, int C,
                           int NT, int dim, int H, int M, int m, int kind,
                           float p0, float p1, float p2, int device,
                           void* stream) {
  return launch_spread<false>(vals, slot_pos, row_count, origin, tile_id, out,
                              S, K, C, NT, dim, H, M, m, kind, p0, p1, p2,
                              device, stream);
}

int tnt_spread_tiles(const float* vals, const float* slot_pos,
                     const int* row_count, const int* origin, float* out,
                     int S, int K, int C, int dim, int H, int M, int m,
                     int kind, float p0, float p1, float p2, int device,
                     void* stream) {
  return launch_spread<true>(vals, slot_pos, row_count, origin, nullptr, out,
                             S, K, C, S, dim, H, M, m, kind, p0, p1, p2,
                             device, stream);
}

int tnt_spread_tiles_dense_contract(const float* vals, const float* slot_pos,
                                    const int* row_count, const int* origin,
                                    const int* tile_id, float* out, int S,
                                    int K, int C, int NT, int dim, int H, int M,
                                    int m, int kind, float p0, float p1,
                                    float p2, const int* layout, int device,
                                    void* stream) {
  return launch_spread_contract<false>(vals, slot_pos, row_count, origin,
                                       tile_id, out, S, K, C, NT, dim, H, M, m,
                                       kind, p0, p1, p2, layout, device, stream);
}

int tnt_spread_tiles_contract(const float* vals, const float* slot_pos,
                              const int* row_count, const int* origin,
                              float* out, int S, int K, int C, int dim, int H,
                              int M, int m, int kind, float p0, float p1,
                              float p2, const int* layout, int device,
                              void* stream) {
  return launch_spread_contract<true>(vals, slot_pos, row_count, origin,
                                      nullptr, out, S, K, C, S, dim, H, M, m,
                                      kind, p0, p1, p2, layout, device, stream);
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

int tnt_pos_grad(const float* tiles, const float* wts, const float* slot_pos,
                 const int* row_count, const int* origin,
                 const int* tile_index, float* dpos, int S, int K, int C,
                 int NT, int dim, int H, int M, int m, int kind, float p0,
                 float p1, float p2, float dcoef, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || S == 0) return static_cast<int>(err);
  pos_grad_kernel<<<S, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tiles, wts, slot_pos, row_count, origin, tile_index, dpos, S, K, C, NT,
      dim, H, M, m, Window{kind, p0, p1, p2}, dcoef);
  return static_cast<int>(cudaGetLastError());
}

const char* tnt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
