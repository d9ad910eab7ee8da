// Spread window contractions of the binned NFFT, for Hopper. (The gather
// and the position gradient are in points.cuh, gather.cu and pos_grad.cu;
// the window functions in window.cuh.)
//
// Replaces the TPU kernels of the JAX package's ops/pallas/contract.py:
//   tnt_spread_tiles_dense_tensor, tnt_spread_tiles_dense_contract,
//   tnt_spread_tiles_dense  <- spread_tiles_dense_pallas (kernel
//       _spread_dense_kernel) and its row-batched twin spread_tiles_rb_pallas;
//   tnt_spread_tiles_tensor, tnt_spread_tiles_contract, tnt_spread_tiles
//                           <- spread_tiles_pallas (kernel _spread_kernel),
//       the per-row tiles of the flat-grid route.
//
// What they compute. A plan row s holds row_count[s] <= K points of one
// tile (origin o_s, halo edge H = T + 2m + 1). Point k has, per axis d, a
// window start cell w = (floor(M x_kd) - m) mod M, offset o = (w - o_sd) mod M
// in [0, T), and window values phi(frac + m - l), l in [0, 2m+2), at tile
// cells u = o + l. Spread adds x_k * prod_d phi_d into those L^dim cells of
// the row's dense tile.
//
// Design of the spreads: three designs, chosen per call by the tile's
// geometry (ops/contract.py:spread_design).
//   tensor and contraction (spread_contract_kernel<kPerRow, kMT, kWN, kCull>;
//   tnt_*_tensor with kMT = 1 or 2, tnt_*_contract with kMT = 0): the TPU
//   kernels' dense form. The tile is the matrix OUT[(c,u), (v,w)] =
//   sum_k x_c A0 (x) (A1 A2), a contraction over the row's points with
//   every output in one thread's registers: no atomics, and each output
//   sums its points in slot order, so the result is the same bits on every
//   run. It does H^dim / L^dim times the sparse work (10.2x at the 3D
//   headline, T = 8: 2197 against 216 multiply-adds per point and column).
//   The tensor design issues the products on the FP64 tensor cores
//   (mma.sync m16n8k8 f64; 3D tiles, see spread_design); the contraction
//   in FP32 register tiles on the CUDA cores (1D and 2D tiles, and 3D
//   tiles of many rows on few columns). Both run while that ratio is at
//   most ops/contract.py:DENSE_RATIO_MAX. Both routes share them: per row
//   (B7) every block stores its band of its row's tile (a row with no
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
//   rounding, not bits, and vary from run to run. It runs for 1D and 2D
//   tiles above the ratio limit, and for 3D tiles above it whose
//   accumulator, C H^3 floats, fits the shared memory of a block.
//   culled tensor (kCull; a flag of the tensor launch): a 3D tile above the
//   ratio limit whose accumulator does not fit would take the wide design
//   with global atomics (2.6e8 of them a streamed member at H = 41, C = 2).
//   It takes the tensor design instead, with OUT's rows in (u, c) order so
//   that a row band covers a run of cells on axis 0 (a column band covers
//   one on axis 1). Before a chunk's products each warp keeps the points of
//   its run whose window [o_d, o_d + L) meets the band's cells on axes 0
//   and 1 (a ballot), the block lists them in slot order (each warp's list
//   after the lists of the warps before it), and windows, X and the mma
//   run over the kept points only. A dropped point's products are all
//   exact zeros (its windows are 0 on every cell of the band), so each
//   output sums the same nonzero products in the same slot order; only the
//   groups of 8 that the mma adds together change, and double sums of
//   exact float products rounded once to float32 then differ from the
//   unculled design's by at most an ulp. The kept list does not depend on
//   timing, so the result repeats bit for bit. Culled, a streamed member's
//   bands keep 28% of the (point, band) pairs.
// Bound on the H100 at the 3D headline (n = 2^24, N = 256, sigma = 1.625,
// m = 2, T = 8, K = 1024, 19,860 rows, NT = 52^3 tiles of H^3 = 2197 cells),
// counting only the n filled slots' values and coordinates (no kernel reads
// a padded slot):
//   spread reads ~0.27 GB (values and coordinates) and writes the 1.24 GB
//   dense tile array: bytes bound, ~0.45 ms at 3.35 TB/s; its ~9.7e9 flops
//   (per point 3 x 6 window values at ~8 flops, 216 cells at 2 flops) take
//   ~0.14 ms at 67 TFLOP/s float32.
//   per-row spread (B7) at C columns reads the values and coordinates of
//   the n filled slots (0.2 + 0.07 C GB) and writes S C H^3 floats
//   (0.175 C GB): ~0.64 ms of bytes at C = 8, against ~6.0e10 flops
//   (~0.90 ms): bound by operations (at C = 1, 0.13 against 0.14 ms).
//   The dense designs issue more: n points x (C H rows, padded to the
//   contraction's 8-row thread tiles or the tensor design's m16 tiles in
//   each band) x (H^{dim-1} columns, padded to 8) multiply-adds, 16 x 176
//   per point at C = 1 (one band of 13 rows): 9.4e10 flops, 1.41 ms at
//   67 TFLOP/s, the FP64 tensor peak as the FP32 one (NVIDIA's H100 SXM
//   data sheet); the tensor design besides forms each point's windows and
//   its row of X once per band.
// At the Gram geometry (n = 2^22 on [-1, 1)^3, gaussian m = 4, sigma = 2,
// M = 512, T = 16, H = 25, 4,913 occupied tiles of 32,768): the dense
// spread writes 2.05 GB, 0.63 ms of bytes; the tensor design issues
// 32 x 632 multiply-adds per point at C = 1 (25 rows in two m16 tiles, 625
// columns in 79 n8 tiles): 1.70e11 flops, 2.53 ms at the FP64 tensor peak.
// chip_smoke.py computes the bounds from its run's plan (bounds()) and
// prints the share of the bound and the issued flops' share of the peak.
// What holds the kernels back: the wide spread, its shared-memory atomics
// (about 1.7 a clock per SM at C = 8); the contraction, the issue of its
// FMAs and 16-byte shared loads (8 x 8 outputs a thread: 4 loads per 64
// FMAs) and, at C = 1 where the band has only 13 rows, forming each
// point's operands (its windows, one row of X and of KR); the tensor
// design, not the tensor cores: each B fragment is formed from two window
// values in shared memory (2 loads, a multiply, a widening a value), and
// the warps that issue the products also form the next chunk's operands
// between barriers, so with 128 registers a thread (one block of 16 warps
// an SM at the Gram geometry) forming and products take turns. Switched
// off in turn on the H100, the products with their fragments take 3.3 ms
// at the Gram geometry (the peak is 2.53) and forming, the staging and the
// stores the rest.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (torch_nfft_tpu_torch/_build.py). Plain C interface:
// every function returns the cudaError_t of its launch.

#include <cuda_runtime.h>

#include "tile.cuh"
#include "window.cuh"

namespace {

using tnt::cp_async4;
using tnt::cp_async_wait_all;
using tnt::phi;
using tnt::Window;

constexpr int kMaxL = 20;  // window cells per axis: 2m + 2 <= 20
constexpr int kThreads = 256;
constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kSmemOptIn = 232448;  // 227 KB, the H100's per-block limit

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

// Offset o of a coordinate's window start inside the row's tile, (floor(M p)
// - m - org) mod M, and the window argument's fraction frac, rounded as
// axis_window rounds them.
__device__ __forceinline__ int tile_offset(float p, int org, int M, int m, float* frac) {
  const float scaled = __fmul_rn(p, static_cast<float>(M));
  const float fl = floorf(scaled);
  *frac = __fsub_rn(scaled, fl);
  int st = static_cast<int>(fl) - m;  // (floor - m) mod M, (st - origin) mod M
  if (st < 0) st += M;
  if (st < 0 || st >= M) st = (st % M + M) % M;
  int o = st - org;
  if (o < 0) o += M;
  if (o < 0 || o >= M) o = (o % M + M) % M;
  return o;
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

// The spread of both routes as a contraction (the "contraction" and
// "tensor" designs; the kernel above is the "wide" design). A row's tile is
// the matrix OUT[(c,u), (v,w)] = sum_k X[k,(c,u)] KR[k,(v,w)] with
// X[k,(c,u)] = x_c[k] A0[k,u] and KR[k,(v,w)] = A1[k,v] A2[k,w] (KR = A1 in
// 2D, 1 in 1D). Block (s, y) owns band y of OUT: rows [r0, r0 + R) and
// columns [p0, p0 + PB), for the whole row (kPerRow) or the whole run of
// rows of its tile (B1, owned by the block of the run's first row). Points
// go in chunks of KC through two shared-memory buffers. Before the block
// multiplies one chunk, each warp starts cp.async copies of the next
// chunk's coordinates and values for its own run of points; after, it
// turns them into that chunk's float32 operands (per point and axis the
// window as a dense row of H values, then the points' rows of X and, for
// the contraction, of KR, each entry one product looked up through the
// band's row and column tables), so the loads' latency hides behind the
// products and one barrier a chunk orders both. The products:
//   kMT = 0 ("contraction"): thread t (< RG * CG; ty = t % RG, tx = t / RG)
//   holds kTM rows (float4 groups ty + g RG) by kTN columns (float4 groups
//   tx + g CG) of the band in FP32 registers and adds its kTM x kTN outer
//   products point by point (an 8 x 8 tile: one 16-byte shared load per 16
//   FMAs).
//   kMT = 1 or 2 ("tensor"): warp w (wm = w % RG, wn = w / RG) holds kMT m16
//   tiles (rows 16 (wm kMT + i)) by WN <= kWN n8 tiles (columns
//   8 (wn WN + j)) of the band in FP64 registers and adds 8 points at a
//   time with mma.sync m16n8k8 f64 on the tensor cores. Its A fragments
//   are loaded from X, its B fragments formed as they load, each entry
//   KR[k, p] the float product of two window values; both are widened to
//   double in registers, which is exact, and so are the products of two
//   widened floats. A chunk is padded to a multiple of 8 points with zero
//   operands; tiles past the band's rows or columns are not issued. The
//   row strides of X and of the windows are 8 or 24 mod 32 floats, so a
//   fragment's 32 loads fall on 32 banks.
// No atomics: every output is one thread's register, summed over the points
// in slot order whatever KC, R and PB are (the tensor design in double, in
// groups of the 8 points [8 i, 8 i + 8) of a row), so results are the same
// bits from run to run and, the contraction's, from one band or chunk size
// to another. Last the band is rounded to float32, once, and goes through
// shared memory to global memory in 16-byte stores.
// The launch's layout comes whole from ops/contract.py:spread_design (its
// TM, TN, MMA, MT_WN and MAX_THREADS are kTM, kTN, kMma*, kWarpN and
// kMaxThreadsRT; the launches refuse another thread or warp tile).
constexpr int kMaxThreadsRT = 512;  // 128 registers a thread
constexpr int kTM = 8, kTN = 8;      // rows, columns of OUT a thread holds (contraction)
constexpr int kMmaM = 16, kMmaN = 8, kMmaK = 8;  // mma.sync.m16n8k8 f64 (tensor)
// n8 tiles a warp holds at most with 1 and 2 m16 tiles (tensor): 32 and 40
// doubles a lane
constexpr int kWarpN[3] = {1, 8, 5};

struct Band {
  int R, PB, KC;   // rows and columns of a band, points per chunk
  int RG, CG;      // contraction: thread rows (R / kTM) and columns (PB / kTN),
                   // rounded up; tensor: warp rows and columns
  int col_bands;   // bands across the columns (blockIdx.y = rb * col_bands + cb)
  int NCH;         // most channels the rows of one band touch
  int RS, PS;      // floats a point's row of X, entries of the column tables
                   // (and floats a point's row of KR, contraction): the
                   // band's rows and columns, padded
  int ADS;         // floats a point's windows, at least dim H + 2
  int WN;          // n8 tiles a warp (tensor, at most kWarpN[kMT])
  int buf;         // floats a chunk buffer: at least KC (RS + ADS + dim +
                   // NCH), and KC PS more (contraction), 16 B aligned
};

// D += A B on one m16n8k8 tile in double. With g = lane / 4, t = lane % 4:
// a_i = A[g + 8 (i % 2)][t + 4 (i / 2)], b_i = B[t + 4 i][g],
// d_i = D[g + 8 (i / 2)][2 t + i % 2].
__device__ __forceinline__ void mma_f64(double* d, const double* a, const double* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

template <bool kPerRow, int kMT, int kWN, bool kCull>
__global__ void __launch_bounds__(kMaxThreadsRT) spread_contract_kernel(
    const float* __restrict__ vals, const float* __restrict__ slot_pos,
    const int* __restrict__ row_count, const int* __restrict__ origin,
    const int* __restrict__ tile_id, float* __restrict__ out, int S, int K,
    int C, int NT, int dim, int H, int M, int m, Window w, Band b) {
  constexpr bool kTensor = kMT > 0;
  static_assert(kTensor || !kCull, "only the tensor design culls");
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
  const int Rpad = b.RS, Ppad = b.PS, KC = b.KC;
  const int rq = Rpad / 4, pq = Ppad / 4;
  const int KRS = kTensor ? 0 : Ppad;  // floats a point's row of KR in a buffer
  const size_t SK = static_cast<size_t>(S) * K;
  // channels the band's rows touch (culled: rows (u, c), every channel)
  const int c_lo = kCull ? 0 : r0 / H;
  const int n_ch = kCull ? C : (r0 + Rv - 1) / H - c_lo + 1;
  // culled: the band's cells on axis 0 (its rows) and axis 1 (its columns)
  const int u_lo = r0 / C, u_hi = (r0 + Rv - 1) / C;
  const int v_lo = dim == 3 ? p0 / H : p0, v_hi = dim == 3 ? (p0 + PBv - 1) / H : p0 + PBv - 1;

  // the band's row and column tables, then two chunk buffers. A point's
  // windows are ADS >= dim H + 2 floats: dense rows (0 outside its L cells)
  // per axis, then a 0 and a 1. X[k, r] = x_{c_lo + row_c[r]} A0[row_u[r]]
  // (0 where row_c < 0); KR[k, p] = win[col_i1[p]] win[col_i2[p]], the
  // indices pointing at the 1 for an axis the geometry lacks and at the 0
  // past the band. A buffer holds [KC][Rpad] X, [KC][KRS] KR (the
  // contraction's; the tensor design forms KR as it loads its fragments),
  // [KC][ADS] windows, and the staged [dim][KC] coordinates and [NCH][KC]
  // values.
  extern __shared__ __align__(16) float smem[];
  const int ADS = b.ADS, kZero = dim * H, kOne = dim * H + 1;
  int* row_c = reinterpret_cast<int*>(smem);
  int* row_u = row_c + Rpad;
  int* col_i1 = row_u + Rpad;
  int* col_i2 = col_i1 + Ppad;
  float* bufs = smem + 2 * (Rpad + Ppad);
  const int buf_floats = b.buf;
  // culled: after the buffers, the chunk's kept points as the warps listed
  // them (slots), each warp's count, and each buffer's count
  int* keep_src = reinterpret_cast<int*>(bufs + 2 * buf_floats);
  int* warp_kept = keep_src + KC;
  int* chunk_kept = warp_kept + 32;
  for (int i = threadIdx.x; i < Rpad; i += blockDim.x) {
    const int r = r0 + i;
    if (kCull) {
      row_c[i] = i < Rv ? r % C : -1;
      row_u[i] = i < Rv ? r / C : 0;
    } else {
      const int c = r / H;
      row_c[i] = i < Rv ? c - c_lo : -1;
      row_u[i] = r - c * H;
    }
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

  // A chunk of nk points from slot j0 of row s, padded to a multiple of the
  // mma's k (tensor): each warp takes the run [ka, ka + cw) of it, the first
  // nr of them points, the rest zero operands.
  struct Chunk {
    int s, ka, cw, nr;
    size_t j0;
  };
  auto chunk = [&](int s, size_t j0, int nk) {
    const int np = kTensor ? (nk + kMmaK - 1) / kMmaK * kMmaK : nk;
    const int per = (np + n_warps - 1) / n_warps;
    const int ka = min(np, warp * per);
    const int cw = min(np, ka + per) - ka;
    return Chunk{s, ka, cw, max(0, min(cw, nk - ka)), j0};
  };
  // start the copies of the warp's coordinates and values into buffer bi
  auto stage = [&](const Chunk& ch, int bi) {
    float* pos_s = bufs + bi * buf_floats + KC * (Rpad + KRS + ADS);
    float* val_s = pos_s + KC * dim;
    for (int e = lane; e < dim * ch.nr; e += 32) {
      const int d = e / ch.nr, q = ch.ka + e - d * ch.nr;
      cp_async4(pos_s + d * KC + q, slot_pos + d * SK + ch.j0 + q);
    }
    for (int e = lane; e < n_ch * ch.nr; e += 32) {
      const int ci = e / ch.nr, q = ch.ka + e - ci * ch.nr;
      cp_async4(val_s + ci * KC + q, vals + (c_lo + ci) * SK + ch.j0 + q);
    }
  };
  // wait for them and form the warp's rows of X and KR in buffer bi
  auto form = [&](const Chunk& ch, int bi) {
    float* xs = bufs + bi * buf_floats;
    float* kr = xs + KC * Rpad;
    float* ad = kr + KC * KRS;
    const float* pos_s = ad + KC * ADS;
    const float* val_s = pos_s + KC * dim;
    const int* org = origin + ch.s * dim;
    cp_async_wait_all();
    __syncwarp();
    // the warp forms its points q < nf, staged at slot ka + q, at k0 + q, and
    // zero operands at [z0, z1): its run's points, then up to ka + cw
    int k0 = ch.ka, nf = ch.nr, z0 = ch.ka + ch.nr, z1 = ch.ka + ch.cw;
    if constexpr (kCull) {
      // keep the run's points whose window meets the band on axes 0 and 1,
      // listed in slot order; after the barrier each warp's list follows
      // the lists of the warps before it, and the last warp pads the
      // chunk's kept points with zero operands to the mma's k
      int cnt = 0;
      for (int q0 = 0; q0 < ch.nr; q0 += 32) {
        const int k = ch.ka + q0 + lane;
        bool keep = false;
        if (q0 + lane < ch.nr) {
          float frac;
          const int o0 = tile_offset(pos_s[k], org[0], M, m, &frac);
          keep = o0 <= u_hi && o0 + L > u_lo;
          if (dim > 1) {
            const int o1 = tile_offset(pos_s[KC + k], org[1], M, m, &frac);
            keep = keep && o1 <= v_hi && o1 + L > v_lo;
          }
        }
        const unsigned kept = __ballot_sync(0xffffffffu, keep);
        if (keep) keep_src[ch.ka + cnt + __popc(kept & ((1u << lane) - 1u))] = k;
        cnt += __popc(kept);
      }
      if (lane == 0) warp_kept[warp] = cnt;
      __syncthreads();
      int before = 0, total = 0;
      for (int wi = 0; wi < n_warps; ++wi) {
        const int n_w = warp_kept[wi];
        before += wi < warp ? n_w : 0;
        total += n_w;
      }
      if (t == 0) chunk_kept[bi] = total;
      k0 = before;
      nf = cnt;
      z0 = z1 = 0;
      if (warp == n_warps - 1) {
        z0 = total;
        z1 = (total + kMmaK - 1) / kMmaK * kMmaK;
      }
    }
    auto src = [&](int q) { return kCull ? keep_src[ch.ka + q] : ch.ka + q; };
    // dense windows, one (point, axis) a lane
    for (int e = lane; e < nf * dim; e += 32) {
      const int q = e / dim, d = e - q * dim;
      float frac;
      const int o = tile_offset(pos_s[d * KC + src(q)], org[d], M, m, &frac);
      float* a = ad + (k0 + q) * ADS;
      if (d == 0) {
        a[kZero] = 0.0f;
        a[kOne] = 1.0f;
      }
      a += d * H;
#pragma unroll 4
      for (int u = 0; u < H; ++u) a[u] = 0.0f;
#pragma unroll 4
      for (int l = 0; l < L; ++l)
        if (o + l < H) a[o + l] = phi(w, __fadd_rn(frac, static_cast<float>(m - l)));
    }
    // the tensor design's zero operands: windows of zeros (KR 0, finite)
    if (kTensor)
      for (int e = lane; e < (z1 - z0) * ADS; e += 32) ad[z0 * ADS + e] = 0.0f;
    __syncwarp();
    if constexpr (!kTensor) {
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
    }
    // X's rows (the tensor design's, padded to the m16 tiles it reads)
    const int x_rows = kTensor ? (Rv + kMmaM - 1) / kMmaM * kMmaM : Rpad;
    for (int r = lane; r < x_rows; r += 32) {
      const int ci = row_c[r], u = row_u[r];
#pragma unroll 8
      for (int q = 0; q < nf; ++q) {
        const int k = k0 + q;
        xs[k * Rpad + r] = ci >= 0 ? val_s[ci * KC + src(q)] * ad[k * ADS + u] : 0.0f;
      }
      for (int k = z0; k < z1; ++k) xs[k * Rpad + r] = 0.0f;
    }
  };

  // contraction: the thread's kTM x kTN tile (threads past RG * CG idle)
  const bool active = t < b.RG * b.CG;
  const int ty = t % b.RG, tx = t / b.RG;
  float acc[kTensor ? 1 : kTM][kTensor ? 1 : kTN];
  // tensor: the warp's kMT x kWN tiles, the first m_tiles x n_tiles of
  // them inside the band; the lane's fragment row qg and column qt
  const int qg = lane >> 2, qt = lane & 3;
  const int wm = warp % b.RG, wn = warp / b.RG;
  const int m_tiles = max(0, min(kMT, (Rv + kMmaM - 1) / kMmaM - wm * kMT));
  const int n_tiles = max(0, min(b.WN, (PBv + kMmaN - 1) / kMmaN - wn * b.WN));
  const int m_lane = wm * kMT * kMmaM + qg, n_lane = wn * b.WN * kMmaN + qg;
  // the window entries of the lane's column of each of its n8 tiles, i1 | i2 << 16
  int cols[kWN];
  double dacc[kTensor ? kMT : 1][kWN][4];
  if constexpr (kTensor) {
#pragma unroll
    for (int j = 0; j < kWN; ++j) {
      const int pl = min(n_lane + kMmaN * j, Ppad - 1);
      cols[j] = col_i1[pl] | col_i2[pl] << 16;
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kWN; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) dacc[i][j][q] = 0.0;
  } else {
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
  }

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
    if constexpr (kTensor) {
      const float* xs = bufs + bi * buf_floats + qt * Rpad + m_lane;
      const float* ws = bufs + bi * buf_floats + KC * Rpad + qt * ADS;
      const int np = ((kCull ? chunk_kept[bi] : nk) + kMmaK - 1) / kMmaK * kMmaK;
      for (int kb = 0; kb < np; kb += kMmaK) {
        const float* xa = xs + kb * Rpad;
        const float* w0 = ws + kb * ADS;
        const float* w1 = w0 + 4 * ADS;
        double a[kMT][4];
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          if (i < m_tiles) {
            a[i][0] = xa[kMmaM * i];
            a[i][1] = xa[kMmaM * i + 8];
            a[i][2] = xa[4 * Rpad + kMmaM * i];
            a[i][3] = xa[4 * Rpad + kMmaM * i + 8];
          }
        }
#pragma unroll
        for (int j = 0; j < kWN; ++j) {
          if (j < n_tiles) {
            const int i1 = cols[j] & 0xffff, i2 = cols[j] >> 16;
            const double bf[2] = {w0[i1] * w0[i2], w1[i1] * w1[i2]};
#pragma unroll
            for (int i = 0; i < kMT; ++i)
              if (i < m_tiles) mma_f64(dacc[i][j], a[i], bf);
          }
        }
      }
    } else if (active) {
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
  if constexpr (kTensor) {
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kWN; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int rl = m_lane + kMmaM * i + 8 * (q >> 1);
          const int cl = wn * b.WN * kMmaN + kMmaN * j + 2 * qt + (q & 1);
          if (j < n_tiles && rl < Rv && cl < PBv)
            buf[rl * PBv + cl] = static_cast<float>(dacc[i][j][q]);
        }
  } else if (active) {
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
  if (PBv == P && (!kCull || C == 1)) {  // the band is one contiguous run of the tile
    const int head = min(count, (4 - shift) & 3);
    const int nvec = (count - head) / 4;
    for (int i = t; i < head; i += blockDim.x) dst[i] = buf[i];
    float4* d4 = reinterpret_cast<float4*>(dst + head);
    const float4* b4 = reinterpret_cast<const float4*>(buf + head);
    for (int i = t; i < nvec; i += blockDim.x) d4[i] = b4[i];
    for (int i = head + 4 * nvec + t; i < count; i += blockDim.x) dst[i] = buf[i];
  } else {  // a row of the band a warp (culled, row r of OUT is tile row (r % C) H + r / C)
    float* tdst = out + static_cast<size_t>(tile) * C * g.cells + p0;
    for (int rl = warp; rl < Rv; rl += n_warps) {
      const int r = r0 + rl;
      float* row = tdst + static_cast<size_t>(kCull ? r % C * H + r / C : r) * P;
      for (int cl = lane; cl < PBv; cl += 32) row[cl] = buf[rl * PBv + cl];
    }
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

// Launches spread_contract_kernel<kPerRow, kMT, kWN, kCull> on a grid of
// (row, band).
template <bool kPerRow, int kMT, int kWN, bool kCull = false>
int launch_bands(const float* vals, const float* slot_pos, const int* row_count,
                 const int* origin, const int* tile_id, float* out, int S, int K,
                 int C, int NT, int dim, int H, int M, int m, const Window& w,
                 const Band& b, int row_bands, int threads, size_t smem,
                 void* stream) {
  if (row_bands * b.col_bands > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (smem > kSmemOptIn) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        spread_contract_kernel<kPerRow, kMT, kWN, kCull>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  spread_contract_kernel<kPerRow, kMT, kWN, kCull>
      <<<dim3(S, row_bands * b.col_bands), threads, smem,
         static_cast<cudaStream_t>(stream)>>>(vals, slot_pos, row_count, origin,
                                              tile_id, out, S, K, C, NT, dim, H,
                                              M, m, w, b);
  return static_cast<int>(cudaGetLastError());
}

// The contraction as ops/contract.py:spread_design laid it out; layout
// holds TM, TN, R, PB, KC, RG, CG, row_bands, col_bands, NCH, buf, threads,
// shared bytes.
template <bool kPerRow>
int launch_spread_contract(const float* vals, const float* slot_pos,
                           const int* row_count, const int* origin,
                           const int* tile_id, float* out, int S, int K, int C,
                           int NT, int dim, int H, int M, int m, int kind,
                           float p0, float p1, float p2, const int* layout,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || S == 0) return static_cast<int>(err);
  const Band b{layout[2], layout[3], layout[4], layout[5], layout[6], layout[8],
               layout[9], layout[5] * kTM, layout[6] * kTN, dim * H + 2, 0, layout[10]};
  const int row_bands = layout[7], threads = layout[11];
  if (layout[0] != kTM || layout[1] != kTN || b.RG * kTM < b.R || b.CG * kTN < b.PB)
    return static_cast<int>(cudaErrorInvalidValue);
  if (threads < b.RG * b.CG || threads > kMaxThreadsRT || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  return launch_bands<kPerRow, 0, 1>(vals, slot_pos, row_count, origin, tile_id, out,
                                  S, K, C, NT, dim, H, M, m, Window{kind, p0, p1, p2},
                                  b, row_bands, threads, static_cast<size_t>(layout[12]),
                                  stream);
}

// The tensor design as ops/contract.py:spread_design laid it out; layout
// holds the mma's m, n, k, R, PB, KC, MT, WN (m16 and n8 tiles a warp), RG,
// CG (warp rows and columns), row_bands, col_bands, NCH, RS, PS, ADS, buf,
// threads, shared bytes, and 1 to cull (rows (u, c), every channel staged;
// KC + 34 ints after the two buffers), else 0.
template <bool kPerRow>
int launch_spread_tensor(const float* vals, const float* slot_pos,
                         const int* row_count, const int* origin,
                         const int* tile_id, float* out, int S, int K, int C,
                         int NT, int dim, int H, int M, int m, int kind,
                         float p0, float p1, float p2, const int* layout,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || S == 0) return static_cast<int>(err);
  const Band b{layout[3], layout[4], layout[5], layout[8], layout[9], layout[11],
               layout[12], layout[13], layout[14], layout[15], layout[7], layout[16]};
  const int MT = layout[6], row_bands = layout[10], threads = layout[17], cull = layout[19];
  const size_t smem = static_cast<size_t>(layout[18]);
  const size_t need = 4 * (2 * static_cast<size_t>(b.RS + b.PS) + 2 * static_cast<size_t>(b.buf) +
                           (cull ? b.KC + 34 : 0));
  if (layout[0] != kMmaM || layout[1] != kMmaN || layout[2] != kMmaK ||
      (MT != 1 && MT != 2) || b.WN < 1 || b.WN > kWarpN[MT] || b.KC < kMmaK ||
      b.KC % kMmaK != 0 || b.RG * MT * kMmaM < b.R || b.CG * b.WN * kMmaN < b.PB ||
      b.RS < (b.R + kMmaM - 1) / kMmaM * kMmaM || b.PS < (b.PB + kMmaN - 1) / kMmaN * kMmaN ||
      b.RS % 4 != 0 || b.PS % 4 != 0 || b.ADS < dim * H + 2 || b.ADS >= 1 << 16 ||
      (cull != 0 && cull != 1) || (cull && b.NCH < C) || smem < need)
    return static_cast<int>(cudaErrorInvalidValue);
  if (threads != 32 * b.RG * b.CG || threads > kMaxThreadsRT)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const Window w{kind, p0, p1, p2};
#define TNT_LAUNCH_TENSOR(MT_, CULL_)                                                      \
  launch_bands<kPerRow, MT_, kWarpN[MT_], CULL_>(vals, slot_pos, row_count, origin, tile_id, \
                                                  out, S, K, C, NT, dim, H, M, m, w, b,      \
                                                  row_bands, threads, smem, stream)
  if (cull) return MT == 1 ? TNT_LAUNCH_TENSOR(1, true) : TNT_LAUNCH_TENSOR(2, true);
  return MT == 1 ? TNT_LAUNCH_TENSOR(1, false) : TNT_LAUNCH_TENSOR(2, false);
#undef TNT_LAUNCH_TENSOR
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

int tnt_spread_tiles_dense_tensor(const float* vals, const float* slot_pos,
                                  const int* row_count, const int* origin,
                                  const int* tile_id, float* out, int S, int K,
                                  int C, int NT, int dim, int H, int M, int m,
                                  int kind, float p0, float p1, float p2,
                                  const int* layout, int device, void* stream) {
  return launch_spread_tensor<false>(vals, slot_pos, row_count, origin, tile_id,
                                     out, S, K, C, NT, dim, H, M, m, kind, p0, p1,
                                     p2, layout, device, stream);
}

int tnt_spread_tiles_tensor(const float* vals, const float* slot_pos,
                            const int* row_count, const int* origin, float* out,
                            int S, int K, int C, int dim, int H, int M, int m,
                            int kind, float p0, float p1, float p2,
                            const int* layout, int device, void* stream) {
  return launch_spread_tensor<true>(vals, slot_pos, row_count, origin, nullptr,
                                    out, S, K, C, S, dim, H, M, m, kind, p0, p1, p2,
                                    layout, device, stream);
}

const char* tnt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
