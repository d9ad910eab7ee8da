// Static permutations of the binned NFFT's user <-> slot maps, for Hopper:
// the ragged row-stream passes and the Benes network.
//
// Replaces the TPU kernels of the JAX package:
//   tnt_expand_rows   <- ops/pallas/ragged.py:expand_rows (_expand_kernel);
//   tnt_compact_rows  <- ops/pallas/ragged.py:compact_rows (_compact_kernel);
//   tnt_benes_outer   <- ops/pallas/benes.py:apply_benes, its cross-block
//       stages (_cross_stage_pallas, _outer_fused);
//   tnt_benes_local   <- ops/pallas/benes.py:apply_benes, its fused stages
//       (_fused_stages_kernel, _local_kernel_loop, _apply_benes_super).
//
// Every kernel moves 32-bit words, so one kernel serves float32 and int32
// payloads, and a permutation is exact to the bit. Arrays hold C columns;
// element offsets are 64-bit (C * 2^q passes 2^31 at 64 columns of 2^25).
//
// Ragged rows. A plan's rows tile the sorted order [0, n) contiguously:
// row s holds stream positions [rs[s], rs[s] + cnt[s]). The TPU kernels
// roll a two-block window of the stream per group of rows to align lanes;
// here one thread per padded element (c, s, k) reads or writes its stream
// word directly. Reads (expand) and writes (compact) of one row are
// consecutive words, so a warp's accesses coalesce. Rows never overlap, so
// the compaction needs no atomics; a row with cnt = 0 expands to zeros and
// compacts to nothing.
//
// Benes network. n = 2^q elements per column, 2q-1 stages with exchange
// distances 2^d, d = q-1, ..., 1, 0, 1, ..., q-1. Stage t's pair p joins
// elements lo = ((p >> d) << (d+1)) + (p & (2^d - 1)) and lo + 2^d, and
// swaps them where bit (p & 31) of word p >> 5 of the stage's row of the
// router's per-pair bits is set (csrc/benes_router.cpp). The TPU kernels
// expand those bits to one int32 word per element so that a vector lane
// reads its own mask; here a block copies the words its pairs need into
// shared memory once, coalesced where they are contiguous, 1/32 of the
// bytes. Forward gives out[perm[i]] = in[i]; the stages run back to front
// (stage j reads the bits of stage 2q-2-j; the distances are a palindrome)
// apply the inverse. Stages of distance >= 2^s are the outer ones, the
// 2s-1 below form the middle:
//   tnt_benes_outer runs a run of consecutive outer stages (one side's
//   q-s, or as many as a tile holds) in one pass over the (C, 2^q) array:
//   in the view (2^q / 2^d_lo rows of 2^d_lo), a stage at distance
//   2^d >= 2^d_lo pairs two rows in the same column, so the 2^r rows that
//   differ in the run's bits hold every partner their elements meet. A
//   block takes those rows' strip of >= 32 columns (128-byte segments),
//   as the JAX package's _outer_fused takes (Go, C) column chunks.
//   tnt_benes_local runs the middle on blocks of 2^s consecutive elements
//   of a column (after the entry side the network has split into such
//   independent blocks).
// Both hold their tile in registers (tile.cuh): a stage at tile bit d < 5
// exchanges across lanes with __shfl_xor_sync, one at a register bit in
// registers; only a stage elsewhere moves the tile through shared memory
// into a layout whose register bits cover it and the stages after it (one
// __syncthreads per layout change, not per stage). With q <= s the network
// is one local pass.
//
// Bound on the H100 at the 3D headline (n = 2^24, one column): reading and
// writing the 64 MB array once and reading the 49 MB of pair bits once,
// ~0.054 ms at 3.35 TB/s per direction. With blocks of 2^13 and outer
// tiles of 2^13 (ops/benes.py) the schedule makes five passes (two a side
// for the 11 outer stages, one local pass), ~0.2 ms at the memory rate; the
// local pass's 25 stages of shuffles and register exchanges bound it more
// than its bytes. The ragged passes move the n values once each way plus
// the padded rows.
// chip_smoke.py computes the bounds from its run and prints them beside the
// times.

#include <cstdint>
#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

using namespace tnt;

constexpr int kThreads = 256;

int blocks_for(int64_t total, int threads) {
  int64_t b = (total + threads - 1) / threads;
  if (b > (1 << 30)) b = 1 << 30;  // the kernels loop over the rest
  return static_cast<int>(b < 1 ? 1 : b);
}

__global__ void expand_rows_kernel(const uint32_t* __restrict__ stream,
                                   const int* __restrict__ rs,
                                   const int* __restrict__ cnt,
                                   uint32_t* __restrict__ out, int64_t ld,
                                   int S, int K, int C) {
  const int64_t row_words = static_cast<int64_t>(S) * K;
  const int64_t total = row_words * C;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t c = i / row_words;
    const int64_t r = i - c * row_words;
    const int s = static_cast<int>(r / K);
    const int k = static_cast<int>(r - static_cast<int64_t>(s) * K);
    out[i] = k < __ldg(cnt + s) ? __ldg(stream + c * ld + __ldg(rs + s) + k) : 0u;
  }
}

__global__ void compact_rows_kernel(const uint32_t* __restrict__ padded,
                                    const int* __restrict__ rs,
                                    const int* __restrict__ cnt,
                                    uint32_t* __restrict__ out, int64_t sc,
                                    int64_t ss, int64_t sk, int64_t size,
                                    int64_t n, int S, int K, int C) {
  const int64_t row_words = static_cast<int64_t>(S) * K;
  const int64_t lanes = row_words * C;
  const int64_t tail = size - n;
  const int64_t total = lanes + tail * C;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    if (i < lanes) {
      const int64_t c = i / row_words;
      const int64_t r = i - c * row_words;
      const int s = static_cast<int>(r / K);
      const int k = static_cast<int>(r - static_cast<int64_t>(s) * K);
      if (k < __ldg(cnt + s)) {
        out[c * size + __ldg(rs + s) + k] = __ldg(padded + c * sc + s * ss + k * sk);
      }
    } else {  // the stream's tail beyond n
      const int64_t j = i - lanes;
      const int64_t c = j / tail;
      out[c * size + n + (j - c * tail)] = 0u;
    }
  }
}

// Index of the pair whose lower member is element i at distance 2^d.
__device__ __forceinline__ int64_t pair_of(int64_t i, int d) {
  return ((i >> (d + 1)) << d) | (i & ((int64_t{1} << d) - 1));
}

template <int kLogE>
struct Words {
  static constexpr int E = 1 << kLogE;
  uint32_t v[E];
  int lo;  // register bits [lo, lo + kLogE) of the tile index
};

// Moves the tile through shared memory into the layout ``lo``. Every thread
// calls it at the same point. One barrier: a thread writes and reads only
// its own slots of each layout, so the next change's writes cannot meet
// this change's reads.
template <int kLogE>
__device__ __forceinline__ void relayout(Words<kLogE>& R, int lo, uint32_t* sv) {
  const int x = threadIdx.x;
#pragma unroll
  for (int r = 0; r < Words<kLogE>::E; ++r) sv[slot_pos<kLogE>(x, R.lo, r)] = R.v[r];
  __syncthreads();
  R.lo = lo;
#pragma unroll
  for (int r = 0; r < Words<kLogE>::E; ++r) R.v[r] = sv[slot_pos<kLogE>(x, lo, r)];
}

// The stage at tile bit d, its pair bits in ``sbits`` (the tile's pairs in
// order, one bit each: the pair of lower member t is bit pt & 31 of word
// pt >> 5, pt = pair_of(t, d)). The word and bit of each slot's pair follow
// from per-thread values and compile-time slot constants: for d >= 5 the
// 32 lanes of a slot share one word and lane L reads bit L; for d < 5,
// which runs in the layout lo = 5 (t = lane | r << 5 | warp << (5 + kLogE)),
// the word is t >> 6 and the bit the lane's with bit d taken out, bit 4
// from bit 5 of t, the slot's bit 0.
template <int kLogE>
__device__ __forceinline__ void benes_stage(Words<kLogE>& R, int d,
                                            const uint32_t* sbits) {
  const int x = threadIdx.x, lane = x & 31, lo = R.lo;
  if (d < 5) {
    const int lane_bit = 1 << d;
    const uint32_t* wp = sbits + ((x >> 5) << (kLogE - 1));
    const int bl = ((lane >> (d + 1)) << d) | (lane & (lane_bit - 1));
    const uint32_t m0 = 1u << bl, m1 = 1u << (bl | 16);
#pragma unroll
    for (int r = 0; r < Words<kLogE>::E; ++r) {
      const uint32_t pv = __shfl_xor_sync(kFull, R.v[r], lane_bit);
      if (wp[r >> 1] & ((r & 1) ? m1 : m0)) R.v[r] = pv;
    }
    return;
  }
  const int xlow = x & ((1 << lo) - 1), xhigh = x >> lo;
  const int step = 1 << (lo - 5);  // t >> 5 grows by step from slot to slot
  const int w0 = (xlow >> 5) | (xhigh << (lo + kLogE - 6));
  const uint32_t lane_mask = 1u << lane;
  const int rb = d - lo;
#pragma unroll
  for (int RB = 0; RB < kLogE; ++RB) {
    if (RB != rb) continue;
#pragma unroll
    for (int r = 0; r < Words<kLogE>::E; ++r) {
      if (r & (1 << RB)) continue;
      const int h = r | (1 << RB);
      // the slot bits of the pair index: r without its bit RB
      const int f = (r & ((1 << RB) - 1)) | ((r >> (RB + 1)) << RB);
      if (sbits[w0 + f * step] & lane_mask) {
        const uint32_t a = R.v[r];
        R.v[r] = R.v[h];
        R.v[h] = a;
      }
    }
  }
}

__host__ __device__ __forceinline__ int stage_distance(int q, int j) {
  return j < q ? q - 1 - j : j - q + 1;
}

// Network positions j0..j1 (one side's consecutive outer stages, distances
// monotone between d_lo and d_hi) in one pass. Tile index t of block blk of
// its column: bits [0, wl) are index bits [0, wl), bits [wl, wl + r) index
// bits [d_lo, d_hi]; blk supplies index bits [wl, d_lo) and above d_hi.
// Stage j reads bit row (reverse ? 2q-2-j : j) of ``bits`` ((2q-1, n/64)).
template <int kLogE>
__global__ void __launch_bounds__(kMaxThreads) benes_outer_kernel(
    uint32_t* __restrict__ v, const uint32_t* __restrict__ bits, int64_t n,
    int q, int j0, int j1, int reverse, int wl) {
  extern __shared__ uint32_t smem[];
  const int da = stage_distance(q, j0), db = stage_distance(q, j1);
  const bool down = da > db;
  const int d_lo = down ? db : da, d_hi = down ? da : db;
  const int T = wl + d_hi - d_lo + 1;
  const int n_st = j1 - j0 + 1;
  const int wps = 1 << (T - 6);  // bit words per stage and tile
  uint32_t* sbits = smem;
  uint32_t* sv = smem + n_st * wps;
  const int64_t per_col = n >> T;
  const int64_t c = blockIdx.x / per_col;
  const int64_t blk = blockIdx.x - c * per_col;
  const int mid = d_lo - wl;
  const int64_t fixed = ((blk & ((int64_t{1} << mid) - 1)) << wl) |
                        ((blk >> mid) << (d_hi + 1));
  uint32_t* col = v + c * n + fixed;  // the tile's offsets from here fit 32 bits
  const auto offset = [wl, d_lo](int t) {
    return (static_cast<uint32_t>(t) & ((1u << wl) - 1)) |
           (static_cast<uint32_t>(t >> wl) << d_lo);
  };
  // each stage's words: pair word w covers the tile pairs 32w..32w+31, one
  // global word (the tile's bits 0..4 are the index's and d >= 5)
  const int64_t row_words = n >> 6;
  for (int i = threadIdx.x; i < n_st * wps; i += blockDim.x) {
    const int st = i / wps;
    const int j = j0 + st;
    const int d = stage_distance(q, j);
    const int bt = wl + d - d_lo;
    const int pt = (i - st * wps) << 5;
    const int t = ((pt >> bt) << (bt + 1)) | (pt & ((1 << bt) - 1));
    const int64_t row = reverse ? 2 * q - 2 - j : j;
    sbits[i] = __ldg(bits + row * row_words + (pair_of(fixed + offset(t), d) >> 5));
  }
  Words<kLogE> R;
  R.lo = layout_for<kLogE>(wl + da - d_lo, T, down);
#pragma unroll
  for (int r = 0; r < Words<kLogE>::E; ++r) {
    R.v[r] = col[offset(slot_pos<kLogE>(threadIdx.x, R.lo, r))];
  }
  __syncthreads();  // the bit words are in
  for (int st = 0; st < n_st; ++st) {
    const int bt = wl + stage_distance(q, j0 + st) - d_lo;
    if (bt < R.lo || bt >= R.lo + kLogE) relayout(R, layout_for<kLogE>(bt, T, down), sv);
    benes_stage(R, bt, sbits + st * wps);
  }
#pragma unroll
  for (int r = 0; r < Words<kLogE>::E; ++r) {
    col[offset(slot_pos<kLogE>(threadIdx.x, R.lo, r))] = R.v[r];
  }
}

// Positions j = q-s .. q+s-2 of the network (every distance below 2^s) on
// blocks of 2^s consecutive elements of a column.
template <int kLogE>
__global__ void __launch_bounds__(kMaxThreads) benes_local_kernel(
    uint32_t* __restrict__ v, const uint32_t* __restrict__ bits, int64_t n,
    int q, int s, int reverse) {
  extern __shared__ uint32_t smem[];
  const int n_st = 2 * s - 1;
  const int wps = 1 << (s - 6);  // the block's 2^(s-1) pair bits per stage
  uint32_t* sbits = smem;
  uint32_t* sv = smem + n_st * wps;
  const int64_t per_col = n >> s;
  const int64_t c = blockIdx.x / per_col;
  const int64_t blk = blockIdx.x - c * per_col;
  uint32_t* src = v + c * n + (blk << s);
  const int64_t row_words = n >> 6;
  for (int i = threadIdx.x; i < n_st * wps; i += blockDim.x) {
    const int st = i / wps;
    const int j = q - s + st;
    const int64_t row = reverse ? 2 * q - 2 - j : j;
    sbits[i] = __ldg(bits + row * row_words + (blk << (s - 6)) + (i - st * wps));
  }
  Words<kLogE> R;
  R.lo = layout_for<kLogE>(s - 1, s, true);
#pragma unroll
  for (int r = 0; r < Words<kLogE>::E; ++r) {
    R.v[r] = src[slot_pos<kLogE>(threadIdx.x, R.lo, r)];
  }
  __syncthreads();  // the bit words are in
  for (int st = 0; st < n_st; ++st) {
    const bool down = st < s - 1;
    const int d = down ? s - 1 - st : st - s + 1;
    if (d >= 5 ? d < R.lo || d >= R.lo + kLogE : R.lo != 5) {
      relayout(R, layout_for<kLogE>(d, s, down), sv);
    }
    benes_stage(R, d, sbits + st * wps);
  }
#pragma unroll
  for (int r = 0; r < Words<kLogE>::E; ++r) {
    src[slot_pos<kLogE>(threadIdx.x, R.lo, r)] = R.v[r];
  }
}

template <int kLogE>
cudaError_t launch_outer(uint32_t* v, const uint32_t* bits, int64_t n, int C,
                         int q, int j0, int j1, int reverse, int wl, int T,
                         cudaStream_t stream) {
  const int r_bits = j1 - j0 + 1;
  const size_t smem = sizeof(uint32_t) *
      ((static_cast<size_t>(r_bits) << (T - 6)) + (r_bits > kLogE ? size_t{1} << T : 0));
  cudaError_t err = set_smem(benes_outer_kernel<kLogE>, smem);
  if (err != cudaSuccess) return err;
  benes_outer_kernel<kLogE><<<static_cast<unsigned>((n >> T) * C), 1 << (T - kLogE),
                              smem, stream>>>(v, bits, n, q, j0, j1, reverse, wl);
  return cudaGetLastError();
}

template <int kLogE>
cudaError_t launch_local(uint32_t* v, const uint32_t* bits, int64_t n, int C,
                         int q, int s, int reverse, cudaStream_t stream) {
  const size_t smem = sizeof(uint32_t) *
      ((static_cast<size_t>(2 * s - 1) << (s - 6)) + (s > 5 + kLogE ? size_t{1} << s : 0));
  cudaError_t err = set_smem(benes_local_kernel<kLogE>, smem);
  if (err != cudaSuccess) return err;
  benes_local_kernel<kLogE><<<static_cast<unsigned>((n >> s) * C), 1 << (s - kLogE),
                              smem, stream>>>(v, bits, n, q, s, reverse);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int tnt_expand_rows(const void* stream, const int* row_start,
                    const int* row_count, void* out, int64_t ld, int64_t L,
                    int S, int K, int C, int device, void* strm) {
  (void)L;  // rows read only [0, n) of each column; L >= n is the caller's
  cudaError_t err = cudaSetDevice(device);
  const int64_t total = static_cast<int64_t>(S) * K * C;
  if (err != cudaSuccess || total == 0) return static_cast<int>(err);
  expand_rows_kernel<<<blocks_for(total, kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(strm)>>>(
      static_cast<const uint32_t*>(stream), row_start, row_count,
      static_cast<uint32_t*>(out), ld, S, K, C);
  return static_cast<int>(cudaGetLastError());
}

int tnt_compact_rows(const void* padded, const int* row_start,
                     const int* row_count, void* out, int64_t sc, int64_t ss,
                     int64_t sk, int64_t size, int64_t n, int S, int K, int C,
                     int device, void* strm) {
  cudaError_t err = cudaSetDevice(device);
  const int64_t total = (static_cast<int64_t>(S) * K + (size - n)) * C;
  if (err != cudaSuccess || total == 0) return static_cast<int>(err);
  compact_rows_kernel<<<blocks_for(total, kThreads), kThreads, 0,
                        static_cast<cudaStream_t>(strm)>>>(
      static_cast<const uint32_t*>(padded), row_start, row_count,
      static_cast<uint32_t*>(out), sc, ss, sk, size, n, S, K, C);
  return static_cast<int>(cudaGetLastError());
}

// Network positions j0..j1 (consecutive outer stages of one side: all of
// distance >= 2^5, j1 < q or j0 >= q) on the (C, n) words v in place, in
// one pass with tiles of at most 2^tile_log2 words (at most tile_log2 - 5
// stages).
int tnt_benes_outer(void* v, const void* bits, int64_t n, int C, int q, int j0,
                    int j1, int reverse, int tile_log2, int device, void* strm) {
  const int da = stage_distance(q, j0), db = stage_distance(q, j1);
  const int d_lo = da < db ? da : db;
  const int r_bits = j1 - j0 + 1;
  int wl = tile_log2 - r_bits;
  if (wl > d_lo) wl = d_lo;
  const int T = wl + r_bits;
  const bool one_side = (j1 < q || j0 >= q) && (da > db ? da - db : db - da) == r_bits - 1;
  if (j0 < 0 || j1 > 2 * q - 2 || r_bits < 1 || !one_side || wl < 5 || T < 6 ||
      T > 15 || q > 31 || n != (int64_t{1} << q) || C < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* w = static_cast<uint32_t*>(v);
  const auto* b = static_cast<const uint32_t*>(bits);
  const auto s = static_cast<cudaStream_t>(strm);
  switch (words_log2(T)) {
    case 1: err = launch_outer<1>(w, b, n, C, q, j0, j1, reverse, wl, T, s); break;
    case 2: err = launch_outer<2>(w, b, n, C, q, j0, j1, reverse, wl, T, s); break;
    case 3: err = launch_outer<3>(w, b, n, C, q, j0, j1, reverse, wl, T, s); break;
    case 4: err = launch_outer<4>(w, b, n, C, q, j0, j1, reverse, wl, T, s); break;
    case 5: err = launch_outer<5>(w, b, n, C, q, j0, j1, reverse, wl, T, s); break;
    default: err = launch_outer<6>(w, b, n, C, q, j0, j1, reverse, wl, T, s); break;
  }
  return static_cast<int>(err);
}

// Positions q-s .. q+s-2 (every distance below 2^s, 6 <= s <= 15, s <= q)
// on blocks of 2^s elements of each column of the (C, n) words v, in place.
int tnt_benes_local(void* v, const void* bits, int64_t n, int C, int q, int s,
                    int reverse, int device, void* strm) {
  if (s < 6 || s > 15 || s > q || n != (int64_t{1} << q) || C < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* w = static_cast<uint32_t*>(v);
  const auto* b = static_cast<const uint32_t*>(bits);
  const auto st = static_cast<cudaStream_t>(strm);
  switch (words_log2(s)) {
    case 1: err = launch_local<1>(w, b, n, C, q, s, reverse, st); break;
    case 2: err = launch_local<2>(w, b, n, C, q, s, reverse, st); break;
    case 3: err = launch_local<3>(w, b, n, C, q, s, reverse, st); break;
    case 4: err = launch_local<4>(w, b, n, C, q, s, reverse, st); break;
    case 5: err = launch_local<5>(w, b, n, C, q, s, reverse, st); break;
    default: err = launch_local<6>(w, b, n, C, q, s, reverse, st); break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
