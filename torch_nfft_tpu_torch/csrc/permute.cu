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
// row s holds stream positions [rs[s], rs[s] + cnt[s]), rs the exclusive
// cumsum of cnt. The TPU kernels roll a two-block window of the stream per
// group of rows to align lanes. Here a block takes a group of R
// consecutive rows (R*K ~ 2^12 words, ops/ragged.py:rows_per_group), whose
// filled lanes are one span [rs[s0], rs[s0] + sum cnt) of the stream, and
// stages that span in shared memory: the rows' starts and counts are read
// once per block, a lane's row is j >> log2 K for the plans' power-of-two
// K (a multiply-high for any other K: no division), and every global
// access is a 16-byte vector except the span's two partial ends.
//   expand: the span in with 16-byte loads (its partial ends as single
//   words), the padded rows out with 16-byte stores (a row starts at word
//   s*K), zeros for lanes >= cnt.
//   compact: each row's filled lanes in with 16-byte loads (vectors wholly
//   past cnt are not read), assembled in shared memory at their stream
//   offsets, the span out with 16-byte stores and its ends as single words,
//   so no two blocks write one word and no atomics are needed; extra blocks
//   write the zero tail [n, size). The rows of unslot_values at C > 1 (the
//   (S*K, C) slot array seen as (C, S, K), strides (1, K*C, C)) are read as
//   the group's contiguous (R*K, C) slab, all columns in one block, and
//   transposed in shared memory; other strides read one word at a time.
// Bound: the n filled words of each column once each way plus the padded
// side, ~0.04 ms a pass at the 3D headline (n = 2^24, S*K = 20.3 M);
// chip_smoke.py prints it beside the time.
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
// than its bytes. chip_smoke.py computes the bounds from its run and prints
// them beside the times.

#include <cstdint>
#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

using namespace tnt;

constexpr int kRowThreads = 256;
// zero-tail words per block of the compaction
constexpr int kTailWords = 8192;

// j / d for 0 <= j < 2^31 without a division: (mulhi(j, mul) + j) >> shift,
// with mul = 0 for a power-of-two d (a shift) and otherwise Granlund and
// Montgomery's round-up multiplier (ops/ragged.py:fast_divisor).
struct FastDiv {
  uint32_t mul;
  int shift;
  __device__ __forceinline__ int operator()(int j) const {
    const uint32_t u = static_cast<uint32_t>(j);
    return static_cast<int>((__umulhi(u, mul) + u) >> shift);
  }
};

// Word offset of p past the 16-byte boundary at or below it.
__device__ __forceinline__ int lead_of(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

__host__ __device__ __forceinline__ int round4(int w) { return (w + 3) & ~3; }

// Shared words of one column's span buffer: the span, its lead and the
// 16-byte vectors that cover both ends.
__host__ __device__ __forceinline__ int span_words(int R, int K) { return round4(R * K) + 8; }

// The group's rows [s0, s0 + nr): starts and counts into shared memory, one
// coalesced read each. Returns the span's first stream word; *len gets its
// length (rows tile the stream, so the span is the last row's end less it).
__device__ __forceinline__ int load_group(const int* __restrict__ rs,
                                          const int* __restrict__ cnt, int s0,
                                          int nr, int* s_rs, int* s_cnt, int* len) {
  for (int i = threadIdx.x; i < nr; i += blockDim.x) {
    s_rs[i] = __ldg(rs + s0 + i);
    s_cnt[i] = __ldg(cnt + s0 + i);
  }
  __syncthreads();
  *len = s_rs[nr - 1] + s_cnt[nr - 1] - s_rs[0];
  return s_rs[0];
}

// dst[j] = value(j) for 0 <= j < len: 16-byte stores where a whole aligned
// vector lies inside, single words at the two ends (which a neighbouring
// block may share).
template <class F>
__device__ __forceinline__ void write_words(uint32_t* dst, int len, F value) {
  const int lead = lead_of(dst);
  const int nv = len > 0 ? (len + lead + 3) >> 2 : 0;
  uint4* v = reinterpret_cast<uint4*>(dst - lead);
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    const int j = 4 * i - lead;
    if (j >= 0 && j + 4 <= len) {
      v[i] = make_uint4(value(j), value(j + 1), value(j + 2), value(j + 3));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (j + e >= 0 && j + e < len) dst[j + e] = value(j + e);
      }
    }
  }
}

// span[lead_of(src) + j] = src[j] for 0 <= j < len: 16-byte loads where a
// whole aligned vector lies inside, single words at the two ends (nothing
// outside [src, src + len) is read).
__device__ __forceinline__ void read_words(uint32_t* span, const uint32_t* src, int len) {
  const int lead = lead_of(src);
  const int nv = len > 0 ? (len + lead + 3) >> 2 : 0;
  const uint4* v = reinterpret_cast<const uint4*>(src - lead);
#pragma unroll 4
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    const int j = 4 * i - lead;
    if (j >= 0 && j + 4 <= len) {
      reinterpret_cast<uint4*>(span)[i] = __ldg(v + i);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (j + e >= 0 && j + e < len) span[4 * i + e] = __ldg(src + j + e);
      }
    }
  }
}

// dst[0, len) from span, which holds dst's word j at span[lead_of(dst) + j]:
// the same vectors as write_words, one shared 16-byte load each.
__device__ __forceinline__ void write_span(uint32_t* dst, int len, const uint32_t* span) {
  const int lead = lead_of(dst);
  const int nv = len > 0 ? (len + lead + 3) >> 2 : 0;
  uint4* v = reinterpret_cast<uint4*>(dst - lead);
  const uint4* sv = reinterpret_cast<const uint4*>(span);
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    const int j = 4 * i - lead;
    if (j >= 0 && j + 4 <= len) {
      v[i] = sv[i];
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (j + e >= 0 && j + e < len) dst[j + e] = span[4 * i + e];
      }
    }
  }
}

// Block (g, y): rows [g*R, g*R + R) of columns y, y + gridDim.y, ...
__global__ void __launch_bounds__(kRowThreads) expand_rows_kernel(
    const uint32_t* __restrict__ stream, const int* __restrict__ rs,
    const int* __restrict__ cnt, uint32_t* __restrict__ out, int64_t ld, int S,
    int K, FastDiv div_k, int R, int C) {
  extern __shared__ __align__(16) uint32_t rows_smem[];
  int* s_rs = reinterpret_cast<int*>(rows_smem);
  int* s_cnt = s_rs + R;
  uint32_t* span = rows_smem + round4(2 * R);
  const int s0 = blockIdx.x * R;
  const int nr = min(R, S - s0);
  int len;
  const int a = load_group(rs, cnt, s0, nr, s_rs, s_cnt, &len);
  for (int c = blockIdx.y; c < C; c += gridDim.y) {
    const uint32_t* src = stream + c * ld + a;
    read_words(span, src, len);
    __syncthreads();
    const int base = lead_of(src) - a;  // stream word p is span[base + p]
    uint32_t* dst = out + (static_cast<int64_t>(c) * S + s0) * K;
    if ((K & 3) == 0) {  // aligned rows: a vector lies in one row
      for (int i = threadIdx.x; i < (nr * K) >> 2; i += blockDim.x) {
        const int j = 4 * i, r = div_k(j), k = j - r * K;
        const int m = s_cnt[r] - k;  // filled lanes of the vector, if > 0
        const uint32_t* p = span + base + s_rs[r] + k;
        reinterpret_cast<uint4*>(dst)[i] = make_uint4(
            m > 0 ? p[0] : 0u, m > 1 ? p[1] : 0u, m > 2 ? p[2] : 0u, m > 3 ? p[3] : 0u);
      }
    } else {
      write_words(dst, nr * K, [&](int j) {
        const int r = div_k(j), k = j - r * K;
        return k < s_cnt[r] ? span[base + s_rs[r] + k] : 0u;
      });
    }
    __syncthreads();  // the span is read before the next column's loads
  }
}

enum Layout { kRows = 0, kStrided = 1, kSlab = 2 };

// Block (g, y), g < groups: rows [g*R, g*R + R) of columns y, y +
// gridDim.y, ... (kSlab: of every column, gridDim.y = 1). kRows: each row's
// K words contiguous and 16-byte aligned (K % 4 == 0); kStrided: any
// strides; kSlab: strides (1, K*C, C). Blocks g >= groups write the zero
// tail [n, size) in chunks of kTailWords.
template <int kLayout>
__global__ void __launch_bounds__(kRowThreads) compact_rows_kernel(
    const uint32_t* __restrict__ padded, const int* __restrict__ rs,
    const int* __restrict__ cnt, uint32_t* __restrict__ out, int64_t sc,
    int64_t ss, int64_t sk, int64_t size, int64_t n, int S, int K, FastDiv div_k,
    FastDiv div_c, int R, int C, int groups) {
  extern __shared__ __align__(16) uint32_t rows_smem[];
  if (static_cast<int>(blockIdx.x) >= groups) {
    const int64_t start = n + static_cast<int64_t>(blockIdx.x - groups) * kTailWords;
    const int len = static_cast<int>(min(static_cast<int64_t>(kTailWords), size - start));
    for (int c = blockIdx.y; c < C; c += gridDim.y) {
      write_words(out + c * size + start, len, [](int) { return 0u; });
    }
    return;
  }
  int* s_rs = reinterpret_cast<int*>(rows_smem);
  int* s_cnt = s_rs + R;
  uint32_t* span = rows_smem + round4(2 * R);
  const int s0 = blockIdx.x * R;
  const int nr = min(R, S - s0);
  const int words = nr * K;
  int len;
  const int a = load_group(rs, cnt, s0, nr, s_rs, s_cnt, &len);
  if (kLayout == kSlab) {
    // the group's (words, C) slab, one contiguous range; a word's column
    // buffer is span + w * cap, aligned like its output column
    const int cap = span_words(R, K);
    const uint32_t* slab = padded + static_cast<int64_t>(s0) * K * C;
    const int total = words * C;
    const int lead = lead_of(slab);
    const int nv = total > 0 ? (total + lead + 3) >> 2 : 0;
    const uint4* v = reinterpret_cast<const uint4*>(slab - lead);
    const int64_t out_word = static_cast<int64_t>(reinterpret_cast<uintptr_t>(out) >> 2) + a;
    for (int i = threadIdx.x; i < nv; i += blockDim.x) {
      int dst[4];
      bool any = false;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = 4 * i - lead + e;
        dst[e] = -1;
        if (f >= 0 && f < total) {
          const int j = div_c(f), w = f - j * C;
          const int r = div_k(j), k = j - r * K;
          if (k < s_cnt[r]) {
            dst[e] = w * cap + static_cast<int>((out_word + w * size) & 3) + s_rs[r] - a + k;
            any = true;
          }
        }
      }
      if (any && 4 * i - lead >= 0 && 4 * i - lead + 4 <= total) {
        const uint4 x = __ldg(v + i);
        if (dst[0] >= 0) span[dst[0]] = x.x;
        if (dst[1] >= 0) span[dst[1]] = x.y;
        if (dst[2] >= 0) span[dst[2]] = x.z;
        if (dst[3] >= 0) span[dst[3]] = x.w;
      } else if (any) {  // a vector the slab only partly covers: its words
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (dst[e] >= 0) span[dst[e]] = __ldg(slab + 4 * i - lead + e);
        }
      }
    }
    __syncthreads();
    for (int w = 0; w < C; ++w) write_span(out + w * size + a, len, span + w * cap);
    return;
  }
  for (int c = blockIdx.y; c < C; c += gridDim.y) {
    uint32_t* dst = out + c * size + a;
    const int base = lead_of(dst) - a;  // stream word p goes to span[base + p]
    const uint32_t* col = padded + c * sc + s0 * ss;
    if (kLayout == kRows) {
      for (int i = threadIdx.x; i < words >> 2; i += blockDim.x) {
        const int j = 4 * i;
        const int r = div_k(j), k = j - r * K;
        const int m = s_cnt[r] - k;  // filled lanes of the vector, if > 0
        if (m > 0) {
          const uint4 x = __ldg(reinterpret_cast<const uint4*>(col + r * ss + k));
          uint32_t* p = span + base + s_rs[r] + k;
          p[0] = x.x;
          if (m > 1) p[1] = x.y;
          if (m > 2) p[2] = x.z;
          if (m > 3) p[3] = x.w;
        }
      }
    } else {
      for (int j = threadIdx.x; j < words; j += blockDim.x) {
        const int r = div_k(j), k = j - r * K;
        if (k < s_cnt[r]) span[base + s_rs[r] + k] = __ldg(col + r * ss + k * sk);
      }
    }
    __syncthreads();
    write_span(dst, len, span);
    __syncthreads();  // the span is read before the next column's writes
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

// Rows of R = rows_per_group (ops/ragged.py) a block; K's divisor
// (mul_k, shift_k) from fast_divisor.
int tnt_expand_rows(const void* stream, const int* row_start,
                    const int* row_count, void* out, int64_t ld, int64_t L,
                    int S, int K, int C, int R, uint32_t mul_k, int shift_k,
                    int device, void* strm) {
  (void)L;  // rows read only [0, n) of each column; L >= n is the caller's
  if (S < 0 || K < 1 || C < 0 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || S == 0 || C == 0) return static_cast<int>(err);
  const size_t smem = sizeof(uint32_t) * (round4(2 * R) + span_words(R, K));
  err = set_smem(expand_rows_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + R - 1) / R, C < 65535 ? C : 65535);
  expand_rows_kernel<<<grid, kRowThreads, smem, static_cast<cudaStream_t>(strm)>>>(
      static_cast<const uint32_t*>(stream), row_start, row_count,
      static_cast<uint32_t*>(out), ld, S, K, FastDiv{mul_k, shift_k}, R, C);
  return static_cast<int>(cudaGetLastError());
}

// ``layout``: 0 rows (K % 4 == 0, every row 16-byte aligned), 1 any
// strides, 2 the slab (strides (1, K*C, C)); ops/ragged.py:compact_layout
// chooses. R rows a block (for the slab, R*K*C ~ the group's words); C's
// divisor (mul_c, shift_c) serves the slab.
int tnt_compact_rows(const void* padded, const int* row_start,
                     const int* row_count, void* out, int64_t sc, int64_t ss,
                     int64_t sk, int64_t size, int64_t n, int S, int K, int C,
                     int layout, int R, uint32_t mul_k, int shift_k,
                     uint32_t mul_c, int shift_c, int device, void* strm) {
  if (S < 0 || K < 1 || C < 0 || R < 1 || size < n || layout < kRows || layout > kSlab) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  const int groups = (S + R - 1) / R;
  const int64_t tail = (size - n + kTailWords - 1) / kTailWords;
  if (err != cudaSuccess || C == 0 || groups + tail == 0) return static_cast<int>(err);
  const int spans = layout == kSlab ? C : 1;
  const size_t smem = sizeof(uint32_t) *
      (round4(2 * R) + static_cast<size_t>(spans) * span_words(R, K));
  const dim3 grid(static_cast<unsigned>(groups + tail),
                  layout == kSlab ? 1 : (C < 65535 ? C : 65535));
  const auto st = static_cast<cudaStream_t>(strm);
  const auto* in = static_cast<const uint32_t*>(padded);
  auto* o = static_cast<uint32_t*>(out);
  const FastDiv dk{mul_k, shift_k}, dc{mul_c, shift_c};
  switch (layout) {
#define TNT_COMPACT(L)                                                         \
  case L:                                                                      \
    err = set_smem(compact_rows_kernel<L>, smem);                              \
    if (err != cudaSuccess) return static_cast<int>(err);                      \
    compact_rows_kernel<L><<<grid, kRowThreads, smem, st>>>(                   \
        in, row_start, row_count, o, sc, ss, sk, size, n, S, K, dk, dc, R, C,  \
        groups);                                                               \
    break;
    TNT_COMPACT(kRows)
    TNT_COMPACT(kStrided)
    TNT_COMPACT(kSlab)
#undef TNT_COMPACT
  }
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
