// Static permutations of the binned NFFT's user <-> slot maps, for Hopper:
// the ragged row-stream passes and the Benes network.
//
// Replaces the TPU kernels of the JAX package:
//   tnt_expand_rows   <- ops/pallas/ragged.py:expand_rows (_expand_kernel);
//   tnt_compact_rows  <- ops/pallas/ragged.py:compact_rows (_compact_kernel);
//   tnt_benes_stage   <- ops/pallas/benes.py:apply_benes, its cross-block
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
// reads its own mask; a CUDA thread indexes the per-pair bits directly,
// 1/32 of the bytes. Forward gives out[perm[i]] = in[i]; the stages run
// back to front (stage j reads the bits of stage 2q-2-j; the distances are
// a palindrome) apply the inverse.
//   tnt_benes_stage runs one stage at a distance >= 2^s over the whole
//   (C, 2^q) array in place: one thread per pair and column.
//   tnt_benes_local runs every stage of distance < 2^s: after the
//   q-s outer stages, the network has split into independent blocks of 2^s
//   consecutive elements, each of which a thread block loads into shared
//   memory, exchanges through its 2s-1 middle stages (a __syncthreads()
//   between stages) and writes back. The whole network is then
//   q-s global stages, one local pass, q-s global stages; with q <= s it is
//   one local pass.
//
// Bound on the H100 at the 3D headline (n = 2^24, one column, s = 15):
// each of the 18 global stages reads and writes 64 MB (plus 1 MB of pair
// bits), the local pass as much again: ~2.5 GB per network, ~0.75 ms at
// 3.35 TB/s. The ragged passes move the n values once each way plus the
// padded rows. chip_smoke.py computes the bounds from its run and prints
// them beside the times.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLocalThreads = 1024;

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

__device__ __forceinline__ bool pair_bit(const uint32_t* __restrict__ bits,
                                         int64_t p) {
  return (__ldg(bits + (p >> 5)) >> (p & 31)) & 1u;
}

__device__ __forceinline__ int64_t pair_lo(int64_t p, int d) {
  return ((p >> d) << (d + 1)) + (p & ((int64_t{1} << d) - 1));
}

// One exchange stage at distance 2^d over (C, n) in place; ``bits`` is the
// stage's row of per-pair words.
__global__ void benes_stage_kernel(uint32_t* __restrict__ v,
                                   const uint32_t* __restrict__ bits,
                                   int64_t n, int C, int d) {
  const int64_t half = n >> 1;
  const int64_t total = half * C;
  const int64_t D = int64_t{1} << d;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t c = i / half;
    const int64_t p = i - c * half;
    if (pair_bit(bits, p)) {
      uint32_t* col = v + c * n;
      const int64_t lo = pair_lo(p, d);
      const uint32_t a = col[lo];
      col[lo] = col[lo + D];
      col[lo + D] = a;
    }
  }
}

// Stages j = q-s .. q+s-2 of the network (every distance below 2^s) on
// blocks of 2^s consecutive elements in shared memory; stage j reads the
// bits of row (reverse ? 2q-2-j : j) of ``bits`` ((2q-1, n/64) words).
__global__ void benes_local_kernel(uint32_t* __restrict__ v,
                                   const uint32_t* __restrict__ bits,
                                   int64_t n, int q, int s, int reverse) {
  extern __shared__ uint32_t blk[];
  const int64_t B = int64_t{1} << s;
  const int64_t per_col = n >> s;
  const int64_t c = blockIdx.x / per_col;
  const int64_t b = blockIdx.x - c * per_col;
  uint32_t* src = v + c * n + b * B;
  for (int64_t i = threadIdx.x; i < B; i += blockDim.x) blk[i] = src[i];
  __syncthreads();
  const int64_t words = n >> 6;
  const int64_t pair0 = b * (B >> 1);
  for (int j = q - s; j <= q + s - 2; ++j) {
    const int d = j < q ? q - 1 - j : j - q + 1;
    const int t = reverse ? 2 * q - 2 - j : j;
    const uint32_t* row = bits + t * words;
    const int64_t D = int64_t{1} << d;
    for (int64_t lp = threadIdx.x; lp < (B >> 1); lp += blockDim.x) {
      if (pair_bit(row, pair0 + lp)) {
        const int64_t lo = pair_lo(lp, d);
        const uint32_t a = blk[lo];
        blk[lo] = blk[lo + D];
        blk[lo + D] = a;
      }
    }
    __syncthreads();
  }
  for (int64_t i = threadIdx.x; i < B; i += blockDim.x) src[i] = blk[i];
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

int tnt_benes_stage(void* v, const void* stage_bits, int64_t n, int C, int d,
                    int device, void* strm) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = (n >> 1) * C;
  benes_stage_kernel<<<blocks_for(total, kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(strm)>>>(
      static_cast<uint32_t*>(v), static_cast<const uint32_t*>(stage_bits), n,
      C, d);
  return static_cast<int>(cudaGetLastError());
}

int tnt_benes_local(void* v, const void* bits, int64_t n, int C, int q, int s,
                    int reverse, int device, void* strm) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(uint32_t) << s;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(benes_local_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (n >> s) * C;
  const int threads = (1 << (s - 1)) < kLocalThreads ? (1 << (s - 1)) : kLocalThreads;
  benes_local_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                       static_cast<cudaStream_t>(strm)>>>(
      static_cast<uint32_t*>(v), static_cast<const uint32_t*>(bits), n, q, s,
      reverse);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
