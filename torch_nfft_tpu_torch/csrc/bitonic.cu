// Bitonic key/value sort for Hopper.
//
// Replaces the TPU kernels of the JAX package's ops/pallas/bitonic.py
// (sort_pairs and apply_permutation):
//   tnt_bitonic_local_sort   <- _local_sort_loop_kernel / _local_rounds_kernel;
//   tnt_bitonic_cross_stage  <- _cross_stage (one stage at distance >= block);
//   tnt_bitonic_local_merge  <- _local_merge_loop_kernel / _local_merge_kernel.
//
// The network (fixed by the JAX module's docstring; the block size changes
// only the schedule): Q = 2^q elements, rounds jj = 1..q, in round jj the
// stages d = jj-1..0 exchange the pair (i, i ^ 2^d), i the member with bit
// d clear; the pair sorts descending iff bit jj of i is set (round q is
// ascending everywhere). Both members take one verdict,
// swap = (key_lo > key_hi) XOR desc, so tied keys move as the TPU kernels
// move them and the output equals theirs bit for bit. Keys are int32;
// values are any 32-bit word (float32 or int32), moved unchanged.
//
// Schedule with blocks of 2^b elements (b <= q): the local sort runs rounds
// 1..b inside each block in shared memory (one launch); each later round jj
// runs its stages of distance >= 2^b as one elementwise launch each over
// the whole array (coalesced: a warp takes 32 consecutive pairs), then its
// b stages below 2^b inside each block in shared memory (one launch). A
// block of 2^b keys and values needs 2^(b+3) bytes of shared memory; the
// wrapper (ops/bitonic.py) takes b = 13, 64 KB, two blocks of 1024
// threads per SM.
//
// Bound on the H100 at Q = 2^24: reading and writing the keys and values
// once, 268 MB, ~0.08 ms at 3.35 TB/s; the network's 2^23 x 300
// comparisons take ~0.04 ms at 67 T operations/s. The schedule is far from
// either: each of the q-b rounds beyond the block reads and writes the
// whole array once per cross stage and once for its local merge, besides
// the local sort's pass: (q-b)(q-b+3)/2 + 1 passes (78 at q = 24, b = 13),
// each ~0.08 ms at best.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// (torch_nfft_tpu_torch/_build.py). Plain C interface: every function
// returns the cudaError_t of its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLocalThreads = 1024;
constexpr size_t kSmemDefault = 48 * 1024;

// Position of pair p's lower member at distance 2^d.
__device__ __forceinline__ int64_t pair_lo(int64_t p, int d) {
  return ((p >> d) << (d + 1)) + (p & ((int64_t{1} << d) - 1));
}

// One compare-exchange of the elements lo and lo + 2^d of (k, v).
__device__ __forceinline__ void exchange(int* k, uint32_t* v, int64_t lo,
                                         int64_t D, bool desc) {
  const int ka = k[lo], kb = k[lo + D];
  if ((ka > kb) != desc) {
    k[lo] = kb;
    k[lo + D] = ka;
    const uint32_t va = v[lo];
    v[lo] = v[lo + D];
    v[lo + D] = va;
  }
}

// Rounds jj_lo..jj_hi on the block of 2^b elements starting at global
// element base, held in shared memory (k, v): in round jj the stages
// d = min(jj, b) - 1 .. 0, those below the block's size.
__device__ void block_rounds(int* k, uint32_t* v, int64_t base, int b,
                             int jj_lo, int jj_hi) {
  const int64_t pairs = int64_t{1} << (b - 1);
  for (int jj = jj_lo; jj <= jj_hi; ++jj) {
    for (int d = (jj < b ? jj : b) - 1; d >= 0; --d) {
      const int64_t D = int64_t{1} << d;
      for (int64_t p = threadIdx.x; p < pairs; p += blockDim.x) {
        const int64_t lo = pair_lo(p, d);
        exchange(k, v, lo, D, ((base + lo) >> jj) & 1);
      }
      __syncthreads();
    }
  }
}

// Rounds jj_lo..jj_hi, below the block's size, on each block of 2^b
// elements: 1..b for the local sort, jj..jj (> b) for a local merge.
__global__ void __launch_bounds__(kLocalThreads) bitonic_local_kernel(
    int* __restrict__ keys, uint32_t* __restrict__ vals, int b, int jj_lo,
    int jj_hi) {
  extern __shared__ int smem_keys[];
  const int64_t B = int64_t{1} << b;
  uint32_t* smem_vals = reinterpret_cast<uint32_t*>(smem_keys + B);
  const int64_t base = static_cast<int64_t>(blockIdx.x) * B;
  for (int64_t i = threadIdx.x; i < B; i += blockDim.x) {
    smem_keys[i] = keys[base + i];
    smem_vals[i] = vals[base + i];
  }
  __syncthreads();
  block_rounds(smem_keys, smem_vals, base, b, jj_lo, jj_hi);
  for (int64_t i = threadIdx.x; i < B; i += blockDim.x) {
    keys[base + i] = smem_keys[i];
    vals[base + i] = smem_vals[i];
  }
}

// Stage (jj, d) over the whole array, one thread per pair.
__global__ void bitonic_cross_kernel(int* __restrict__ keys,
                                     uint32_t* __restrict__ vals, int64_t n,
                                     int jj, int d) {
  const int64_t half = n >> 1;
  const int64_t D = int64_t{1} << d;
  for (int64_t p = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       p < half; p += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t lo = pair_lo(p, d);
    exchange(keys, vals, lo, D, (lo >> jj) & 1);
  }
}

int launch_local(void* keys, void* vals, int64_t n, int b, int jj_lo,
                 int jj_hi, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = size_t{8} << b;
  if (smem > kSmemDefault) {
    err = cudaFuncSetAttribute(bitonic_local_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = (1 << (b - 1)) < kLocalThreads ? (1 << (b - 1)) : kLocalThreads;
  bitonic_local_kernel<<<static_cast<unsigned>(n >> b), threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(keys), static_cast<uint32_t*>(vals), b, jj_lo, jj_hi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Rounds 1..b of the network on each block of 2^b elements of (keys, vals),
// n = 2^q >= 2^b, in place.
int tnt_bitonic_local_sort(void* keys, void* vals, int64_t n, int b,
                           int device, void* stream) {
  return launch_local(keys, vals, n, b, 1, b, device, stream);
}

// Stage d >= b of round jj over the whole (keys, vals), in place.
int tnt_bitonic_cross_stage(void* keys, void* vals, int64_t n, int jj, int d,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t blocks = ((n >> 1) + kThreads - 1) / kThreads;
  if (blocks > (1 << 30)) blocks = 1 << 30;  // the kernel loops over the rest
  bitonic_cross_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(keys), static_cast<uint32_t*>(vals), n, jj, d);
  return static_cast<int>(cudaGetLastError());
}

// Stages d = b-1..0 of round jj > b on each block of 2^b elements, in place.
int tnt_bitonic_local_merge(void* keys, void* vals, int64_t n, int jj, int b,
                            int device, void* stream) {
  return launch_local(keys, vals, n, b, jj, jj, device, stream);
}

}  // extern "C"
