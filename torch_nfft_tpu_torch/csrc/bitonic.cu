// Bitonic key/value sort for Hopper.
//
// Replaces the TPU kernels of the JAX package's ops/pallas/bitonic.py
// (sort_pairs and apply_permutation):
//   tnt_bitonic_local_sort   <- _local_sort_loop_kernel / _local_rounds_kernel;
//   tnt_bitonic_cross_round  <- _cross_stage (the stages at distance >= block);
//   tnt_bitonic_local_merge  <- _local_merge_loop_kernel / _local_merge_kernel.
//
// The network (fixed by the JAX module's docstring; the schedule below
// changes only the order in which independent comparators run): Q = 2^q
// elements, rounds jj = 1..q, in round jj the stages d = jj-1..0 exchange
// the pair (i, i ^ 2^d), i the member with bit d clear; the pair sorts
// descending iff bit jj of i is set (round q is ascending everywhere). Both
// members take one verdict, swap = (key_lo > key_hi) XOR desc, so tied keys
// move as the TPU kernels move them and the output equals theirs bit for
// bit. Keys are int32; values are any 32-bit word (float32 or int32),
// moved unchanged.
//
// Schedule with blocks of 2^b elements: the local sort runs rounds 1..b on
// each block (one launch); each later round jj runs its stages of distance
// >= 2^b in one cross pass (two where a round has more stages than a tile
// holds), then its b stages below 2^b on each block (the local merge).
//
// All three kernels hold a tile of 2^T elements in registers (tile.cuh):
// a stage at tile bit d < 5 runs with __shfl_xor_sync (both lanes compute
// one verdict from the same two keys), one at a register bit in registers,
// and only a stage elsewhere moves the tile through shared memory once,
// into a layout whose register bits cover it and the stages after it (one
// __syncthreads per layout change, not per stage). Global loads and stores
// go straight between registers and memory: a warp's lanes touch 32
// consecutive words.
//   Local kernels: the tile is a block of 2^b consecutive elements.
//   Cross pass of round jj over the stages d_hi..d_lo (>= b): in the view
//   (Q / 2^d_lo rows of 2^d_lo), such a stage pairs two rows in the same
//   column, and the 2^r rows (r = d_hi - d_lo + 1) that differ in bits
//   d_lo..d_hi hold every partner any of their elements meets in the pass.
//   A tile is those rows' strip of 2^(T-r) columns (>= 32: 128-byte row
//   segments); the direction, bit jj > d_hi of the index, is one per tile.
//   Rounds of r <= kLogE stages need no shared memory at all.
//
// Bound on the H100 at Q = 2^24: reading and writing the keys and values
// once, 268 MB, ~0.08 ms at 3.35 TB/s; the network's 2^23 x 300
// comparisons take ~0.04 ms at 67 T operations/s. The schedule reads and
// writes the array once per pass: the local sort, 12 merges and 17 cross
// passes at q = 24 with blocks and tiles of 2^12 (ops/bitonic.py), against
// 78 passes with one launch per cross stage, so ~2.4 ms at the memory rate.
// A block holds 16 keys and values a thread (~106 registers): at 256
// threads two blocks share an SM, so one block's loads overlap another's
// exchanges.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// (torch_nfft_tpu_torch/_build.py). Plain C interface: every function
// returns the cudaError_t of its launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

using namespace tnt;

__device__ __forceinline__ void exchange(int& ka, int& kb, uint32_t& va,
                                         uint32_t& vb, bool desc) {
  if ((ka > kb) != desc) {
    const int k = ka;
    ka = kb;
    kb = k;
    const uint32_t v = va;
    va = vb;
    vb = v;
  }
}

template <int kLogE>
struct Regs {
  static constexpr int E = 1 << kLogE;
  int k[E];
  uint32_t v[E];
  int lo;  // register bits [lo, lo + kLogE) of the tile index
};

// Moves the tile through shared memory (sk, sv) into the layout ``lo``.
// Every thread calls it at the same point. One barrier: a thread writes and
// reads only its own slots of each layout, so the next change's writes
// cannot meet this change's reads.
template <int kLogE>
__device__ __forceinline__ void relayout(Regs<kLogE>& R, int lo, int* sk,
                                         uint32_t* sv) {
  const int x = threadIdx.x;
#pragma unroll
  for (int r = 0; r < Regs<kLogE>::E; ++r) {
    const int p = slot_pos<kLogE>(x, R.lo, r);
    sk[p] = R.k[r];
    sv[p] = R.v[r];
  }
  __syncthreads();
  R.lo = lo;
#pragma unroll
  for (int r = 0; r < Regs<kLogE>::E; ++r) {
    const int p = slot_pos<kLogE>(x, lo, r);
    R.k[r] = sk[p];
    R.v[r] = sv[p];
  }
}

// The stage at tile bit d (in registers or across lanes). Bit r of
// ``dmask`` is the direction of slot r's pair (its lower member's).
template <int kLogE>
__device__ __forceinline__ void stage(Regs<kLogE>& R, int d, uint32_t dmask) {
  if (d < 5) {
    const int lane_bit = 1 << d;
    const bool upper = (threadIdx.x & lane_bit) != 0;
#pragma unroll
    for (int r = 0; r < Regs<kLogE>::E; ++r) {
      const int pk = __shfl_xor_sync(kFull, R.k[r], lane_bit);
      const uint32_t pv = __shfl_xor_sync(kFull, R.v[r], lane_bit);
      const int klo = upper ? pk : R.k[r];
      const int khi = upper ? R.k[r] : pk;
      if ((klo > khi) != ((dmask >> r) & 1u)) {
        R.k[r] = pk;
        R.v[r] = pv;
      }
    }
    return;
  }
  const int rb = d - R.lo;
#pragma unroll
  for (int RB = 0; RB < kLogE; ++RB) {
    if (RB != rb) continue;
#pragma unroll
    for (int r = 0; r < Regs<kLogE>::E; ++r) {
      if (r & (1 << RB)) continue;
      const int h = r | (1 << RB);
      exchange(R.k[r], R.k[h], R.v[r], R.v[h], (dmask >> r) & 1u);
    }
  }
}

// Directions of the slots in a block of 2^b elements starting at ``base``,
// round jj: bit jj of base + tile index, as a mask over the slots.
template <int kLogE>
__device__ __forceinline__ uint32_t local_dirs(int64_t base, int b, int jj, int lo) {
  if (jj >= b) return ((base >> jj) & 1) ? ~0u : 0u;
  if (jj >= lo && jj < lo + kLogE) {
    switch (jj - lo) {  // the slots whose bit jj - lo is set
      case 0: return 0xaaaaaaaau;
      case 1: return 0xccccccccu;
      case 2: return 0xf0f0f0f0u;
      case 3: return 0xff00ff00u;
      default: return 0xffff0000u;
    }
  }
  return ((slot_pos<kLogE>(threadIdx.x, lo, 0) >> jj) & 1) ? ~0u : 0u;
}

// Rounds jj_lo..jj_hi on each block of 2^b consecutive elements, each round
// from stage min(jj, b) - 1 down to 0: 1..b for the local sort, jj..jj
// (> b) for a local merge.
template <int kLogE>
__global__ void __launch_bounds__(kMaxThreads) bitonic_local_kernel(
    int* __restrict__ keys, uint32_t* __restrict__ vals, int b, int jj_lo,
    int jj_hi) {
  extern __shared__ int smem_keys[];
  uint32_t* smem_vals = reinterpret_cast<uint32_t*>(smem_keys + (1 << b));
  const int64_t base = static_cast<int64_t>(blockIdx.x) << b;
  int* kb = keys + base;
  uint32_t* vb = vals + base;
  Regs<kLogE> R;
  const int d0 = (jj_lo < b ? jj_lo : b) - 1;
  R.lo = layout_for<kLogE>(d0, b, true);
#pragma unroll
  for (int r = 0; r < Regs<kLogE>::E; ++r) {
    const int p = slot_pos<kLogE>(threadIdx.x, R.lo, r);
    R.k[r] = kb[p];
    R.v[r] = vb[p];
  }
  for (int jj = jj_lo; jj <= jj_hi; ++jj) {
    for (int d = (jj < b ? jj : b) - 1; d >= 0; --d) {
      if (d >= 5 && (d < R.lo || d >= R.lo + kLogE)) {
        relayout(R, layout_for<kLogE>(d, b, true), smem_keys, smem_vals);
      }
      stage(R, d, local_dirs<kLogE>(base, b, jj, R.lo));
    }
  }
#pragma unroll
  for (int r = 0; r < Regs<kLogE>::E; ++r) {
    const int p = slot_pos<kLogE>(threadIdx.x, R.lo, r);
    kb[p] = R.k[r];
    vb[p] = R.v[r];
  }
}

// Stages d_hi..d_lo of round jj in one pass. Tile index t of block blk:
// bits [0, wl) are index bits [0, wl) (the column), bits [wl, wl + r) are
// index bits [d_lo, d_hi] (the row); blk supplies index bits [wl, d_lo)
// and above d_hi.
template <int kLogE>
__global__ void __launch_bounds__(kMaxThreads) bitonic_cross_kernel(
    int* __restrict__ keys, uint32_t* __restrict__ vals, int jj, int d_hi,
    int d_lo, int wl) {
  extern __shared__ int smem_keys[];
  const int r_bits = d_hi - d_lo + 1;
  const int T = wl + r_bits;
  uint32_t* smem_vals = reinterpret_cast<uint32_t*>(smem_keys + (1 << T));
  const int mid = d_lo - wl;
  const int64_t blk = blockIdx.x;
  const int64_t fixed = ((blk & ((int64_t{1} << mid) - 1)) << wl) |
                        ((blk >> mid) << (d_hi + 1));
  int* kb = keys + fixed;  // the tile's offsets from here fit 32 bits
  uint32_t* vb = vals + fixed;
  const auto offset = [wl, d_lo](int t) {
    return (static_cast<uint32_t>(t) & ((1u << wl) - 1)) |
           (static_cast<uint32_t>(t >> wl) << d_lo);
  };
  const uint32_t dmask = ((fixed >> jj) & 1) ? ~0u : 0u;  // bit jj > d_hi: one per tile
  Regs<kLogE> R;
  R.lo = layout_for<kLogE>(T - 1, T, true);
#pragma unroll
  for (int r = 0; r < Regs<kLogE>::E; ++r) {
    const uint32_t o = offset(slot_pos<kLogE>(threadIdx.x, R.lo, r));
    R.k[r] = kb[o];
    R.v[r] = vb[o];
  }
  for (int d = T - 1; d >= wl; --d) {
    if (d < R.lo || d >= R.lo + kLogE) {
      relayout(R, layout_for<kLogE>(d, T, true), smem_keys, smem_vals);
    }
    stage(R, d, dmask);
  }
#pragma unroll
  for (int r = 0; r < Regs<kLogE>::E; ++r) {
    const uint32_t o = offset(slot_pos<kLogE>(threadIdx.x, R.lo, r));
    kb[o] = R.k[r];
    vb[o] = R.v[r];
  }
}

template <int kLogE>
cudaError_t launch_local(void* keys, void* vals, int64_t n, int b, int jj_lo,
                         int jj_hi, cudaStream_t stream) {
  // shared memory only where some stage lies above the register bits
  const size_t smem = b > 5 + kLogE ? size_t{8} << b : 0;
  cudaError_t err = set_smem(bitonic_local_kernel<kLogE>, smem);
  if (err != cudaSuccess) return err;
  bitonic_local_kernel<kLogE><<<static_cast<unsigned>(n >> b), 1 << (b - kLogE),
                                smem, stream>>>(
      static_cast<int*>(keys), static_cast<uint32_t*>(vals), b, jj_lo, jj_hi);
  return cudaGetLastError();
}

template <int kLogE>
cudaError_t launch_cross(void* keys, void* vals, int64_t n, int jj, int d_hi,
                         int d_lo, int wl, int T, cudaStream_t stream) {
  const size_t smem = d_hi - d_lo + 1 > kLogE ? size_t{8} << T : 0;
  cudaError_t err = set_smem(bitonic_cross_kernel<kLogE>, smem);
  if (err != cudaSuccess) return err;
  bitonic_cross_kernel<kLogE><<<static_cast<unsigned>(n >> T), 1 << (T - kLogE),
                                smem, stream>>>(
      static_cast<int*>(keys), static_cast<uint32_t*>(vals), jj, d_hi, d_lo, wl);
  return cudaGetLastError();
}

int local(void* keys, void* vals, int64_t n, int b, int jj_lo, int jj_hi,
          int device, void* stream) {
  // 2^b elements, 8, 16 or 32 a thread, 32 to 512 threads: b in [8, 14]
  if (b < 8 || b > 14 || n < (int64_t{1} << b)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (words_log2(b)) {
    case 3: err = launch_local<3>(keys, vals, n, b, jj_lo, jj_hi, s); break;
    case 4: err = launch_local<4>(keys, vals, n, b, jj_lo, jj_hi, s); break;
    default: err = launch_local<5>(keys, vals, n, b, jj_lo, jj_hi, s); break;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Rounds 1..b of the network on each block of 2^b elements of (keys, vals),
// n = 2^q >= 2^b, 8 <= b <= 14, in place.
int tnt_bitonic_local_sort(void* keys, void* vals, int64_t n, int b,
                           int device, void* stream) {
  return local(keys, vals, n, b, 1, b, device, stream);
}

// Stages d_hi..d_lo (d_lo >= 8, d_hi < jj) of round jj over the whole
// (keys, vals), in place, in one pass with tiles of at most 2^tile_log2
// elements (tile_log2 <= 14; at most tile_log2 - 5 stages).
int tnt_bitonic_cross_round(void* keys, void* vals, int64_t n, int jj,
                            int d_hi, int d_lo, int tile_log2, int device,
                            void* stream) {
  const int r_bits = d_hi - d_lo + 1;
  int wl = tile_log2 - r_bits;
  if (wl > d_lo) wl = d_lo;
  const int T = wl + r_bits;
  if (r_bits < 1 || d_lo < 8 || wl < 5 || T < 9 || T > 14 || d_hi >= jj || d_hi > 30 ||
      n < (int64_t{1} << (d_hi + 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (words_log2(T)) {
    case 3: err = launch_cross<3>(keys, vals, n, jj, d_hi, d_lo, wl, T, s); break;
    case 4: err = launch_cross<4>(keys, vals, n, jj, d_hi, d_lo, wl, T, s); break;
    default: err = launch_cross<5>(keys, vals, n, jj, d_hi, d_lo, wl, T, s); break;
  }
  return static_cast<int>(err);
}

// Stages d = b-1..0 of round jj > b on each block of 2^b elements, in place.
int tnt_bitonic_local_merge(void* keys, void* vals, int64_t n, int jj, int b,
                            int device, void* stream) {
  return local(keys, vals, n, b, jj, jj, device, stream);
}

}  // extern "C"
