// A tile of an exchange network held in registers, shared by the bitonic
// sort (bitonic.cu) and the Benes network (permute.cu).
//
// A thread block holds a tile of 2^T elements, each thread E = 2^kLogE of
// them. A tile index t has its bits 0..4 on the lane, kLogE consecutive
// bits [lo, lo + kLogE) on the register slot (lo >= 5) and the rest on the
// thread's other bits. A stage at tile bit d < 5 exchanges across lanes, at
// a bit inside the register bits within a thread; a stage elsewhere first
// moves the tile through shared memory into a layout whose register bits
// cover it (each kernel's relayout). Also the launch and copy helpers the
// kernels share.

#pragma once

#include <cstddef>
#include <cuda_runtime.h>

namespace tnt {

constexpr size_t kSmemDefault = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;
// At most 512 threads a block, so that a thread may hold 128 registers: 16
// keys and values, or 16 to 64 words, stay in registers (at 1024 threads
// the cap of 64 spills them).
constexpr int kMaxThreads = 512;

// log2 of the elements a thread holds in a tile of 2^T (6 <= T <= 15): 32
// threads up to T = 8, 16 elements from 2^9 to 2^13, 512 threads beyond.
__host__ __device__ constexpr int words_log2(int T) {
  return T < 9 ? T - 5 : (T > 13 ? T - 9 : 4);
}

// Tile index of register slot r of thread x in the layout with register
// bits [lo, lo + kLogE): x's bits below lo stay, the slot goes in at lo,
// x's higher bits move up past it.
template <int kLogE>
__device__ __forceinline__ int slot_pos(int x, int lo, int r) {
  return (x & ((1 << lo) - 1)) | (r << lo) | ((x >> lo) << (lo + kLogE));
}

// Register bits for a stage at tile bit d of a tile of 2^T when the next
// stages lie below d (down) or above it (up), kept inside [5, T).
template <int kLogE>
__device__ __forceinline__ int layout_for(int d, int T, bool down) {
  int lo = down ? d - kLogE + 1 : d;
  if (lo > T - kLogE) lo = T - kLogE;
  return lo < 5 ? 5 : lo;
}

// Dynamic shared memory above the default 48 KB needs the kernel's opt-in.
template <class Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Asynchronous copies from global to shared memory (cp.async): 4 bytes,
// or 16 with both addresses 16-byte aligned; wait_all waits for the
// thread's own copies (a barrier then publishes them to the block).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace tnt
