// The half spectrum's turn for the band-pruned spectral stages
// (ops/fft.py:_adjoint_lines, _forward_lines): the kept values k < n2 of the
// last axis's transform between the layout of cuFFT's R2C and
// C2R, R lines of K complex values (line b, value k at b * K + k), and the
// layout of the pruned C2C passes, n2 rows of R (k * R + b).
//
// Replaces no Pallas kernel: the JAX package's spectral stage is a chain of
// pruned DFT matmuls. cuFFT can write and read the turned layout itself
// (output or input stride R), and up to n = 1024 points that costs less than
// this extra pass (ops/fft.py takes it there); at n = 2048 its R2C and C2R
// in that layout took 3.0 and 2.4 times their contiguous time, and this turn
// a fraction of it (tools/spectral_stages.py).
//
// Gather (to_rows): dst[k * R + b] = src[b * K + k] for k < n2.
// Scatter: dst[b * K + k] = src[k * R + b] for k < n2, 0 for k >= n2:
// the C2R's zero padding is written here, not by a separate fill.
//
// Bound on the H100: bytes, each value read once and written once: at the
// slab of the grid-sharded pair (R = 512 * 2048, K = 1025, n2 = 513,
// complex64) 8.6 GB a gather and 12.9 GB a scatter, 2.6 and 3.9 ms at
// 3.35 TB/s. Design: 32 x 32 tiles through shared memory (33 columns, so
// the turned read of a column spreads over the banks), 32 x 8 threads a
// block, four values a thread; both the read and the write of a tile run
// along rows of 32 values, 256 bytes of complex64, and a line group's k
// tiles go to consecutive blocks (2.87 and 2.37 TB/s at the slab against
// 2.51 and 1.27 with the k tiles on a second grid axis).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;

template <typename T>
__global__ void turn_half_kernel(const T* __restrict__ src, T* __restrict__ dst,
                                 int64_t R, int K, int n2, bool to_rows, int k_tiles) {
  __shared__ T tile[kTile][kTile + 1];
  // consecutive blocks take the k tiles of one group of lines, so the
  // sectors of a line's K values fill in L2 together
  const int64_t b0 = static_cast<int64_t>(blockIdx.x / k_tiles) * kTile;
  const int k0 = static_cast<int>(blockIdx.x % k_tiles) * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  if (to_rows) {
    for (int j = ty; j < kTile; j += kRows) {  // lines b0 + j, values k0 + tx
      const int64_t b = b0 + j;
      const int k = k0 + tx;
      if (b < R && k < n2) tile[j][tx] = src[b * K + k];
    }
    __syncthreads();
    for (int j = ty; j < kTile; j += kRows) {  // rows k0 + j, lines b0 + tx
      const int k = k0 + j;
      const int64_t b = b0 + tx;
      if (b < R && k < n2) dst[k * R + b] = tile[tx][j];
    }
  } else {
    for (int j = ty; j < kTile; j += kRows) {  // rows k0 + j, lines b0 + tx
      const int k = k0 + j;
      const int64_t b = b0 + tx;
      if (b < R && k < n2) tile[j][tx] = src[k * R + b];
    }
    __syncthreads();
    for (int j = ty; j < kTile; j += kRows) {  // lines b0 + j, values k0 + tx
      const int64_t b = b0 + j;
      const int k = k0 + tx;
      if (b < R && k < K) dst[b * K + k] = k < n2 ? tile[tx][j] : T{};
    }
  }
}

template <typename T>
cudaError_t launch(const void* src, void* dst, int64_t R, int K, int n2, bool to_rows,
                   cudaStream_t stream) {
  const int k_tiles = ((to_rows ? n2 : K) + kTile - 1) / kTile;
  const int64_t blocks = (R + kTile - 1) / kTile * k_tiles;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  turn_half_kernel<T><<<static_cast<unsigned>(blocks), dim3(kTile, kRows), 0, stream>>>(
      static_cast<const T*>(src), static_cast<T*>(dst), R, K, n2, to_rows, k_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int tnt_turn_half(const void* src, void* dst, int64_t R, int K, int n2, int to_rows,
                  int is_double, int device, void* stream) {
  if (R < 0 || K < 1 || n2 < 1 || n2 > K) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || R == 0) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  err = is_double ? launch<double2>(src, dst, R, K, n2, to_rows != 0, s)
                  : launch<float2>(src, dst, R, K, n2, to_rows != 0, s);
  return static_cast<int>(err);
}

}  // extern "C"
