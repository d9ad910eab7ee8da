// The gather of the binned NFFT (B2): tnt_gather_points, points_kernel of
// points.cuh without the position gradient. Replaces
// ops/pallas/contract.py:gather_points_pallas of the JAX package; the design
// and its bound are in points.cuh.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// (torch_nfft_tpu_torch/_build.py). Plain C interface: returns the
// cudaError_t of the launch.

#include "points.cuh"

extern "C" int tnt_gather_points(const float* tiles, const float* slot_pos,
                                 const int* row_count, const int* origin,
                                 const int* tile_index, float* y, int S, int K,
                                 int C, int NT, int dim, int H, int M, int m,
                                 int kind, float p0, float p1, float p2,
                                 const int* layout, int device, void* stream) {
  const tnt::points::Args a{tiles, nullptr, slot_pos, row_count, origin, tile_index, y,
                            S, K, C, NT, dim, H, M, tnt::Window{kind, p0, p1, p2},
                            0.0f, 0, 0};
  return tnt::points::launch<false>(a, m, layout, device, stream);
}
