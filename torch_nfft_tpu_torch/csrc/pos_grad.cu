// The position gradient of the binned NFFT (B5): tnt_pos_grad,
// points_kernel of points.cuh with the derivative windows. Replaces
// ops/pallas/contract.py:pos_grad_pallas of the JAX package; the design and
// its bound are in points.cuh.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// (torch_nfft_tpu_torch/_build.py). Plain C interface: returns the
// cudaError_t of the launch.

#include "points.cuh"

extern "C" int tnt_pos_grad(const float* tiles, const float* wts, const float* slot_pos,
                            const int* row_count, const int* origin,
                            const int* tile_index, float* dpos, int S, int K, int C,
                            int NT, int dim, int H, int M, int m, int kind, float p0,
                            float p1, float p2, float dcoef, const int* layout,
                            int device, void* stream) {
  const tnt::points::Args a{tiles, wts, slot_pos, row_count, origin, tile_index, dpos,
                            S, K, C, NT, dim, H, M, tnt::Window{kind, p0, p1, p2},
                            dcoef, 0, 0};
  return tnt::points::launch<true>(a, m, layout, device, stream);
}
