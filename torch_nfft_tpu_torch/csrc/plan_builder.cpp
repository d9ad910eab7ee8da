// Native plan builder for the binned spread/gather engine.
//
// TPU-native counterpart of the reference's C++ runtime layer
// (csrc/core.cpp dispatch + csrc/cuda/core_cuda.cu host orchestration): the
// device-side window convolution needs points grouped by grid tile, and this
// does the grouping — a single-pass counting sort by (batch, tile) plus
// fixed-capacity row packing — in O(n + bins) with no comparison sort. The
// Python fallback (ops/binned.py: build_plan) does the same with
// np.argsort/np.unique in O(n log n); results are permutation-identical.
//
// Exposed as a plain C ABI consumed via ctypes (no libtorch/pybind
// dependency). All buffers are caller-allocated NumPy arrays.
//
// Pipeline:
//   1. bin id per point: b = batch * nb^dim + prod of per-axis tile indices,
//      tile index = ((floor(pos*M) - m) mod M) / T   [window start cell]
//   2. counting sort of point indices by bin id
//   3. rows: every occupied bin gets ceil(count / K) rows of capacity K
//   4. emit slot tables (point index + validity), per-row tile origins and
//      batch ids, and the inverse point -> flat-slot map.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>

extern "C" {

// Pass 1: count points per bin and return the number of rows needed.
// bin_of_point (n) and counts (num_bins) are outputs.
// Returns total rows S, or -1 on error.
int64_t nfft_plan_count(
    const float* pos,      // (n, dim) row-major
    const int32_t* batch,  // (n,) or nullptr
    int64_t n,
    int32_t dim,
    int32_t M,
    int32_t m,
    int32_t T,
    int32_t nb,            // tiles per axis = ceil(M / T)
    int32_t K,             // row capacity
    int64_t num_bins,      // batch_size * nb^dim
    int64_t* bin_of_point, // out (n)
    int64_t* counts        // out (num_bins), zero-initialized by callee
) {
    if (n < 0 || dim < 1 || dim > 8 || T <= 0 || K <= 0) return -1;
    std::memset(counts, 0, sizeof(int64_t) * (size_t)num_bins);
    for (int64_t i = 0; i < n; ++i) {
        int64_t b = batch ? (int64_t)batch[i] : 0;
        for (int32_t d = 0; d < dim; ++d) {
            // float32 arithmetic to match the device window computation
            // (jnp.floor(pos * M) in f32, ops/window.py compute_shifts)
            float scaled = std::floor(pos[i * dim + d] * (float)M);
            int64_t s = (int64_t)scaled - (int64_t)m;
            s %= M;
            if (s < 0) s += M;
            b = b * nb + (s / T);
        }
        if (b < 0 || b >= num_bins) return -1;
        bin_of_point[i] = b;
        counts[b]++;
    }
    int64_t rows = 0;
    for (int64_t q = 0; q < num_bins; ++q) rows += (counts[q] + K - 1) / K;
    return rows;
}

// Pass 2: fill the plan tables. S must equal the value returned by pass 1.
// slot_pt (S, K) int32; slot_valid (S, K) float32; origin (S, dim) int32;
// row_batch (S,) int32; inv_slot (n,) int32. Sorted layout for fused
// kernels: order (n,) int32 = point ids in (batch, tile) order;
// row_start/row_count (S,) int32 index contiguous runs of `order` per row.
int32_t nfft_plan_fill(
    const int64_t* bin_of_point,
    const int64_t* counts,
    int64_t n,
    int32_t dim,
    int32_t T,
    int32_t nb,
    int32_t K,
    int64_t num_bins,
    int64_t S,
    int32_t* slot_pt,
    float* slot_valid,
    int32_t* origin,
    int32_t* row_batch,
    int32_t* inv_slot,
    int32_t* order,
    int32_t* row_start,
    int32_t* row_count
) {
    // exclusive prefix over bins -> start of each bin in the sorted order,
    // and the first row index of each bin.
    std::vector<int64_t> bin_start(num_bins);
    std::vector<int64_t> bin_row(num_bins);
    int64_t acc = 0, row_acc = 0;
    for (int64_t q = 0; q < num_bins; ++q) {
        bin_start[q] = acc;
        bin_row[q] = row_acc;
        acc += counts[q];
        row_acc += (counts[q] + K - 1) / K;
    }
    if (row_acc != S) return -1;

    // init tables: every slot points at point 0 with validity 0
    std::memset(slot_pt, 0, sizeof(int32_t) * (size_t)S * K);
    std::memset(slot_valid, 0, sizeof(float) * (size_t)S * K);

    // per-row origin + batch (decoded from the bin id) and sorted-run extents
    int64_t q = 0;
    for (int64_t r = 0; r < S; ++r) {
        while (q + 1 < num_bins && bin_row[q + 1] <= r) ++q;
        // find the bin owning row r (bins are visited in order; rows of a
        // bin are contiguous). q now satisfies bin_row[q] <= r.
        int64_t bid = q;
        for (int32_t d = dim - 1; d >= 0; --d) {
            origin[r * dim + d] = (int32_t)((bid % nb) * T);
            bid /= nb;
        }
        row_batch[r] = (int32_t)bid;
        int64_t rank = r - bin_row[q];
        row_start[r] = (int32_t)(bin_start[q] + rank * K);
        int64_t cnt = counts[q] - rank * K;
        row_count[r] = (int32_t)(cnt < K ? cnt : K);
    }

    // counting-sort placement directly into the slot tables
    std::vector<int64_t> cursor(num_bins, 0);
    for (int64_t i = 0; i < n; ++i) {
        int64_t b = bin_of_point[i];
        int64_t k = cursor[b]++;
        int64_t row = bin_row[b] + k / K;
        int64_t kk = k % K;
        slot_pt[row * K + kk] = (int32_t)i;
        slot_valid[row * K + kk] = 1.0f;
        inv_slot[i] = (int32_t)(row * K + kk);
        order[bin_start[b] + k] = (int32_t)i;
    }
    return 0;
}

}  // extern "C"
