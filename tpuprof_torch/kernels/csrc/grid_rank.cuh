// The grid rank shared by K5 (spear.cu) and K6 (rank.cu), so the two
// Spearman tiers cannot drift apart.
//
// The reference (tpuprof/kernels/fused.py::_grid_ranks) ranks a value x
// against its column's G-point CDF grid g by a dense compare:
//
//   rank = (#{k : g[k] < x} + #{k : g[k] <= x}) * float32(0.5 / G)
//
// On a grid row that is nondecreasing (RowSampler.cdf_grid: sample
// quantiles, +inf pads last; the backend checks it once per profile) both
// predicates are monotone along the row, so each count is a binary
// search: the lower and the upper bound of x.  That gives the dense
// compare's counts exactly, for any x (a NaN x fails every compare and
// ranks 0, +inf passes every finite point), in 2*ceil(log2(G + 1)) shared-
// memory reads instead of 2G compares.  The count sum is exact in float32
// (at most 2 * MAX_GRID), and the one rounding is the product with the
// constant ``c``, which the host computes in double and rounds to float32
// once, as the reference's weak-typed constant is; __fmul_rn keeps the
// compiler from contracting it with a later subtraction.

#pragma once

#include <cuda_runtime.h>

namespace tpt {

constexpr int MAX_GRID = 256;     // MAX_SPEAR_GRID of tpuprof_torch.config

__device__ __forceinline__ float grid_rank(const float* g, int G, float x,
                                           float c) {
  int lo = 0, n = G;
  while (n > 0) {                 // lower bound: #(g < x)
    const int h = n >> 1;
    if (g[lo + h] < x) {
      lo += h + 1;
      n -= h + 1;
    } else {
      n = h;
    }
  }
  const int lt = lo;
  n = G - lo;
  while (n > 0) {                 // upper bound: #(g <= x), at least lt
    const int h = n >> 1;
    if (g[lo + h] <= x) {
      lo += h + 1;
      n -= h + 1;
    } else {
      n = h;
    }
  }
  return __fmul_rn((float)(lt + lo), c);
}

}  // namespace tpt

extern "C" int tpt_max_grid() { return tpt::MAX_GRID; }
