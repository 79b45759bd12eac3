// K5: the narrow Spearman tier (at most 512 numeric columns), for Hopper
// (sm_90a).
//
// Replaces tpuprof/kernels/fused.py::_spear_tiles (Pallas body
// _spear_kernel).  For one batch xt (C, R) float32, row_valid (R,) bytes
// and each column's G-point CDF grid (C, G) float32 (G <= 256, rows
// nondecreasing, +inf where a column has no sample) it ranks every value
// against its column's grid and computes the pairwise-complete Gram sums
// of d = rank - 0.5 over the finite values:
//
//   P, S1, S2 (C, C) f32 and N (C, C) i32, as K1 does for d = x - shift.
//
// What bounds it on an H100: the Gram of the ranks plus one read of xt
// (chip_smoke.py gram_bounds with each product at its cheapest exact
// type's rate: 0.020 ms at C=200, R=65536, G=256, where a rank is a
// multiple of 1/512, so d is exact in one bf16 term and d^2 in two: P and
// S1 one bf16 pass, S2 two, N one int8 pass over a triangle; the bytes
// alone take 0.016 ms).  The rank searches are not counted: they are this
// design's cost, not work the function needs (the reference's dense
// compare does 2G compares a value).
//
// Design: two stages on one stream.
//
// 1. K6's rank launch (grid_rank.cuh launch_rank, one copy of the device
//    code) writes the ranks of the batch into a (C, R) float32 scratch,
//    NaN where the row is invalid or x not finite: each value is ranked
//    once, by one search.
// 2. K1's tensor-core Gram (gram.cuh launch_gram: gram_tc + gram_fold, the
//    3xTF32 split with float32 promotion) over the scratch with shift 0.5,
//    on the row partition K1 takes at C columns (fused.py ``splits``).
//
// So K5 is bit for bit K6 followed by K3 with skip_stats on the same
// batch (K3 takes K1's partition at these widths): the narrow and the
// wide Spearman tiers cannot drift apart.  The TPU kernel kept the ranks
// out of device memory; here their round trip, 2*C*R*4 bytes (105 MB at
// C=200, R=65536: 0.031 ms at 3.35 TB/s), buys a Gram on the tensor cores,
// which has no shared memory left for a grid stage (gram.cuh TC_SMEM).
// Row splits and their in-order fold are K1's: no float atomics, a rerun
// gives the same bits.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast math).

#include "gram.cuh"
#include "grid_rank.cuh"

// One narrow Spearman batch: three launches on ``stream`` (the ranks, the
// Gram, its fold); returns the rank launch's status or cudaGetLastError().
// ``c`` is float32(0.5 / G); ``half`` holds C copies of 0.5 (the shift of
// d = rank - 0.5, filled once by the caller).  Scratch: ranks (C*R f32),
// partial (gram_splits*4*C*C f32).
extern "C" int tpt_spear(const float* xt, const uint8_t* row_valid,
                         const float* grid, int C, int64_t R, int G, float c,
                         int gram_splits, int64_t gram_rows,
                         const float* half, float* ranks, float* partial,
                         float* P, float* S1, float* S2, int* N,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      tpt::launch_rank(xt, row_valid, grid, C, R, G, c, ranks, st);
  if (e != cudaSuccess) return (int)e;
  tpt::launch_gram(ranks, row_valid, half, C, R, gram_splits, gram_rows,
                   partial, P, S1, S2, N, st);
  return (int)cudaGetLastError();
}
