// K1: pass A of the two-pass profile, for Hopper (sm_90a).
//
// Replaces tpuprof/kernels/fused.py::_fused_tiles (Pallas body _kernel,
// helpers _masks / _accumulate_stats).  For one batch xt (C, R) float32,
// row-major so each column is contiguous, row_valid (R,) bytes and a
// per-column centering shift, it computes
//
//   sums   (C, 8) f32: s1..s4 of d = x - shift over finite values, min/max
//          over non-null values (inf included), min/max over finite values;
//   counts (C, 8) i32: finite n, zeros, +-inf, missing (lanes 4..7 zero);
//   P, S1, S2 (C, C) f32 and N (C, C) i32: the pairwise-complete Gram
//          sums  P = d d^T,  S1 = d m^T,  S2 = d^2 m^T,  N = m m^T
//          with m the finite mask (kernels/corr.py semantics).
//
// What bounds it on an H100: the Gram work the function needs is one
// multiply-add per (i, j, row) for S1 and S2 and, as P and N are
// symmetric, per (i <= j, row) for P and N: 2*C*(C+1)*R + 4*C^2*R flops,
// float32 outside the tensor cores (the reference runs at
// precision=HIGHEST, so no TF32).  At C=200, R=65536 that is 15.8 GFLOP
// against 67 TFLOP/s, about 0.235 ms; the batch itself is 52 MB, about
// 16 us at 3.35 TB/s.  So the kernel is bound by operations.  It computes
// P and N in full (both triangles, 8*C^2*R flops in all), a third more
// than the bound counts: one tile schedule for all four sums is the
// price of keeping this first version simple.  Its design keeps the FMA
// units fed:
//
// * the Gram kernel loads row chunks of column blocks i and j into shared
//   memory and forms d, m (and d^2 in registers) there, as the TPU kernel
//   did in VMEM: the masked, centered operands never go to device memory;
// * each thread owns a 4x4 micro-tile of all four Gram sums, 64 FMAs for
//   every 16 shared-memory loads;
// * the rows split over a fixed number of blocks that depends only on the
//   shape, partial sums land in scratch, and a second launch folds them in
//   split order.  No float atomics anywhere, so a rerun gives the same bits.
//
// The per-column statistics are a separate memory-bound pass over
// (column, row-split) blocks with the same fixed-order fold.  Ragged C and
// R are masked inside the kernels; nothing is padded or copied.  The device
// code lives in gram.cuh, shared with K3 (fused_wide.cu) and K5 (spear.cu).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast math: the
// statistics count NaN, +-inf and denormals exactly).

#include "gram.cuh"

// One pass-A batch: four launches on ``stream``, returns cudaGetLastError().
// Scratch: psums (C*stat_splits*8 f32), pcounts (C*stat_splits*4 i32),
// partial (gram_splits*4*C*C f32).
extern "C" int tpt_fused_a(const float* xt, const uint8_t* row_valid,
                           const float* shift, int C, int64_t R,
                           int stat_splits, int64_t stat_rows,
                           int gram_splits, int64_t gram_rows, float* psums,
                           int* pcounts, float* partial, float* sums,
                           int* counts, float* P, float* S1, float* S2,
                           int* N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  tpt::launch_stats(xt, row_valid, shift, C, R, stat_splits, stat_rows,
                    psums, pcounts, sums, counts, st);
  tpt::launch_gram(xt, row_valid, shift, C, R, gram_splits, gram_rows,
                   partial, P, S1, S2, N, st);
  return (int)cudaGetLastError();
}
