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
// symmetric, per (i <= j, row) for P and N: 2*C*(C+1)*R + 4*C^2*R flops.
// The reference runs it at precision=HIGHEST (float32 accuracy), so the
// bound depends on the type each product runs in (at C=200, R=65536):
//
// * the function's: each product in the cheapest type exact to float32:
//   P as 3 TF32 passes at 495 TFLOP/s, S1 and S2 as 3 bf16 passes each at
//   989 TFLOP/s (m is 0 or 1, exact in bf16), N once in int8 at 1,979
//   TOP/s: 0.049 ms;
// * the route this kernel takes, all of it in TF32 with a 3xTF32 split
//   (3 + 1 passes for P and N, 2 + 2 for S1 and S2), 31.5 GFLOP: 0.064 ms;
// * float32 on the CUDA cores, 67 TFLOP/s: 15.8 GFLOP, 0.235 ms (the route
//   of the earlier design, 1.61 ms).
//
// The batch itself is 52 MB, about 16 us at 3.35 TB/s, so each way the
// kernel is bound by operations.  It takes the tensor-core route
// (gram.cuh gram_tc):
//
// * mma.sync m16n8k8 TF32 on operands formed and split once per chunk
//   from raw x into shared memory, so d, d^2 and m never go to device
//   memory (as the TPU kernel kept them in VMEM), and float32 promotion
//   every 128 rows, since the tensor cores' float32 accumulation is not
//   documented to round to nearest;
// * one block per pair of 64-column tiles of the upper triangle: the work
//   the bound counts, not both triangles of P and N;
// * a 3-stage cp.async ring of raw x and row_valid, so loads overlap the
//   tensor cores;
// * the rows split over a fixed number of blocks that depends only on the
//   shape, partial sums land in scratch, and a second launch folds them in
//   split order.  No float atomics anywhere, so a rerun gives the same bits.
//
// The per-column statistics are a separate memory-bound pass over
// (column, row-split) blocks with the same fixed-order fold.  Ragged C and
// R are masked inside the kernels; nothing is padded or copied.  The device
// code lives in gram.cuh, shared with K3 (fused_wide.cu) and K4
// (fused_ab.cu).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast math: the
// statistics count NaN, +-inf and denormals exactly; no flush to zero, no
// single-pass TF32).

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
