// K3: pass A of the two-pass profile for wide tables (513..2048 numeric
// columns), and the Gram of the wide Spearman tier's stage 2, for Hopper
// (sm_90a).
//
// Replaces tpuprof/kernels/fused.py::_fused_tiles_wide (Pallas body
// _kernel_wide).  For one batch xt (C, R) float32, row_valid (R,) bytes and
// a per-column shift it computes what K1 computes (fused_a.cu):
//
//   sums (C, 8) f32, counts (C, 8) i32: the per-column statistics;
//   P, S1, S2 (C, C) f32, N (C, C) i32: the pairwise-complete Gram sums.
//
// With skip_stats set it computes the Gram alone and fills sums/counts
// with their identities (0 for the sums and counts, +inf for the minima,
// -inf for the maxima), as the reference's skip_stats does: the Spearman
// rank Gram over K6's ranks (shift 0.5) needs no statistics.
//
// What bounds it on an H100: the Gram, 2*C*(C+1)*R + 4*C^2*R flops (P and
// N symmetric) at float32 accuracy (the reference runs at
// precision=HIGHEST).  At C=2048, R=65536 that is 1.65 TFLOP: 24.6 ms at
// the CUDA cores' 67 TFLOP/s float32, or, on the route K3 takes, twice
// that in TF32 products (the 3xTF32 split, gram.cuh gram_tc) at 495
// TFLOP/s, 6.67 ms; with each product in its cheapest type exact to
// float32 (K1's header), 5.14 ms.  The batch is 537 MB, 0.16 ms at 3.35
// TB/s: bound by operations, by a wider margin than K1 as the work grows
// with C^2.
//
// What changes against K1 is memory, not the schedule.  The Pallas kernel
// tiled (256, 256) output blocks over a sequential row grid because the
// narrow kernel's (C, 2C) VMEM accumulators stop fitting past 512
// columns.  K1's Gram (gram.cuh gram_tc) already tiles any C in pairs of
// 64-column tiles of the upper triangle with registers as accumulators,
// so K3 runs the same device code.  What grows is the scratch of the row
// splits: each split holds its own (4, C, C) partial sums, 64 MiB at
// C=2048.  Past 512 columns the wrapper (fused.py ``splits`` with a cap)
// bounds the split count so the scratch stays a small multiple of the
// outputs (at C=2048 the 528 tile pairs alone fill the card's 132 SMs four
// times, so one split), while keeping each split under 2^20 rows so the
// float32 pair counts stay exact; at K1's widths K3 takes K1's partition,
// so the Spearman Gram of K5 (spear.cu) is K3's bit for bit.  The fold of the splits is in split order: no float
// atomics, a rerun gives the same bits.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast math).

#include "gram.cuh"

namespace {

__global__ void stats_identity(int C, float* __restrict__ sums,
                               int* __restrict__ counts) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const float f[8] = {0.f, 0.f, 0.f, 0.f, INFINITY, -INFINITY, INFINITY,
                      -INFINITY};
  for (int j = 0; j < 8; ++j) {
    sums[(int64_t)c * 8 + j] = f[j];
    counts[(int64_t)c * 8 + j] = 0;
  }
}

}  // namespace

// One wide pass-A batch on ``stream``; returns cudaGetLastError().
// Scratch: psums (C*stat_splits*8 f32) and pcounts (C*stat_splits*4 i32),
// unused with skip_stats; partial (gram_splits*4*C*C f32).
extern "C" int tpt_fused_wide(const float* xt, const uint8_t* row_valid,
                              const float* shift, int C, int64_t R,
                              int skip_stats, int stat_splits,
                              int64_t stat_rows, int gram_splits,
                              int64_t gram_rows, float* psums, int* pcounts,
                              float* partial, float* sums, int* counts,
                              float* P, float* S1, float* S2, int* N,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (skip_stats) {
    stats_identity<<<(C + 127) / 128, 128, 0, st>>>(C, sums, counts);
  } else {
    tpt::launch_stats(xt, row_valid, shift, C, R, stat_splits, stat_rows,
                      psums, pcounts, sums, counts, st);
  }
  tpt::launch_gram(xt, row_valid, shift, C, R, gram_splits, gram_rows,
                   partial, P, S1, S2, N, st);
  return (int)cudaGetLastError();
}
