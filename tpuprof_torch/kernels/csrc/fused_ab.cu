// K4: the single-pass kernel of profile_passes="fused", for Hopper
// (sm_90a).
//
// Replaces tpuprof/kernels/fused.py::_fused_ab_tiles (Pallas body
// _kernel_ab).  For one batch xt (C, R) float32, row-major so each column
// is contiguous, row_valid (R,) bytes, a per-column centering shift and
// provisional per-column pass-B bounds lo, hi and mean (the scale formed
// from lo and hi as K2 forms it, hist.cuh bin_scale), it
// computes in one read of the batch what K1 (fused_a.cu) and then K2
// (hist_b.cu) compute from two:
//
//   sums (C, 8) f32, counts (C, 8) i32, P, S1, S2 (C, C) f32, N (C, C) i32:
//        K1's statistics and pairwise-complete Gram sums;
//   hist (C, nbins) i32 and dev (C,) f32: K2's per-bin counts and
//        sum |x - mean| on the provisional bounds.
//
// The contract is identity, bit for bit, with K1 followed by K2 on the
// same inputs: when the provisional bounds turn out exact, the fused
// counts and MAD numerator ARE the two-pass ones
// (tpuprof_torch/runtime/singlepass.py).  So the design does not carry
// the TPU kernel's tile schedule over; it is built from the port's own K1
// and K2 device code:
//
// * one statistics-and-histogram pass over (column, row-split) blocks of
//   256 threads, on K1's statistics partition, which is K2's partition
//   (one function, tpuprof_torch/kernels/hist.py ``splits``).  Each value
//   is loaded once and fed to K1's per-thread accumulators (gram.cuh
//   StatsAcc) and K2's binning and |x - mean| sum (hist.cuh hist_add), in
//   the same row order per thread; each block then runs both kernels'
//   fixed-shape trees (stats_store, hist_store).  Bin counts are
//   shared-memory integer atomics; the two folds (stats_fold, dev_fold)
//   run in split order;
// * the Gram: K1's launch (gram.cuh launch_gram: the tensor-core gram_tc
//   and its fold), unchanged, on K1's Gram splits.
//
// No float atomics, no single-pass TF32, no fast math: a rerun gives the
// same bits.
//
// What bounds it on an H100: the Gram, as K1: 2*C*(C+1)*R + 4*C^2*R flops
// (P and N symmetric), 15.8 GFLOP at C=200, R=65536.  On the route it
// takes, the 3xTF32 split on the tensor cores, that is 31.5 GFLOP of TF32
// products, 0.064 ms at 495 TFLOP/s (0.235 ms in float32 at 67 TFLOP/s;
// 0.049 ms with each product in its cheapest type exact to float32, as
// K1's header counts it); the binning adds about C*R compares, which neither bound counts; the
// batch is 52 MB, about 16 us at 3.35 TB/s.  What K4 saves over K1 then
// K2 is K2's second read of the batch on the device; the larger saving
// is on the host, which ingests and ships every batch once instead of
// twice.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast math).

#include "gram.cuh"
#include "hist.cuh"

namespace {

static_assert(tpt::STATS_THREADS == tpt::HIST_THREADS,
              "K4 runs K1's and K2's block trees in one block");

__global__ void __launch_bounds__(tpt::STATS_THREADS)
stats_hist_partial(const float* __restrict__ xt,
                   const uint8_t* __restrict__ rv,
                   const float* __restrict__ shift,
                   const float* __restrict__ lo,
                   const float* __restrict__ hi,
                   const float* __restrict__ mean, int64_t R, int nbins,
                   int64_t rows_per_split, int splits,
                   float* __restrict__ psums, int* __restrict__ pcounts,
                   int* __restrict__ hcounts, float* __restrict__ pdev) {
  extern __shared__ int hist[];
  const int c = blockIdx.x;
  const int s = blockIdx.y;
  for (int b = threadIdx.x; b < nbins; b += tpt::STATS_THREADS) hist[b] = 0;
  __syncthreads();

  const float* col = xt + (int64_t)c * R;
  const float sh = shift[c];
  const float l = lo[c];
  const float sc = tpt::bin_scale(l, hi[c], nbins);
  const float mu = mean[c];
  const float top = (float)(nbins - 1);
  const int64_t r0 = (int64_t)s * rows_per_split;
  const int64_t r1 = min(R, r0 + rows_per_split);
  tpt::StatsAcc acc;
  float dev = 0.f;
  for (int64_t r = r0 + threadIdx.x; r < r1; r += tpt::STATS_THREADS) {
    const float x = col[r];
    const bool valid = rv[r] != 0;
    acc.add(x, valid, sh);
    if (valid && isfinite(x)) tpt::hist_add(x, l, sc, mu, top, hist, dev);
  }
  const int64_t part = (int64_t)c * splits + s;
  tpt::stats_store(acc, part, psums, pcounts);
  tpt::hist_store(dev, hist, nbins, part, hcounts + (int64_t)c * nbins,
                  pdev);
}

}  // namespace

extern "C" int tpt_fused_ab_max_bins() { return tpt::HIST_MAX_BINS; }

// One fused batch: five launches on ``stream``, returns cudaGetLastError().
// ``hcounts`` (C, nbins) must arrive zeroed.  Scratch: psums
// (C*stat_splits*8 f32), pcounts (C*stat_splits*4 i32), pdev
// (C*stat_splits f32), partial (gram_splits*4*C*C f32).
extern "C" int tpt_fused_ab(const float* xt, const uint8_t* row_valid,
                            const float* shift, const float* lo,
                            const float* hi, const float* mean, int C,
                            int64_t R, int nbins, int stat_splits,
                            int64_t stat_rows, int gram_splits,
                            int64_t gram_rows, float* psums, int* pcounts,
                            float* pdev, float* partial, float* sums,
                            int* counts, float* P, float* S1, float* S2,
                            int* N, int* hcounts, float* dev,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  stats_hist_partial<<<dim3(C, stat_splits), tpt::STATS_THREADS,
                       nbins * sizeof(int), st>>>(
      xt, row_valid, shift, lo, hi, mean, R, nbins, stat_rows,
      stat_splits, psums, pcounts, hcounts, pdev);
  tpt::stats_fold<<<(C + 127) / 128, 128, 0, st>>>(psums, pcounts, C,
                                                    stat_splits, sums,
                                                    counts);
  tpt::dev_fold<<<(C + 127) / 128, 128, 0, st>>>(pdev, C, stat_splits, dev);
  tpt::launch_gram(xt, row_valid, shift, C, R, gram_splits, gram_rows,
                   partial, P, S1, S2, N, st);
  return (int)cudaGetLastError();
}
