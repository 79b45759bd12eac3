// K2: pass B of the two-pass profile, for Hopper (sm_90a).
//
// Replaces tpuprof/kernels/pallas_hist.py::histogram_tiles, both bodies
// (_hist_kernel_cumulative, the default, and the legacy _hist_kernel):
// per-column fixed-bin counts of the finite values of one batch plus the
// exact-MAD numerator sum |x - mean|.  The per-value binning, the block's
// reduction and the fold live in hist.cuh, shared with the single-pass
// kernel K4 (fused_ab.cu), which bins the same way.
//
// What bounds it on an H100: memory.  The batch is read once (C*R*4 bytes
// plus R row flags; 52 MB at C=200, R=65536, about 16 us at 3.35 TB/s),
// and the work per value is a few flops.  The design streams each column
// once with coalesced loads over (column, row-split) blocks, counts into a
// shared-memory int32 histogram with integer atomics (exact in any order),
// adds it to the output with integer atomics, and writes the float32
// sum |x - mean| per block to scratch, folded by a second launch in split
// order, so a rerun gives the same bits.  The row splits follow the
// partition of ``split_cols`` columns (tpuprof_torch/kernels/hist.py): a
// re-bin of a few columns folds its MAD in the order the full-width pass
// does.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast math:
// isfinite, floor and denormals must behave as IEEE says).

#include "hist.cuh"

namespace {

using tpt::HIST_THREADS;

__global__ void __launch_bounds__(HIST_THREADS)
hist_partial(const float* __restrict__ xt, const uint8_t* __restrict__ rv,
             const float* __restrict__ lo, const float* __restrict__ scale,
             const float* __restrict__ mean, int64_t R, int nbins,
             int64_t rows_per_split, int splits, int* __restrict__ counts,
             float* __restrict__ pdev) {
  extern __shared__ int hist[];
  const int c = blockIdx.x;
  const int s = blockIdx.y;
  for (int b = threadIdx.x; b < nbins; b += HIST_THREADS) hist[b] = 0;
  __syncthreads();

  const float* col = xt + (int64_t)c * R;
  const float l = lo[c];
  const float sc = scale[c];
  const float mu = mean[c];
  const float top = (float)(nbins - 1);
  const int64_t r0 = (int64_t)s * rows_per_split;
  const int64_t r1 = min(R, r0 + rows_per_split);
  float dev = 0.f;
  for (int64_t r = r0 + threadIdx.x; r < r1; r += HIST_THREADS) {
    const float x = col[r];
    if (rv[r] != 0 && isfinite(x))
      tpt::hist_add(x, l, sc, mu, top, hist, dev);
  }
  tpt::hist_store(dev, hist, nbins, (int64_t)c * splits + s,
                  counts + (int64_t)c * nbins, pdev);
}

}  // namespace

extern "C" const char* tpt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
extern "C" int tpt_hist_b_max_bins() { return tpt::HIST_MAX_BINS; }

// One pass-B batch: two launches on ``stream``, returns cudaGetLastError().
// ``counts`` (C, nbins) must arrive zeroed; pdev is (C, splits) scratch.
extern "C" int tpt_hist_b(const float* xt, const uint8_t* row_valid,
                          const float* lo, const float* scale,
                          const float* mean, int C, int64_t R, int nbins,
                          int splits, int64_t rows_per_split, int* counts,
                          float* pdev, float* dev, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  hist_partial<<<dim3(C, splits), HIST_THREADS, nbins * sizeof(int), st>>>(
      xt, row_valid, lo, scale, mean, R, nbins, rows_per_split, splits,
      counts, pdev);
  tpt::dev_fold<<<(C + 127) / 128, 128, 0, st>>>(pdev, C, splits, dev);
  return (int)cudaGetLastError();
}
