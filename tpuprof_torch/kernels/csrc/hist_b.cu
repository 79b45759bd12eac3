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
// does.  Each thread walks rows r0 + t + 256k in order; the MAD's bits
// rest on that order, the 256-wide tree and the split-order fold.
//
// What the first design lost (measured on an H100 80GB HBM3 at 700 W,
// PERF.md's K2 findings): of 34 us of device time a call, its kernel took
// 24 and six small launches the rest (the scale's four torch ops, the
// zero fill and dev_fold).  Its shared atomics cost nothing extra (a
// batch whose every value lands in one bin takes as long), and nvcc had
// unrolled its row loop by 4 with the loads ahead of the atomics.
//
// What this design does: each block forms its column's scale from lo and
// hi (hist.cuh bin_scale, the wrapper's float32 recipe bit for bit),
// which takes four launches off a call; the values are loaded with the
// streaming hint (ld.global.cs: read once, evict first; 4% faster than
// plain loads at 10 bins, 15% at 8,192), the row loop unrolled by 8 (16
// loads ahead of its atomics in the SASS; not timed apart).  Three
// launches a call stay: the output's zero fill (the blocks of a column
// add their counts into it with integer atomics), this kernel, and
// dev_fold (the MAD partials in split order): 27 us of device time
// against the 16 us bound.  A fold by the last block of each column in
// place of the fill and dev_fold, and an explicit group of 8 loads a
// thread, measured no faster (within 2% at 10 bins; the fold 17-42%
// slower at 8,192 bins).
//
// Past HIST_MAX_BINS bins (8,192) a second body, hist_partial_global,
// counts into the output in device memory: see it below.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast math:
// isfinite, floor and denormals must behave as IEEE says).

#include "hist.cuh"

namespace {

using tpt::HIST_THREADS;

__global__ void __launch_bounds__(HIST_THREADS)
hist_partial(const float* __restrict__ xt, const uint8_t* __restrict__ rv,
             const float* __restrict__ lo, const float* __restrict__ hi,
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
  const float sc = tpt::bin_scale(l, hi[c], nbins);
  const float mu = mean[c];
  const float top = (float)(nbins - 1);
  const int64_t r0 = (int64_t)s * rows_per_split;
  const int64_t r1 = min(R, r0 + rows_per_split);
  float dev = 0.f;
#pragma unroll 8
  for (int64_t r = r0 + threadIdx.x; r < r1; r += HIST_THREADS) {
    const float x = __ldcs(col + r);
    if (rv[r] != 0 && isfinite(x))
      tpt::hist_add(x, l, sc, mu, top, hist, dev);
  }
  tpt::hist_store(dev, hist, nbins, (int64_t)c * splits + s,
                  counts + (int64_t)c * nbins, pdev);
}

// The body past HIST_MAX_BINS: a (column, nbins) histogram does not fit in
// shared memory, so each value's bin is added straight into the zeroed
// output with an integer atomicAdd in device memory (exact in any order,
// so the counts are deterministic).  The scale, the clip, the row walk and
// the MAD tree are the shared body's, so each column's MAD bits equal
// those of the shared body on the same batch.  Bound: the same bytes as
// the shared body, plus one global atomic a value; the atomics of a column
// whose values spread over its bins rarely collide, those of a column
// whose values share a bin serialize in L2.
__global__ void __launch_bounds__(HIST_THREADS)
hist_partial_global(const float* __restrict__ xt,
                    const uint8_t* __restrict__ rv,
                    const float* __restrict__ lo,
                    const float* __restrict__ hi,
                    const float* __restrict__ mean, int64_t R, int nbins,
                    int64_t rows_per_split, int splits,
                    int* __restrict__ counts, float* __restrict__ pdev) {
  const int c = blockIdx.x;
  const int s = blockIdx.y;
  const float* col = xt + (int64_t)c * R;
  int* out = counts + (int64_t)c * nbins;
  const float l = lo[c];
  const float sc = tpt::bin_scale(l, hi[c], nbins);
  const float mu = mean[c];
  const float top = (float)(nbins - 1);
  const int64_t r0 = (int64_t)s * rows_per_split;
  const int64_t r1 = min(R, r0 + rows_per_split);
  float dev = 0.f;
#pragma unroll 8
  for (int64_t r = r0 + threadIdx.x; r < r1; r += HIST_THREADS) {
    const float x = __ldcs(col + r);
    if (rv[r] != 0 && isfinite(x)) {
      atomicAdd(&out[tpt::bin_of(x, l, sc, top)], 1);
      dev += fabsf(x - mu);
    }
  }
  tpt::dev_store(dev, (int64_t)c * splits + s, pdev);
}

}  // namespace

extern "C" const char* tpt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
extern "C" int tpt_hist_b_max_bins() { return tpt::HIST_MAX_BINS; }

// One pass-B batch: two launches on ``stream``, returns cudaGetLastError().
// Up to HIST_MAX_BINS bins the shared body counts, past it the global one.
// ``counts`` (C, nbins) must arrive zeroed; pdev is (C, splits) scratch.
extern "C" int tpt_hist_b(const float* xt, const uint8_t* row_valid,
                          const float* lo, const float* hi,
                          const float* mean, int C, int64_t R, int nbins,
                          int splits, int64_t rows_per_split, int* counts,
                          float* pdev, float* dev, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nbins <= tpt::HIST_MAX_BINS)
    hist_partial<<<dim3(C, splits), HIST_THREADS, nbins * sizeof(int),
                   st>>>(xt, row_valid, lo, hi, mean, R, nbins,
                         rows_per_split, splits, counts, pdev);
  else
    hist_partial_global<<<dim3(C, splits), HIST_THREADS, 0, st>>>(
        xt, row_valid, lo, hi, mean, R, nbins, rows_per_split, splits,
        counts, pdev);
  tpt::dev_fold<<<(C + 127) / 128, 128, 0, st>>>(pdev, C, splits, dev);
  return (int)cudaGetLastError();
}
