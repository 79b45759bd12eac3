// Device code of pass B's binning, shared by K2 (hist_b.cu) and the
// single-pass kernel K4 (fused_ab.cu), so both count every value into the
// same bin and fold the same MAD numerator bit for bit:
//
// * bin_scale: float32 nbins / max(hi - lo, 1e-30), the reference's
//   recipe as tpuprof_torch/kernels/hist.py ``bin_scale`` rounds it,
//   formed by each block from lo and hi (no launches of its own);
// * hist_add: one valid, finite value into its bin of the block's
//   shared-memory int32 histogram (integer atomics: exact in any order)
//   and into the thread's sum |x - mean|;
// * hist_store: the block's fixed-shape tree of those sums to one partial
//   per (column, row-split) (dev_store), and the block histogram added to
//   the output with integer atomics;
// * bin_of / dev_store: the same bin and the same tree for K2's bodies
//   past HIST_MAX_BINS, the cluster body (a column's histogram in the
//   shared memory of a thread-block cluster) and the one that counts
//   straight into the output (hist_b.cu);
// * dev_fold: the partials folded in split order (a rerun gives the same
//   bits).
//
// A value lands in bin clip(floor(t), 0, nbins - 1) with
// t = (x - lo) * scale, exactly as the reference's histogram_tiles
// computes it.  t is formed as written, a subtraction then a multiplication
// (__fsub_rn / __fmul_rn: no fused multiply-add can apply), so every value
// gets the reference's t bit for bit.  For an integer b,
// floor(t) >= b  <=>  t >= b, so these per-bin counts equal the cumulative
// body's differenced counts for every input; a NaN t (from
// (x - lo) = inf times scale = 0, or a NaN scale) lands in bin 0, as it
// does there.
//
// The shared atomicAdd compiles to ATOMS.POPC.INC, which adds a warp's
// increments of one address as one: a warp whose values share one bin (a
// constant column) costs what one whose values spread does (measured on
// an H100, PERF.md's K2 findings).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tpt {

constexpr int HIST_THREADS = 256;
// the shared-memory histogram's bound: K4's, and K2's shared body's (K2
// counts more bins in device memory)
constexpr int HIST_MAX_BINS = 8192;
// K2's cluster body: at most HIST_CLUSTER_MAX blocks a cluster (past
// HIST_PORTABLE_CLUSTER the launch opts in to a non-portable size), each
// holding a slice of at most HIST_SLICE_MAX_BINS int32 words in dynamic
// shared memory: a block's opt-in shared memory on sm_90 (232,448 bytes)
// less dev_store's tree.  tpuprof_torch/kernels/hist.py mirrors them
// (checked when the library is bound) and plans every launch.
constexpr int HIST_CLUSTER_MAX = 16;
constexpr int HIST_PORTABLE_CLUSTER = 8;
constexpr int HIST_SMEM_OPTIN = 232448;
constexpr int HIST_SLICE_MAX_BINS = 57856;
static_assert(HIST_SLICE_MAX_BINS * 4 + HIST_THREADS * 4 == HIST_SMEM_OPTIN,
              "a slice and dev_store's tree fill a block's shared memory");

// hist.py bin_scale: one IEEE subtraction, torch.clamp_min (which keeps a
// NaN, where fmaxf would not), one IEEE division.
__device__ __forceinline__ float bin_scale(float lo, float hi, int nbins) {
  float width = __fsub_rn(hi, lo);
  if (!isnan(width)) width = fmaxf(width, 1e-30f);
  return __fdiv_rn((float)nbins, width);
}

// The bin of one valid, finite value: clip(floor(t), 0, nbins - 1).
__device__ __forceinline__ int bin_of(float x, float lo, float scale,
                                      float top) {
  const float t = __fmul_rn(__fsub_rn(x, lo), scale);
  // fmaxf returns 0 for a NaN t, the cumulative body's bin
  return (int)fminf(fmaxf(floorf(t), 0.f), top);
}

__device__ __forceinline__ void hist_add(float x, float lo, float scale,
                                         float mean, float top,
                                         int* __restrict__ hist,
                                         float& dev) {
  atomicAdd(&hist[bin_of(x, lo, scale, top)], 1);
  dev += fabsf(x - mean);
}

// The block's fixed-shape tree of the threads' sums |x - mean| to one
// partial per (column, row-split).  Every thread of the block must call
// it, after its last value.
__device__ __forceinline__ void dev_store(float dev, int64_t part,
                                          float* __restrict__ pdev) {
  __shared__ float red[HIST_THREADS];
  red[threadIdx.x] = dev;
  __syncthreads();
  for (int stride = HIST_THREADS / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) red[threadIdx.x] += red[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) pdev[part] = red[0];
}

// Every thread of the block must call it, after its last hist_add.
__device__ __forceinline__ void hist_store(float dev,
                                           const int* __restrict__ hist,
                                           int nbins, int64_t part,
                                           int* __restrict__ counts,
                                           float* __restrict__ pdev) {
  dev_store(dev, part, pdev);
  for (int b = threadIdx.x; b < nbins; b += HIST_THREADS) {
    const int v = hist[b];
    if (v) atomicAdd(&counts[b], v);
  }
}

__global__ void dev_fold(const float* __restrict__ pdev, int C, int splits,
                         float* __restrict__ dev) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += pdev[(int64_t)c * splits + s];
  dev[c] = acc;
}

}  // namespace tpt
