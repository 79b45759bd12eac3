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
// Past HIST_MAX_BINS bins (8,192) a column's histogram does not fit one
// block's 32 KB: hist_partial_cluster holds it in the shared memory of a
// thread-block cluster where the wrapper's plan (hist.py cluster_plan)
// takes one, and elsewhere hist_partial_global counts into the output in
// device memory.  See both below.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast math:
// isfinite, floor and denormals must behave as IEEE says).

#include <cooperative_groups.h>

#include <mutex>
#include <set>
#include <tuple>

#include "hist.cuh"

namespace cg = cooperative_groups;

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

// The last tier, where the plan takes no cluster (no private copy fits a
// block and a spread histogram would need more than 3 blocks, where this
// body measured faster; PERF.md, K2): each value's bin is added straight
// into the zeroed output with an integer atomicAdd in device memory
// (exact in any order, so the counts are deterministic).  The scale, the
// clip, the row walk and the MAD tree are the shared body's, so each
// column's MAD bits equal those of the shared body on the same batch.
// Bound: the same bytes as the shared body, plus one global atomic a
// value; the atomics of a column whose values spread over its bins
// rarely collide, those of a column whose values share a bin serialize
// in L2.
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

// The cluster body, past HIST_MAX_BINS: a column's histogram held in the
// shared memory of a thread-block cluster.
//
// What held the device-memory body back (PERF.md, K2): one global atomic
// a value, served in L2, and a zero fill of the whole (C, nbins) output
// before the launch.  Here the grid stays (C, S) on the shared body's row
// partition, padded to S_pad (a multiple of K) along y, and the launch
// groups each K consecutive splits of a column into a cluster (cluster
// dims (1, K, 1)).  A block with s < S walks exactly the rows, in exactly
// the order, of the shared body (r0 + t + 256 k, __ldcs; in batches of
// WALK_BATCH loads a thread) and writes the same dev_store partial, so
// each column's MAD is bit for bit the shared body's; a padding block
// (s >= S) walks no rows and writes no partial.  The layout says where
// the counts live (tpuprof_torch/kernels/hist.py cluster_plan chooses
// it):
//
// * PRIVATE16 / PRIVATE32: every block counts its rows into a whole copy
//   of the column's histogram in its own shared memory (shared integer
//   atomics), then the cluster sums its K copies through distributed
//   shared memory, block k summing the k-th range of words over the
//   copies (16-byte loads through map_shared_rank) and flushing it.
//   PRIVATE16 packs two 16-bit counters a word, for blocks that count
//   fewer than 2^16 values: bin b in half b & 1 of word b >> 1 (one add
//   of 1 << 16 (b & 1)), so a copy takes half the words and twice the
//   blocks fit an SM; PRIVATE32 holds one counter a word (its +1 add
//   compiles to ATOMS.POPC.INC, a warp's adds of one word in one step).
//   The plan takes a private copy wherever one fits: adds into a peer's
//   shared memory, the spread layouts below, cost several times these
//   local adds and the reduction (PERF.md, K2).
// * SPREAD: a histogram too large for one block's shared memory is
//   spread over the cluster: block k owns the bins b with b % K == k
//   (interleaved, so a column whose values crowd a few neighbouring bins
//   spreads over the cluster; contiguous ranges measured slower on a
//   clean batch, faster on a one-bin one), at word b / K; a value's bin
//   goes into its owner's word by an integer atomic through
//   map_shared_rank, and each block flushes its own slice.  A remote add
//   costs about what an L2 atomic does, so this wins only where the
//   device-memory body's output outgrows L2 and few blocks only host a
//   slice: the plan takes it at K <= 3 (hist.py SPREAD_MAX).
//
// cluster.sync() after the slices are zeroed in the spread layouts (no
// peer adds into a word not yet zeroed), after the row walk (every add is
// seen), and after a private reduction (no block exits while a peer still
// reads its copy).  Flush: when one cluster holds the whole column
// (S_pad == K, ``store``) every bin is written once with plain stores
// (coalesced from a private copy, strided by K from a spread slice), the
// counts' bytes bound, and the wrapper allocates the output with no zero
// fill.  When several clusters cover a column (private copies with
// S > HIST_CLUSTER_MAX: long batches of few columns), each adds its
// nonzero counts onto a zeroed output with integer atomics, as hist_store
// does.  The counts are exact in any order.
enum : int { PRIVATE16 = 0, PRIVATE32 = 1, SPREAD = 2 };
// rows a thread loads before it adds them: with a 128 KB private copy one
// block (8 warps) runs on an SM, where the shared body's loop, unrolled
// by 8, keeps too few loads in flight to cover the memory's latency.
// -DTPT_HIST_WALK_BATCH=n builds another batch (chip_smoke.py --k2-probe
// times 8 beside 16).
#ifndef TPT_HIST_WALK_BATCH
#define TPT_HIST_WALK_BATCH 16
#endif
constexpr int WALK_BATCH = TPT_HIST_WALK_BATCH;

__device__ __forceinline__ void put(int* __restrict__ out, int b, int v,
                                    int store) {
  if (store)
    out[b] = v;
  else if (v)
    atomicAdd(&out[b], v);
}

template <int LAYOUT>
__global__ void __launch_bounds__(HIST_THREADS)
hist_partial_cluster(const float* __restrict__ xt,
                     const uint8_t* __restrict__ rv,
                     const float* __restrict__ lo,
                     const float* __restrict__ hi,
                     const float* __restrict__ mean, int64_t R, int nbins,
                     int64_t rows_per_split, int splits, int words,
                     int store, int* __restrict__ counts,
                     float* __restrict__ pdev) {
  constexpr bool PRIVATE = LAYOUT == PRIVATE16 || LAYOUT == PRIVATE32;
  extern __shared__ int4 sm4[];
  int* const sm = reinterpret_cast<int*>(sm4);
  cg::cluster_group cluster = cg::this_cluster();
  const int k_n = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int c = blockIdx.x;
  const int s = blockIdx.y;
  for (int i = threadIdx.x; i < words / 4; i += HIST_THREADS)
    sm4[i] = make_int4(0, 0, 0, 0);
  if (PRIVATE)
    __syncthreads();
  else
    cluster.sync();

  if (s < splits) {
    const float* col = xt + (int64_t)c * R;
    const float l = lo[c];
    const float sc = tpt::bin_scale(l, hi[c], nbins);
    const float mu = mean[c];
    const float top = (float)(nbins - 1);
    const int64_t r0 = (int64_t)s * rows_per_split;
    const int64_t r1 = min(R, r0 + rows_per_split);
    float dev = 0.f;
    // the shared body's rows in its order, WALK_BATCH loads a thread in
    // flight before their adds
    for (int64_t base = r0 + threadIdx.x; base < r1;
         base += (int64_t)HIST_THREADS * WALK_BATCH) {
      float xs[WALK_BATCH];
      uint8_t vs[WALK_BATCH];
#pragma unroll
      for (int u = 0; u < WALK_BATCH; ++u) {
        const int64_t r = base + (int64_t)HIST_THREADS * u;
        xs[u] = r < r1 ? __ldcs(col + r) : 0.f;
        vs[u] = r < r1 ? rv[r] : 0;
      }
#pragma unroll
      for (int u = 0; u < WALK_BATCH; ++u) {
        const float x = xs[u];
        if (vs[u] == 0 || !isfinite(x)) continue;
        const int b = tpt::bin_of(x, l, sc, top);
        if constexpr (LAYOUT == PRIVATE32) {
          atomicAdd(&sm[b], 1);
        } else if constexpr (LAYOUT == PRIVATE16) {
          atomicAdd(&sm[b >> 1], 1 << ((b & 1) * 16));
        } else {
          atomicAdd(cluster.map_shared_rank(sm, b % k_n) + b / k_n, 1);
        }
        dev += fabsf(x - mu);
      }
    }
    tpt::dev_store(dev, (int64_t)c * splits + s, pdev);
  }
  cluster.sync();

  int* out = counts + (int64_t)c * nbins;
  if constexpr (PRIVATE) {
    // block rank sums the rank-th range of 16-byte words over the copies:
    // 4 bins a range word (PRIVATE32), or 8 (PRIVATE16: bins 2w, 2w + 1 of
    // word w)
    constexpr int PER = LAYOUT == PRIVATE32 ? 4 : 8;
    const int n4 = words / 4;
    const int w4 = (n4 + k_n - 1) / k_n;
    const int end = min(n4, (rank + 1) * w4);
    const bool vec = store && nbins % PER == 0;
    for (int i = rank * w4 + threadIdx.x; i < end; i += HIST_THREADS) {
      int a[PER] = {};
      for (int k = 0; k < k_n; ++k) {
        const int4 v4 = cluster.map_shared_rank(sm4, k)[i];
        const int v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (LAYOUT == PRIVATE32) {
            a[j] += v[j];
          } else {
            a[2 * j] += v[j] & 0xffff;
            a[2 * j + 1] += (unsigned)v[j] >> 16;
          }
        }
      }
      const int b = PER * i;
      if (vec) {
#pragma unroll
        for (int j = 0; j < PER; j += 4)
          *reinterpret_cast<int4*>(out + b + j) =
              make_int4(a[j], a[j + 1], a[j + 2], a[j + 3]);
        continue;
      }
#pragma unroll
      for (int j = 0; j < PER; ++j)
        if (b + j < nbins) put(out, b + j, a[j], store);
    }
    cluster.sync();
  } else {
    for (int i = threadIdx.x; i < words; i += HIST_THREADS) {
      const int b = i * k_n + rank;
      if (b >= nbins) break;          // b grows with i
      put(out, b, sm[i], store);
    }
  }
}

using ClusterKernel = void (*)(const float*, const uint8_t*, const float*,
                               const float*, const float*, int64_t, int,
                               int64_t, int, int, int, int*, float*);

ClusterKernel cluster_kernel(int layout) {
  switch (layout) {
    case PRIVATE16: return hist_partial_cluster<PRIVATE16>;
    case PRIVATE32: return hist_partial_cluster<PRIVATE32>;
    case SPREAD: return hist_partial_cluster<SPREAD>;
  }
  return nullptr;
}

// (device, kernel, cluster size, dynamic shared bytes) checked once: the
// attributes set and cudaOccupancyMaxActiveClusters at least 1
std::mutex checked_mu;
std::set<std::tuple<int, const void*, int, int>> checked;

// Sets the kernel's shared-memory attributes on the current device and
// asks whether at least one cluster of ``k`` blocks with ``smem`` dynamic
// shared bytes each fits the card; once per (device, kernel, k, smem).
// Any failure is returned: the caller raises, no other body is taken.
cudaError_t check_cluster(ClusterKernel fn, const cudaLaunchConfig_t& cfg,
                          int k, int smem) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  const auto key = std::make_tuple(device, (const void*)fn, k, smem);
  std::lock_guard<std::mutex> hold(checked_mu);
  if (checked.count(key)) return cudaSuccess;
  e = cudaFuncSetAttribute((const void*)fn,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           tpt::HIST_SLICE_MAX_BINS * (int)sizeof(int));
  if (e != cudaSuccess) return e;
  if (k > tpt::HIST_PORTABLE_CLUSTER) {
    e = cudaFuncSetAttribute((const void*)fn,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return e;
  }
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, (const void*)fn, &cfg);
  if (e != cudaSuccess) return e;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  checked.insert(key);
  return cudaSuccess;
}

// Whether the cluster body can run ``plan`` as given (tpt_hist_b).
bool plan_ok(int nbins, int splits, int64_t rows_per_split, int cluster,
             int splits_pad, int words, int layout, int store) {
  if (cluster < 1 || cluster > tpt::HIST_CLUSTER_MAX || splits < 1 ||
      splits_pad < splits || splits_pad % cluster != 0 ||
      splits_pad > 65535 || words < 4 || words % 4 != 0 ||
      words > tpt::HIST_SLICE_MAX_BINS || (store && splits_pad != cluster))
    return false;
  switch (layout) {
    case PRIVATE16:   // a block counts fewer than 2^16 values
      return rows_per_split < 65536 && 2 * (int64_t)words >= nbins;
    case PRIVATE32:
      return words >= nbins;
    case SPREAD:
      return (int64_t)words * cluster >= nbins;
  }
  return false;
}

}  // namespace

extern "C" const char* tpt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
extern "C" int tpt_hist_b_max_bins() { return tpt::HIST_MAX_BINS; }
extern "C" int tpt_hist_b_cluster_max() { return tpt::HIST_CLUSTER_MAX; }
extern "C" int tpt_hist_b_slice_max_bins() {
  return tpt::HIST_SLICE_MAX_BINS;
}

// One pass-B batch: two launches on ``stream``, returns the first CUDA
// error (cudaGetLastError() after the launches).  ``cluster`` 0: up to
// HIST_MAX_BINS bins the shared body counts, past it the device-memory
// body.  ``cluster`` K >= 1: the cluster body on the plan the wrapper
// made (hist.py cluster_plan): ``splits_pad`` a multiple of K, ``words``
// the int32 words of shared memory a block holds (a multiple of 4),
// ``layout`` 0-2 (PRIVATE16, PRIVATE32, SPREAD),
// ``store`` the flush by plain stores (one cluster a column).  A plan it
// cannot run is refused with cudaErrorInvalidValue, a cluster the card
// cannot host with the error that says so; nothing runs then.
// ``counts`` (C, nbins) must arrive zeroed unless ``store``; pdev is
// (C, splits) scratch.
extern "C" int tpt_hist_b(const float* xt, const uint8_t* row_valid,
                          const float* lo, const float* hi,
                          const float* mean, int C, int64_t R, int nbins,
                          int splits, int64_t rows_per_split, int cluster,
                          int splits_pad, int words, int layout, int store,
                          int* counts, float* pdev, float* dev,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cluster > 0) {
    if (!plan_ok(nbins, splits, rows_per_split, cluster, splits_pad, words,
                 layout, store))
      return (int)cudaErrorInvalidValue;
    ClusterKernel fn = cluster_kernel(layout);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = cluster;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C, splits_pad);
    cfg.blockDim = dim3(HIST_THREADS);
    cfg.dynamicSmemBytes = (size_t)words * sizeof(int);
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t e = check_cluster(fn, cfg, cluster,
                                  (int)cfg.dynamicSmemBytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaLaunchKernelEx(&cfg, fn, xt, row_valid, lo, hi, mean, R, nbins,
                           rows_per_split, splits, words, store, counts,
                           pdev);
    if (e != cudaSuccess) return (int)e;
  } else if (nbins <= tpt::HIST_MAX_BINS) {
    hist_partial<<<dim3(C, splits), HIST_THREADS, nbins * sizeof(int),
                   st>>>(xt, row_valid, lo, hi, mean, R, nbins,
                         rows_per_split, splits, counts, pdev);
  } else {
    hist_partial_global<<<dim3(C, splits), HIST_THREADS, 0, st>>>(
        xt, row_valid, lo, hi, mean, R, nbins, rows_per_split, splits,
        counts, pdev);
  }
  tpt::dev_fold<<<(C + 127) / 128, 128, 0, st>>>(pdev, C, splits, dev);
  return (int)cudaGetLastError();
}
