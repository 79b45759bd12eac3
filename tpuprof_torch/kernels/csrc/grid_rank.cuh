// The grid rank of K6 (rank.cu), whose launch is also K5's first stage
// (fused.py spear_tiles_cuda): one copy of the device code and its launch,
// so the two Spearman tiers cannot drift apart.
//
// The reference (tpuprof/kernels/fused.py::_grid_ranks) ranks a value x
// against its column's G-point CDF grid g by a dense compare:
//
//   rank = (#{k : g[k] < x} + #{k : g[k] <= x}) * float32(0.5 / G)
//
// On a grid row that is nondecreasing (RowSampler.cdf_grid: sample
// quantiles, +inf pads last; the backend checks it once per profile) both
// predicates are monotone along the row, so both counts come from one
// search, exactly as the dense compare gives them for any x:
//
// * lt = #(g < x): a fixed-trip, branch-free descent of MAX_LOG =
//   ceil(log2(MAX_GRID + 1)) = 9 steps through the grid in Eytzinger
//   (heap) order, k = 2k + (e[k] < x) from k = 1, padded with +inf to
//   2^MAX_LOG - 1 points (a pad is never below x, so one depth serves
//   every G <= MAX_GRID), so lt = k - 2^MAX_LOG.  The descent also keeps
//   the last point at which it went left: g[lt], x's successor, with no
//   read of its own.
// * le = #(g <= x): g[lt] > x (or lt == G) gives le = lt, the common case.
//   Only where g[lt] == x does a run of tied points need counting: a
//   gallop from lt over the sorted grid (steps 1, 2, 4, ...), then a
//   binary refinement of the last step.  A NaN x fails every compare:
//   lt = le = 0, as in the dense compare.
//
// So a value that ties no grid point takes MAX_LOG shared-memory reads,
// not the two binary searches (18 at G = 256) of the earlier design.  The
// heap order puts level j of the descent in 2^j consecutive words, so the
// top six levels read distinct banks (a warp's lanes broadcast or spread,
// never conflict) where a binary search over the sorted row read words a
// multiple of 32 apart, all in one bank.  The count sum is exact in float32
// (at most 2 * MAX_GRID), and the one rounding is the product with the
// constant ``c``, which the host computes in double and rounds to float32
// once, as the reference's weak-typed constant is; __fmul_rn keeps the
// compiler from contracting it.  tests/test_torch_rank_search.py models
// this search step for step.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tpt {

constexpr int MAX_GRID = 256;     // MAX_SPEAR_GRID of tpuprof_torch.config
constexpr int MAX_LOG = 9;        // ceil(log2(MAX_GRID + 1)): descent steps
static_assert((1 << MAX_LOG) > MAX_GRID && (1 << (MAX_LOG - 1)) <= MAX_GRID,
              "MAX_LOG is ceil(log2(MAX_GRID + 1))");
constexpr int RANK_THREADS = 256;
constexpr int RANK_VALUES = 4;    // values in flight a thread
constexpr int RANK_STEP = RANK_THREADS * RANK_VALUES;   // rows a block pass
// blocks of a rank launch: about four waves of eight blocks an SM over an
// H100's 132 SMs, so a column's rows are cut in as few blocks as fill it
constexpr int RANK_TARGET_BLOCKS = 4 * 8 * 132;

// le = #(g <= x) for a value whose successor g[lt] equals x: gallop over
// the sorted grid ``s`` from lt, then refine the last step.
__device__ __forceinline__ int tie_count(const float* s, int G, int lt,
                                         float x) {
  int le = lt + 1;                  // s[lt] <= x
  int step = 1;
  while (le + step - 1 < G && s[le + step - 1] <= x) {
    le += step;
    step <<= 1;
  }
  for (step >>= 1; step > 0; step >>= 1)
    if (le + step - 1 < G && s[le + step - 1] <= x) le += step;
  return le;
}

// Ranks of one column's rows [r0, r1): ``eyt`` is the column's grid in
// heap order (words 1 .. 2^MAX_LOG - 1), ``srt`` in sorted order.  VEC: xt,
// out and rv are aligned for 16-, 16- and 4-byte accesses and r0 and r1
// are multiples of 4, so a thread reads four consecutive rows at once;
// otherwise its four rows lie RANK_THREADS apart (coalesced scalars).
template <bool VEC>
__device__ __forceinline__ void rank_rows(const float* eyt, const float* srt,
                                          int G, float c,
                                          const float* __restrict__ x,
                                          const uint8_t* __restrict__ rv,
                                          int64_t r0, int64_t r1,
                                          float* __restrict__ out) {
  const float nan = __int_as_float(0x7fc00000);   // the canonical quiet NaN
  for (int64_t base = r0; base < r1; base += RANK_STEP) {
    float xv[RANK_VALUES];
    bool ok[RANK_VALUES];
    int64_t row[RANK_VALUES];
#pragma unroll
    for (int v = 0; v < RANK_VALUES; ++v)
      row[v] = VEC ? base + RANK_VALUES * threadIdx.x + v
                   : base + v * RANK_THREADS + threadIdx.x;
    if constexpr (VEC) {
      if (row[0] >= r1) continue;
      const float4 q = *reinterpret_cast<const float4*>(x + row[0]);
      const uint32_t m = *reinterpret_cast<const uint32_t*>(rv + row[0]);
      xv[0] = q.x;
      xv[1] = q.y;
      xv[2] = q.z;
      xv[3] = q.w;
#pragma unroll
      for (int v = 0; v < RANK_VALUES; ++v)
        ok[v] = ((m >> (8 * v)) & 0xffu) != 0 && isfinite(xv[v]);
    } else {
#pragma unroll
      for (int v = 0; v < RANK_VALUES; ++v) {
        const bool in = row[v] < r1;
        xv[v] = in ? x[row[v]] : 0.f;
        ok[v] = in && rv[row[v]] != 0 && isfinite(xv[v]);
      }
    }
    // the descents of all values interleaved: their reads overlap
    int k[RANK_VALUES];
    float succ[RANK_VALUES];
#pragma unroll
    for (int v = 0; v < RANK_VALUES; ++v) {
      k[v] = 1;
      succ[v] = INFINITY;
    }
#pragma unroll
    for (int d = 0; d < MAX_LOG; ++d)
#pragma unroll
      for (int v = 0; v < RANK_VALUES; ++v) {
        const float e = eyt[k[v]];
        const bool below = e < xv[v];
        succ[v] = below ? succ[v] : e;
        k[v] = 2 * k[v] + (below ? 1 : 0);
      }
    float rank[RANK_VALUES];
#pragma unroll
    for (int v = 0; v < RANK_VALUES; ++v) {
      const int lt = k[v] - (1 << MAX_LOG);
      const int le = lt < G && succ[v] <= xv[v]
                         ? tie_count(srt, G, lt, xv[v]) : lt;
      rank[v] = ok[v] ? __fmul_rn((float)(lt + le), c) : nan;
    }
    if constexpr (VEC) {
      *reinterpret_cast<float4*>(out + row[0]) =
          make_float4(rank[0], rank[1], rank[2], rank[3]);
    } else {
#pragma unroll
      for (int v = 0; v < RANK_VALUES; ++v)
        if (row[v] < r1) out[row[v]] = rank[v];
    }
  }
}

// One block per (column, stretch of rows): the column's grid is staged in
// shared memory once, in heap order for the descent and in sorted order
// for the tie count, then the block ranks its rows.
template <bool VEC>
__global__ void __launch_bounds__(RANK_THREADS)
rank_kernel(const float* __restrict__ xt, const uint8_t* __restrict__ rv,
            const float* __restrict__ grid, int64_t R, int G, float c,
            int64_t rows_per_block, float* __restrict__ out) {
  __shared__ float eyt[1 << MAX_LOG];
  __shared__ float srt[MAX_GRID];
  const int col = blockIdx.y;
  const float* gcol = grid + (int64_t)col * G;
  for (int k = threadIdx.x + 1; k < (1 << MAX_LOG); k += RANK_THREADS) {
    // heap node k at depth d: sorted point
    // (2 (k - 2^d) + 1) 2^(MAX_LOG-d-1) - 1
    const int d = 31 - __clz(k);
    const int i = (2 * (k - (1 << d)) + 1) * (1 << (MAX_LOG - d - 1)) - 1;
    eyt[k] = i < G ? gcol[i] : INFINITY;
  }
  for (int k = threadIdx.x; k < G; k += RANK_THREADS) srt[k] = gcol[k];
  __syncthreads();
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t r1 = min(R, r0 + rows_per_block);
  rank_rows<VEC>(eyt, srt, G, c, xt + (int64_t)col * R, rv, r0, r1,
                 out + (int64_t)col * R);
}

// Ranks of one batch, xt (C, R) -> out (C, R), on ``st``: the rank where
// the row is valid and x finite, NaN elsewhere.  ``c`` is float32(0.5 / G).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for G outside
// 1..MAX_GRID.
inline cudaError_t launch_rank(const float* xt, const uint8_t* rv,
                               const float* grid, int C, int64_t R, int G,
                               float c, float* out, cudaStream_t st) {
  if (G < 1 || G > MAX_GRID) return cudaErrorInvalidValue;
  if (C == 0 || R == 0) return cudaSuccess;
  // a column's rows cut into as few stretches as fill the card, each a
  // whole number of block passes (so a vector path's stretches stay
  // aligned)
  const int64_t passes = (R + RANK_STEP - 1) / RANK_STEP;
  int64_t per_col = (RANK_TARGET_BLOCKS + C - 1) / C;
  per_col = per_col < 1 ? 1 : (per_col > passes ? passes : per_col);
  const int64_t rows_per_block =
      (passes + per_col - 1) / per_col * RANK_STEP;
  const dim3 blocks((unsigned)((R + rows_per_block - 1) / rows_per_block),
                    (unsigned)C);
  const bool vec = reinterpret_cast<uintptr_t>(xt) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(rv) % 4 == 0 && R % 4 == 0;
  if (vec)
    rank_kernel<true><<<blocks, RANK_THREADS, 0, st>>>(
        xt, rv, grid, R, G, c, rows_per_block, out);
  else
    rank_kernel<false><<<blocks, RANK_THREADS, 0, st>>>(
        xt, rv, grid, R, G, c, rows_per_block, out);
  return cudaGetLastError();
}

}  // namespace tpt

extern "C" int tpt_max_grid() { return tpt::MAX_GRID; }
