// Device code shared by the pass-A kernels K1 (fused_a.cu), K3
// (fused_wide.cu), the single-pass kernel K4 (fused_ab.cu) and the narrow
// Spearman kernel K5 (spear.cu):
//
// * StatsAcc / stats_store / stats_partial / stats_fold: the per-column
//   statistics of one batch (s1..s4 of d = x - shift over finite values,
//   min/max over non-null values, min/max over finite values; finite n,
//   zeros, +-inf, missing) over a fixed (column, row-split) partition,
//   folded in split order (the fused K4, fused_ab.cu, runs the same
//   per-value and per-block code);
// * gram_tile: one (TILE x TILE) output tile of the pairwise-complete Gram
//   sums P = d d^T, S1 = d m^T, S2 = d^2 m^T, N = m m^T over the rows of one
//   split, with the operands d (masked, centred) and m (finite mask) formed
//   in shared memory by a chunk loader the caller supplies;
// * gram_fold: the splits' partial Gram sums folded in split order.
//
// No float atomics anywhere: every partition depends only on the shape
// (tpuprof_torch/kernels/fused.py ``splits``), so a rerun gives the same
// bits.  Ragged C and R are masked inside the kernels.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tpt {

constexpr int STATS_THREADS = 256;
constexpr int TILE = 64;          // Gram output tile edge (columns)
constexpr int TR = 32;            // rows per shared-memory chunk
constexpr int TPE = 16;           // threads per tile edge (4x4 per thread)
constexpr int GRAM_THREADS = TPE * TPE;

typedef float Chunk[TILE + 1];    // one row of a (TR x TILE) chunk

// One thread's accumulators of the per-column statistics, fed the values of
// one (column, row-split) block in row order.  K1, K3 and the fused K4
// (fused_ab.cu) run this one copy, so their sums agree bit for bit.
struct StatsAcc {
  float f[8];
  int k[4];

  __device__ __forceinline__ StatsAcc() {
    f[0] = f[1] = f[2] = f[3] = 0.f;
    f[4] = f[6] = INFINITY;
    f[5] = f[7] = -INFINITY;
    k[0] = k[1] = k[2] = k[3] = 0;
  }

  __device__ __forceinline__ void add(float x, bool valid, float sh) {
    const bool nan = isnan(x);
    const bool inf = isinf(x);
    const bool notnull = valid && !nan;
    const bool fin = notnull && !inf;
    const float d = fin ? x - sh : 0.f;
    const float d2 = d * d;
    f[0] += d;
    f[1] += d2;
    f[2] += d2 * d;
    f[3] += d2 * d2;
    if (notnull) {
      f[4] = fminf(f[4], x);
      f[5] = fmaxf(f[5], x);
    }
    if (fin) {
      f[6] = fminf(f[6], x);
      f[7] = fmaxf(f[7], x);
    }
    k[0] += fin;
    k[1] += notnull && x == 0.f;
    k[2] += notnull && inf;
    k[3] += valid && nan;
  }
};

// The block's fixed-shape tree reduction of every thread's StatsAcc
// (deterministic order), written by thread 0 to partial slot ``base``.
// Every thread of the block must call it.
__device__ __forceinline__ void stats_store(const StatsAcc& a, int64_t base,
                                            float* __restrict__ psums,
                                            int* __restrict__ pcounts) {
  __shared__ float sf[8][STATS_THREADS];
  __shared__ int si[4][STATS_THREADS];
  for (int q = 0; q < 8; ++q) sf[q][threadIdx.x] = a.f[q];
  for (int q = 0; q < 4; ++q) si[q][threadIdx.x] = a.k[q];
  __syncthreads();
  for (int stride = STATS_THREADS / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      const int o = threadIdx.x + stride;
      for (int q = 0; q < 4; ++q) sf[q][threadIdx.x] += sf[q][o];
      sf[4][threadIdx.x] = fminf(sf[4][threadIdx.x], sf[4][o]);
      sf[5][threadIdx.x] = fmaxf(sf[5][threadIdx.x], sf[5][o]);
      sf[6][threadIdx.x] = fminf(sf[6][threadIdx.x], sf[6][o]);
      sf[7][threadIdx.x] = fmaxf(sf[7][threadIdx.x], sf[7][o]);
      for (int q = 0; q < 4; ++q) si[q][threadIdx.x] += si[q][o];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    for (int q = 0; q < 8; ++q) psums[base * 8 + q] = sf[q][0];
    for (int q = 0; q < 4; ++q) pcounts[base * 4 + q] = si[q][0];
  }
}

__global__ void __launch_bounds__(STATS_THREADS)
stats_partial(const float* __restrict__ xt, const uint8_t* __restrict__ rv,
              const float* __restrict__ shift, int64_t R,
              int64_t rows_per_split, int splits,
              float* __restrict__ psums, int* __restrict__ pcounts) {
  const int c = blockIdx.x;
  const int s = blockIdx.y;
  const float* col = xt + (int64_t)c * R;
  const float sh = shift[c];
  const int64_t r0 = (int64_t)s * rows_per_split;
  const int64_t r1 = min(R, r0 + rows_per_split);
  StatsAcc acc;
  for (int64_t r = r0 + threadIdx.x; r < r1; r += STATS_THREADS)
    acc.add(col[r], rv[r] != 0, sh);
  stats_store(acc, (int64_t)c * splits + s, psums, pcounts);
}

__global__ void stats_fold(const float* __restrict__ psums,
                           const int* __restrict__ pcounts, int C,
                           int splits, float* __restrict__ sums,
                           int* __restrict__ counts) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float f[8] = {0.f, 0.f, 0.f, 0.f, INFINITY, -INFINITY, INFINITY,
                -INFINITY};
  int k[4] = {0, 0, 0, 0};
  for (int s = 0; s < splits; ++s) {
    const float* p = psums + ((int64_t)c * splits + s) * 8;
    const int* q = pcounts + ((int64_t)c * splits + s) * 4;
    for (int j = 0; j < 4; ++j) f[j] += p[j];
    f[4] = fminf(f[4], p[4]);
    f[5] = fmaxf(f[5], p[5]);
    f[6] = fminf(f[6], p[6]);
    f[7] = fmaxf(f[7], p[7]);
    for (int j = 0; j < 4; ++j) k[j] += q[j];
  }
  for (int j = 0; j < 8; ++j) sums[(int64_t)c * 8 + j] = f[j];
  for (int j = 0; j < 4; ++j) counts[(int64_t)c * 8 + j] = k[j];
  for (int j = 4; j < 8; ++j) counts[(int64_t)c * 8 + j] = 0;
}

// K1's chunk loader: d = x - shift and m = 1 where the row is valid and x
// finite, 0 elsewhere.  Consecutive threads read consecutive rows of one
// column (coalesced); the +1 padding keeps the transposed stores free of
// bank conflicts.
struct ShiftLoader {
  const float* __restrict__ xt;
  const uint8_t* __restrict__ rv;
  const float* __restrict__ shift;
  int C;
  int64_t R;

  __device__ __forceinline__ void operator()(int64_t r_chunk, int64_t r_end,
                                             int col0, Chunk* d,
                                             Chunk* m) const {
    for (int e = threadIdx.x; e < TR * TILE; e += GRAM_THREADS) {
      const int rr = e % TR;
      const int cc = e / TR;
      const int64_t r = r_chunk + rr;
      const int c = col0 + cc;
      bool fin = false;
      float v = 0.f;
      if (r < r_end && c < C && rv[r] != 0) {
        const float x = xt[(int64_t)c * R + r];
        fin = isfinite(x);
        v = fin ? x - shift[c] : 0.f;
      }
      d[rr][cc] = v;
      m[rr][cc] = fin ? 1.f : 0.f;
    }
  }
};

// One (TILE x TILE) tile of P, S1, S2, N over rows [r0, r1), written to
// ``out``, the (4, C, C) partial block of this row split.  Each thread owns
// a 4x4 micro-tile of all four sums: 64 FMAs for every 16 shared loads.
template <class LoadI, class LoadJ>
__device__ __forceinline__ void gram_tile(const LoadI& load_i,
                                          const LoadJ& load_j, int C,
                                          int64_t r0, int64_t r1, int bi,
                                          int bj, float* __restrict__ out) {
  const int tx = threadIdx.x % TPE;
  const int ty = threadIdx.x / TPE;

  __shared__ float di[TR][TILE + 1], mi[TR][TILE + 1];
  __shared__ float dj[TR][TILE + 1], mj[TR][TILE + 1];

  float aP[4][4], aS1[4][4], aS2[4][4], aN[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      aP[p][q] = aS1[p][q] = aS2[p][q] = aN[p][q] = 0.f;

  for (int64_t rc = r0; rc < r1; rc += TR) {
    load_i(rc, r1, bi, di, mi);
    load_j(rc, r1, bj, dj, mj);
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < TR; ++rr) {
      float a[4], a2[4], am[4], b[4], bm[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        a[p] = di[rr][ty + TPE * p];
        am[p] = mi[rr][ty + TPE * p];
        a2[p] = a[p] * a[p];
        b[p] = dj[rr][tx + TPE * p];
        bm[p] = mj[rr][tx + TPE * p];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          aP[p][q] = fmaf(a[p], b[q], aP[p][q]);
          aS1[p][q] = fmaf(a[p], bm[q], aS1[p][q]);
          aS2[p][q] = fmaf(a2[p], bm[q], aS2[p][q]);
          aN[p][q] = fmaf(am[p], bm[q], aN[p][q]);
        }
    }
    __syncthreads();
  }

  // partial layout: (splits, 4, C, C) — P, S1, S2, N of this row split
  const int64_t cc = (int64_t)C * C;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int i = bi + ty + TPE * p;
    if (i >= C) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = bj + tx + TPE * q;
      if (j >= C) continue;
      const int64_t o = (int64_t)i * C + j;
      out[o] = aP[p][q];
      out[cc + o] = aS1[p][q];
      out[2 * cc + o] = aS2[p][q];
      out[3 * cc + o] = aN[p][q];
    }
  }
}

// The Gram of K1 and K3: grid (tiles, tiles, splits) over ShiftLoader.
__global__ void __launch_bounds__(GRAM_THREADS)
gram_partial(const float* __restrict__ xt, const uint8_t* __restrict__ rv,
             const float* __restrict__ shift, int C, int64_t R,
             int64_t rows_per_split, float* __restrict__ partial) {
  const int s = blockIdx.z;
  const int64_t r0 = (int64_t)s * rows_per_split;
  const int64_t r1 = min(R, r0 + rows_per_split);
  const ShiftLoader load{xt, rv, shift, C, R};
  gram_tile(load, load, C, r0, r1, blockIdx.x * TILE, blockIdx.y * TILE,
            partial + (int64_t)s * 4 * C * C);
}

__global__ void gram_fold(const float* __restrict__ partial, int C,
                          int splits, float* __restrict__ P,
                          float* __restrict__ S1, float* __restrict__ S2,
                          int* __restrict__ N) {
  const int64_t cc = (int64_t)C * C;
  const int64_t o = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= cc) return;
  float p = 0.f, s1 = 0.f, s2 = 0.f;
  int n = 0;
  for (int s = 0; s < splits; ++s) {
    const float* b = partial + (int64_t)s * 4 * cc;
    p += b[o];
    s1 += b[cc + o];
    s2 += b[2 * cc + o];
    // each split's count is an exact integer in f32 (the wrapper keeps a
    // split below 2^24 rows), so the conversion is exact
    n += (int)b[3 * cc + o];
  }
  P[o] = p;
  S1[o] = s1;
  S2[o] = s2;
  N[o] = n;
}

// Launch gram_partial + gram_fold for one batch on ``st``.
inline void launch_gram(const float* xt, const uint8_t* rv,
                        const float* shift, int C, int64_t R,
                        int gram_splits, int64_t gram_rows, float* partial,
                        float* P, float* S1, float* S2, int* N,
                        cudaStream_t st) {
  const int tiles = (C + TILE - 1) / TILE;
  gram_partial<<<dim3(tiles, tiles, gram_splits), GRAM_THREADS, 0, st>>>(
      xt, rv, shift, C, R, gram_rows, partial);
  const int64_t cc = (int64_t)C * C;
  gram_fold<<<(unsigned)((cc + 255) / 256), 256, 0, st>>>(
      partial, C, gram_splits, P, S1, S2, N);
}

// Launch stats_partial + stats_fold for one batch on ``st``.
inline void launch_stats(const float* xt, const uint8_t* rv,
                         const float* shift, int C, int64_t R,
                         int stat_splits, int64_t stat_rows, float* psums,
                         int* pcounts, float* sums, int* counts,
                         cudaStream_t st) {
  stats_partial<<<dim3(C, stat_splits), STATS_THREADS, 0, st>>>(
      xt, rv, shift, R, stat_rows, stat_splits, psums, pcounts);
  stats_fold<<<(C + 127) / 128, 128, 0, st>>>(psums, pcounts, C,
                                                stat_splits, sums, counts);
}

}  // namespace tpt

extern "C" const char* tpt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
extern "C" int tpt_gram_tile() { return tpt::TILE; }
extern "C" int tpt_gram_rows() { return tpt::TR; }
