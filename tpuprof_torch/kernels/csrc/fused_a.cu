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
// R are masked inside the kernels; nothing is padded or copied.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast math: the
// statistics count NaN, +-inf and denormals exactly).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int STATS_THREADS = 256;
constexpr int TILE = 64;          // Gram output tile edge (columns)
constexpr int TR = 32;            // rows per shared-memory chunk
constexpr int TPE = 16;           // threads per tile edge (4x4 per thread)
constexpr int GRAM_THREADS = TPE * TPE;

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

  float f[8] = {0.f, 0.f, 0.f, 0.f, INFINITY, -INFINITY, INFINITY,
                -INFINITY};
  int k[4] = {0, 0, 0, 0};
  for (int64_t r = r0 + threadIdx.x; r < r1; r += STATS_THREADS) {
    const float x = col[r];
    const bool valid = rv[r] != 0;
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

  // fixed-shape tree reduction across the block: deterministic order
  __shared__ float sf[8][STATS_THREADS];
  __shared__ int si[4][STATS_THREADS];
  for (int q = 0; q < 8; ++q) sf[q][threadIdx.x] = f[q];
  for (int q = 0; q < 4; ++q) si[q][threadIdx.x] = k[q];
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
    const int64_t base = (int64_t)c * splits + s;
    for (int q = 0; q < 8; ++q) psums[base * 8 + q] = sf[q][0];
    for (int q = 0; q < 4; ++q) pcounts[base * 4 + q] = si[q][0];
  }
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

// Load one (TR rows x TILE columns) chunk of a column block into shared
// memory as d and m.  Consecutive threads read consecutive rows of one
// column (coalesced); the +1 padding keeps the transposed stores free of
// bank conflicts.
__device__ __forceinline__ void load_chunk(
    const float* __restrict__ xt, const uint8_t* __restrict__ rv,
    const float* __restrict__ shift, int C, int64_t R, int64_t r_chunk,
    int64_t r_end, int col0, float (*d)[TILE + 1], float (*m)[TILE + 1]) {
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

__global__ void __launch_bounds__(GRAM_THREADS)
gram_partial(const float* __restrict__ xt, const uint8_t* __restrict__ rv,
             const float* __restrict__ shift, int C, int64_t R,
             int64_t rows_per_split, float* __restrict__ partial) {
  const int bi = blockIdx.x * TILE;
  const int bj = blockIdx.y * TILE;
  const int s = blockIdx.z;
  const int64_t r0 = (int64_t)s * rows_per_split;
  const int64_t r1 = min(R, r0 + rows_per_split);
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
    load_chunk(xt, rv, shift, C, R, rc, r1, bi, di, mi);
    load_chunk(xt, rv, shift, C, R, rc, r1, bj, dj, mj);
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
  float* out = partial + (int64_t)s * 4 * cc;
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

}  // namespace

extern "C" const char* tpt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
extern "C" int tpt_fused_a_tile() { return TILE; }
extern "C" int tpt_fused_a_rows() { return TR; }

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
  stats_partial<<<dim3(C, stat_splits), STATS_THREADS, 0, st>>>(
      xt, row_valid, shift, R, stat_rows, stat_splits, psums, pcounts);
  stats_fold<<<(C + 127) / 128, 128, 0, st>>>(psums, pcounts, C,
                                                stat_splits, sums, counts);
  const int tiles = (C + TILE - 1) / TILE;
  gram_partial<<<dim3(tiles, tiles, gram_splits), GRAM_THREADS, 0, st>>>(
      xt, row_valid, shift, C, R, gram_rows, partial);
  const int64_t cc = (int64_t)C * C;
  gram_fold<<<(unsigned)((cc + 255) / 256), 256, 0, st>>>(
      partial, C, gram_splits, P, S1, S2, N);
  return (int)cudaGetLastError();
}
