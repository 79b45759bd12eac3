// Device code shared by the pass-A kernels K1 (fused_a.cu), K3
// (fused_wide.cu), the single-pass kernel K4 (fused_ab.cu) and the narrow
// Spearman kernel K5 (spear.cu, the Gram of its ranks):
//
// * StatsAcc / stats_store / stats_partial / stats_fold: the per-column
//   statistics of one batch (s1..s4 of d = x - shift over finite values,
//   min/max over non-null values, min/max over finite values; finite n,
//   zeros, +-inf, missing) over a fixed (column, row-split) partition,
//   folded in split order (the fused K4, fused_ab.cu, runs the same
//   per-value and per-block code);
// * gram_tc / launch_gram: the pairwise-complete Gram sums P = d d^T,
//   S1 = d m^T, S2 = d^2 m^T, N = m m^T of K1, K3, K4 and K5 on the
//   tensor cores (3xTF32 split, one block per pair of tiles of the upper
//   triangle, a cp.async ring, float32 promotion), section below;
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

// ---------------------------------------------------------------------------
// The Gram of K1, K3, K4 and K5 on the tensor cores: gram_tc + gram_fold.
//
// One block per unordered pair of TC_TILE-column tiles (bi <= bj) and row
// split.  Raw x and row_valid of both tiles arrive in a ring of TC_STAGES
// cp.async chunks of TC_ROWS rows.  Each chunk's values are formed once:
// d, d^2 and m, with d and d^2 split into TF32 hi + lo, go to five planes
// in shared memory, which every warp reads for its mma.sync m16n8k8 TF32
// fragments (forming them in each warp's registers instead repeats that
// work 4x for the i tile and 2x for the j tile).  With float32
// accumulation:
//
//   P(i,j)  = d_i d_j    3 passes: lo*hi + hi*lo + hi*hi
//   S1(i,j) = d_i m_j    2 passes (m is 0 or 1, exact in TF32)
//   S2(i,j) = d2_i m_j   2 passes
//   S1(j,i), S2(j,i)     2 passes each, as m_i d_j and m_i d2_j
//   N(i,j)  = m_i m_j    1 pass, exact (integer sums below 2^24)
//
// so the pair's loads feed both triangles of S1 and S2 and one triangle of
// P and N, which the block writes mirrored.  Every TC_PROMOTE chunks the
// MMA sums of P, S1 and S2 are added into IEEE float32 sums in shared
// memory and restarted from 0: the tensor cores' float32 accumulation is
// not documented to round to nearest, so no MMA sum runs longer than
// TC_PROMOTE * TC_ROWS rows.  Partition, pass order and promotion order
// depend only on the shape, so a rerun gives the same bits.
// ---------------------------------------------------------------------------

constexpr int TC_TILE = 64;         // output tile edge (columns)
constexpr int TC_ROWS = 32;         // rows per cp.async chunk (4 k-steps)
constexpr int TC_STAGES = 3;        // chunks in flight in the ring
constexpr int TC_PROMOTE = 4;       // chunks between promotions (128 rows)
constexpr int TC_THREADS = 256;     // 8 warps: 2 (i) x 4 (j) of 32 x 16
// floats per staged column: = 4 (mod 32) banks, so the fragment loads
// (8 columns x 4 rows a warp) are conflict-free, and 16-byte rows
constexpr int TC_PITCH = TC_ROWS + 4;
constexpr int TC_STAGE_FLOATS = 2 * TC_TILE * TC_PITCH;
// the formed operands of one chunk: dh, dl, qh, ql (d^2) and m planes
constexpr int TC_PLANES = 5;
// promoted float32 sums a thread owns: P, S1(i,j), S2(i,j), S1(j,i),
// S2(j,i) x 2 x 2 mma tiles x 4 accumulators
constexpr int TC_PROM = 5 * 2 * 2 * 4;
constexpr int TC_SMEM =
    (TC_PROM * TC_THREADS + TC_PLANES * TC_STAGE_FLOATS + 2 * TC_TILE) * 4 +
    TC_STAGES * (TC_STAGE_FLOATS * 4 + TC_ROWS);

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(v));
  return u;
}

// v = hi + lo, both TF32.  A finite v that rounds past the largest TF32
// value keeps its truncation as hi; a non-finite v (d^2 overflowed) keeps
// hi = v and lo = 0, so the products are inf or NaN where float32's are.
__device__ __forceinline__ void tf32_split(float v, uint32_t& hi,
                                           uint32_t& lo) {
  uint32_t h = tf32_rna(v);
  if (isinf(__uint_as_float(h)) && !isinf(v))
    h = __float_as_uint(v) & 0xffffe000u;
  const float r = __fsub_rn(v, __uint_as_float(h));   // exact
  hi = h;
  lo = isfinite(r) ? tf32_rna(r) : 0u;
}

// One value's operands, as a warp's fragment registers hold them.
struct TcOp {
  uint32_t dh, dl, qh, ql, m;
};

// The operands of the value at ``o`` in the planes ``pl`` (plane stride
// TC_STAGE_FLOATS).
__device__ __forceinline__ TcOp tc_load(const uint32_t* pl, int o) {
  return {pl[o], pl[TC_STAGE_FLOATS + o], pl[2 * TC_STAGE_FLOATS + o],
          pl[3 * TC_STAGE_FLOATS + o], pl[4 * TC_STAGE_FLOATS + o]};
}

// c += a b for one m16n8k8 tile; a = operand FA of the 4 A values (rows
// g, g+8 at k = t, then at k = t+4), b = operand FB of the 2 B values
// (column g at k = t, t+4).
template <uint32_t TcOp::*FA, uint32_t TcOp::*FB>
__device__ __forceinline__ void mma(float (&c)[4], const TcOp (&a)[4],
                                    const TcOp (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0].*FA), "r"(a[1].*FA), "r"(a[2].*FA), "r"(a[3].*FA),
        "r"(b[0].*FB), "r"(b[1].*FB));
}

// ``x_vec``: xt is 16-byte aligned and R % 4 == 0 (16-byte copies of x);
// ``rv_vec``: row_valid is 16-byte aligned.  Split starts are multiples of
// TC_ROWS, so every copy of a chunk is then aligned.
__global__ void __launch_bounds__(TC_THREADS, 1)
gram_tc(const float* __restrict__ xt, const uint8_t* __restrict__ rv,
        const float* __restrict__ shift, int C, int64_t R,
        int64_t rows_per_split, int x_vec, int rv_vec,
        float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* prom = reinterpret_cast<float*>(smem);
  uint32_t* planes = reinterpret_cast<uint32_t*>(prom + TC_PROM * TC_THREADS);
  float* shs = reinterpret_cast<float*>(planes + TC_PLANES * TC_STAGE_FLOATS);
  float* xs = shs + 2 * TC_TILE;
  uint8_t* rvs = reinterpret_cast<uint8_t*>(xs + TC_STAGES * TC_STAGE_FLOATS);

  // this block's tile pair bi <= bj: index p = bj (bj + 1) / 2 + bi
  const int p = blockIdx.x;
  int bj = (int)((sqrtf(8.f * p + 1.f) - 1.f) * 0.5f);
  while (bj * (bj + 1) / 2 > p) --bj;
  while ((bj + 1) * (bj + 2) / 2 <= p) ++bj;
  const int bi = p - bj * (bj + 1) / 2;
  const bool diag = bi == bj;
  const int ci = bi * TC_TILE, cj = bj * TC_TILE;
  const int ncols = diag ? TC_TILE : 2 * TC_TILE;     // staged columns
  const int jo = diag ? 0 : TC_TILE;                  // where j's start

  const int64_t r0 = (int64_t)blockIdx.y * rows_per_split;
  const int64_t r1 = min(R, r0 + rows_per_split);
  const int nchunks =
      r1 > r0 ? (int)((r1 - r0 + TC_ROWS - 1) / TC_ROWS) : 0;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wi = (warp >> 2) * 32;    // the warp's first i and j columns
  const int wj = (warp & 3) * 16;

  // staged column -> table column
  auto column = [&](int col) {
    return col < TC_TILE ? ci + col : cj + col - TC_TILE;
  };

  // chunk k of this split into stage k % TC_STAGES; rows past r1 and
  // columns past C arrive as zeros (row_valid 0: d = m = 0)
  auto load = [&](int k) {
    float* xd = xs + (k % TC_STAGES) * TC_STAGE_FLOATS;
    uint8_t* rd = rvs + (k % TC_STAGES) * TC_ROWS;
    const int64_t r = r0 + (int64_t)k * TC_ROWS;
    if (x_vec) {
      for (int e = tid; e < ncols * (TC_ROWS / 4); e += TC_THREADS) {
        const int col = e / (TC_ROWS / 4);
        const int q = (e % (TC_ROWS / 4)) * 4;
        const int c = column(col);
        const int64_t rr = r + q;
        const bool in = c < C && rr < r1;
        cp_async16(xd + col * TC_PITCH + q, in ? xt + (int64_t)c * R + rr : xt,
                   in ? (int)min((int64_t)16, 4 * (r1 - rr)) : 0);
      }
    } else {
      for (int e = tid; e < ncols * TC_ROWS; e += TC_THREADS) {
        const int col = e / TC_ROWS;
        const int q = e % TC_ROWS;
        const int c = column(col);
        const int64_t rr = r + q;
        const bool in = c < C && rr < r1;
        cp_async4(xd + col * TC_PITCH + q, in ? xt + (int64_t)c * R + rr : xt,
                  in ? 4 : 0);
      }
    }
    if (rv_vec) {
      if (tid < TC_ROWS / 16) {
        const int64_t rr = r + 16 * tid;
        cp_async16(rd + 16 * tid, rr < r1 ? rv + rr : rv,
                   rr < r1 ? (int)min((int64_t)16, r1 - rr) : 0);
      }
    } else if (tid < TC_ROWS) {
      rd[tid] = r + tid < r1 ? rv[r + tid] : 0;
    }
  };

  // d = x - shift where the row is valid and x finite (0 elsewhere), d^2
  // in float32, both split, and m = 1.0f or 0, for every value of staged
  // chunk k: a warp takes one column's TC_ROWS rows at a time
  auto form = [&](int k) {
    const float* xd = xs + (k % TC_STAGES) * TC_STAGE_FLOATS;
    const uint8_t* rd = rvs + (k % TC_STAGES) * TC_ROWS;
    for (int e = tid; e < ncols * TC_ROWS; e += TC_THREADS) {
      const int col = e / TC_ROWS;
      const int o = col * TC_PITCH + e % TC_ROWS;
      const float x = xd[o];
      const bool fin = rd[e % TC_ROWS] != 0 && isfinite(x);
      const float d = fin ? __fsub_rn(x, shs[col]) : 0.f;
      uint32_t* pl = planes + o;
      tf32_split(d, pl[0], pl[TC_STAGE_FLOATS]);
      tf32_split(__fmul_rn(d, d), pl[2 * TC_STAGE_FLOATS],
                 pl[3 * TC_STAGE_FLOATS]);
      pl[4 * TC_STAGE_FLOATS] = fin ? 0x3f800000u : 0u;
    }
  };

  if (tid < ncols) {
    const int c = column(tid);
    shs[tid] = c < C ? shift[c] : 0.f;
  }

  // MMA sums: P, N, S1(i,j), S2(i,j), and m_i d_j = S1(j,i), m_i d2_j =
  // S2(j,i) (not needed on a diagonal tile, whose S1(i,j) holds both)
  float aP[2][2][4], aN[2][2][4], a1[2][2][4], a2[2][2][4], b1[2][2][4],
      b2[2][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        aP[mt][nt][e] = aN[mt][nt][e] = a1[mt][nt][e] = a2[mt][nt][e] =
            b1[mt][nt][e] = b2[mt][nt][e] = 0.f;
  for (int k = 0; k < TC_PROM; ++k) prom[k * TC_THREADS + tid] = 0.f;

  // slot of promoted sum ``q`` (0 P, 1 S1(i,j), 2 S2(i,j), 3 S1(j,i),
  // 4 S2(j,i)) of accumulator e of mma tile (mt, nt): thread-private, and
  // consecutive threads on consecutive words
  auto slot = [&](int q, int mt, int nt, int e) -> float& {
    return prom[(((q * 2 + mt) * 2 + nt) * 4 + e) * TC_THREADS + tid];
  };
  auto promote = [&]() {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          slot(0, mt, nt, e) += aP[mt][nt][e];
          slot(1, mt, nt, e) += a1[mt][nt][e];
          slot(2, mt, nt, e) += a2[mt][nt][e];
          slot(3, mt, nt, e) += b1[mt][nt][e];
          slot(4, mt, nt, e) += b2[mt][nt][e];
          aP[mt][nt][e] = a1[mt][nt][e] = a2[mt][nt][e] = b1[mt][nt][e] =
              b2[mt][nt][e] = 0.f;
        }
  };

#pragma unroll
  for (int k = 0; k < TC_STAGES - 1; ++k) {
    if (k < nchunks) load(k);
    cp_async_commit();
  }
  for (int k = 0; k < nchunks; ++k) {
    cp_async_wait<TC_STAGES - 2>();
    // chunk k landed; chunk k - 1's stage and the planes are free
    __syncthreads();
    if (k + TC_STAGES - 1 < nchunks) load(k + TC_STAGES - 1);
    cp_async_commit();
    form(k);
    __syncthreads();
#pragma unroll
    for (int k0 = 0; k0 < TC_ROWS; k0 += 8) {
      TcOp B[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int o = (jo + wj + 8 * nt + g) * TC_PITCH + k0 + t;
        B[nt][0] = tc_load(planes, o);
        B[nt][1] = tc_load(planes, o + 4);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int o = (wi + 16 * mt + g) * TC_PITCH + k0 + t;
        const TcOp A[4] = {tc_load(planes, o),
                           tc_load(planes, o + 8 * TC_PITCH),
                           tc_load(planes, o + 4),
                           tc_load(planes, o + 8 * TC_PITCH + 4)};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma<&TcOp::dl, &TcOp::dh>(aP[mt][nt], A, B[nt]);
          mma<&TcOp::dh, &TcOp::dl>(aP[mt][nt], A, B[nt]);
          mma<&TcOp::dh, &TcOp::dh>(aP[mt][nt], A, B[nt]);
          mma<&TcOp::m, &TcOp::m>(aN[mt][nt], A, B[nt]);
          mma<&TcOp::dl, &TcOp::m>(a1[mt][nt], A, B[nt]);
          mma<&TcOp::dh, &TcOp::m>(a1[mt][nt], A, B[nt]);
          mma<&TcOp::ql, &TcOp::m>(a2[mt][nt], A, B[nt]);
          mma<&TcOp::qh, &TcOp::m>(a2[mt][nt], A, B[nt]);
          if (!diag) {
            mma<&TcOp::m, &TcOp::dl>(b1[mt][nt], A, B[nt]);
            mma<&TcOp::m, &TcOp::dh>(b1[mt][nt], A, B[nt]);
            mma<&TcOp::m, &TcOp::ql>(b2[mt][nt], A, B[nt]);
            mma<&TcOp::m, &TcOp::qh>(b2[mt][nt], A, B[nt]);
          }
        }
      }
    }
    if ((k + 1) % TC_PROMOTE == 0 || k + 1 == nchunks) promote();
  }

  // partial layout: (splits, 4, C, C) — P, S1, S2, N of this row split.
  // P and N are written from one triangle to both, so they are exactly
  // symmetric.
  const int64_t cc = (int64_t)C * C;
  float* out = partial + (int64_t)blockIdx.y * 4 * cc;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int a = wi + 16 * mt + 8 * (e >> 1) + g;
        const int b = wj + 8 * nt + 2 * t + (e & 1);
        const int i = ci + a, j = cj + b;
        if (i >= C || j >= C) continue;
        const int64_t ij = (int64_t)i * C + j, ji = (int64_t)j * C + i;
        const float pv = slot(0, mt, nt, e), nv = aN[mt][nt][e];
        if (!diag || a <= b) {
          out[ij] = pv;
          out[3 * cc + ij] = nv;
          out[ji] = pv;
          out[3 * cc + ji] = nv;
        }
        out[cc + ij] = slot(1, mt, nt, e);
        out[2 * cc + ij] = slot(2, mt, nt, e);
        if (!diag) {
          out[cc + ji] = slot(3, mt, nt, e);
          out[2 * cc + ji] = slot(4, mt, nt, e);
        }
      }
}

// Launch gram_tc + gram_fold for one batch on ``st``: ``gram_splits``
// splits of ``gram_rows`` rows (a multiple of TC_ROWS), each over the
// T (T + 1) / 2 tile pairs of the upper triangle.
inline void launch_gram(const float* xt, const uint8_t* rv,
                        const float* shift, int C, int64_t R,
                        int gram_splits, int64_t gram_rows, float* partial,
                        float* P, float* S1, float* S2, int* N,
                        cudaStream_t st) {
  const int tiles = (C + TC_TILE - 1) / TC_TILE;
  const int pairs = tiles * (tiles + 1) / 2;
  cudaFuncSetAttribute(gram_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       TC_SMEM);
  const int x_vec = (reinterpret_cast<uintptr_t>(xt) % 16 == 0) && R % 4 == 0;
  const int rv_vec = reinterpret_cast<uintptr_t>(rv) % 16 == 0;
  gram_tc<<<dim3(pairs, gram_splits), TC_THREADS, TC_SMEM, st>>>(
      xt, rv, shift, C, R, gram_rows, x_vec, rv_vec, partial);
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
extern "C" int tpt_tc_tile() { return tpt::TC_TILE; }
extern "C" int tpt_tc_rows() { return tpt::TC_ROWS; }
