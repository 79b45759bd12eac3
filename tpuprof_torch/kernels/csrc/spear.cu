// K5: the narrow Spearman tier (at most 512 numeric columns) in one read
// of the batch, for Hopper (sm_90a).
//
// Replaces tpuprof/kernels/fused.py::_spear_tiles (Pallas body
// _spear_kernel).  For one batch xt (C, R) float32, row_valid (R,) bytes
// and each column's G-point CDF grid (C, G) float32 (G <= 256, rows
// nondecreasing, +inf where a column has no sample) it ranks every value
// against its column's grid (grid_rank.cuh) and computes the pairwise-
// complete Gram sums of d = rank - 0.5 over the finite values:
//
//   P, S1, S2 (C, C) f32 and N (C, C) i32, as K1 does for d = x - shift.
//
// What bounds it on an H100: the Gram, as for K1 (2*C*(C+1)*R + 4*C^2*R
// float32 flops; 0.235 ms at C=200, R=65536), plus one read of xt.  The
// rank searches are not counted: they are this design's cost, not work the
// function needs (the reference's dense compare does 2G compares a value).
//
// Design: K1's Gram (gram.cuh gram_tile) with another chunk loader.  Where
// K1's loader forms d = x - shift, K5's forms d = rank - 0.5 with
// __fsub_rn, so d is bit for bit what K6 followed by K3 forms.  A block
// stages the grids of its two 64-column blocks in shared memory once
// (2 * 64 * G * 4 bytes, 128 KiB at G=256: dynamic shared memory above the
// 48 KiB default, opted into with cudaFuncSetAttribute), and the loader
// ranks each value by binary search against them.  The grid never leaves
// shared memory and the ranks never reach device memory, which is what the
// TPU kernel's single read was for.  Row splits and their in-order fold
// are K1's: no float atomics, a rerun gives the same bits.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast math).

#include "gram.cuh"
#include "grid_rank.cuh"

namespace {

using tpt::Chunk;
using tpt::GRAM_THREADS;
using tpt::TILE;
using tpt::TR;

// d = rank - 0.5 and m = 1 where the row is valid and x finite, 0
// elsewhere; ``g`` is this column block's (TILE, G) grid in shared memory.
struct RankLoader {
  const float* __restrict__ xt;
  const uint8_t* __restrict__ rv;
  const float* g;
  int G;
  float c;
  int C;
  int64_t R;

  __device__ __forceinline__ void operator()(int64_t r_chunk, int64_t r_end,
                                             int col0, Chunk* d,
                                             Chunk* m) const {
    for (int e = threadIdx.x; e < TR * TILE; e += GRAM_THREADS) {
      const int rr = e % TR;
      const int cc = e / TR;
      const int64_t r = r_chunk + rr;
      const int col = col0 + cc;
      bool fin = false;
      float v = 0.f;
      if (r < r_end && col < C && rv[r] != 0) {
        const float x = xt[(int64_t)col * R + r];
        fin = isfinite(x);
        if (fin) v = __fsub_rn(tpt::grid_rank(g + cc * G, G, x, c), 0.5f);
      }
      d[rr][cc] = v;
      m[rr][cc] = fin ? 1.f : 0.f;
    }
  }
};

__global__ void __launch_bounds__(GRAM_THREADS)
spear_partial(const float* __restrict__ xt, const uint8_t* __restrict__ rv,
              const float* __restrict__ grid, int C, int64_t R, int G,
              float c, int64_t rows_per_split, float* __restrict__ partial) {
  extern __shared__ float grids[];        // (2, TILE, G)
  const int bi = blockIdx.x * TILE;
  const int bj = blockIdx.y * TILE;
  float* gi = grids;
  float* gj = grids + TILE * G;
  for (int e = threadIdx.x; e < TILE * G; e += GRAM_THREADS) {
    const int cc = e / G;
    const int k = e % G;
    gi[e] = bi + cc < C ? grid[(int64_t)(bi + cc) * G + k] : INFINITY;
    gj[e] = bj + cc < C ? grid[(int64_t)(bj + cc) * G + k] : INFINITY;
  }
  __syncthreads();
  const int s = blockIdx.z;
  const int64_t r0 = (int64_t)s * rows_per_split;
  const int64_t r1 = min(R, r0 + rows_per_split);
  const RankLoader load_i{xt, rv, gi, G, c, C, R};
  const RankLoader load_j{xt, rv, gj, G, c, C, R};
  tpt::gram_tile(load_i, load_j, C, r0, r1, bi, bj,
                 partial + (int64_t)s * 4 * C * C);
}

}  // namespace

// One narrow Spearman batch: two launches on ``stream``; returns the
// status of the shared-memory opt-in or cudaGetLastError().  ``c`` is
// float32(0.5 / G).  Scratch: partial (gram_splits*4*C*C f32).
extern "C" int tpt_spear(const float* xt, const uint8_t* row_valid,
                         const float* grid, int C, int64_t R, int G, float c,
                         int gram_splits, int64_t gram_rows, float* partial,
                         float* P, float* S1, float* S2, int* N,
                         void* stream) {
  if (G < 1 || G > tpt::MAX_GRID) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = 2 * TILE * G * (int)sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      spear_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (C + TILE - 1) / TILE;
  spear_partial<<<dim3(tiles, tiles, gram_splits), GRAM_THREADS, smem, st>>>(
      xt, row_valid, grid, C, R, G, c, gram_rows, partial);
  const int64_t cc = (int64_t)C * C;
  tpt::gram_fold<<<(unsigned)((cc + 255) / 256), 256, 0, st>>>(
      partial, C, gram_splits, P, S1, S2, N);
  return (int)cudaGetLastError();
}
