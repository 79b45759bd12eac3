// K6: grid ranks materialized to device memory, stage 1 of the wide
// Spearman tier (more than 512 numeric columns), for Hopper (sm_90a).
//
// Replaces tpuprof/kernels/fused.py::_rank_tiles (Pallas body
// _rank_kernel).  For one batch xt (C, R) float32, row_valid (R,) bytes
// and each column's G-point CDF grid (C, G) float32 (G <= 256, rows
// nondecreasing) it writes ranks (C, R) float32: the grid rank of x
// (grid_rank.cuh, the same device function K5 uses) where the row is valid
// and x finite, NaN elsewhere.  Stage 2 is K3 with skip_stats over these
// ranks with shift 0.5, where a NaN rank is masked as a NaN value is.
//
// What bounds it on an H100: memory.  The function reads xt once and
// writes the ranks once, 2*C*R*4 bytes (1.07 GB at C=2048, R=65536, 0.32
// ms at 3.35 TB/s); the binary searches are a few dozen shared-memory
// reads a value, not work the function needs.  Design: a block owns one
// column and a stretch of rows, stages the column's grid in shared memory
// once, and its threads read and write consecutive rows (coalesced),
// each thread a grid-strided run of rows.  The TPU kernel's (256, 128)
// tiles were a VMEM budget for its unrolled compare loop; nothing of that
// carries over.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast math).

#include <math.h>
#include <stdint.h>

#include "grid_rank.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_THREAD = 8;

__global__ void __launch_bounds__(THREADS)
rank_kernel(const float* __restrict__ xt, const uint8_t* __restrict__ rv,
            const float* __restrict__ grid, int64_t R, int G, float c,
            float* __restrict__ out) {
  __shared__ float g[tpt::MAX_GRID];
  const int col = blockIdx.y;
  for (int k = threadIdx.x; k < G; k += THREADS)
    g[k] = grid[(int64_t)col * G + k];
  __syncthreads();
  const float nan = __int_as_float(0x7fc00000);   // the canonical quiet NaN
  const int64_t base = (int64_t)col * R;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t r = (int64_t)blockIdx.x * THREADS + threadIdx.x; r < R;
       r += stride) {
    const float x = xt[base + r];
    out[base + r] = rv[r] != 0 && isfinite(x) ? tpt::grid_rank(g, G, x, c)
                                              : nan;
  }
}

}  // namespace

extern "C" const char* tpt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// Ranks of one batch: one launch on ``stream``; returns
// cudaGetLastError().  ``c`` is float32(0.5 / G).
extern "C" int tpt_rank(const float* xt, const uint8_t* row_valid,
                        const float* grid, int C, int64_t R, int G, float c,
                        float* out, void* stream) {
  if (G < 1 || G > tpt::MAX_GRID) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t per_block = (int64_t)THREADS * ROWS_PER_THREAD;
  const unsigned bx = (unsigned)((R + per_block - 1) / per_block);
  rank_kernel<<<dim3(bx > 0 ? bx : 1, C), THREADS, 0, st>>>(
      xt, row_valid, grid, R, G, c, out);
  return (int)cudaGetLastError();
}
