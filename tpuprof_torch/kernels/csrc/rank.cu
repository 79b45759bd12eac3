// K6: grid ranks materialized to device memory, stage 1 of the wide
// Spearman tier (more than 512 numeric columns), for Hopper (sm_90a).
//
// Replaces tpuprof/kernels/fused.py::_rank_tiles (Pallas body
// _rank_kernel).  For one batch xt (C, R) float32, row_valid (R,) bytes
// and each column's G-point CDF grid (C, G) float32 (G <= 256, rows
// nondecreasing) it writes ranks (C, R) float32: the grid rank of x where
// the row is valid and x finite, NaN elsewhere.  Stage 2 is K3 with
// skip_stats over these ranks with shift 0.5, where a NaN rank is masked
// as a NaN value is.  K5 (fused.py spear_tiles_cuda) is this launch, then
// K3's with skip_stats, at most 512 columns.
//
// What bounds it on an H100: memory.  The function reads xt once and
// writes the ranks once, 2*C*R*4 bytes (1.07 GB at C=2048, R=65536, 0.32
// ms at 3.35 TB/s).  The search is this design's cost, not work the
// function needs, and it is what the design cuts (grid_rank.cuh): one
// fixed-trip descent of 9 conflict-free shared-memory reads a value (one
// depth for every G <= 256; the tie count only where x equals a grid point),
// four values in flight a thread, with 16-byte loads of x, one 4-byte load
// of row_valid and 16-byte stores of the ranks where the pointers are
// aligned and R % 4 == 0 (coalesced scalars otherwise), and blocks that
// each stage their column's grid once for a long stretch of rows (about
// four waves of blocks over the card in all).  The TPU kernel's (256, 128)
// tiles were a VMEM budget for its unrolled compare loop; nothing of that
// carries over.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast math).

#include "grid_rank.cuh"

extern "C" const char* tpt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// Ranks of one batch: one launch on ``stream``; returns cudaGetLastError()
// (cudaErrorInvalidValue for G outside 1..256).  ``c`` is float32(0.5 / G).
extern "C" int tpt_rank(const float* xt, const uint8_t* row_valid,
                        const float* grid, int C, int64_t R, int G, float c,
                        float* out, void* stream) {
  return (int)tpt::launch_rank(xt, row_valid, grid, C, R, G, c, out,
                               static_cast<cudaStream_t>(stream));
}
