// hll_regs: pass A's HyperLogLog observations of float32 lanes, made on the
// card from the batch K1 reads, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference hashes every value on the host
// during ingest (native/hash.cpp::tpuprof_hash_pack_u64 over the float32
// bits widened to 64, then tpuprof_hll_update).  For a float32 lane the key
// is a pure function of the value that the x plane already carries to the
// card, so the hash, the pack and the register fold move here and the host
// prepare pool stops hashing those lanes.  The registers are the host's bit
// for bit:
//
//   key  = the float32 bits, -0.0 taken as +0.0, widened to 64 bits; a
//          padding row (row_valid 0) or a NaN (null) gives none;
//   h    = splitmix64(key), exactly native/hash.cpp::splitmix;
//   idx  = the top p bits of h, rho = clz32 of the next 32 bits + 1,
//          clamped to [1, 31] (native/hash.cpp::pack_one);
//   regs[hash lane][idx] = max(regs[hash lane][idx], rho).
//
// Everything is done on the bits (the zero and NaN tests too), so no
// floating-point mode of the build can change a key.
//
// What bounds it on an H100: each value is read once (4 bytes: 52.4 MB at
// 200 x 65,536, 15.7 us at 3.35 TB/s) and hashed with two 64-bit multiplies
// (some 30 integer instructions), about as long again on the integer pipes
// at that size.  Its design:
//
// * one block per (lane, row split): the lane's 2^p registers (8 KB at
//   p = 11) in shared memory, filled by shared-memory atomicMax (max is
//   order-free, so any schedule gives the same registers);
// * coalesced 16-byte loads of the column (and 4-byte loads of row_valid)
//   where the split starts aligned, scalar loads elsewhere;
// * the row splits fill about four blocks an SM; each block then raises the
//   lane's registers in device memory with atomicMax, only where its own
//   register is above what it reads there (registers only grow, so a stale
//   read costs an atomic, never a lost maximum).
//
// The registers are updated in place; the launch folds one batch.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tpt {

constexpr int HLL_THREADS = 256;
constexpr int HLL_MAX_PRECISION = 11;     // idx (11) + rho (5) = 16 bits
constexpr int HLL_TARGET_BLOCKS = 4 * 132;

__device__ __forceinline__ uint64_t hll_splitmix(uint64_t z) {
  z += 0x9E3779B97F4A7C15ULL;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

__device__ __forceinline__ void hll_observe(float v, bool row_ok, int p,
                                            int* sregs) {
  uint32_t bits = __float_as_uint(v);
  if (!row_ok || (bits & 0x7FFFFFFFu) > 0x7F800000u) return;   // pad, NaN
  if ((bits << 1) == 0u) bits = 0u;                            // -0.0
  const uint64_t h = hll_splitmix(static_cast<uint64_t>(bits));
  const uint32_t idx = static_cast<uint32_t>(h >> (64 - p));
  const uint32_t b = static_cast<uint32_t>(h >> (32 - p));
  int rho = __clz(static_cast<int>(b | 1u)) + 1;
  rho = rho > 31 ? 31 : rho;
  atomicMax(sregs + idx, rho);
}

// grid (K lanes, S row splits); lanes holds K (numeric lane, hash lane)
// pairs; regs is (n_hash, 2^p) int32, row-major.
__global__ void __launch_bounds__(HLL_THREADS)
hll_regs(const float* __restrict__ xt, const uint8_t* __restrict__ row_valid,
         const int* __restrict__ lanes, int64_t R, int64_t split_rows, int p,
         int* __restrict__ regs) {
  extern __shared__ int sregs[];
  const int m = 1 << p;
  for (int i = threadIdx.x; i < m; i += HLL_THREADS) sregs[i] = 0;
  __syncthreads();
  const int num_lane = lanes[2 * blockIdx.x];
  const int hash_lane = lanes[2 * blockIdx.x + 1];
  const float* col = xt + static_cast<int64_t>(num_lane) * R;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * split_rows;
  const int64_t r1 = r0 + split_rows < R ? r0 + split_rows : R;
  int64_t r = r0;
  if ((reinterpret_cast<uintptr_t>(col + r0) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(row_valid + r0) & 3) == 0) {
    const int64_t n4 = (r1 - r0) >> 2;
    const float4* c4 = reinterpret_cast<const float4*>(col + r0);
    const uchar4* v4 = reinterpret_cast<const uchar4*>(row_valid + r0);
    for (int64_t i = threadIdx.x; i < n4; i += HLL_THREADS) {
      const float4 x = __ldg(c4 + i);
      const uchar4 v = __ldg(v4 + i);
      hll_observe(x.x, v.x != 0, p, sregs);
      hll_observe(x.y, v.y != 0, p, sregs);
      hll_observe(x.z, v.z != 0, p, sregs);
      hll_observe(x.w, v.w != 0, p, sregs);
    }
    r = r0 + (n4 << 2);
  }
  for (int64_t i = r + threadIdx.x; i < r1; i += HLL_THREADS)
    hll_observe(__ldg(col + i), __ldg(row_valid + i) != 0, p, sregs);
  __syncthreads();
  int* out = regs + static_cast<int64_t>(hash_lane) * m;
  for (int i = threadIdx.x; i < m; i += HLL_THREADS) {
    const int s = sregs[i];
    if (s > 0 && s > __ldcg(out + i)) atomicMax(out + i, s);
  }
}

// The row partition: about HLL_TARGET_BLOCKS blocks over the K lanes,
// splits of whole float4s; S * split_rows covers R.
inline void hll_partition(int K, int64_t R, int64_t* splits,
                          int64_t* split_rows) {
  int64_t s = (HLL_TARGET_BLOCKS + K - 1) / K;
  const int64_t most = (R + 4095) / 4096;     // at least 4,096 rows a split
  s = s < most ? s : most;
  s = s < 1 ? 1 : s;
  int64_t rows = (R + s - 1) / s;
  rows = (rows + 3) / 4 * 4;
  *split_rows = rows;
  *splits = (R + rows - 1) / rows;
}

inline void launch_hll_regs(const float* xt, const uint8_t* row_valid,
                            const int* lanes, int K, int64_t R, int p,
                            int* regs, cudaStream_t st) {
  if (K <= 0 || R <= 0) return;
  int64_t splits, split_rows;
  hll_partition(K, R, &splits, &split_rows);
  dim3 grid(static_cast<unsigned>(K), static_cast<unsigned>(splits));
  hll_regs<<<grid, HLL_THREADS, sizeof(int) << p, st>>>(
      xt, row_valid, lanes, R, split_rows, p, regs);
}

}  // namespace tpt
