// Copy of tpuprof/native/hash.cpp for the PyTorch port: the same hashes,
// bit for bit, so distinct counts and top-k keys agree with the reference.
//
// Native host-path hashing for tpuprof ingestion.
//
// The reference's equivalent work happens inside the Spark JVM (Tungsten
// codegen, external to its repo — SURVEY.md §2.3); tpuprof's host hot
// loop is hashing every cell for HLL distinct counts (SURVEY §7.2
// "Strings on TPU": hashing throughput is the likely CPU bottleneck at
// 1B rows).  Two entry points, loaded via ctypes (no pybind11 in the
// image):
//
//   tpuprof_hash_u64   — splitmix64 finalizer over raw 64-bit patterns
//                        (float64 bitcasts, int64 timestamps/ints)
//   tpuprof_hash_bytes — xxHash64 over variable-length UTF-8 values
//                        given Arrow large_string offsets, hashing the
//                        dictionary buffer directly (zero Python objects)
//
// Both are deterministic and seed-stable: hashes must agree across
// batches, fragments, and hosts for HLL registers to merge correctly.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t P2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t P3 = 0x165667B19E3779F9ULL;
constexpr uint64_t P4 = 0x85EBCA77C2B2AE63ULL;
constexpr uint64_t P5 = 0x27D4EB2F165667C5ULL;

inline uint64_t rotl(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

inline uint64_t read64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint64_t round1(uint64_t acc, uint64_t input) {
  acc += input * P2;
  acc = rotl(acc, 31);
  return acc * P1;
}

inline uint64_t merge_round(uint64_t acc, uint64_t val) {
  acc ^= round1(0, val);
  return acc * P1 + P4;
}

inline uint64_t avalanche(uint64_t h) {
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// splitmix64 finalizer — the ONE definition both tpuprof_hash_u64 and
// the fused hash+pack path use (they must stay bit-identical for HLL
// registers from the two paths to merge).
inline uint64_t splitmix(uint64_t z) {
  z += 0x9E3779B97F4A7C15ULL;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

// Full xxHash64 of one byte run.
uint64_t xxh64(const uint8_t* p, size_t len, uint64_t seed) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = round1(v1, read64(p));
      v2 = round1(v2, read64(p + 8));
      v3 = round1(v3, read64(p + 16));
      v4 = round1(v4, read64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge_round(h, v1);
    h = merge_round(h, v2);
    h = merge_round(h, v3);
    h = merge_round(h, v4);
  } else {
    h = seed + P5;
  }
  h += static_cast<uint64_t>(len);
  while (p + 8 <= end) {
    h ^= round1(0, read64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= static_cast<uint64_t>(read32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p++) * P5;
    h = rotl(h, 11) * P1;
  }
  return avalanche(h);
}

}  // namespace

extern "C" {

// out[i] = splitmix64-style avalanche of in[i] (raw 64-bit patterns).
void tpuprof_hash_u64(const uint64_t* in, uint64_t* out, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    out[i] = splitmix(in[i]);
  }
}

// out[i] = xxh64(data[offsets[i] .. offsets[i+1]]) for n values sharing
// one contiguous buffer (Arrow large_string layout: int64 offsets).
void tpuprof_hash_bytes(const uint8_t* data, const int64_t* offsets,
                        uint64_t* out, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    const int64_t beg = offsets[i];
    const int64_t len = offsets[i + 1] - beg;
    out[i] = xxh64(data + beg, static_cast<size_t>(len), 0);
  }
}

namespace {

// (idx << 5) | rho from one 64-bit hash — bit-identical to
// kernels/hll.pack: idx = top `precision` bits, rho = clz of the next
// 32 bits + 1, capped at 31, floored at 1 (so packed == 0 iff invalid).
inline uint16_t pack_one(uint64_t h, int precision) {
  const int shift_idx = 64 - precision;
  const uint32_t idx = static_cast<uint32_t>(h >> shift_idx);
  const uint32_t b =
      static_cast<uint32_t>((h >> (shift_idx - 32)) & 0xFFFFFFFFULL);
  const uint32_t bb = b | 1u;
  const int fl = 31 - __builtin_clz(bb);   // floor(log2(bb))
  int rho = 32 - fl;
  if (rho > 31) rho = 31;
  if (rho < 1) rho = 1;
  return static_cast<uint16_t>((idx << 5) | static_cast<uint32_t>(rho));
}

}  // namespace

// Fused hash+pack for numeric/date columns: splitmix64 the raw key and
// pack the HLL observation in ONE pass (the separate hash_u64 + numpy
// pack formulation costs two full passes plus an intermediate array —
// measured as the second-largest share of host batch prep).
void tpuprof_hash_pack_u64(const uint64_t* keys, const uint8_t* valid,
                           uint16_t* out, size_t n, int precision) {
  for (size_t i = 0; i < n; ++i) {
    out[i] = (valid && !valid[i]) ? 0 : pack_one(splitmix(keys[i]),
                                                 precision);
  }
}

// Fused hash+pack that ALSO keeps the full 64-bit hash (exact-distinct
// mode, config.full_hashes): one pass produces the packed HLL
// observation AND writes the unpacked splitmix hash straight into the
// caller's preallocated stream (h64, typically a slice of the
// HostBatch num_hashes plane) — replacing the separate
// tpuprof_hash_u64 pass plus an 8-byte/row Python-side copy.
// Bit-identical to tpuprof_hash_pack_u64 / tpuprof_hash_u64 by
// construction: same splitmix, same pack_one.
void tpuprof_hash_pack_keep_u64(const uint64_t* keys,
                                const uint8_t* valid, uint16_t* out,
                                uint64_t* h64, size_t n, int precision) {
  for (size_t i = 0; i < n; ++i) {
    const uint64_t h = splitmix(keys[i]);
    h64[i] = h;
    out[i] = (valid && !valid[i]) ? 0 : pack_one(h, precision);
  }
}

// Fused gather+pack for dictionary-encoded columns: observations come
// from the per-dictionary-value hashes (dict_hashes, length n_dict)
// gathered through int64 codes; invalid rows (code < 0 / out of range /
// !valid) pack to 0.
void tpuprof_pack_gather(const uint64_t* dict_hashes, size_t n_dict,
                         const int64_t* codes, const uint8_t* valid,
                         uint16_t* out, size_t n, int precision) {
  for (size_t i = 0; i < n; ++i) {
    const int64_t c = codes[i];
    const bool ok = (!valid || valid[i]) && c >= 0 &&
                    static_cast<uint64_t>(c) < n_dict;
    out[i] = ok ? pack_one(dict_hashes[c], precision) : 0;
  }
}

// Fold packed HLL observations into registers on the host: each cell is
// (idx << 5) | rho in a uint16 (0 = null/padding — kernels/hll.pack);
// regs is (n_cols x m) int32 row-major, updated in place with
// regs[c][idx] = max(regs[c][idx], rho).  Strides are in ELEMENTS so
// both C- and F-order observation planes walk without a copy.  Exactly
// the semantics of the device scatter path (kernels/hll.update) — the
// two must agree bit-for-bit for checkpoints and merges to mix.
void tpuprof_hll_update(const uint16_t* packed, size_t n_rows,
                        size_t n_cols, ptrdiff_t row_stride,
                        ptrdiff_t col_stride, int32_t* regs, size_t m) {
  auto fold_range = [=](size_t c0, size_t c1) {
    for (size_t c = c0; c < c1; ++c) {
      int32_t* r = regs + c * m;
      const uint16_t* p = packed + static_cast<ptrdiff_t>(c) * col_stride;
      for (size_t i = 0; i < n_rows; ++i) {
        const uint16_t v = p[static_cast<ptrdiff_t>(i) * row_stride];
        if (!v) continue;
        const uint32_t idx = v >> 5;
        const int32_t rho = v & 31;
        if (idx < m && rho > r[idx]) r[idx] = rho;
      }
    }
  };
  // columns own disjoint register rows, so the fold is embarrassingly
  // parallel; thread only when the work amortizes spawn cost
  const size_t hw = std::thread::hardware_concurrency();
  const size_t want = n_cols / 4;       // >= 4 columns per worker
  size_t n_threads = hw < want ? hw : want;
  if (n_threads < 2 || n_rows * n_cols < (1u << 18)) {
    fold_range(0, n_cols);
    return;
  }
  std::vector<std::thread> workers;
  const size_t chunk = (n_cols + n_threads - 1) / n_threads;
  size_t started_cols = 0;
  try {
    for (size_t t = 0; t < n_threads; ++t) {
      const size_t c0 = t * chunk;
      const size_t c1 = (c0 + chunk < n_cols) ? c0 + chunk : n_cols;
      if (c0 >= c1) break;
      workers.emplace_back(fold_range, c0, c1);
      started_cols = c1;
    }
  } catch (...) {
    // spawn failure (EAGAIN under thread limits, or a toolchain without
    // working gthreads): finish what was not handed out serially —
    // letting the exception cross the extern "C"/ctypes boundary would
    // terminate the host process
    for (auto& w : workers) w.join();
    fold_range(started_cols, n_cols);
    return;
  }
  for (auto& w : workers) w.join();
}

}  // extern "C"
