// Hash and directory route shared by the table's CUDA kernels.
//
// The same arithmetic as repro_torch/core/hashing.py: a key's hash is
// fmix32 (MurmurHash3's finalizer) or the key's bits, shifted left by
// hash_shift; its directory entry is the top dmax bits of that hash; the
// entry names the owning bucket (a pool row).
#pragma once

#include <cstdint>

namespace repro_torch {

constexpr int32_t kEmptyKey = INT32_MIN;  // free slot; never a live key

enum HashId : int { kFmix32 = 0, kIdentity = 1 };

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// hash_shift is in [0, 32) and dmax in [1, 30], with dmax + hash_shift <=
// 32 (core/table.py's TableConfig refuses the rest): the route keeps dmax
// of the 32 - hash_shift bits the shift leaves, and its index is below 2**30
__device__ __forceinline__ uint32_t table_hash(int32_t key, int hash_id,
                                               int hash_shift) {
  uint32_t h = static_cast<uint32_t>(key);
  if (hash_id == kFmix32) h = fmix32(h);
  return h << hash_shift;
}

__device__ __forceinline__ int32_t route(const int32_t* __restrict__ dir,
                                         int32_t key, int dmax, int hash_id,
                                         int hash_shift) {
  const uint32_t h = table_hash(key, hash_id, hash_shift);
  return __ldg(dir + (h >> (32 - dmax)));
}

}  // namespace repro_torch
