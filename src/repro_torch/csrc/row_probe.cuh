// The bucket-row probe shared by the table's two lookup kernels
// (fused_probe.cu, probe.cu), so that the two cannot drift apart.
//
// Contract (core/table.py::probe_rows): found = some slot of the row equals
// the query, and an EMPTY query never matches; val = the first matching
// slot's value, -1 on a miss.
//
// On the H100 a probe is one random 32-byte sector of keys per query (B = 8
// int32, read as two 16-byte loads) and, on a hit, one value: there is no
// reuse to stage in shared memory, so each access stays one sector.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "hash_route.cuh"

namespace repro_torch {

// kRow8: B == 8 and the pool base is 16-byte aligned (the launcher checks),
// so a row is two aligned int4 loads.
template <bool kRow8>
__device__ __forceinline__ void probe_row(const int32_t* __restrict__ pool_keys,
                                          const int32_t* __restrict__ pool_vals,
                                          int32_t bucket, int B, int32_t q,
                                          uint8_t* found, int32_t* val) {
  const int64_t row = static_cast<int64_t>(bucket) * B;
  int slot = -1;
  if (q != kEmptyKey) {
    if (kRow8) {
      const int4* r = reinterpret_cast<const int4*>(pool_keys + row);
      const int4 lo = __ldg(r);
      const int4 hi = __ldg(r + 1);
      const int32_t k[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int s = 7; s >= 0; --s)
        if (k[s] == q) slot = s;
    } else {
      for (int s = B - 1; s >= 0; --s)
        if (__ldg(pool_keys + row + s) == q) slot = s;
    }
  }
  *found = slot >= 0;
  *val = slot >= 0 ? __ldg(pool_vals + row + slot) : -1;
}

// Whether the 16-byte row loads apply: 32-byte rows on a 16-byte-aligned base.
inline bool rows_of_eight(const void* pool_keys, int B) {
  return B == 8 && reinterpret_cast<uintptr_t>(pool_keys) % 16 == 0;
}

}  // namespace repro_torch
