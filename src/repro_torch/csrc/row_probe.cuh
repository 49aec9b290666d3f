// The bucket-row probe and launch shape shared by the table's two lookup
// kernels (fused_probe.cu, probe.cu), so that the two cannot drift apart.
//
// Contract (core/table.py::probe_rows): found = some slot of the row equals
// the query, and an EMPTY query never matches; val = the first matching
// slot's value, -1 on a miss.
//
// On the H100 a probe moves a few random 32-byte sectors per query and
// computes almost nothing, and a lookup batch is a few thousand queries: the
// kernel's time is the launch plus a chain of dependent device-memory round
// trips (each an L2 hit or an HBM access), not its bytes. The design cuts
// the chain and spreads the queries over the card:
//
// - A vector row (kVec > 0) reads its values in the same step as its keys,
//   with no dependency on the match, and picks the first matching slot's
//   value in registers. That takes the value read off the end of the chain;
//   a miss reads a value sector it does not need (the bytes bound in
//   chip_smoke.py still counts one value per hit, what the work needs).
//   At the wide path's 36,864 queries those extra sectors cost as much as
//   the round trip saves (warm), or more (cold): there the sector rate,
//   not the chain, sets the time (PERF.md §6).
// - The block is small by default (64 threads) so that a main-path lookup
//   of 4,608 queries runs as 72 blocks on 72 of the 132 SMs, not 18 blocks
//   on 18: each SM then keeps fewer queries' round trips in flight at once.
//   The block size is a launch argument (dispatch_threads, below), so that
//   the plan can measure it per geometry (kernels/tuning.py).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hash_route.cuh"

namespace repro_torch {

// Threads a block for both probes, chosen at launch: 32, 64, 128 or 256.
// The plan's default is 64, which spreads a main-path lookup over 72 SMs.
// Measured at all four on the main table (tools/probe_timing.py, PERF.md
// §6): warm, 64 ties 32 at 4,608 queries and is the fastest at 36,864, and
// 256 is 0.2 us slower at both; cold, all four within 0.1 us.
//
// Calls launch(std::integral_constant<int, kThreads>{}) for threads ==
// kThreads and returns true; returns false, launching nothing, for any
// other value (the launchers then return cudaErrorInvalidValue: a block
// size is never rounded to a neighbour).
template <class Launch>
inline bool dispatch_threads(int threads, Launch&& launch) {
  switch (threads) {
    case 32:
      launch(std::integral_constant<int, 32>{});
      return true;
    case 64:
      launch(std::integral_constant<int, 64>{});
      return true;
    case 128:
      launch(std::integral_constant<int, 128>{});
      return true;
    case 256:
      launch(std::integral_constant<int, 256>{});
      return true;
    default:
      return false;
  }
}

// kVec > 0: B == 4 * kVec and both pools' bases are 16-byte aligned (the
// launcher checks), so a row's keys and its values are kVec int4 loads each,
// all issued together. kVec == 0: any B, slot by slot, the value after the
// match.
template <int kVec>
__device__ __forceinline__ void probe_row(const int32_t* __restrict__ pool_keys,
                                          const int32_t* __restrict__ pool_vals,
                                          int32_t bucket, int B, int32_t q,
                                          uint8_t* found, int32_t* val) {
  const int64_t row = static_cast<int64_t>(bucket) * B;
  bool hit = false;
  int32_t v = -1;
  if constexpr (kVec > 0) {
    const int4* rk = reinterpret_cast<const int4*>(pool_keys + row);
    const int4* rv = reinterpret_cast<const int4*>(pool_vals + row);
    int4 k[kVec], x[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      k[j] = __ldg(rk + j);
      x[j] = __ldg(rv + j);
    }
    // last slot first, so that the first matching slot has the last word
    auto pick = [&](int32_t key, int32_t value) {
      if (key == q) {
        hit = true;
        v = value;
      }
    };
#pragma unroll
    for (int j = kVec - 1; j >= 0; --j) {
      pick(k[j].w, x[j].w);
      pick(k[j].z, x[j].z);
      pick(k[j].y, x[j].y);
      pick(k[j].x, x[j].x);
    }
    hit = hit && q != kEmptyKey;
  } else if (q != kEmptyKey) {
    int slot = -1;
    for (int s = B - 1; s >= 0; --s)
      if (__ldg(pool_keys + row + s) == q) slot = s;
    hit = slot >= 0;
    if (hit) v = __ldg(pool_vals + row + slot);
  }
  *found = hit;
  *val = hit ? v : -1;
}

// Calls launch(std::integral_constant<int, kVec>{}) with the row path the
// pools allow: vector rows for B in {4, 8, 16, 32} on 16-byte-aligned
// bases (faster than slot by slot at each of these B, PERF.md §6), the
// slot-by-slot path otherwise (another B, or a pool that is a view at an
// odd offset).
template <class Launch>
inline void dispatch_rows(const void* pool_keys, const void* pool_vals, int B,
                          Launch&& launch) {
  const bool aligned = (reinterpret_cast<uintptr_t>(pool_keys) |
                        reinterpret_cast<uintptr_t>(pool_vals)) % 16 == 0;
  if (aligned && B == 4)
    launch(std::integral_constant<int, 1>{});
  else if (aligned && B == 8)
    launch(std::integral_constant<int, 2>{});
  else if (aligned && B == 16)
    launch(std::integral_constant<int, 4>{});
  else if (aligned && B == 32)
    launch(std::integral_constant<int, 8>{});
  else
    launch(std::integral_constant<int, 0>{});
}

}  // namespace repro_torch
