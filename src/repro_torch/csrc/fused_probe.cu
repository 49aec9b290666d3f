// fused_probe: hash -> directory route -> bucket probe, one thread per query.
//
// Replaces the Pallas TPU kernel src/repro/kernels/lookup.py::fused_probe
// (_fused_probe_kernel + _probe_tile). On the TPU a gather has to be a
// one-hot contraction on the MXU, with the directory chunked through VMEM,
// 16-bit halves for fp32 exactness and a dmax <= 17 cap. None of that
// carries over: here each thread gathers directly, at any dmax.
//
// What bounds it on the H100: a chain of dependent device-memory round
// trips plus the launch, not bytes. A main-path lookup (4,608 queries)
// moves 216,576 B, 0.065 us at 3.35 TB/s, yet takes 0.8 us above the
// launch floor (1.1 us with the value read after the match; PERF.md §6).
// Per query the chain was four round trips: the query, its directory entry
// (the directory is 4 MiB at dmax = 20, which stays in the 50 MB L2, but 4
// GiB at dmax = 30, where the entry and the row both come from HBM), the
// 8-key row of its bucket and, only after the match, one value. It is now
// three: row_probe.cuh reads the row's values beside its keys and picks the
// match in registers, and the 64-thread blocks (the default; the block size
// is a launch argument) spread a lookup over 72 SMs instead of 18. The first
// two steps stay in series: the route needs the query's hash, the row
// needs the route.
//
// Contract (kernels/lookup.py::fused_probe_plain): found = any slot of the
// routed row equals the query, and an EMPTY query never matches; val = the
// first matching slot's value, -1 on a miss.
#include <cuda_runtime.h>

#include <cstdint>

#include "hash_route.cuh"
#include "row_probe.cuh"

namespace {

template <int kThreads, int kVec>
__global__ void __launch_bounds__(kThreads)
fused_probe_kernel(
    const int32_t* __restrict__ dir, const int32_t* __restrict__ queries,
    const int32_t* __restrict__ pool_keys,
    const int32_t* __restrict__ pool_vals, uint8_t* __restrict__ found,
    int32_t* __restrict__ vals, int n, int B, int dmax, int hash_id,
    int hash_shift) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t q = __ldg(queries + i);
  repro_torch::probe_row<kVec>(
      pool_keys, pool_vals,
      repro_torch::route(dir, q, dmax, hash_id, hash_shift), B, q, found + i,
      vals + i);
}

}  // namespace

// Pointers are device pointers; threads is the block size (32, 64, 128 or
// 256); stream is a cudaStream_t. Returns the cudaError_t of the launch
// (0 = cudaSuccess), or cudaErrorInvalidValue for another block size.
extern "C" int fused_probe_launch(const void* dir, const void* queries,
                                  const void* pool_keys, const void* pool_vals,
                                  void* found, void* vals, int n, int B,
                                  int dmax, int hash_id, int hash_shift,
                                  int threads, void* stream) {
  if (!repro_torch::dispatch_threads(threads, [](auto) {}))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const int32_t*>(dir);
  const auto* q = static_cast<const int32_t*>(queries);
  const auto* pk = static_cast<const int32_t*>(pool_keys);
  const auto* pv = static_cast<const int32_t*>(pool_vals);
  auto* f = static_cast<uint8_t*>(found);
  auto* v = static_cast<int32_t*>(vals);
  repro_torch::dispatch_threads(threads, [&](auto t) {
    constexpr int kThreads = decltype(t)::value;
    const int blocks = (n + kThreads - 1) / kThreads;
    repro_torch::dispatch_rows(pk, pv, B, [&](auto vec) {
      fused_probe_kernel<kThreads, decltype(vec)::value>
          <<<blocks, kThreads, 0, s>>>(d, q, pk, pv, f, v, n, B, dmax,
                                       hash_id, hash_shift);
    });
  });
  return static_cast<int>(cudaGetLastError());
}
