// probe: bucket probe of pre-routed queries, one thread per query.
//
// Replaces the Pallas TPU kernel src/repro/kernels/lookup.py::probe
// (_probe_kernel + _probe_tile), which the JAX package runs beyond its fused
// probe's bounds. The TPU kernel walks a grid of (query tile, pool chunk)
// and gathers each query's row by a one-hot MXU contraction over every pool
// chunk, in 16-bit halves for fp32 exactness; that cost grows with the pool.
// None of it carries over: here each thread reads its bucket id and gathers
// its row directly, whatever the pool's size.
//
// What bounds it on the H100: as in fused_probe.cu, the launch and a chain
// of dependent device-memory round trips, not bytes (a wide-path lookup of
// 36,864 queries moves 1.7 MB, 0.52 us at 3.35 TB/s), and at that width
// also the rate of random sectors. Per query the chain was three round
// trips: the bucket id and the query (two loads in one step), the key row,
// then one value. It is now two: the row probe (row_probe.cuh, shared with
// fused_probe.cu) reads the values beside the keys, and the launch uses the
// same blocks (64 threads by default, a launch argument). At 36,864
// queries the value sectors of misses cost what the round trip saves: the
// wider grid alone gains warm, and the
// kernel is slower cold than with the value read after the match
// (PERF.md §6).
//
// Contract (kernels/lookup.py::probe_plain): found = any slot of row
// bucket_ids[i] equals the query, and an EMPTY query never matches; val =
// the first matching slot's value, -1 on a miss. The Pallas kernel sums the
// values of the matching slots; the two agree while keys are distinct within
// a row, which the table guarantees.
#include <cuda_runtime.h>

#include <cstdint>

#include "row_probe.cuh"

namespace {

template <int kThreads, int kVec>
__global__ void __launch_bounds__(kThreads)
probe_kernel(
    const int32_t* __restrict__ bucket_ids,
    const int32_t* __restrict__ queries, const int32_t* __restrict__ pool_keys,
    const int32_t* __restrict__ pool_vals, uint8_t* __restrict__ found,
    int32_t* __restrict__ vals, int n, int B) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  repro_torch::probe_row<kVec>(pool_keys, pool_vals, __ldg(bucket_ids + i),
                                B, __ldg(queries + i), found + i, vals + i);
}

}  // namespace

// Pointers are device pointers; every bucket id names a pool row; threads
// is the block size (32, 64, 128 or 256); stream is a cudaStream_t. Returns
// the cudaError_t of the launch (0 = cudaSuccess), or cudaErrorInvalidValue
// for another block size.
extern "C" int probe_launch(const void* bucket_ids, const void* queries,
                            const void* pool_keys, const void* pool_vals,
                            void* found, void* vals, int n, int B,
                            int threads, void* stream) {
  if (!repro_torch::dispatch_threads(threads, [](auto) {}))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const int32_t*>(bucket_ids);
  const auto* q = static_cast<const int32_t*>(queries);
  const auto* pk = static_cast<const int32_t*>(pool_keys);
  const auto* pv = static_cast<const int32_t*>(pool_vals);
  auto* f = static_cast<uint8_t*>(found);
  auto* v = static_cast<int32_t*>(vals);
  repro_torch::dispatch_threads(threads, [&](auto t) {
    constexpr int kThreads = decltype(t)::value;
    const int blocks = (n + kThreads - 1) / kThreads;
    repro_torch::dispatch_rows(pk, pv, B, [&](auto vec) {
      probe_kernel<kThreads, decltype(vec)::value>
          <<<blocks, kThreads, 0, s>>>(b, q, pk, pv, f, v, n, B);
    });
  });
  return static_cast<int>(cudaGetLastError());
}
