// fused_probe: hash -> directory route -> bucket probe, one thread per query.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/lookup.py: fused_probe
// (_fused_probe_kernel + _probe_tile) for dmax <= 17, and above that the
// route in XLA plus the unfused probe (_probe_kernel), which is what the JAX
// package runs at dmax 20. On the TPU a gather has to be a one-hot
// contraction on the MXU, with the directory chunked through VMEM, 16-bit
// halves for fp32 exactness and the dmax <= 17 cap. None of that carries
// over: here each thread gathers directly, at any dmax.
//
// What bounds it on the H100: random 32-byte sectors from device memory.
// Per query the thread reads its directory entry (4 MiB at dmax = 20, which
// stays in the 50 MB L2), the 8-key row of its bucket (B = 8 int32 = one
// 32-byte sector, read as two 16-byte loads) and, on a hit, one value.
// There is no reuse to stage in shared memory, so the design keeps every
// access a single sector and enough queries in flight to hide latency.
//
// Contract (kernels/lookup.py::fused_probe_plain): found = any slot of the
// routed row equals the query, and an EMPTY query never matches; val = the
// first matching slot's value, -1 on a miss.
#include <cuda_runtime.h>

#include <cstdint>

#include "hash_route.cuh"

namespace {

using repro_torch::kEmptyKey;

template <bool kRow8>
__global__ void fused_probe_kernel(const int32_t* __restrict__ dir,
                                   const int32_t* __restrict__ queries,
                                   const int32_t* __restrict__ pool_keys,
                                   const int32_t* __restrict__ pool_vals,
                                   uint8_t* __restrict__ found,
                                   int32_t* __restrict__ vals, int n, int B,
                                   int dmax, int hash_id, int hash_shift) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t q = queries[i];
  const int64_t row = static_cast<int64_t>(
      repro_torch::route(dir, q, dmax, hash_id, hash_shift)) * B;
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
  found[i] = slot >= 0;
  vals[i] = slot >= 0 ? __ldg(pool_vals + row + slot) : -1;
}

}  // namespace

// Pointers are device pointers; stream is a cudaStream_t. Returns the
// cudaError_t of the launch (0 = cudaSuccess).
extern "C" int fused_probe_launch(const void* dir, const void* queries,
                                  const void* pool_keys, const void* pool_vals,
                                  void* found, void* vals, int n, int B,
                                  int dmax, int hash_id, int hash_shift,
                                  void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const int32_t*>(dir);
  const auto* q = static_cast<const int32_t*>(queries);
  const auto* pk = static_cast<const int32_t*>(pool_keys);
  const auto* pv = static_cast<const int32_t*>(pool_vals);
  auto* f = static_cast<uint8_t*>(found);
  auto* v = static_cast<int32_t*>(vals);
  // the 16-byte row loads need 32-byte rows on a 16-byte-aligned base
  const bool row8 = B == 8 && reinterpret_cast<uintptr_t>(pk) % 16 == 0;
  if (row8)
    fused_probe_kernel<true><<<blocks, threads, 0, s>>>(
        d, q, pk, pv, f, v, n, B, dmax, hash_id, hash_shift);
  else
    fused_probe_kernel<false><<<blocks, threads, 0, s>>>(
        d, q, pk, pv, f, v, n, B, dmax, hash_id, hash_shift);
  return static_cast<int>(cudaGetLastError());
}
