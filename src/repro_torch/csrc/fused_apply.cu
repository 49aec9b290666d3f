// fused_apply: the table's whole fast-path write transaction in one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/apply.py::fused_apply
// (_fused_apply_kernel). The TPU kernel is one program with one serial loop
// over the lanes, hiding HBM latency by double-buffered DMA of each lane's
// bucket row, bounded by VMEM to dmax <= 17, 2**17 pool rows and 512 lanes.
// Here one thread block of n_lanes threads (n <= 1024, B <= 32) runs the
// transaction at any dmax and pool size; wider transactions take
// grouped_apply.cu:
//
//   phase A   every lane at once: hash, directory route, frozen check,
//             active mask; ops and bucket ids go to shared memory.
//   phase A2  each active lane finds its bucket group's first lane (its
//             leader) through a shared open-addressing table keyed by
//             bucket id, with atomicMin on the group's leader slot.
//   phase B   each leader walks its group's lanes in lane order with the
//             bucket row in registers, applies the ops with the running
//             occupancy (bucket_row.cuh, the combine step grouped_apply.cu
//             shares: the full test first, ST_FULL even for a delete, as
//             kernels/ref.py::fused_apply_ref), writes each lane's status,
//             and writes the row back once, in place, if it changed. Distinct
//             buckets proceed in parallel (design rule B); no two leaders
//             touch the same row, so no row needs a lock.
//
// The trash row (pool row P) is never written.
//
// What bounds it on the H100: latency, not bandwidth. A 512-lane batch
// must move a few tens of KB (ops, directory entries, each reached key row
// read once, each changed row written once), well under a microsecond of
// device-memory time; the launch, the dependent global reads of phase A and
// the longest group's serial walk in phase B take microseconds. The design
// keeps the serial part per bucket group, not per batch, and keeps rows in
// registers.
//
// Contract (kernels/apply.py::fused_apply_plain): statuses TRUE / FALSE /
// ST_FULL / ST_FROZEN / ST_IDLE per lane, the routed bucket id of every
// lane, and the pools updated as if the lanes ran one by one in lane order.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "bucket_row.cuh"
#include "hash_route.cuh"

namespace {

using repro_torch::kStFrozen;
using repro_torch::kStIdle;

constexpr int kMaxLanes = 1024;   // one thread per lane, one block
constexpr int kTableBits = 11;    // leader table: 2048 slots >= 2 * lanes
constexpr int kTable = 1 << kTableBits;

template <int kMaxB>
__global__ void __launch_bounds__(kMaxLanes)
    fused_apply_kernel(const int32_t* __restrict__ dir,
                       const uint8_t* __restrict__ frozen,
                       const int32_t* __restrict__ kinds,
                       const int32_t* __restrict__ keys,
                       const int32_t* __restrict__ values,
                       int32_t* __restrict__ pool_keys,
                       int32_t* __restrict__ pool_vals,
                       int32_t* __restrict__ status,
                       int32_t* __restrict__ bids, int n, int B, int dmax,
                       int hash_id, int hash_shift) {
  __shared__ int32_t s_kind[kMaxLanes];
  __shared__ int32_t s_key[kMaxLanes];
  __shared__ int32_t s_val[kMaxLanes];
  __shared__ int32_t s_group[kMaxLanes];  // leader-table slot, -1 if idle
  __shared__ int32_t t_bid[kTable];
  __shared__ int32_t t_lead[kTable];

  const int i = threadIdx.x;
  for (int t = i; t < kTable; t += blockDim.x) {
    t_bid[t] = -1;
    t_lead[t] = INT_MAX;
  }

  // --- phase A: route, frozen check, idle/frozen statuses ----------------
  int32_t b = 0;
  bool active = false;
  if (i < n) {
    const int32_t kind = kinds[i];
    const int32_t key = keys[i];
    b = repro_torch::route(dir, key, dmax, hash_id, hash_shift);
    bids[i] = b;
    active = repro_torch::is_update(kind) && !frozen[b];
    if (!active) status[i] = kind == 0 ? kStIdle : kStFrozen;
    s_kind[i] = kind;
    s_key[i] = key;
    s_val[i] = values[i];
  }
  __syncthreads();

  // --- phase A2: one leader-table slot per bucket, first lane leads ------
  int group = -1;
  if (active) {
    int t = static_cast<int>((static_cast<uint32_t>(b) * 2654435761u) >>
                             (32 - kTableBits));
    while (true) {
      const int prev = atomicCAS(&t_bid[t], -1, b);
      if (prev == -1 || prev == b) break;
      t = (t + 1) & (kTable - 1);
    }
    atomicMin(&t_lead[t], i);
    group = t;
  }
  if (i < n) s_group[i] = group;
  __syncthreads();

  // --- phase B: leaders combine their groups in lane order ---------------
  if (!active || t_lead[group] != i) return;
  const int64_t base = static_cast<int64_t>(b) * B;
  repro_torch::RegisterRow<kMaxB> row;
  row.load(pool_keys + base, pool_vals + base, B);
  for (int j = i; j < n; ++j) {
    if (s_group[j] != group) continue;
    status[j] = repro_torch::apply_op(row, B, s_kind[j], s_key[j], s_val[j]);
  }
  row.store(pool_keys + base, pool_vals + base, B);
}

}  // namespace

// Pointers are device pointers; frozen is bool (one byte each); the pools
// are [P+1, B] int32 and are updated in place; stream is a cudaStream_t.
// Returns the cudaError_t of the launch (0 = cudaSuccess), or
// cudaErrorInvalidValue for a geometry outside 1 <= n <= 1024, 1 <= B <= 32.
extern "C" int fused_apply_launch(const void* dir, const void* frozen,
                                  const void* kinds, const void* keys,
                                  const void* values, void* pool_keys,
                                  void* pool_vals, void* status, void* bids,
                                  int n, int B, int dmax, int hash_id,
                                  int hash_shift, void* stream) {
  if (n <= 0) return 0;
  if (n > kMaxLanes || B < 1 || B > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (n + 31) / 32 * 32;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const int32_t*>(dir);
  const auto* fr = static_cast<const uint8_t*>(frozen);
  const auto* kd = static_cast<const int32_t*>(kinds);
  const auto* ky = static_cast<const int32_t*>(keys);
  const auto* vl = static_cast<const int32_t*>(values);
  auto* pk = static_cast<int32_t*>(pool_keys);
  auto* pv = static_cast<int32_t*>(pool_vals);
  auto* st = static_cast<int32_t*>(status);
  auto* bd = static_cast<int32_t*>(bids);
  if (B <= 8)
    fused_apply_kernel<8><<<1, threads, 0, s>>>(
        d, fr, kd, ky, vl, pk, pv, st, bd, n, B, dmax, hash_id, hash_shift);
  else
    fused_apply_kernel<32><<<1, threads, 0, s>>>(
        d, fr, kd, ky, vl, pk, pv, st, bd, n, B, dmax, hash_id, hash_shift);
  return static_cast<int>(cudaGetLastError());
}
