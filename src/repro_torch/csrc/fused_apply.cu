// fused_apply: the table's whole fast-path write transaction in one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/apply.py::fused_apply
// (_fused_apply_kernel). The TPU kernel is one program with one serial loop
// over the lanes, hiding HBM latency by double-buffered DMA of each lane's
// bucket row, bounded by VMEM to dmax <= 17, 2**17 pool rows and 512 lanes.
// Here one thread block of 512 threads runs a transaction of n <= 1024
// lanes (one 1,024-lane chunk of the grouping core, two lanes a thread) at
// any dmax and pool size, with rows of B <= 32 slots; wider transactions
// take grouped_apply.cu:
//
//   phase A   every lane at once: hash, directory route, frozen check;
//             idle and frozen lanes get their status here, active lanes'
//             ops and bucket ids go to shared memory, and each bucket gets
//             a slot of a leader table (lane_groups.cuh), the lane's
//             12-bit group key.
//   phase B   the grouping core (lane_groups.cuh, shared with
//             grouped_apply.cu): a stable block radix sort of the lanes on
//             their group keys, 3 passes, then the first lane of each
//             bucket's run applies the run's ops in lane order with the
//             row's keys in registers (bucket_row.cuh: the full test first,
//             ST_FULL even for a delete, as kernels/ref.py::fused_apply_ref)
//             and writes the row's changed slots back once, in place.
//             Distinct buckets proceed in parallel (design rule B); no two
//             run owners touch the same row, so no row needs a lock.
//
// The trash row (pool row P) is never written.
//
// What bounds it on the H100: latency, not bandwidth. A 512-lane batch
// must move a few tens of KB (ops, directory entries, each reached key row
// read once, each changed row written once), well under a microsecond of
// device-memory time; the launch, the dependent global reads of phase A,
// the sort's barriers and a run's row read take microseconds. The design
// keeps the serial part per bucket run (almost always one op), with no
// per-lane scan of the lane array, and keeps a row's keys in registers: at
// 512 threads a thread may hold 128 registers, so the 32-slot row does not
// spill.
//
// Contract (kernels/apply.py::fused_apply_plain): statuses TRUE / FALSE /
// ST_FULL / ST_FROZEN / ST_IDLE per lane, the routed bucket id of every
// lane, and the pools updated as if the lanes ran one by one in lane order.
#include <cuda_runtime.h>

#include <cstdint>

#include "bucket_row.cuh"
#include "hash_route.cuh"
#include "lane_groups.cuh"

namespace {

using repro_torch::kStFrozen;
using repro_torch::kStIdle;

constexpr int kThreads = 512;
constexpr int kItems = 2;  // lanes a thread: one 1,024-lane chunk
using Groups = repro_torch::LaneGroups<kThreads, kItems>;
using Table = repro_torch::LeaderTable<Groups::kChunk>;

struct Shared {
  Groups::Shared groups;
  Table table;
};

template <int kMaxB>
__global__ void __launch_bounds__(kThreads, 1)
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
  extern __shared__ __align__(16) unsigned char smem[];
  auto& sh = *reinterpret_cast<Shared*>(smem);
  auto& s = sh.groups;
  sh.table.clear(kThreads);

  // --- phase A: route, frozen check, idle/frozen statuses ----------------
  // Each step runs over the thread's lanes before the next, so that their
  // global loads are in flight together.
  int32_t kind[kItems], key[kItems], val[kItems], b[kItems];
  bool active[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = j * kThreads + threadIdx.x;
    kind[j] = i < n ? kinds[i] : 0;
    key[j] = i < n ? keys[i] : 0;
    val[j] = i < n ? values[i] : 0;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = j * kThreads + threadIdx.x;
    b[j] = i < n ? repro_torch::route(dir, key[j], dmax, hash_id, hash_shift)
                 : 0;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    active[j] = repro_torch::is_update(kind[j]) && !frozen[b[j]];
  }
  __syncthreads();  // the table is clear
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = j * kThreads + threadIdx.x;
    uint32_t group = repro_torch::kIdleKey;
    if (i < n) {
      bids[i] = b[j];
      if (active[j]) {
        s.kind[i] = kind[j];
        s.key[i] = key[j];
        s.val[i] = val[j];
        s.bid[i] = b[j];
        group = sh.table.insert(b[j]);
      } else {
        s.status[i] = kind[j] == 0 ? kStIdle : kStFrozen;
      }
    }
    s.run_key[i] = group;
  }
  __syncthreads();

  // --- phase B: bucket runs in lane order --------------------------------
  Groups::apply_runs<repro_torch::RegisterRow<kMaxB>>(s, Table::kKeyBits, B,
                                                      pool_keys, pool_vals);
  for (int i = threadIdx.x; i < n; i += kThreads) status[i] = s.status[i];
}

template <int kMaxB>
cudaError_t launch(const int32_t* d, const uint8_t* fr, const int32_t* kd,
                   const int32_t* ky, const int32_t* vl, int32_t* pk,
                   int32_t* pv, int32_t* st, int32_t* bd, int n, int B,
                   int dmax, int hash_id, int hash_shift, cudaStream_t s) {
  constexpr size_t bytes = sizeof(Shared);
  const cudaError_t e =
      repro_torch::open_shared_memory(fused_apply_kernel<kMaxB>, bytes);
  if (e != cudaSuccess) return e;
  fused_apply_kernel<kMaxB><<<1, kThreads, bytes, s>>>(
      d, fr, kd, ky, vl, pk, pv, st, bd, n, B, dmax, hash_id, hash_shift);
  return cudaGetLastError();
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
  if (n > Groups::kChunk || B < 1 || B > 32)
    return static_cast<int>(cudaErrorInvalidValue);
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
  const cudaError_t e =
      B <= 8 ? launch<8>(d, fr, kd, ky, vl, pk, pv, st, bd, n, B, dmax,
                         hash_id, hash_shift, s)
             : launch<32>(d, fr, kd, ky, vl, pk, pv, st, bd, n, B, dmax,
                          hash_id, hash_shift, s);
  return static_cast<int>(e);
}
