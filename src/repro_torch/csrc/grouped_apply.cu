// grouped_apply: combining apply of ops sorted by (bucket, lane), any width.
//
// Replaces the Pallas TPU kernel src/repro/kernels/apply.py::grouped_apply
// (_apply_kernel), which the JAX package runs beyond its fused apply's
// bounds. The TPU kernel cuts the pool into VMEM-sized ranges of rows, pads
// every range's ops to the batch width and walks them serially, one grid
// step per range. None of that carries over: here the ops need no grouping
// by pool range, and the kernel spreads over as many blocks as the batch
// needs, with no bound on its width.
//
// One thread per op. An op is active when its kind is insert or delete. A
// run is a maximal stretch of consecutive active ops on one bucket; an idle
// op ends a run and never reads or writes a row, whatever its bucket id (the
// table sorts idle lanes last with their real bucket ids, so a bucket may
// show up as a live run and again among the idle lanes). The thread of a
// run's first op owns the run's row: it walks the run in index order with
// the row in registers (B <= 32; wider rows it works on in device memory,
// which it alone touches), applies each op with the combine step fused
// apply uses (bucket_row.cuh: the full test first, ST_FULL even for a
// delete), writes each op's status, and writes the row back once, only the
// halves that changed. Distinct buckets proceed in parallel (design rule B).
//
// Precondition: the active ops of one bucket are consecutive (the (bucket,
// lane) sort gives that), or two threads would own one row. The plain
// version (kernels/apply.py::grouped_apply_plain) has no such precondition.
//
// What bounds it on the H100: latency. A 4,096-op batch moves a few hundred
// KB (ops, statuses, one key-row read per bucket reached, the changed rows
// written), about 0.1 us of device-memory time; the launch, the dependent
// reads at a run's start and the longest run's serial walk take
// microseconds. A hot bucket makes one long serial run.
//
// Contract (kernels/ref.py::apply_ref): statuses TRUE / FALSE / ST_FULL /
// ST_IDLE (int8), and the pools updated as if the ops ran one by one in
// index order. The trash row is never written.
#include <cuda_runtime.h>

#include <cstdint>

#include "bucket_row.cuh"

namespace {

using repro_torch::is_update;

template <class Row>
__global__ void grouped_apply_kernel(const int32_t* __restrict__ kinds,
                                     const int32_t* __restrict__ keys,
                                     const int32_t* __restrict__ values,
                                     const int32_t* __restrict__ bucket_ids,
                                     int32_t* __restrict__ pool_keys,
                                     int32_t* __restrict__ pool_vals,
                                     int8_t* __restrict__ status, int m,
                                     int B) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  if (!is_update(kinds[i])) {
    status[i] = repro_torch::kStIdle;
    return;
  }
  const int32_t b = bucket_ids[i];
  if (i > 0 && is_update(kinds[i - 1]) && bucket_ids[i - 1] == b)
    return;  // not the first op of its run: the run's owner applies it
  const int64_t base = static_cast<int64_t>(b) * B;
  Row row;
  row.load(pool_keys + base, pool_vals + base, B);
  for (int j = i; j < m; ++j) {
    const int32_t kind = kinds[j];
    if (!is_update(kind) || bucket_ids[j] != b) break;
    status[j] = static_cast<int8_t>(
        repro_torch::apply_op(row, B, kind, keys[j], values[j]));
  }
  row.store(pool_keys + base, pool_vals + base, B);
}

template <class Row>
void launch(const int32_t* kd, const int32_t* ky, const int32_t* vl,
            const int32_t* bd, int32_t* pk, int32_t* pv, int8_t* st, int m,
            int B, cudaStream_t s) {
  const int threads = 256;
  const int blocks = (m + threads - 1) / threads;
  grouped_apply_kernel<Row><<<blocks, threads, 0, s>>>(kd, ky, vl, bd, pk, pv,
                                                       st, m, B);
}

}  // namespace

// Pointers are device pointers; the ops are i32[m], each active op's bucket
// id names a pool row; the pools are [rows, B] int32 and are updated in
// place; status is int8[m]; stream is a cudaStream_t. Returns the
// cudaError_t of the launch (0 = cudaSuccess), or cudaErrorInvalidValue for
// B < 1.
extern "C" int grouped_apply_launch(const void* kinds, const void* keys,
                                    const void* values, const void* bucket_ids,
                                    void* pool_keys, void* pool_vals,
                                    void* status, int m, int B, void* stream) {
  if (m <= 0) return 0;
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* kd = static_cast<const int32_t*>(kinds);
  const auto* ky = static_cast<const int32_t*>(keys);
  const auto* vl = static_cast<const int32_t*>(values);
  const auto* bd = static_cast<const int32_t*>(bucket_ids);
  auto* pk = static_cast<int32_t*>(pool_keys);
  auto* pv = static_cast<int32_t*>(pool_vals);
  auto* st = static_cast<int8_t*>(status);
  if (B <= 8)
    launch<repro_torch::RegisterRow<8>>(kd, ky, vl, bd, pk, pv, st, m, B, s);
  else if (B <= 32)
    launch<repro_torch::RegisterRow<32>>(kd, ky, vl, bd, pk, pv, st, m, B, s);
  else
    launch<repro_torch::MemoryRow>(kd, ky, vl, bd, pk, pv, st, m, B, s);
  return static_cast<int>(cudaGetLastError());
}
