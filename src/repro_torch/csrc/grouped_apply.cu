// grouped_apply: combining apply of ops in any order, any width.
//
// Replaces the Pallas TPU kernel src/repro/kernels/apply.py::grouped_apply
// (_apply_kernel), which the JAX package runs beyond its fused apply's
// bounds. The TPU kernel takes ops sorted by bucket, cuts the pool into
// VMEM-sized ranges of rows, pads every range's ops to the batch width and
// walks them serially, one grid step per range. None of that carries over:
// here the ops come in lane order, unsorted, and the kernel groups them
// itself.
//
// One thread block of 512 threads works through the batch in chunks of
// 1,024, 2,048 or 4,096 lanes (2, 4 or 8 lanes a thread; the chunk is a
// launch argument, 4,096 by default), one chunk after another in lane
// order, with
// the grouping core it shares with fused_apply.cu (lane_groups.cuh): the
// chunk's ops go to shared memory with coalesced loads; a stable block
// radix sort on each active op's bucket id (as many bits as the pool's row
// count needs: 21, 6 passes, for 2**20 + 1 rows) puts every bucket's ops in
// one run, in lane order; the thread at a run's head walks the run with the
// row's keys in registers (B <= 32; wider rows it works on in device
// memory, which it alone touches), applies each op with the combine step
// fused apply uses (bucket_row.cuh: the full test first, ST_FULL even for a
// delete) and writes the row's changed slots back once. An idle op never
// reads or writes a row, whatever its bucket id. A bucket whose ops span
// two chunks sees the earlier chunk's first, so the result is index order
// across the whole batch.
//
// What bounds it on the H100: one SM. A 4,096-op batch moves a few hundred
// KB (ops, statuses, one key-row read per bucket reached, the changed slots
// written), about 0.1 us of device-memory time; the sort's barriers and the
// owners' row gathers, all from one SM, take microseconds, and a hot
// bucket makes one long serial run. lane_groups.cuh says why one block
// suffices at these widths, and what the route past it is.
//
// Contract (kernels/ref.py::apply_ref): statuses TRUE / FALSE / ST_FULL /
// ST_IDLE (int8), and the pools updated as if the ops ran one by one in
// index order. The trash row is never written.
#include <cuda_runtime.h>

#include <cstdint>

#include "bucket_row.cuh"
#include "lane_groups.cuh"

namespace {

using repro_torch::is_update;

constexpr int kThreads = 512;

// kItems lanes a thread: chunks of 512 * kItems lanes. A chunk sorts all of
// its lanes, padding included, and its shared memory (7 words a lane plus
// the sort's storage) shrinks with it.
template <int kItems, class Row>
__global__ void __launch_bounds__(kThreads, 1)
    grouped_apply_kernel(const int32_t* __restrict__ kinds,
                         const int32_t* __restrict__ keys,
                         const int32_t* __restrict__ values,
                         const int32_t* __restrict__ bucket_ids,
                         int32_t* __restrict__ pool_keys,
                         int32_t* __restrict__ pool_vals,
                         int8_t* __restrict__ status, int m, int B,
                         int key_bits) {
  using Groups = repro_torch::LaneGroups<kThreads, kItems>;
  extern __shared__ __align__(16) unsigned char smem[];
  auto& s = *reinterpret_cast<typename Groups::Shared*>(smem);

  for (int base = 0; base < m; base += Groups::kChunk) {
    const int n = min(Groups::kChunk, m - base);
    // all of the thread's loads first, so that they are in flight together
    int32_t kind[kItems], key[kItems], val[kItems], b[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = j * kThreads + threadIdx.x;
      const bool in = i < n;
      kind[j] = in ? kinds[base + i] : 0;
      key[j] = in ? keys[base + i] : 0;
      val[j] = in ? values[base + i] : 0;
      b[j] = in ? bucket_ids[base + i] : 0;
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = j * kThreads + threadIdx.x;
      uint32_t group = repro_torch::kIdleKey;
      if (is_update(kind[j])) {
        s.kind[i] = kind[j];
        s.key[i] = key[j];
        s.val[i] = val[j];
        s.bid[i] = b[j];
        group = static_cast<uint32_t>(b[j]);
      } else if (i < n) {
        s.status[i] = repro_torch::kStIdle;
      }
      s.run_key[i] = group;
    }
    __syncthreads();
    Groups::template apply_runs<Row>(s, key_bits, B, pool_keys, pool_vals);
    for (int i = threadIdx.x; i < n; i += kThreads)
      status[base + i] = static_cast<int8_t>(s.status[i]);
    __syncthreads();  // the next chunk overwrites the shared arrays
  }
}

template <int kItems, class Row>
cudaError_t launch(const int32_t* kd, const int32_t* ky, const int32_t* vl,
                   const int32_t* bd, int32_t* pk, int32_t* pv, int8_t* st,
                   int m, int B, int key_bits, cudaStream_t s) {
  constexpr size_t bytes =
      sizeof(typename repro_torch::LaneGroups<kThreads, kItems>::Shared);
  const cudaError_t e = repro_torch::open_shared_memory(
      grouped_apply_kernel<kItems, Row>, bytes);
  if (e != cudaSuccess) return e;
  grouped_apply_kernel<kItems, Row><<<1, kThreads, bytes, s>>>(
      kd, ky, vl, bd, pk, pv, st, m, B, key_bits);
  return cudaGetLastError();
}

// The row type for B: keys in registers up to 32 slots, else in memory.
template <int kItems>
cudaError_t launch_rows(const int32_t* kd, const int32_t* ky,
                        const int32_t* vl, const int32_t* bd, int32_t* pk,
                        int32_t* pv, int8_t* st, int m, int B, int key_bits,
                        cudaStream_t s) {
  if (B <= 8)
    return launch<kItems, repro_torch::RegisterRow<8>>(kd, ky, vl, bd, pk, pv,
                                                       st, m, B, key_bits, s);
  if (B <= 32)
    return launch<kItems, repro_torch::RegisterRow<32>>(
        kd, ky, vl, bd, pk, pv, st, m, B, key_bits, s);
  return launch<kItems, repro_torch::MemoryRow>(kd, ky, vl, bd, pk, pv, st, m,
                                                B, key_bits, s);
}

}  // namespace

// Pointers are device pointers; the ops are i32[m] in any order, each active
// op's bucket id names a pool row below `rows`; the pools are [rows, B]
// int32 and are updated in place; status is int8[m]; chunk is the lanes a
// chunk (1,024, 2,048 or 4,096); stream is a cudaStream_t. Returns the
// cudaError_t of the launch (0 = cudaSuccess), or cudaErrorInvalidValue for
// another chunk, B < 1 or rows < 1.
extern "C" int grouped_apply_launch(const void* kinds, const void* keys,
                                    const void* values, const void* bucket_ids,
                                    void* pool_keys, void* pool_vals,
                                    void* status, int m, int B, int rows,
                                    int chunk, void* stream) {
  if (chunk != 1024 && chunk != 2048 && chunk != 4096)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0) return 0;
  if (B < 1 || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  // every bucket id is below rows < 2**key_bits, so below the idle key's
  // all-ones low key_bits bits
  int key_bits = 1;
  while ((int64_t{1} << key_bits) <= rows) ++key_bits;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* kd = static_cast<const int32_t*>(kinds);
  const auto* ky = static_cast<const int32_t*>(keys);
  const auto* vl = static_cast<const int32_t*>(values);
  const auto* bd = static_cast<const int32_t*>(bucket_ids);
  auto* pk = static_cast<int32_t*>(pool_keys);
  auto* pv = static_cast<int32_t*>(pool_vals);
  auto* st = static_cast<int8_t*>(status);
  cudaError_t e;
  if (chunk == 1024)
    e = launch_rows<2>(kd, ky, vl, bd, pk, pv, st, m, B, key_bits, s);
  else if (chunk == 2048)
    e = launch_rows<4>(kd, ky, vl, bd, pk, pv, st, m, B, key_bits, s);
  else
    e = launch_rows<8>(kd, ky, vl, bd, pk, pv, st, m, B, key_bits, s);
  return static_cast<int>(e);
}
