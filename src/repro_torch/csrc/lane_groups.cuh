// The grouping core shared by the table's two apply kernels (fused_apply.cu,
// grouped_apply.cu): one thread block takes a chunk of lanes, orders the
// active ones by bucket in shared memory, stably, and lets the first lane of
// each bucket's run apply the run's ops in lane order with the row's keys in
// registers (bucket_row.cuh).
//
// Per chunk, in dynamic shared memory:
//
//   1. load    (the kernel's own code) each lane's kind, key, value and
//              bucket id, with coalesced loads, and its group key: one value
//              per bucket, below 2**key_bits - 1, or kIdleKey for an idle or
//              padding lane. grouped_apply takes the bucket id itself;
//              fused_apply, whose bucket ids span more bits than its
//              1,024-lane chunk needs, compacts them first through a
//              LeaderTable (below).
//   2. sort    a block-wide stable radix sort (cub::BlockRadixSort, LSD, so
//              equal keys keep their input order) of the lane indices on the
//              low key_bits bits of the group key, 4 bits a pass. Each
//              bucket's lanes end up in one run, in lane order; idle lanes,
//              whose key is all ones in those bits, last.
//   3. apply   the thread at a run's first position owns the run's row:
//              it loads the row, applies the run's ops in order (apply_op,
//              bucket_row.cuh), writes each lane's status at the lane's own
//              index in shared memory and writes the row's changed slots
//              back once. A run of one op is one apply_op with no walk,
//              which is almost every op at the table's usual fill.
//
// Total work is O(n log n) in the chunk's lanes (the sort, a fixed number
// of passes); the longest serial part is the longest run (every lane on one
// bucket: one walk of the chunk, with nothing quadratic before it).
// Distinct buckets never share a row owner, so no row needs a lock.
//
// Chunks of one batch run one after another, in lane order, inside the same
// block: a bucket whose ops span a chunk border sees the earlier chunk's
// ops first, as index order requires. Why one block suffices at these
// widths: a 4,096-lane chunk's ops and sort scratch fit in one SM's shared
// memory, and the work is a few hundred KB of traffic (ops, statuses, one
// key-row read per bucket, the changed slots written), too little to need
// the card's bandwidth. What one SM does bound is the rate at which its
// owners gather rows (hence bucket_row.cuh's key-only, 16-byte row loads)
// and the sort's barriers. Spreading one batch over blocks would need the
// grouping to be global: a device-wide sort (what the PyTorch sort around
// the earlier grouped kernel did, at 14 times the kernel's time), or a
// cluster of blocks sharing the sorted runs in distributed shared memory,
// the Hopper route if one SM's gathers come to bound the kernel.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <cub/block/block_radix_sort.cuh>

#include "bucket_row.cuh"

namespace repro_torch {

constexpr int ceil_log2(int x) {
  int b = 0;
  while ((1 << b) < x) ++b;
  return b;
}

constexpr uint32_t kIdleKey = 0xFFFFFFFFu;  // sorts after every group key

template <int kThreads, int kItems>
struct LaneGroups {
  static constexpr int kChunk = kThreads * kItems;
  using Sort = cub::BlockRadixSort<uint32_t, kThreads, kItems, uint32_t>;

  struct Shared {
    typename Sort::TempStorage sort;
    int32_t kind[kChunk];
    int32_t key[kChunk];
    int32_t val[kChunk];
    int32_t bid[kChunk];
    int32_t status[kChunk];
    uint32_t run_key[kChunk];   // group key; sorted in place
    uint32_t run_lane[kChunk];  // lane index, in the sorted order
  };

  // Steps 2 and 3. On entry, after a __syncthreads(): run_key[i] for every
  // i < kChunk, and kind/key/val/bid of every lane whose key is not
  // kIdleKey. On return, after a __syncthreads(): status[i] of every such
  // lane, the pools updated.
  template <class Row>
  __device__ static void apply_runs(Shared& s, int key_bits, int B,
                                    int32_t* __restrict__ pool_keys,
                                    int32_t* __restrict__ pool_vals) {
    const int first = threadIdx.x * kItems;
    uint32_t keys[kItems], lanes[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      keys[j] = s.run_key[first + j];
      lanes[j] = first + j;
    }
    Sort(s.sort).Sort(keys, lanes, 0, key_bits);
    __syncthreads();  // every run_key read before it is overwritten
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      s.run_key[first + j] = keys[j];
      s.run_lane[first + j] = lanes[j];
    }
    __syncthreads();

    for (int p = threadIdx.x; p < kChunk; p += kThreads) {
      const uint32_t group = s.run_key[p];
      if (group == kIdleKey) break;  // idle lanes sort last
      if (p > 0 && s.run_key[p - 1] == group) continue;  // not a run's head
      const int64_t base = static_cast<int64_t>(s.bid[s.run_lane[p]]) * B;
      Row row;
      row.load(pool_keys + base, pool_vals + base, B);
      int q = p;
      do {
        const uint32_t lane = s.run_lane[q];
        s.status[lane] =
            apply_op(row, B, s.kind[lane], s.key[lane], s.val[lane]);
      } while (++q < kChunk && s.run_key[q] == group);
      row.store(pool_keys + base, pool_vals + base, B);
    }
    __syncthreads();
  }
};

// Compact group keys for one chunk: each distinct bucket gets its own slot
// of an open-addressing table (atomicCAS on the bucket id, linear probing;
// twice the chunk's slots, so at most half full), and the slot, below
// kSlots, is the lane's group key, over kBits + 1 bits. Worth it where a
// chunk is small against the bucket-id range: fused_apply's 1,024 lanes
// sort in 3 passes of 4 bits on 12-bit slots instead of 6 on a 2**20-row
// pool's 21-bit ids, and 1,024 inserts cost less than 3 passes. At 4,096
// lanes the inserts cost more than the passes they save, so grouped_apply
// sorts on bucket ids.
template <int kChunk>
struct LeaderTable {
  static constexpr int kBits = ceil_log2(2 * kChunk);
  static constexpr int kSlots = 1 << kBits;
  static constexpr int kKeyBits = kBits + 1;
  int32_t bucket[kSlots];  // -1 if free

  __device__ void clear(int threads) {
    for (int t = threadIdx.x; t < kSlots; t += threads) bucket[t] = -1;
  }

  // The slot of bucket b (>= 0), claimed if it is new.
  __device__ uint32_t insert(int32_t b) {
    uint32_t t = (static_cast<uint32_t>(b) * 2654435761u) >> (32 - kBits);
    while (true) {
      const int32_t prev = atomicCAS(&bucket[t], -1, b);
      if (prev == -1 || prev == b) return t;
      t = (t + 1) & (kSlots - 1);
    }
  }
};

// Opens the kernel's dynamic shared memory past the default 48 KB.
template <class Kernel>
cudaError_t open_shared_memory(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro_torch
