// resize_apply: the ST_FULL slow path of a kernel write transaction, the
// bounded split rounds of core/table.py::apply_batch, in one launch.
//
// Replaces no TPU kernel: the JAX package runs this path as jnp code
// (src/repro/core/table.py::apply_batch), and so did the port, as PyTorch.
// What bounded it on the H100 was not bytes but the host: a call for ten
// ST_FULL lanes dispatched some 580 PyTorch operations and 15 host syncs
// (the pending and wave counts it read to steer its loops, the scalar index
// writes of the splits), and several of its passes ran over the whole pool
// or directory (a sort over the P+1 bucket ids, maps of P+1 entries, a
// rewrite of all 2**dmax directory entries). Here one thread block runs
// every round on the device with no host round trip, and its work is the
// pending lanes, the buckets it splits and their directory ranges.
//
// Contract: the result of apply_batch(cfg, state, ops) where ops are the
// ST_FULL lanes of a fused_apply / grouped_apply transaction, every other
// lane NOP (kernels/ops.py::_finish_kernel_apply), field by field and
// status by status. On such a batch the plain transaction's fast pass
// applies nothing (the lanes are the suffixes of their bucket groups, on
// buckets at counts == B), so the kernel does not run it; it completes only
// what the fast pass would: ops whose destination is frozen.
//
// The block (512 threads; the lane lists in dynamic shared memory, or in
// the wrapper's scratch where n is too wide) takes the fresh lanes in lane
// order into an entry list, then runs at most `rounds` rounds of
// [split, wave] (or [wave, split] under use_fast_path=False):
//
//   split  route the pending entries, sort them by (bucket, entry) with a
//          bitonic sort, and take each bucket once, ascending: a bucket that
//          is live, not frozen and at counts == B is split, or, at depth
//          dmax, gives its ops OVERFLOW and sets error. Child pairs come off
//          the free stack, then the watermark (_alloc_pairs; ids past the
//          pool clamp to the trash row and set error); a warp a parent moves
//          its items by the child bit in slot order; the parents retire onto
//          the free stack in the same order; only each parent's own
//          directory range is rewritten, the lower half to child 0.
//   wave   route again, complete ops on frozen buckets, sort by (bucket,
//          entry) and let the first entry of each bucket's run apply the
//          run's ops in lane order on the row (bucket_row.cuh: the full test
//          first); an op that meets a full row stays pending, and so do the
//          run's later ops.
//
// The trash row P takes what the plain passes write there when a pass has
// masked entries (bdepth + 1, bprefix * 2 + 1, free_stack[P] = P, counts
// and live cleared); the kernel never writes the trash row's slots. So an
// op routed to the trash row (a directory range whose children clamped to
// P when the pool ran out) is never applied: it stays PENDING and the call
// ends with error set. Here the plain passes differ: they apply such ops to
// row P, which every pass also overwrites with its masked entries' writes
// (in no fixed order on the card), and report them applied though their
// items are lost.
//
// What bounds it on the H100: latency. Ten ST_FULL lanes move a few KB; the
// block's barriers (a bitonic sort of m entries takes log2(m)(log2(m)+1)/2
// of them) and its dependent reads of directory entries, bucket rows and
// the free stack take microseconds. A split's directory range is 2**(dmax -
// depth) entries, spread over every thread.
#include <cuda_runtime.h>

#include <cstdint>

#include "bucket_row.cuh"
#include "hash_route.cuh"

namespace {

using repro_torch::kEmptyKey;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kNop = 0;
constexpr int kIns = 1;
// core/table.py's statuses
constexpr int kPending = -1;
constexpr int kFrozen = -2;
constexpr int kOverflow = -3;
constexpr uint64_t kPad = ~uint64_t{0};  // sorts after every (bucket, entry)
// the entry lists stay in shared memory up to this many bytes
constexpr size_t kMaxShared = 200 * 1024;

// Device pointers, in the order of the launcher's pointer array.
enum Ptr : int {
  kDir, kKeys, kVals, kBdepth, kBprefix, kLive, kFrozenP, kFreeStack,
  kCounts, kDepthIn, kNallocIn, kFreeTopIn, kErrorIn, kAppliedSeqIn,
  kLastStatusIn, kKind, kKey, kVal, kSeq, kStatus, kAppliedSeq,
  kLastStatus, kDepth, kNalloc, kFreeTop, kError, kStats, kScratch,
  kNumPtrs
};

struct Args {
  int32_t* dir;
  int32_t* keys;
  int32_t* vals;
  int32_t* bdepth;
  int32_t* bprefix;
  uint8_t* live;
  uint8_t* frozen;
  int32_t* free_stack;
  int32_t* counts;
  const int32_t* depth_in;
  const int32_t* nalloc_in;
  const int32_t* free_top_in;
  const uint8_t* error_in;
  const int32_t* applied_seq_in;
  const int8_t* last_status_in;
  const int32_t* kind;
  const int32_t* key;
  const int32_t* val;
  const int32_t* seq;
  int8_t* status;
  int32_t* applied_seq;
  int8_t* last_status;
  int32_t* depth;
  int32_t* nalloc;
  int32_t* free_top;
  uint8_t* error;
  int32_t* stats;  // rounds, waves, splits
  int n, B, P, dmax, hash_id, hash_shift, rounds, fast_order;
};

// The entry lists, carved from one workspace: the sort buffer first (8-byte
// words), then the 32-bit lists. Entry e is the e-th fresh lane in lane
// order; act lists the pending entries.
struct Lists {
  uint64_t* srt;   // [pow2_sz(n)] (bucket << 32 | entry), sorted
  int32_t* lane;   // [n] entry -> lane
  int32_t* key;    // [n]
  int32_t* kind;   // [n]
  int32_t* val;    // [n]
  int32_t* act;    // [n] pending entries
  int32_t* act2;   // [n] compaction target
  int32_t* par;    // [n] split parents, ascending
  int32_t* range;  // [n] their directory ranges' offsets
  int32_t* cid;    // [2n] child ids

  __host__ __device__ static size_t bytes(int n) {
    return sizeof(uint64_t) * static_cast<size_t>(pow2_sz(n)) +
           sizeof(int32_t) * 10 * static_cast<size_t>(n);
  }
  __host__ __device__ static int pow2_sz(int n) {
    int p = 1;
    while (p < n) p <<= 1;
    return p;
  }
  __device__ static Lists carve(unsigned char* base, int n) {
    Lists l;
    l.srt = reinterpret_cast<uint64_t*>(base);
    auto* w =
        reinterpret_cast<int32_t*>(base + sizeof(uint64_t) * pow2_sz(n));
    l.lane = w;
    l.key = w + n;
    l.kind = w + 2 * n;
    l.val = w + 3 * n;
    l.act = w + 4 * n;
    l.act2 = w + 5 * n;
    l.par = w + 6 * n;
    l.range = w + 7 * n;
    l.cid = w + 8 * n;
    return l;
  }
};

struct Shared {
  int warp[kWarps];
  int total;
  int m;  // pending entries
  int depth, nalloc, free_top, error;
  int new_depth, run_max;
  int rounds, waves, splits;
};

// Exclusive prefix sum of v over the block in thread order; `total` gets
// the block's sum. Every thread calls it; it ends with a barrier, so the
// next call may reuse the shared words.
__device__ __forceinline__ int block_scan(Shared& s, int v, int& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s.warp[w] = x;
  __syncthreads();
  if (w == 0) {
    const int own = lane < kWarps ? s.warp[lane] : 0;
    int t = own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, t, o);
      if (lane >= o) t += y;
    }
    if (lane < kWarps) s.warp[lane] = t - own;
    if (lane == kWarps - 1) s.total = t;
  }
  __syncthreads();
  const int out = x - v + s.warp[w];
  total = s.total;
  __syncthreads();
  return out;
}

// Ascending bitonic sort of a[0, n2), n2 a power of two, by the whole block.
__device__ void bitonic_sort(uint64_t* a, int n2) {
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n2; i += kThreads) {
        const int l = i ^ j;
        if (l > i) {
          const uint64_t x = a[i], y = a[l];
          if ((x > y) == ((i & k) == 0)) {
            a[i] = y;
            a[l] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

// The directory entry of a key. The directory is rewritten inside the
// kernel, so it is read with plain loads (route()'s __ldg reads through the
// non-coherent cache).
__device__ __forceinline__ int32_t dir_bucket(const Args& a, int32_t key) {
  const uint32_t h = repro_torch::table_hash(key, a.hash_id, a.hash_shift);
  return a.dir[h >> (32 - a.dmax)];
}

// Keep the pending entries whose lane is still PENDING, in order.
__device__ void compact(Shared& s, Lists& l, const Args& a) {
  const int m = s.m;
  int carry = 0;
  for (int base = 0; base < m; base += kThreads) {
    const int q = base + threadIdx.x;
    int e = 0;
    bool keep = false;
    if (q < m) {
      e = l.act[q];
      keep = a.status[l.lane[e]] == kPending;
    }
    int total;
    const int pos = block_scan(s, keep, total);
    if (keep) l.act2[carry + pos] = e;
    carry += total;
  }
  int32_t* t = l.act;
  l.act = l.act2;
  l.act2 = t;
  if (threadIdx.x == 0) s.m = carry;
  __syncthreads();
}

// Sort the pending entries by (bucket, entry); entries for which `skip`
// holds (given the bucket) get the pad key. Returns the padded length.
template <class Skip>
__device__ int sort_by_bucket(Shared& s, Lists& l, const Args& a,
                              Skip skip) {
  const int m = s.m;
  const int n2 = Lists::pow2_sz(m);
  for (int q = threadIdx.x; q < n2; q += kThreads) {
    uint64_t v = kPad;
    if (q < m) {
      const int e = l.act[q];
      const int32_t b = dir_bucket(a, l.key[e]);
      if (!skip(e, b))
        v = static_cast<uint64_t>(b) << 32 | static_cast<uint32_t>(e);
    }
    l.srt[q] = v;
  }
  __syncthreads();
  bitonic_sort(l.srt, n2);
  return n2;
}

__device__ __forceinline__ int32_t bucket_of(uint64_t v) {
  return static_cast<int32_t>(v >> 32);
}

// One split pass (core/table.py::_split_pass and _do_splits).
__device__ void split_pass(Shared& s, Lists& l, const Args& a) {
  const int m = s.m;
  const int B = a.B, P = a.P;
  sort_by_bucket(s, l, a, [](int, int32_t) { return false; });

  // full destinations: each bucket once (its run's head), ascending
  int k = 0;
  for (int base = 0; base < m; base += kThreads) {
    const int q = base + threadIdx.x;
    bool parent = false;
    int32_t b = 0;
    if (q < m) {
      const uint64_t v = l.srt[q];
      b = bucket_of(v);
      const bool needs = b != P && a.live[b] && !a.frozen[b] &&
                         a.counts[b] == B;
      if (needs && a.bdepth[b] >= a.dmax) {
        const int lane = l.lane[static_cast<uint32_t>(v)];
        a.status[lane] = kOverflow;
        a.applied_seq[lane] = a.seq[lane];
        s.error = 1;
      }
      parent = needs && a.bdepth[b] < a.dmax &&
               (q == 0 || bucket_of(l.srt[q - 1]) != b);
    }
    int total;
    const int pos = block_scan(s, parent, total);
    if (parent) l.par[k + pos] = b;
    k += total;
  }

  // child pairs: the free stack first, then the watermark (_alloc_pairs)
  const int top = s.free_top, nalloc = s.nalloc;
  for (int j = threadIdx.x; j < 2 * k; j += kThreads)
    l.cid[j] = j < top ? a.free_stack[top - 1 - j]
                       : min(nalloc + j - top, P);
  __syncthreads();
  const int pop = min(2 * k, top), grow = 2 * k - pop;
  const int top_after_pop = top - pop;
  if (threadIdx.x == 0) {
    if (nalloc + grow > P) s.error = 1;
    s.nalloc = min(nalloc + grow, P);
    s.new_depth = s.depth;
  }
  __syncthreads();

  // SplitBucket: a warp a parent redistributes its items by the child bit
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < k; r += kWarps) {
    const int32_t p = l.par[r];
    const int pd = a.bdepth[p], pp = a.bprefix[p];
    const int32_t id[2] = {l.cid[2 * r], l.cid[2 * r + 1]};
    int fill[2] = {0, 0};
    for (int c = 0; c < B; c += 32) {
      const int slot = c + lane;
      const int64_t src = static_cast<int64_t>(p) * B + slot;
      const int32_t kk = slot < B ? a.keys[src] : kEmptyKey;
      const int32_t vv = slot < B ? a.vals[src] : 0;
      const bool occ = kk != kEmptyKey;
      const int bit = occ ? (repro_torch::table_hash(kk, a.hash_id,
                                                     a.hash_shift) >>
                             (31 - pd)) & 1
                          : 0;
      const uint32_t below = (1u << lane) - 1;
#pragma unroll
      for (int c01 = 0; c01 < 2; ++c01) {
        const uint32_t mask =
            __ballot_sync(0xFFFFFFFFu, occ && bit == c01);
        if (occ && bit == c01 && id[c01] != P) {
          const int64_t dst = static_cast<int64_t>(id[c01]) * B +
                              fill[c01] + __popc(mask & below);
          a.keys[dst] = kk;
          a.vals[dst] = vv;
        }
        fill[c01] += __popc(mask);
      }
    }
#pragma unroll
    for (int c01 = 0; c01 < 2; ++c01) {
      if (id[c01] == P) continue;
      const int64_t row = static_cast<int64_t>(id[c01]) * B;
      for (int slot = fill[c01] + lane; slot < B; slot += 32) {
        a.keys[row + slot] = kEmptyKey;
        a.vals[row + slot] = 0;
      }
      if (lane == 0) {
        a.counts[id[c01]] = fill[c01];
        a.bdepth[id[c01]] = pd + 1;
        a.bprefix[id[c01]] =
            static_cast<int32_t>(static_cast<uint32_t>(pp) * 2u + c01);
        a.live[id[c01]] = 1;
        a.frozen[id[c01]] = 0;
      }
    }
    if (lane == 0) {
      l.range[r] = 1 << (a.dmax - pd);
      atomicMax(&s.new_depth, pd + 1);
    }
  }
  __syncthreads();

  // retire the parents onto the free stack, in order; the trash row takes
  // the masked entries' writes of the plain pass
  for (int r = threadIdx.x; r < k; r += kThreads) {
    const int32_t p = l.par[r];
    a.live[p] = 0;
    a.counts[p] = 0;
    a.free_stack[top_after_pop + r] = p;
  }
  if (threadIdx.x == 0) {
    if (k < a.n) {
      a.bdepth[P] += 1;
      a.bprefix[P] = static_cast<int32_t>(
          static_cast<uint32_t>(a.bprefix[P]) * 2u + 1u);
      a.free_stack[P] = P;
      a.frozen[P] = 0;
    }
    a.counts[P] = 0;
    a.live[P] = 0;
    s.free_top = top_after_pop + k;
    s.depth = s.new_depth;
    s.splits += k;
  }

  // DirectoryUpdate over the parents' own ranges: offsets, then every
  // entry of every range by every thread
  int total_entries = 0;
  for (int base = 0; base < k; base += kThreads) {
    const int r = base + threadIdx.x;
    const int len = r < k ? l.range[r] : 0;
    int total;
    const int off = block_scan(s, len, total);
    if (r < k) l.range[r] = total_entries + off;
    total_entries += total;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < total_entries; t += kThreads) {
    int lo = 0, hi = k - 1;  // the last range starting at or before t
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (l.range[mid] <= t) lo = mid;
      else hi = mid - 1;
    }
    const int32_t p = l.par[lo];
    const int shift = a.dmax - a.bdepth[p];
    const int i = t - l.range[lo];
    a.dir[(a.bprefix[p] << shift) + i] =
        l.cid[2 * lo + (i >= (1 << (shift - 1)))];
  }
  __syncthreads();
  compact(s, l, a);
}

// One wave pass (core/table.py::_wave_pass and wave_combine).
template <class Row>
__device__ void wave_pass(Shared& s, Lists& l, const Args& a) {
  const int m = s.m;
  const int B = a.B;
  if (threadIdx.x == 0) s.run_max = 0;
  sort_by_bucket(s, l, a, [&](int e, int32_t b) {
    if (b == a.P) return true;  // the trash row: stays pending
    if (!a.frozen[b]) return false;
    const int lane = l.lane[e];
    a.status[lane] = kFrozen;
    a.applied_seq[lane] = a.seq[lane];
    return true;
  });
  for (int q = threadIdx.x; q < m; q += kThreads) {
    const uint64_t v = l.srt[q];
    if (v == kPad) break;  // frozen and trash-row entries sort last
    const int32_t b = bucket_of(v);
    if (q > 0 && bucket_of(l.srt[q - 1]) == b) continue;  // not a head
    const int64_t base = static_cast<int64_t>(b) * B;
    Row row;
    row.load(a.keys + base, a.vals + base, B);
    int delta = 0, len = 0;
    bool full = false;
    for (int p = q; p < m && l.srt[p] != kPad && bucket_of(l.srt[p]) == b;
         ++p, ++len) {
      if (full) continue;
      const int e = static_cast<int>(static_cast<uint32_t>(l.srt[p]));
      const int32_t kind = l.kind[e];
      const int st = repro_torch::apply_op(row, B, kind, l.key[e], l.val[e]);
      if (st == repro_torch::kStFull) {
        full = true;  // nothing leaves a full bucket: the rest stay pending
        continue;
      }
      const int lane = l.lane[e];
      a.status[lane] = static_cast<int8_t>(st);
      a.applied_seq[lane] = a.seq[lane];
      if (st == repro_torch::kStTrue) delta += kind == kIns ? 1 : -1;
    }
    row.store(a.keys + base, a.vals + base, B);
    a.counts[b] += delta;
    atomicMax(&s.run_max, len);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a.counts[a.P] = 0;
    s.waves += s.run_max;
  }
  compact(s, l, a);
}

template <class Row>
__global__ void __launch_bounds__(kThreads, 1)
    resize_apply_kernel(Args a, unsigned char* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Shared s;
  Lists l = Lists::carve(scratch != nullptr ? scratch : smem, a.n);

  // the fresh lanes, in lane order, become the entries
  int m = 0;
  for (int base = 0; base < a.n; base += kThreads) {
    const int i = base + threadIdx.x;
    bool fresh = false;
    if (i < a.n) {
      const int32_t seq_in = a.applied_seq_in[i];
      a.applied_seq[i] = seq_in;
      a.status[i] = kPending;
      fresh = a.kind[i] != kNop && a.seq[i] > seq_in;
    }
    int total;
    const int pos = block_scan(s, fresh, total);
    if (fresh) {
      const int e = m + pos;
      l.lane[e] = i;
      l.key[e] = a.key[i];
      l.kind[e] = a.kind[i];
      l.val[e] = a.val[i];
      l.act[e] = e;
    }
    m += total;
  }
  if (threadIdx.x == 0) {
    s.m = m;
    s.depth = *a.depth_in;
    s.nalloc = *a.nalloc_in;
    s.free_top = *a.free_top_in;
    s.error = *a.error_in;
    s.rounds = s.waves = s.splits = 0;
  }
  __syncthreads();

  if (a.fast_order) {
    // all the fast pass does on an ST_FULL batch: ops whose destination is
    // frozen complete as FROZEN
    for (int q = threadIdx.x; q < s.m; q += kThreads) {
      const int e = l.act[q];
      if (a.frozen[dir_bucket(a, l.key[e])]) {
        const int lane = l.lane[e];
        a.status[lane] = kFrozen;
        a.applied_seq[lane] = a.seq[lane];
      }
    }
    __syncthreads();
    compact(s, l, a);
  }

  for (int r = 0; r < a.rounds && s.m > 0; ++r) {
    if (threadIdx.x == 0) ++s.rounds;
    if (a.fast_order) {
      split_pass(s, l, a);
      wave_pass<Row>(s, l, a);
    } else {
      wave_pass<Row>(s, l, a);
      if (s.m > 0) split_pass(s, l, a);
    }
  }

  // anything still pending is capacity exhaustion; replayed and NOP lanes
  // keep their stored status
  for (int i = threadIdx.x; i < a.n; i += kThreads) {
    const int32_t kind = a.kind[i];
    const bool keep = kind == kNop || a.seq[i] <= a.applied_seq_in[i];
    const int8_t f = keep ? a.last_status_in[i] : a.status[i];
    a.status[i] = f;
    a.last_status[i] = f;
  }
  if (threadIdx.x == 0) {
    *a.depth = s.depth;
    *a.nalloc = s.nalloc;
    *a.free_top = s.free_top;
    *a.error = (s.error || s.m > 0) ? 1 : 0;
    a.stats[0] = s.rounds;
    a.stats[1] = s.waves;
    a.stats[2] = s.splits;
  }
}

template <class Row>
cudaError_t launch(const Args& a, unsigned char* scratch, cudaStream_t st) {
  const size_t bytes = scratch != nullptr ? 0 : Lists::bytes(a.n);
  const cudaError_t e = cudaFuncSetAttribute(
      resize_apply_kernel<Row>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  resize_apply_kernel<Row><<<1, kThreads, bytes, st>>>(a, scratch);
  return cudaGetLastError();
}

}  // namespace

// Bytes of device scratch the launch needs for n lanes: 0 where the entry
// lists fit in shared memory.
extern "C" long long resize_apply_scratch_bytes(int n) {
  const size_t bytes = Lists::bytes(n);
  return bytes <= kMaxShared ? 0 : static_cast<long long>(bytes);
}

// ptrs: kNumPtrs device pointers in the order of enum Ptr (the TableState's
// tensors, the ops, the outputs, then the scratch, null where
// resize_apply_scratch_bytes(n) is 0); the pools are [P+1, B] int32; bool
// tensors are one byte each. fast_order is cfg.use_fast_path. Returns the
// cudaError_t of the launch, or cudaErrorInvalidValue for n < 1, B < 1, P
// < 1, dmax outside [1, 20], a missing scratch or rounds < 0.
extern "C" int resize_apply_launch(void* const* ptrs, int n, int B, int P,
                                   int dmax, int hash_id, int hash_shift,
                                   int rounds, int fast_order, void* stream) {
  auto* scratch = static_cast<unsigned char*>(ptrs[kScratch]);
  if (n < 1 || B < 1 || P < 1 || dmax < 1 || dmax > 20 || rounds < 0 ||
      (scratch == nullptr && resize_apply_scratch_bytes(n) != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.dir = static_cast<int32_t*>(ptrs[kDir]);
  a.keys = static_cast<int32_t*>(ptrs[kKeys]);
  a.vals = static_cast<int32_t*>(ptrs[kVals]);
  a.bdepth = static_cast<int32_t*>(ptrs[kBdepth]);
  a.bprefix = static_cast<int32_t*>(ptrs[kBprefix]);
  a.live = static_cast<uint8_t*>(ptrs[kLive]);
  a.frozen = static_cast<uint8_t*>(ptrs[kFrozenP]);
  a.free_stack = static_cast<int32_t*>(ptrs[kFreeStack]);
  a.counts = static_cast<int32_t*>(ptrs[kCounts]);
  a.depth_in = static_cast<const int32_t*>(ptrs[kDepthIn]);
  a.nalloc_in = static_cast<const int32_t*>(ptrs[kNallocIn]);
  a.free_top_in = static_cast<const int32_t*>(ptrs[kFreeTopIn]);
  a.error_in = static_cast<const uint8_t*>(ptrs[kErrorIn]);
  a.applied_seq_in = static_cast<const int32_t*>(ptrs[kAppliedSeqIn]);
  a.last_status_in = static_cast<const int8_t*>(ptrs[kLastStatusIn]);
  a.kind = static_cast<const int32_t*>(ptrs[kKind]);
  a.key = static_cast<const int32_t*>(ptrs[kKey]);
  a.val = static_cast<const int32_t*>(ptrs[kVal]);
  a.seq = static_cast<const int32_t*>(ptrs[kSeq]);
  a.status = static_cast<int8_t*>(ptrs[kStatus]);
  a.applied_seq = static_cast<int32_t*>(ptrs[kAppliedSeq]);
  a.last_status = static_cast<int8_t*>(ptrs[kLastStatus]);
  a.depth = static_cast<int32_t*>(ptrs[kDepth]);
  a.nalloc = static_cast<int32_t*>(ptrs[kNalloc]);
  a.free_top = static_cast<int32_t*>(ptrs[kFreeTop]);
  a.error = static_cast<uint8_t*>(ptrs[kError]);
  a.stats = static_cast<int32_t*>(ptrs[kStats]);
  a.n = n;
  a.B = B;
  a.P = P;
  a.dmax = dmax;
  a.hash_id = hash_id;
  a.hash_shift = hash_shift;
  a.rounds = rounds;
  a.fast_order = fast_order;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  // keys in registers up to 8 slots; a wider row is worked on in device
  // memory (the 32-slot register row spills beside the kernel's lists)
  if (B <= 8)
    e = launch<repro_torch::RegisterRow<8>>(a, scratch, st);
  else
    e = launch<repro_torch::MemoryRow>(a, scratch, st);
  return static_cast<int>(e);
}
