// The combine step shared by the table's two apply kernels (fused_apply.cu,
// grouped_apply.cu): one insert (upsert) or delete applied to a bucket row
// that a single thread owns, so the two kernels cannot drift apart.
//
// Semantics (kernels/ref.py::apply_ref, paper ExecOnBucket): the full test
// comes first, so no update, not even a delete, runs on a full row (ST_FULL);
// an insert overwrites its key's slot or takes the first free slot; a delete
// clears its key's slot (key EMPTY, value 0).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "hash_route.cuh"

namespace repro_torch {

constexpr int kIns = 1;
constexpr int kDel = 2;
constexpr int kStIdle = -1;
constexpr int kStFalse = 0;
constexpr int kStTrue = 1;
constexpr int kStFrozen = -2;
constexpr int kStFull = -3;

__device__ __forceinline__ bool is_update(int32_t kind) {
  return kind == kIns || kind == kDel;
}

// A row of B <= kMaxB slots whose keys sit in registers: every loop is
// unrolled over kMaxB with a compile-time index, so the arrays never spill
// to local memory. The combine step reads keys only (a value is written,
// never read), so load() reads the key half alone, in 16-byte loads where
// the row allows, and store() writes back, once, only the slots that
// changed: the grouping core's run owners all gather their rows from one
// SM at once, so the fewer and wider a row's accesses, the sooner the
// block's rows are in.
template <int kMaxB>
struct RegisterRow {
  int32_t k[kMaxB], v[kMaxB];
  uint32_t keys_dirty, vals_dirty;  // one bit per slot

  __device__ __forceinline__ void load(const int32_t* pk, const int32_t*,
                                       int B) {
    keys_dirty = vals_dirty = 0;
    if (B % 4 == 0 && reinterpret_cast<uintptr_t>(pk) % 16 == 0) {
#pragma unroll
      for (int c = 0; c < kMaxB / 4; ++c) {
        if (4 * c < B) {
          const int4 q = *reinterpret_cast<const int4*>(pk + 4 * c);
          k[4 * c] = q.x;
          k[4 * c + 1] = q.y;
          k[4 * c + 2] = q.z;
          k[4 * c + 3] = q.w;
        }
      }
    } else {
#pragma unroll
      for (int s = 0; s < kMaxB; ++s) {
        if (s < B) k[s] = pk[s];
      }
    }
  }

  // occupancy, first slot holding `key` (-1 if none), first free slot
  __device__ __forceinline__ void scan(int32_t key, int B, int& occ,
                                       int& slot_eq, int& slot_free) const {
    occ = 0;
    slot_eq = slot_free = -1;
#pragma unroll
    for (int s = kMaxB - 1; s >= 0; --s) {
      if (s < B) {
        occ += k[s] != kEmptyKey;
        if (k[s] == key) slot_eq = s;
        if (k[s] == kEmptyKey) slot_free = s;
      }
    }
  }

  __device__ __forceinline__ void set(int w, int32_t key, int32_t val,
                                      bool key_changes) {
#pragma unroll
    for (int s = 0; s < kMaxB; ++s) {
      if (s == w) {
        k[s] = key;
        v[s] = val;
      }
    }
    if (key_changes) keys_dirty |= 1u << w;
    vals_dirty |= 1u << w;
  }

  __device__ __forceinline__ void store(int32_t* pk, int32_t* pv,
                                        int) const {
#pragma unroll
    for (int s = 0; s < kMaxB; ++s) {
      if (keys_dirty >> s & 1) pk[s] = k[s];
      if (vals_dirty >> s & 1) pv[s] = v[s];
    }
  }
};

// A row of any width worked on in place in device memory: its owner is the
// only thread that touches it, so no copy is needed.
struct MemoryRow {
  int32_t* k;
  int32_t* v;

  __device__ __forceinline__ void load(int32_t* pk, int32_t* pv, int) {
    k = pk;
    v = pv;
  }

  __device__ __forceinline__ void scan(int32_t key, int B, int& occ,
                                       int& slot_eq, int& slot_free) const {
    occ = 0;
    slot_eq = slot_free = -1;
    for (int s = B - 1; s >= 0; --s) {
      const int32_t ks = k[s];
      occ += ks != kEmptyKey;
      if (ks == key) slot_eq = s;
      if (ks == kEmptyKey) slot_free = s;
    }
  }

  __device__ __forceinline__ void set(int w, int32_t key, int32_t val, bool) {
    k[w] = key;
    v[w] = val;
  }

  __device__ __forceinline__ void store(int32_t*, int32_t*, int) const {}
};

// One op of kind kIns or kDel on `row`; returns its status (kStTrue: a new
// key inserted or a present key deleted; kStFalse: an upsert of a present
// key or a delete of an absent one; kStFull).
template <class Row>
__device__ __forceinline__ int apply_op(Row& row, int B, int32_t kind,
                                        int32_t key, int32_t val) {
  int occ, slot_eq, slot_free;
  row.scan(key, B, occ, slot_eq, slot_free);
  if (occ >= B) return kStFull;
  const bool exist = slot_eq >= 0;
  if (kind == kIns) {
    row.set(exist ? slot_eq : slot_free, key, val, !exist);
    return exist ? kStFalse : kStTrue;
  }
  if (exist) row.set(slot_eq, kEmptyKey, 0, true);
  return exist ? kStTrue : kStFalse;
}

}  // namespace repro_torch
