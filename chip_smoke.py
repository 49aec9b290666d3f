#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port of the WF-Ext table on one GPU.

    python3 chip_smoke.py [--seed N]

Builds the CUDA kernels from ``src/repro_torch/csrc`` and runs, each phase
printing one JSON line:

1. build: kernel build seconds, the card's name and power limit;
2. kernels: each kernel against its plain PyTorch version at the shapes of
   the path that launches it — integers, tolerance 0: ``fused_probe`` and
   ``probe`` (2**20 queries, the latter routed beforehand; then the cases
   of their shared row probe, one line each: hits at every slot position
   of 4-, 8- and 32-slot rows that hold a key twice, an 8-slot pool whose
   keys or values start off a 16-byte boundary, half the queries EMPTY);
   ``fused_apply``
   (512-lane batches, all five statuses; every lane on one bucket; 32-slot
   rows) and ``grouped_apply`` (4,096 lanes sorted by (bucket, lane) and in
   lane order, idle lanes on live buckets; 3 chunks and 17 lanes whose
   buckets span the chunk borders; every lane on one bucket), over carried
   rounds, one line per case, the trash row untouched; then one case per
   kernel at ``hash_shift = 2``, the sharded path's, at its shard pool
   and widths (``shift_cases``: the fused kernels shift the hash
   themselves, the unfused ones take bucket ids routed by the shifted
   hash), with its own seeded generator; then the fused kernels at the
   LLM serving path's page table (``page_table_cases``: dmax 11 over 4,096
   rows, ``(seq << 12) | block`` keys, ``fused_probe`` on the step's 8-key
   pre-read and its 512-key page-id lookup, ``fused_apply`` on 16-lane
   batches of a decode step's upserts and an eviction's deletes);
3. main path at full size through the ``Table`` facade:
   ``TableSpec(dmax=20, bucket_size=8, pool_size=2**20, n_lanes=512,
   initial_depth=16)``, a 2**19-key preload, 256 rounds of one 4,608-key
   lookup and one 512-op write transaction (90% lookups), a FROZEN status
   through ``freeze_buddies`` and one ``merge``; every status and lookup
   against a dict oracle, the final content, the invariants, the error
   flag, and the launch counts on this phase (the fused kernels only);
4. wide path: the main table saved (``Table.save``) and restored into the
   same geometry with 4,096-lane transactions (``Table.restore``), past the
   fused apply kernel, so the plan runs ``grouped_apply`` and ``probe``;
   the restored content, invariants, error flag and a re-saved image
   identical to the first; then 64 rounds of one 36,864-key lookup and one
   4,096-op write against the oracle, and the launch counts (the unfused
   kernels only);
5. both paths under the ``"cuda"`` plan against the ``"plain"`` plan on the
   same card: statuses, lookups and state;
6. where a main-path mixed round's time goes: the slow path's share (host
   timers) and the device's busy time and top kernels (torch.profiler);
7. kernel times (CUDA events) at each path's shapes beside their plain
   versions and their bound, with the PyTorch route in front of ``probe``,
   the sort and un-sort ``grouped_apply`` no longer needs, the fused probe
   on the wide path's queries and the launch floor (a one-element add);
   the two probes warm (back to back) and cold (the L2 flushed before each
   launch), each also above the floor timed the same way; each kernel's
   registers and spills from its ``ptxas -v`` report (no spills);
8. the page-table path: the main geometry with the serving tier's
   ``(page, length)`` value schema (``repro/serving/kvcache.py``), keys
   ``(seq << 12) | block`` for 4,096 sequences of 128 blocks preloaded in
   512-lane inserts, then 256 rounds of one 4,608-key lookup and one
   512-op write (one sequence evicted, one admitted on its pages, 256
   ``length`` upserts), every status and payload against an oracle; 32
   more write transactions timed against a raw table with the same state,
   stage by stage; then the image restored into 4,096-lane transactions
   (``grouped_apply``, ``probe``) with every payload checked;
9. the elastic path: ``replay`` of a ``trace.phased`` fill → stable →
   drain → maintain → refill trace (2**20-key universe, 512-op steps) on
   the main geometry with the scenarios' ``ResizePolicy`` pinned to the
   initial depth, against the streaming oracle, then the same trace
   without the policy: depth by phase, auto-splits and merges, ms per
   transaction, the policy's share and its host reads;
10. the serving path: the main image restored under the main geometry,
    the router's cost model measured, then a ``Router`` (1,024-op batches,
    2 ms delay bound) driven on a virtual clock by 1,024 closed-loop
    clients of 128 requests each in the main path's 90/10 mix, every
    result checked against a dict oracle in the router's linearization
    order, handed over onto the wide geometry halfway with requests
    queued: mismatches, drops, latency percentiles, requests per second
    of service time, the cost model, and the launches before the handover
    (the fused kernels only) and after it (the unfused ones only); then
    ``serve_closed_loop`` (256 clients x 64 "churn" ops, the scenarios'
    policy, a handover onto the wide geometry) against its oracle;
11. the chaos path: ``chaos_replay`` of ``chaos_churn`` stretched to
    110,000 ops with a schedule of 12 events (the default 24 cut, listed
    as ``reduced``: restores at 16 lanes take three quarters of the run)
    of every kind (kill/revive, re-shard, policy flap, backend swap
    across ``plain``/``cuda``/``auto``, router handover, torn save)
    against the streaming oracle: digests after every event and at the
    end, mismatches, the error flag, depth, splits and merges, launches,
    and the seconds in restores against the rest;
12. the baselines path: the paper's comparison algorithms
    (``core/baselines.py``: LF-Split, LF-Freeze-M, Lock), sized by
    ``benchmarks/paper_figs.py``'s rules for the main path's 2**20-key
    universe (depth 17), filled at 512 lanes with the main table's live
    keys (LF-Freeze-M's ``-3`` statuses counted), then 16 rounds of the
    main path's 90/10 mix through all four structures (WF-Ext through the
    facade, its launches counted) against dict oracles, the error flags,
    and ``paper_figs``'s directory-stable step (n lookups + one n-lane
    batch, 90% lookups) timed at 16, 64 and 512 lanes: ops/s per
    (algorithm, lanes), WF-Ext's launches per step (its 16- and 64-op
    batches NOP-padded to 512). WF-Ext runs the CUDA kernels, the
    baselines eager PyTorch;
13. the sharded path: sharded placement (``core/dist.py``) with 4 shards
    on the one card (``SHARD_SPEC``: per shard dmax 18, 2**18 pool rows,
    depth 14, so the aggregate is the main geometry), filled with the main
    table's live keys at 512 lanes — its image must equal the main
    table's — then 64 rounds of the 90/10 mix and 16 timed write
    transactions against the oracle, the invariants per shard, the union
    content and the error flag; then a 4 -> 2 re-shard through the image
    into ``SHARD2_SPEC`` (4,096 lanes, past the fused apply kernel) and 8
    rounds there: preload and mixed rates beside the main path's, ms per
    write transaction, restore items/s, and the launches by kernel on
    each stage, which must be exactly one per shard per kernel call (the
    fused kernels before the re-shard, the unfused ones after it);
14. the LLM serving path: the paged-KV engine (``repro_torch/serving/
    engine.py``) at full-width ``deepseek-7b`` (30 layers, d_model 4,096,
    32 heads of 128, d_ff 11,008, vocabulary 102,400; random init in
    bf16) with ``make_paged_config(cfg, batch=8, max_len=1024,
    page_size=16)``: 1,024 pages of 16 tokens and a page table of dmax 11,
    4,096 pool rows and 16 lanes on the fused kernels. 8 sequences decode
    96 steps in lockstep with the dense ``decode_step`` (logits at rtol =
    atol = 2e-2, both driven by the dense argmax); 4 are evicted and 4 new
    ones admitted for 32 steps on the freed pages (``page_alloc`` must not
    move); the engine is handed over to batch 16 (1,536 pages) and both
    engines run 16 steps (logits agree on the first 8 slots). After each
    stage the page table equals a host mirror of ``(seq, block) → (page,
    length)``, the allocator and the slots (``to_dict``, payload lookups,
    invariants, error flag, ``gather_kv``'s lengths, no page live twice or
    both live and free). Then 8 paged steps under torch.profiler; the
    smoke engine's ``save_engine`` / ``warm_start_engine`` round trip on
    the card; every family's smoke ``decode_step`` on the card against the
    CPU (1e-3 in float32, 2e-2 in bf16). The line: mismatches and max
    logit error per stage, launches per decode step by kernel (the fused
    kernels only, the same every step), host reads per step (CUDA's sync
    debug mode), ms per paged and dense step (CUDA events, on the steps
    that carry no instrumentation) and the paged step by part (on steps
    of their own), tokens/s, the step's byte bound (weights and live K/V
    over 3.35 TB/s) and the device's idle share (busy time and wall time
    both from the profiled steps);
15. the sharded serving tier: a ``Router`` on a 4-shard ``SHARD_SPEC``
    table restored from the main image (its cost model measured there),
    1,024 closed-loop clients of 32 requests each in the 90/10 mix
    (a shard bound of 224, so hot shards shed and their clients retry),
    handed over onto the local ``WIDE_SPEC`` halfway; then a local router
    on the main geometry over the result, handed over onto ``SHARD_SPEC``
    halfway with the later submits re-homed under the 4 shards; every
    result against the dict oracle in linearization order, the final
    content and image, the queue depths at each handover, the sheds by
    shard, and the launches, exactly one per shard per facade call while
    sharded (the fused kernels), the unfused ones only on ``WIDE_SPEC``;
    then ``serve_closed_loop`` (256 clients x 64 "churn" ops) on
    ``SHARD_SPEC`` handed over onto the local main geometry; then a
    ``chaos_reshard`` run on 2 shards stretched to 20,000 ops with 6
    events (kill/revive, re-shard and handover across 2 / 4 / 8 shards and
    local, policy flaps): digests after every event, the invariants per
    shard, a move across placements;
16. the training path: ``repro_torch.launch.train.main`` at full-width
    ``smollm-135m`` (30 layers, d_model 576, 9 heads of 64 with 3 KV
    heads, d_ff 1,536, vocabulary 49,152; random init, bf16), 8 steps of
    8 x 2,048 tokens, checkpoints at steps 4 and 8 with the main table
    alongside; a fresh launcher on a copy holding only step 4 replays
    steps 5-8 (losses within 1e-3 relative); the checkpointed table
    restored into ``SHARD_SPEC`` (its image equal to the main table's, one
    ``fused_apply`` per shard per restore transaction); full-width
    ``hymba-1.5b`` (32 layers, d_model 1,600, 25 heads with 5 KV heads,
    SSM state 16, a 1,024 window and every 8th layer global) for 3 steps
    of 2 x 2,048 tokens; every family's smoke ``train_step`` on the card
    against the CPU (1e-3 in float32, 2e-2 in bf16). The line: losses, ms
    per step (CUDA events, steps after the first), tokens/s, peak memory
    and the FLOP bound (6 x parameters x tokens plus attention, over the
    dense bf16 peak) for both models, checkpoint seconds and bytes;
17. the launch tier: ``make_compressed_allreduce``
    (``repro_torch/distributed/compression.py``) on a one-rank NCCL group
    from ``make_local_mesh`` over a full-width ``smollm-135m`` gradient
    tree (134,515,008 elements drawn from the seed) for 3 steps carrying
    the feedback, against the plain arithmetic (float32 quantization, the
    rest in float64): reduced grads and residual within 1 float32 ulp, ms
    per call (CUDA events) beside the byte bound; the dry-run's ``h100x1``
    record (``repro_torch/launch/dryrun.py``) at phase 16's shape (8 x
    2,048 tokens, train) against one real ``train_step`` on the card: the
    traced FLOPs equal ``FlopCounterMode``'s over the real step, op by op,
    and the argument bytes the real state's and batch's, the model FLOPs
    beside phase 16's FLOP bound, the real step's peak memory beside the
    argument bytes, the card's memory beside the dry-run's ``hbm_bytes``;
    then every arch's ``decode_32k`` records on ``h100x1`` and
    ``pod16x16`` and its ``train_4k`` layout on ``pod16x16`` (a fake
    process group of 256 ranks) in a pool of spawned processes, each
    ``ok``, timed (the one-card ``train_4k`` traces stay with the CLI's
    ``--all`` sweep). No kernel is launched.

Then the ``nvidia-smi`` name/power line, the kernels line (with each
kernel's launches on the sharded, the LLM, the sharded serving, the
training path and the launch tier beside the main path's) and, last,
``{"ok": true, "device": {...}}``. Any failed check raises: the exit code
is non-zero and the last line is not printed. Without a CUDA device, or
without the repository beside it, the script fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

EMPTY = -2**31
# H100 SXM peak rates: HBM bytes/s; the float32
# non-tensor rate stands in for 32-bit integer operations
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
MAIN_SPEC = dict(dmax=20, bucket_size=8, pool_size=2**20, n_lanes=512,
                 initial_depth=16)
LOOKUPS_PER_ROUND = 4608
ROUNDS = 256
PRELOAD = 2**19
# the wide path: the main path's geometry with 4,096-lane transactions, past
# the fused apply kernel's 1,024 lanes, so writes take grouped_apply and
# lookups probe; restored from the main path's image, then the same 90/10
# mix at eight times the width
WIDE_SPEC = dict(MAIN_SPEC, n_lanes=4096)
WIDE_LOOKUPS = 8 * LOOKUPS_PER_ROUND
WIDE_ROUNDS = 64
# the page-table path: the serving tier's page table (repro/serving/
# kvcache.py) on the main geometry — keys (seq << BLOCK_BITS) | block, the
# (page, length) value schema, 4,096 sequences of 128 blocks = 2**19
# mappings, pages of 16 tokens; PAGE_TIMED extra write transactions timed
# against a raw table
PAGE_SCHEMA = {"page": "int32", "length": "int32"}
BLOCK_BITS = 12
PAGE_SEQS = 4096
PAGE_BLOCKS = 128
PAGE_TOKENS = 16
PAGE_TIMED = 32
# the elastic path: trace.phased over a 2**20-key universe in 512-op steps
# (maintain runs drain_steps // 2 = 512 steps)
ELASTIC_TRACE = dict(universe=2**20, fill_steps=1024, stable_steps=128,
                     drain_steps=1024, refill_steps=256, batch=512)
# the serving path: the router over the main table restored from its image,
# SERVE_CLIENTS closed-loop clients of SERVE_REQUESTS requests each (the
# main path's 90/10 mix), handed over onto WIDE_SPEC halfway; then
# serve_closed_loop itself with LOOP_CLIENTS x LOOP_OPS "churn" ops
SERVE_CLIENTS = 1024
SERVE_REQUESTS = 128
SERVE_CONFIG = dict(max_batch=1024, max_queue_per_shard=2048,
                    max_delay_s=2e-3)
LOOP_CLIENTS = 256
LOOP_OPS = 64
LOOP_CONFIG = dict(max_batch=512, max_queue_per_shard=512)
# the chaos path: chaos_churn stretched to the JAX package's 100k-op
# acceptance bar (tests/test_chaos.py), every event kind
CHAOS_OPS = 110_000
CHAOS_MIN_OPS = 100_000
# chaos_setup's default schedule has 24 events, 14 of them restores at 16
# lanes, which take three quarters of the run (PERF.md); 12 keep every
# kind and halve them
CHAOS_EVENTS = 12
# the baselines path: the paper's comparison algorithms sized by
# benchmarks/paper_figs.py's rules (:120-140) at the main path's 2**20-key
# universe, filled with the main table's live keys; the directory-stable
# step (n lookups + one n-lane update batch, 90% lookups) timed per width
BASE_KEYS = 2**20
BASE_DEPTH = 17                     # log2(BASE_KEYS / 8)
BASE_LANES = (16, 64, 512)
BASE_ROUNDS = 16
BASE_ITERS, BASE_WARMUP = 20, 3
# the sharded path: sharded placement (core/dist.py) with its 4 shards on
# the one card — per shard dmax 18 and 2**18 pool rows, so the aggregate is
# the main geometry (20 hash bits, 2**20 rows, depth 16) — filled with the
# main table's live keys at 512 lanes; then a 4 -> 2 re-shard through the
# table image into 4,096-lane transactions (past the fused apply kernel),
# at the aggregate depth 16 again
SHARD_SPEC = dict(dmax=18, bucket_size=8, pool_size=2**18, n_lanes=512,
                  initial_depth=14, placement="sharded", shard_bits=2)
SHARD2_SPEC = dict(SHARD_SPEC, dmax=19, pool_size=2**19, n_lanes=4096,
                   initial_depth=15, shard_bits=1)
SHARD_ROUNDS = 64
SHARD_TIMED = 16
SHARD2_ROUNDS = 8
# the hash_shift the kernel cases of phase 2 add: the sharded path's
SHIFT = SHARD_SPEC["shard_bits"]
# the LLM serving path: the paged-KV engine (repro_torch/serving/engine.py)
# at full-width deepseek-7b (random init, bf16) with its page table on the
# fused kernels, against the dense decode: LLM_STEPS decode steps in three
# stages (lockstep decode; evict half the slots and admit new sequences;
# hand over to twice the batch), steps after LLM_WARMUP timed with CUDA
# events, except LLM_TIMED (split into the table transaction, the page-id
# lookup and the layer stack) and LLM_READS (host reads counted), which
# carry instrumentation; then LLM_PROFILED steps under torch.profiler.
# decode_32k (configs/shapes.py: batch 128 at 32,768 tokens) is cut to
# batch 8 at 1,024 tokens
LLM_ARCH = "deepseek-7b"
LLM_BATCH, LLM_MAX_LEN, LLM_PAGE = 8, 1024, 16
LLM_STEPS = (96, 32, 16)
LLM_WARMUP = 8
LLM_TIMED = (40, 48)
LLM_READS = range(48, 56)
LLM_PROFILED = 8
# the sharded serving tier: a router on SHARD_SPEC restored from the main
# image, handed over onto the local WIDE_SPEC halfway, then a local router
# on the main geometry handed over onto SHARD_SPEC; phase 10's 1,024
# clients with 32 requests each (cut from 128). The first router's shard
# bound of 224 sits below the 256 requests a shard averages when all 1,024
# clients have one queued, so hot shards shed and their clients retry
# SHARD_RETRY_S later
SHARD_SERVE_CLIENTS, SHARD_SERVE_REQUESTS = 1024, 32
SHARD_SERVE_CONFIG = dict(SERVE_CONFIG, max_queue_per_shard=224)
SHARD_RETRY_S = 5e-4
# chaos across placements: chaos_reshard on 2 shards stretched to 20,000
# ops (cut from the chaos path's 110,000) with 6 events (cut from 24) over
# 2 / 4 / 8 shards and local
SHARD_CHAOS_OPS, SHARD_CHAOS_EVENTS = 20_000, 6
SHARD_CHAOS_KINDS = ("kill_revive", "reshard", "policy_flap", "handover")
# the training path: full-width smollm-135m (the model examples/
# train_smollm.py trains) through the launcher, 8 steps of 8 x 2,048
# tokens, checkpoints at steps 4 and 8 with the main table alongside, a
# resume from step 4; then full-width hymba-1.5b for 3 steps of 2 x 2,048
# tokens, past its 1,024-token window
TRAIN_ARCH, TRAIN_SEQ, TRAIN_BATCH = "smollm-135m", 2048, 8
TRAIN_STEPS, TRAIN_CKPT_EVERY = 8, 4
HYBRID_ARCH, HYBRID_SEQ, HYBRID_BATCH, HYBRID_STEPS = "hymba-1.5b", 2048, 2, 3
# H100 SXM dense bf16 tensor-core peak
PEAK_BF16_FLOPS = 989e12


# every phase's line, by phase name (phase 13 reads the main path's rates)
LINES = {}


def emit(obj) -> None:
    if "phase" in obj:
        LINES[obj["phase"]] = obj
    print(json.dumps(obj), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn(i)`` over ``iters`` calls (CUDA
    events), after two warm-up calls. The launches queue up behind a
    device-side sleep, so the events time the kernels back to back and not
    the host's launch overhead; ``fn`` must not synchronize."""
    for i in range(2):
        fn(i)
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(200_000_000)      # ~0.1 s: covers the enqueueing
    t0.record()
    for i in range(iters):
        fn(i)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


# bytes written between launches to flush the 50 MB L2
FLUSH_BYTES = 256 << 20


def cold_ms(fn, iters: int) -> float:
    """Median device milliseconds of ``fn(i)`` over ``iters`` calls with the
    L2 flushed before each: a 256 MiB scratch buffer is written, then an
    event pair times ``fn`` alone, so the flush is not in the time. The
    calls queue up behind a device-side sleep, as in ``cuda_ms``; ``fn``
    must not synchronize."""
    scratch = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    fn(0)
    torch.cuda.synchronize()
    pairs = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
             for _ in range(iters)]
    torch.cuda._sleep(200_000_000)
    for i, (t0, t1) in enumerate(pairs):
        scratch.fill_(i)
        t0.record()
        fn(i)
        t1.record()
    torch.cuda.synchronize()
    return float(np.median([t0.elapsed_time(t1) for t0, t1 in pairs]))


def host_ms(fn, iters: int) -> float:
    """Mean wall milliseconds of ``fn(i)`` ending in a synchronize — for
    code that synchronizes inside (the plain apply reads ``.item()``)."""
    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def bound_ms(n_bytes: float, n_ops: float):
    tb, to = n_bytes / PEAK_BYTES_S * 1e3, n_ops / PEAK_OPS_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def distinct_keys(rng, m: int) -> np.ndarray:
    """``m`` distinct int32 keys in [1, 2**31 - 1), seeded order."""
    k = np.unique(rng.integers(1, 2**31 - 1, size=int(m * 1.01) + 64,
                               dtype=np.int64))
    check(k.size >= m, "not enough distinct keys drawn")
    return rng.permutation(k)[:m].astype(np.int32)


def route_np(keys, directory, dmax, shift=0):
    from repro_torch.core.hashing import hash_np
    return directory[(hash_np("fmix32", keys, shift)
                      >> np.uint32(32 - dmax)).astype(np.int64)]


def place_keys(pk, pv, keys, rows, limit, rng):
    """Put ``keys`` into the rows they route to, at most ``limit`` per row
    (first come first placed); returns the mask of keys placed."""
    order = np.argsort(rows, kind="stable")
    r = rows[order]
    start = np.r_[0, np.nonzero(r[1:] != r[:-1])[0] + 1]
    rank = np.arange(r.size) - np.repeat(start, np.diff(np.r_[start, r.size]))
    rank += (pk[r] != EMPTY).sum(axis=1)
    ok = rank < limit
    pk[r[ok], rank[ok]] = keys[order][ok]
    pv[r[ok], rank[ok]] = rng.integers(-2**31, 2**31, size=ok.sum(),
                                       dtype=np.int64).astype(np.int32)
    placed = np.zeros(keys.size, bool)
    placed[order[ok]] = True
    return placed


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions


def sorted_ops(kinds, keys, values, bids, P):
    """Ops in the order the JAX package's grouped transaction gives its
    kernel: active ops by (bucket, lane), then the idle lanes in lane
    order, which keep their real bucket ids."""
    order = np.argsort(np.where(kinds != 0, bids, P + 1), kind="stable")
    return [x[order].astype(np.int32) for x in (kinds, keys, values, bids)]


def apply_case(kernel, plain, pk, pv, batches, dev):
    """Carry the [P+1, B] pools ``pk``/``pv`` through ``batches`` in the
    kernel and in its plain version: outputs and rows 0..P-1 compared
    exactly after every batch, and the kernel's trash row untouched."""
    P = pk.shape[0] - 1
    k_pk, k_pv = torch.tensor(pk, device=dev), torch.tensor(pv, device=dev)
    p_pk, p_pv = k_pk.clone(), k_pv.clone()
    mm = err = 0
    seen = set()
    for ops in batches:
        kout = kernel(*ops, k_pk, k_pv)[2:]
        pout = plain(*ops, p_pk, p_pv)[2:]
        torch.cuda.synchronize()
        mm += sum(int((a != b).sum()) for a, b in zip(kout, pout))
        mm += int((k_pk[:P] != p_pk[:P]).sum() + (k_pv[:P] != p_pv[:P]).sum())
        err = max(err, int((k_pv[:P].long() - p_pv[:P].long()).abs().max()))
        seen |= set(kout[0].tolist())
    trash = bool((k_pk[P].cpu().numpy() == pk[P]).all()
                 and (k_pv[P].cpu().numpy() == pv[P]).all())
    out = {"lanes": int(batches[0][0].shape[0]), "rounds": len(batches),
           "B": int(pk.shape[1]), "statuses": sorted(seen),
           "mismatches": mm, "max_abs_err": err,
           "trash_row_untouched": trash}
    if len(batches[0]) == 4:        # grouped_apply: ops carry bucket ids
        collide = 0
        for kinds, _, _, bids in batches:
            live = torch.unique(bids[kinds != 0])
            collide += int(torch.isin(bids[kinds == 0], live).sum())
        out["idle_lanes_on_live_buckets"] = collide
    return out


ROW_CASES = [("slots", 4), ("slots", 8), ("slots", 32), ("keys_off16", 8),
             ("vals_off16", 8), ("empty", 8)]


def offset_by_one(x: np.ndarray, dev):
    """``x`` as a contiguous [R, B] tensor at storage offset 1: its base is
    4 bytes off a 16-byte boundary, so the kernels take the slot-by-slot
    row path."""
    buf = torch.empty(x.size + 1, dtype=torch.int32, device=dev)
    view = buf[1:].view(x.shape)
    view.copy_(torch.from_numpy(x))
    check(view.data_ptr() % 16 != 0 and view.is_contiguous(), "offset view")
    return view


def row_probe_cases(rng, dev, P=1 << 14):
    """The cases of the row probe the two lookup kernels share
    (``csrc/row_probe.cuh``), each kernel against its plain version, one
    ``kernel_case`` line per case. Rows are filled by keys routed to them,
    then a fifth of the slots emptied, and every third row holds its first
    key again in its last slot under another value (only the first match
    may answer); queries are every live key once, so every slot position
    has hits, as many keys never placed, and EMPTY queries (5%, or half in
    the ``empty`` case). Returns {kernel: (mismatches, max abs err)}."""
    from repro_torch.kernels.lookup import (fused_probe, fused_probe_plain,
                                            probe, probe_plain)
    dmax = MAIN_SPEC["dmax"]
    out = {"fused_probe": (0, 0), "probe": (0, 0)}
    for case, B in ROW_CASES:
        directory = (rng.permutation(1 << dmax) % P).astype(np.int32)
        cand = distinct_keys(rng, 4 * P * B)
        pk = np.full((P, B), EMPTY, np.int32)
        pv = rng.integers(-2**31, 2**31, size=(P, B),
                          dtype=np.int64).astype(np.int32)
        placed = place_keys(pk, pv, cand, route_np(cand, directory, dmax), B,
                            rng)
        pk[rng.random((P, B)) < 0.2] = EMPTY
        pk[::3, B - 1] = pk[::3, 0]
        live = pk[pk != EMPTY]
        q = rng.permutation(np.r_[live, cand[~placed][:live.size]])
        q[rng.random(q.size) < (0.5 if case == "empty" else 0.05)] = EMPTY
        bids = route_np(q, directory, dmax).astype(np.int32)
        eq = (pk[bids] == q[:, None]) & (q != EMPTY)[:, None]
        positions = np.unique(eq.argmax(axis=1)[eq.any(axis=1)]).size
        pk_t = (offset_by_one(pk, dev) if case == "keys_off16"
                else torch.tensor(pk, device=dev))
        pv_t = (offset_by_one(pv, dev) if case == "vals_off16"
                else torch.tensor(pv, device=dev))
        q_t = torch.tensor(q, device=dev)
        runs = {"fused_probe": (fused_probe, fused_probe_plain, dict(
                    dmax=dmax), torch.tensor(directory, device=dev)),
                "probe": (probe, probe_plain, {},
                          torch.tensor(bids, device=dev))}
        for name, (kernel, plain, kw, first) in runs.items():
            kf, kv = kernel(first, q_t, pk_t, pv_t, **kw)
            pf, pvals = plain(first, q_t, pk_t, pv_t, **kw)
            torch.cuda.synchronize()
            mm = int((kf != pf).sum() + (kv != pvals).sum())
            err = int((kv.long() - pvals.long()).abs().max())
            emit({"phase": "kernel_case", "kernel": name,
                  "case": f"{case}_b{B}", "B": B, "queries": int(q.size),
                  "found": int(kf.sum()), "empty_queries": int(
                      (q == EMPTY).sum()), "slot_positions_hit": positions,
                  "mismatches": mm, "max_abs_err": err})
            check(mm == 0, f"{name} {case}_b{B}: disagrees with its plain "
                  f"version in {mm} outputs")
            check(positions == B, f"{case}_b{B}: hits at {positions} of "
                  f"{B} slot positions")
            out[name] = (out[name][0] + mm, max(out[name][1], err))
    return out


def kernel_checks(rng, dev):
    from repro_torch.kernels.apply import (GROUPED_CHUNK, ST_FALSE,
                                           ST_FROZEN, ST_FULL, ST_IDLE,
                                           ST_TRUE, fused_apply,
                                           fused_apply_plain, grouped_apply,
                                           grouped_apply_plain)
    from repro_torch.kernels.lookup import (fused_probe, fused_probe_plain,
                                            probe, probe_plain)

    dmax, P, B = MAIN_SPEC["dmax"], MAIN_SPEC["pool_size"], 8
    # a directory at depth dmax-3 over a shuffled set of rows, filled to
    # about 60% by keys placed in the rows they route to
    depth = dmax - 3
    rows = rng.permutation(P)[: 1 << depth].astype(np.int32)
    directory = rows[np.arange(1 << dmax) >> (dmax - depth)]
    pk = np.full((P + 1, B), EMPTY, np.int32)
    pv = np.zeros((P + 1, B), np.int32)
    keys = distinct_keys(rng, int(0.6 * B * (1 << depth)))
    keys[:2] = [2**31 - 1, -2**31 + 1]
    placed = place_keys(pk, pv, keys, route_np(keys, directory, dmax), B,
                        rng)
    live = keys[placed]
    absent = keys[~placed]
    n_q = 1 << 20
    q = np.where(rng.random(n_q) < 0.5,
                 rng.choice(live, size=n_q), rng.choice(
                     np.r_[absent, -keys[:1000]], size=n_q)).astype(np.int32)
    q[:4] = [EMPTY, 2**31 - 1, -2**31 + 1, 2**31 - 2]
    d_t = torch.tensor(directory, device=dev)
    args = (d_t, torch.tensor(q, device=dev), torch.tensor(pk[:-1], device=dev),
            torch.tensor(pv[:-1], device=dev))
    kf, kv = fused_probe(*args, dmax=dmax)
    pf, pvals = fused_probe_plain(*args, dmax=dmax)
    torch.cuda.synchronize()
    probe_mm = int((kf != pf).sum() + (kv != pvals).sum())
    probe_err = int((kv.long() - pvals.long()).abs().max())
    check(probe_mm == 0, f"fused_probe disagrees with its plain version "
          f"in {probe_mm} outputs")
    check(bool(pf[1]) and bool(pf[2]) and not bool(pf[0]),
          "edge-key queries")

    # probe: the same queries, routed beforehand on the host
    bids = torch.tensor(route_np(q, directory, dmax).astype(np.int32),
                        device=dev)
    rargs = (bids,) + args[1:]
    rf, rv = probe(*rargs)
    rpf, rpv = probe_plain(*rargs)
    torch.cuda.synchronize()
    routed_mm = int((rf != rpf).sum() + (rv != rpv).sum()
                    + (rf != pf).sum() + (rv != pvals).sum())
    routed_err = int((rv.long() - rpv.long()).abs().max())
    check(routed_mm == 0, f"probe disagrees with its plain version in "
          f"{routed_mm} outputs")
    row_checks = row_probe_cases(rng, dev)

    # the apply kernels: 512-lane (fused_apply) and 4,096-lane
    # (grouped_apply) batches over hot rows of mixed fill, carried over
    # rounds, each case against the plain version from the same pools
    n, m = MAIN_SPEC["n_lanes"], WIDE_SPEC["n_lanes"]
    hot = distinct_keys(np.random.default_rng(rng.integers(2**31)), 4096)
    hot_rows = route_np(hot, directory, dmax)
    apk, apv = pk.copy(), pv.copy()
    fill = rng.integers(3, B + 1, size=P + 1)       # many rows near full
    for s in range(B):
        apk[s >= fill, s] = EMPTY      # rows stay prefix-filled
    place_keys(apk, apv, hot[: hot.size // 2], hot_rows[: hot.size // 2], B,
               rng)
    frozen = np.zeros(P + 1, bool)
    frozen[hot_rows[rng.random(hot.size) < 0.08]] = True
    # one hot bucket: an emptied row that every lane reaches, six keys
    # (fewer than its slots, so it never fills and order decides)
    r_hot = int(hot_rows[0])
    apk[r_hot], frozen[r_hot] = EMPTY, False
    few = hot[:6]
    fr_t = torch.tensor(frozen, device=dev)

    def fused_on(d):
        return lambda *a: fused_apply(d, fr_t, *a, dmax=dmax)

    def fused_plain_on(d):
        return lambda *a: fused_apply_plain(d, fr_t, *a, dmax=dmax)

    def ops(width, keys):
        return [rng.integers(0, 3, size=width), keys,
                rng.integers(0, 2**31 - 1, size=width)]

    def routed(width, keys):
        return ops(width, keys) + [route_np(keys, directory, dmax)]

    # fused_apply with 32-slot rows: 2**16 rows, all live at depth 16,
    # about 20 keys a row (some rows full); half the ops on live keys
    P32 = 1 << 16
    dir32 = rng.permutation(P32).astype(np.int32)[np.arange(1 << dmax)
                                                  >> (dmax - 16)]
    d32 = torch.tensor(dir32, device=dev)
    pk32 = np.full((P32 + 1, 32), EMPTY, np.int32)
    pv32 = np.zeros((P32 + 1, 32), np.int32)
    k32 = distinct_keys(rng, 20 * P32)
    place_keys(pk32, pv32, k32, route_np(k32, dir32, dmax), 32, rng)
    fr32 = torch.zeros(P32 + 1, dtype=torch.bool, device=dev)

    d_hot = torch.full_like(d_t, r_hot)
    wide = 3 * GROUPED_CHUNK + 17
    grouped = (grouped_apply, grouped_apply_plain, apk, apv)
    cases = {
        "fused_apply": {
            "main": (fused_on(d_t), fused_plain_on(d_t), apk, apv, 6,
                     lambda: ops(n, rng.choice(hot, size=n))),
            "one_bucket": (fused_on(d_hot), fused_plain_on(d_hot), apk, apv,
                           3, lambda: ops(n, rng.choice(few, size=n))),
            "b32": (lambda *a: fused_apply(d32, fr32, *a, dmax=dmax),
                    lambda *a: fused_apply_plain(d32, fr32, *a, dmax=dmax),
                    pk32, pv32, 4,
                    lambda: ops(n, half_live(rng, k32[:4096], n)))},
        "grouped_apply": {
            # the (bucket, lane) order the JAX package gives its kernel,
            # a quarter of the hot keys so that runs are long and rows
            # fill up; idle lanes keep real bucket ids
            "sorted": (*grouped, 6, lambda: sorted_ops(
                *routed(m, rng.choice(hot[:1024], size=m)), P)),
            # lane order, as kernels/ops.py hands the ops over
            "lane_order": (*grouped, 6, lambda: routed(
                m, rng.choice(hot[:1024], size=m))),
            # 256 keys over 3 chunks and 17 lanes: every bucket's ops span
            # the chunk borders
            "chunk_spanning": (*grouped, 3, lambda: routed(
                wide, rng.choice(hot[:256], size=wide))),
            "one_bucket": (*grouped, 2, lambda: ops(
                m + 17, rng.choice(few, size=m + 17))
                + [np.full(m + 17, r_hot)])}}
    results = {k: {} for k in cases}
    for kernel, kcases in cases.items():
        for case, (fn, plain, pk0, pv0, rounds, make) in kcases.items():
            res = apply_case(fn, plain, pk0, pv0, [
                [torch.tensor(np.asarray(x).astype(np.int32), device=dev)
                 for x in make()] for _ in range(rounds)], dev)
            results[kernel][case] = res
            emit({"phase": "kernel_case", "kernel": kernel, "case": case,
                  **res})
    for kernel, kres in results.items():
        for case, res in kres.items():
            check(res["mismatches"] == 0, f"{kernel} {case}: disagrees with "
                  f"its plain version in {res['mismatches']} outputs")
            check(res["trash_row_untouched"], f"{kernel} {case}: wrote the "
                  f"trash row")
    seen = set(results["fused_apply"]["main"]["statuses"])
    want = {ST_TRUE, ST_FALSE, ST_FULL, ST_FROZEN, ST_IDLE}
    check(want <= seen, f"statuses covered: {sorted(seen)}")
    g_seen = set(results["grouped_apply"]["sorted"]["statuses"])
    want = {ST_TRUE, ST_FALSE, ST_FULL, ST_IDLE}
    check(want <= g_seen, f"grouped statuses covered: {sorted(g_seen)}")
    for case in ("sorted", "lane_order"):
        check(results["grouped_apply"][case]["idle_lanes_on_live_buckets"]
              > 0, f"grouped_apply {case}: no idle lane on a live bucket")
    for kernel in results:
        hot_st = set(results[kernel]["one_bucket"]["statuses"])
        check({ST_TRUE, ST_FALSE} <= hot_st and ST_FULL not in hot_st,
              f"{kernel} one-bucket statuses {sorted(hot_st)}")
    apply_mm = sum(r["mismatches"] for r in results["fused_apply"].values())
    apply_err = max(r["max_abs_err"] for r in results["fused_apply"].values())
    g_mm = sum(r["mismatches"] for r in results["grouped_apply"].values())
    g_err = max(r["max_abs_err"] for r in results["grouped_apply"].values())
    probe_mm += row_checks["fused_probe"][0]
    probe_err = max(probe_err, row_checks["fused_probe"][1])
    routed_mm += row_checks["probe"][0]
    routed_err = max(routed_err, row_checks["probe"][1])
    row_cases = [f"{case}_b{B}" for case, B in ROW_CASES]
    emit({"phase": "kernels", "fused_probe": {
        "queries": n_q, "found": int(kf.sum()), "cases": row_cases,
        "mismatches": probe_mm, "max_abs_err": probe_err}, "probe": {
        "queries": n_q, "found": int(rf.sum()), "cases": row_cases,
        "mismatches": routed_mm, "max_abs_err": routed_err}, "fused_apply": {
        "cases": sorted(results["fused_apply"]), "mismatches": apply_mm,
        "max_abs_err": apply_err}, "grouped_apply": {
        "cases": sorted(results["grouped_apply"]), "mismatches": g_mm,
        "max_abs_err": g_err}, "ok": True})
    return {"fused_probe": (probe_mm, probe_err),
            "fused_apply": (apply_mm, apply_err),
            "probe": (routed_mm, routed_err),
            "grouped_apply": (g_mm, g_err)}


def probe_case(name, case, kernel, plain, first, q, pk_t, pv_t, live,
               dev, kw, **info):
    """One lookup kernel against its plain version on the queries ``q``:
    outputs equal and every live key found; one ``kernel_case`` line.
    Returns (mismatches, max abs err)."""
    q_t = torch.tensor(q.astype(np.int32), device=dev)
    n_live = int(np.isin(q, live).sum())
    kf, kv = kernel(first, q_t, pk_t, pv_t, **kw)
    pf, pvals = plain(first, q_t, pk_t, pv_t, **kw)
    torch.cuda.synchronize()
    mm = int((kf != pf).sum() + (kv != pvals).sum())
    err = int((kv.long() - pvals.long()).abs().max())
    found = int(kf.sum())
    emit({"phase": "kernel_case", "kernel": name, "case": case, **info,
          "queries": int(q.size), "found": found, "live_keys": n_live,
          "mismatches": mm, "max_abs_err": err})
    check(mm == 0, f"{name} {case}: disagrees with its plain version in "
          f"{mm} outputs")
    check(found == n_live, f"{name} {case}: found {found} of {n_live} live "
          "keys")
    return mm, err


def checked_apply_case(name, case, res, **info):
    """Emit and check an ``apply_case`` result: no mismatch, the trash row
    untouched, both TRUE and FALSE statuses seen. Returns (mismatches,
    max abs err)."""
    emit({"phase": "kernel_case", "kernel": name, "case": case, **info,
          **res})
    check(res["mismatches"] == 0, f"{name} {case}: disagrees with its "
          f"plain version in {res['mismatches']} outputs")
    check(res["trash_row_untouched"], f"{name} {case}: wrote the trash row")
    check({1, 0} <= set(res["statuses"]), f"{name} {case}: statuses "
          f"{res['statuses']}")
    return res["mismatches"], res["max_abs_err"]


def shift_cases(rng, dev, B=8):
    """The kernels at ``hash_shift = SHIFT``, the first non-zero value a
    path passes them (the sharded path's shards drop the shard id's bits):
    ``fused_probe`` and ``fused_apply`` hash and shift themselves; ``probe``
    and ``grouped_apply`` take bucket ids routed by the shifted hash in
    PyTorch. At the sharded path's own sizes: a shard's pool
    (``SHARD_SPEC``'s 2**18 rows) under a directory at its initial depth
    (14) of its dmax over shuffled rows, filled to about 60% by keys routed with the
    shift; ``fused_probe`` takes a round's ``LOOKUPS_PER_ROUND`` queries
    and ``probe`` the re-sharded rounds' ``WIDE_LOOKUPS``, the applies
    ``SHARD_SPEC``'s and ``SHARD2_SPEC``'s lanes. Each kernel against its
    plain version with the same shift, tolerance 0, one ``kernel_case``
    line per kernel. Returns {kernel: (mismatches, max abs err)}."""
    from repro_torch.kernels.apply import (fused_apply, fused_apply_plain,
                                           grouped_apply, grouped_apply_plain)
    from repro_torch.kernels.lookup import (fused_probe, fused_probe_plain,
                                            probe, probe_plain)
    dmax, depth, P = (SHARD_SPEC[k] for k in ("dmax", "initial_depth",
                                              "pool_size"))
    rows = rng.permutation(P)[: 1 << depth].astype(np.int32)
    directory = rows[np.arange(1 << dmax) >> (dmax - depth)]
    pk = np.full((P + 1, B), EMPTY, np.int32)
    pv = np.zeros((P + 1, B), np.int32)
    keys = distinct_keys(rng, int(0.6 * B * (1 << depth)))
    placed = place_keys(pk, pv, keys, route_np(keys, directory, dmax, SHIFT),
                        B, rng)
    live, absent = keys[placed], keys[~placed]
    q = rng.permutation(np.r_[live, absent[:live.size]]).astype(np.int32)
    d_t = torch.tensor(directory, device=dev)
    pk_t, pv_t = (torch.tensor(x[:-1], device=dev) for x in (pk, pv))
    out = {}
    for name, kernel, plain, width in (
            ("fused_probe", fused_probe, fused_probe_plain,
             LOOKUPS_PER_ROUND),
            ("probe", probe, probe_plain, WIDE_LOOKUPS)):
        qn = q[:width]
        if name == "probe":
            first, kw = torch.tensor(route_np(qn, directory, dmax, SHIFT)
                                     .astype(np.int32), device=dev), {}
        else:
            first, kw = d_t, dict(dmax=dmax, hash_shift=SHIFT)
        out[name] = probe_case(name, f"shift{SHIFT}_b{B}", kernel, plain,
                               first, qn, pk_t, pv_t, live, dev, kw,
                               hash_shift=SHIFT)

    fr_t = torch.zeros(P + 1, dtype=torch.bool, device=dev)
    n, m = SHARD_SPEC["n_lanes"], SHARD2_SPEC["n_lanes"]
    hot = live[:4096]

    def ops(width):
        k = np.where(rng.random(width) < 0.5, rng.choice(hot, size=width),
                     rng.choice(absent, size=width))
        return [rng.integers(0, 3, size=width), k,
                rng.integers(0, 2**31 - 1, size=width)]

    cases = {
        "fused_apply": (
            lambda *a: fused_apply(d_t, fr_t, *a, dmax=dmax,
                                   hash_shift=SHIFT),
            lambda *a: fused_apply_plain(d_t, fr_t, *a, dmax=dmax,
                                         hash_shift=SHIFT),
            lambda: ops(n)),
        "grouped_apply": (grouped_apply, grouped_apply_plain, lambda: (
            lambda o: o + [route_np(o[1], directory, dmax, SHIFT)])(
                ops(m)))}
    for name, (fn, plain, make) in cases.items():
        res = apply_case(fn, plain, pk, pv, [
            [torch.tensor(np.asarray(x).astype(np.int32), device=dev)
             for x in make()] for _ in range(4)], dev)
        out[name] = checked_apply_case(name, f"shift{SHIFT}", res,
                                       hash_shift=SHIFT)
    return out


def page_table_cases(rng, dev, depth=4):
    """The fused kernels at the LLM serving path's page table (phase 14):
    ``make_paged_config(deepseek-7b, 8, 1024, 16).table``, dmax 11 over
    4,096 pool rows of 8 slots, under a directory at ``depth`` over
    shuffled rows, holding the ``(seq << 12) | block`` keys of 8 slots'
    sequences of 1–16 blocks (about half full). ``fused_probe`` takes the
    step's pre-read (8 queries: each slot's current or next block) and the
    page-id lookup (512: all 64 blocks of every slot); ``fused_apply``
    takes 16-lane batches of the page table's mix, carried: a decode
    step's upserts (8 INS lanes, half on a new block, 8 idle lanes) and an
    eviction's per-block deletes (4 DEL lanes, 12 idle). Each kernel
    against its plain version, tolerance 0, one ``kernel_case`` line per
    case. Returns {kernel: (mismatches, max abs err)}."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.apply import fused_apply, fused_apply_plain
    from repro_torch.kernels.lookup import fused_probe, fused_probe_plain
    from repro_torch.serving import kvcache as KV
    from repro_torch.serving.engine import make_paged_config

    pc = make_paged_config(get_config(LLM_ARCH), LLM_BATCH, LLM_MAX_LEN,
                           LLM_PAGE)
    tbl, B, S = pc.table, pc.table.bucket_size, pc.batch
    dmax, P, lanes = tbl.dmax, tbl.pool_size, tbl.n_lanes
    rows = rng.permutation(P)[: 1 << depth].astype(np.int32)
    directory = rows[np.arange(1 << dmax) >> (dmax - depth)]
    seqs = rng.choice(np.arange(1, 1 << (31 - KV.BLOCK_BITS)), S,
                      replace=False)
    n_blk = rng.integers(1, 17, S)
    keys = np.concatenate([(s << KV.BLOCK_BITS) | np.arange(n)
                           for s, n in zip(seqs, n_blk)]).astype(np.int32)
    pk = np.full((P + 1, B), EMPTY, np.int32)
    pv = np.zeros((P + 1, B), np.int32)
    live = keys[place_keys(pk, pv, keys, route_np(keys, directory, dmax), B,
                           rng)]
    d_t = torch.tensor(directory, device=dev)
    pk_t, pv_t = (torch.tensor(x[:-1], device=dev) for x in (pk, pv))
    cur = n_blk - 1 + (rng.random(S) < 0.5)
    queries = {"page_q8": (seqs << KV.BLOCK_BITS) | cur,
               "page_q512": ((seqs[:, None] << KV.BLOCK_BITS)
                             | np.arange(pc.max_blocks)).reshape(-1)}
    geometry = dict(dmax=dmax, pool_rows=P, depth=depth)
    probes = [probe_case("fused_probe", case, fused_probe, fused_probe_plain,
                         d_t, q, pk_t, pv_t, live, dev, dict(dmax=dmax),
                         **geometry) for case, q in queries.items()]
    out = {"fused_probe": (sum(mm for mm, _ in probes),
                           max(err for _, err in probes))}

    def step_ops():
        blk = n_blk - 1 + (rng.random(S) < 0.5)
        kinds, k, v = (np.zeros(lanes, np.int64) for _ in range(3))
        kinds[:S], k[:S] = 1, (seqs << KV.BLOCK_BITS) | blk
        v[:S] = rng.integers(0, tbl.slab_capacity, S)
        return kinds, k, v

    def evict_ops():
        kinds, k, v = (np.zeros(lanes, np.int64) for _ in range(3))
        slots = rng.choice(S, 4, replace=False)
        kinds[:4] = 2
        k[:4] = (seqs[slots] << KV.BLOCK_BITS) | rng.integers(
            0, n_blk[slots] + 1)
        return kinds, k, v

    fr_t = torch.zeros(P + 1, dtype=torch.bool, device=dev)
    res = apply_case(
        lambda *a: fused_apply(d_t, fr_t, *a, dmax=dmax),
        lambda *a: fused_apply_plain(d_t, fr_t, *a, dmax=dmax), pk, pv,
        [[torch.tensor(x.astype(np.int32), device=dev) for x in make()]
         for make in (step_ops, evict_ops) * 4], dev)
    out["fused_apply"] = checked_apply_case(
        "fused_apply", f"page_mix{lanes}", res, **geometry)
    return out


# ---------------------------------------------------------------------------
# phase 3: the main path through the facade


class Oracle:
    """Dict oracle with lane-order semantics and O(1) random live keys."""

    def __init__(self):
        self.d, self.keys, self.pos = {}, [], {}

    def insert(self, k, v):
        new = k not in self.d
        if new:
            self.pos[k] = len(self.keys)
            self.keys.append(k)
        self.d[k] = v
        return 1 if new else 0

    def delete(self, k):
        if k not in self.d:
            return 0
        del self.d[k]
        i, last = self.pos.pop(k), self.keys.pop()
        if last != k:
            self.keys[i] = last
            self.pos[last] = i
        return 1


def traffic(rng, oracle: Oracle, fresh_iter, absent: np.ndarray, rounds,
            n_lookups, n_writes):
    """Host-side ops for every round and the results the oracle expects:
    one lookup batch (half live keys, half never-inserted keys) and one
    write transaction of ``n_writes`` ops (a quarter each: new inserts,
    updates, deletes of live keys, deletes of absent keys; lanes
    shuffled)."""
    out = []
    h, w = n_lookups // 2, n_writes // 4
    for _ in range(rounds):
        live = np.asarray(oracle.keys, np.int32)
        q = np.r_[rng.choice(live, size=h), rng.choice(absent, size=h)]
        q = rng.permutation(q).astype(np.int32)
        found = np.array([k in oracle.d for k in q.tolist()])
        vals = np.array([oracle.d.get(k, -1) for k in q.tolist()], np.int32)
        old = rng.choice(live, size=2 * w, replace=False)
        keys = np.r_[[next(fresh_iter) for _ in range(w)], old,
                     rng.choice(absent, size=w)].astype(np.int32)
        kinds = np.r_[np.full(2 * w, 1), np.full(2 * w, 2)].astype(np.int32)
        perm = rng.permutation(n_writes)
        keys, kinds = keys[perm], kinds[perm]
        values = rng.integers(0, 2**31 - 1, size=n_writes).astype(np.int32)
        status = np.array([oracle.insert(k, v) if c == 1 else oracle.delete(k)
                           for c, k, v in zip(kinds.tolist(), keys.tolist(),
                                              values.tolist())], np.int8)
        out.append((q, found, vals, kinds, keys, values, status))
    return out


def run_rounds(t, plan, dev):
    """Drive ``plan``'s rounds through the facade (a lookup, then a write
    transaction) and check every lookup and status against the oracle's.
    Returns (table, seconds of the driven rounds)."""
    dev_plan = [tuple(torch.tensor(x, device=dev) for x in (r[0], r[3], r[4],
                                                             r[5]))
                for r in plan]
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for q, kinds, keys_, values in dev_plan:
        outs.append(t.lookup(q))
        t, res = t.apply(kinds, keys_, values)
        outs.append(res.status)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    for r, (q, found, vals, _, _, _, status) in enumerate(plan):
        f, v = outs[2 * r]
        check(np.array_equal(f.cpu().numpy(), found), f"round {r} found")
        check(np.array_equal(v.cpu().numpy(), vals), f"round {r} values")
        check(np.array_equal(outs[2 * r + 1].cpu().numpy(), status),
              f"round {r} statuses")
    return t, secs


def mergeable_parents(snap, dmax, B):
    """(parent_prefix, parent_depth) of buddy pairs that can merge."""
    live = np.nonzero(snap["live"][:-1] & ~snap["frozen"][:-1])[0]
    d, p = snap["bdepth"][live], snap["bprefix"][live]
    left = live[(d >= 1) & (p % 2 == 0)]
    d, p = snap["bdepth"][left], snap["bprefix"][left]
    right = snap["directory"][(p.astype(np.int64) + 1) << (dmax - d)]
    c0, c1 = snap["counts"][left], snap["counts"][right]
    ok = ((snap["bdepth"][right] == d) & ~snap["frozen"][right]
          & (c0 < B) & (c1 < B) & (c0 + c1 <= B))
    return [(int(pp) >> 1, int(dd) - 1) for pp, dd in zip(p[ok], d[ok])]


def main_path(rng, dev):
    from repro_torch.core import table as T
    from repro_torch.core.invariants import check_invariants, to_dict
    from repro_torch.table_api import Table, TableSpec

    spec = TableSpec(**MAIN_SPEC, backend="cuda")
    cfg = spec.table_config()
    n_absent = PRELOAD // 2
    n_fresh = ROUNDS * MAIN_SPEC["n_lanes"] // 4
    keys = distinct_keys(rng, PRELOAD + n_fresh + n_absent)
    pre, fresh, absent = np.split(keys, [PRELOAD, PRELOAD + n_fresh])
    pre_vals = rng.integers(0, 2**31 - 1, size=PRELOAD).astype(np.int32)
    oracle = Oracle()
    for k, v in zip(pre.tolist(), pre_vals.tolist()):
        oracle.insert(k, v)
    plan = traffic(rng, oracle, iter(fresh.tolist()), absent, ROUNDS,
                   LOOKUPS_PER_ROUND, MAIN_SPEC["n_lanes"])

    t = Table.create(spec, device=dev)
    check(t.plan().backend == "cuda" and t.plan().fused_apply
          and t.plan().fused_lookup, "main path plan")
    zero_counts()

    t0 = time.perf_counter()
    t, res = t.insert(torch.tensor(pre, device=dev),
                      torch.tensor(pre_vals, device=dev))
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    check(bool((res.status == T.TRUE).all()), "preload statuses")
    depth_pre = int(t.depth())

    t, t_mix = run_rounds(t, plan, dev)

    # FROZEN through freeze_buddies, then one merge of another pair
    snap = T.to_numpy(t.state)
    parents = mergeable_parents(snap, cfg.dmax, cfg.bucket_size)
    check(len(parents) >= 2, "no mergeable buddy pairs")
    (fp, fd), (mp, md) = parents[0], parents[-1]
    _, ok = T.freeze_buddies(cfg, t.state, fp, fd)
    check(bool(ok), "freeze_buddies")
    b0 = int(snap["directory"][(fp * 2) << (cfg.dmax - fd - 1)])
    victim = next(int(k) for k in snap["keys"][b0] if k != EMPTY)
    t, res = t.insert([victim], [7])
    check(int(res.status[0]) == T.FROZEN, "frozen bucket status")
    m0 = int(snap["directory"][(mp * 2) << (cfg.dmax - md - 1)])
    m1 = int(snap["directory"][(mp * 2 + 1) << (cfg.dmax - md - 1)])
    moved = [int(k) for k in np.r_[snap["keys"][m0], snap["keys"][m1]]
             if k != EMPTY]
    t, ok = t.merge(mp, md)
    check(bool(ok), "merge")
    f, v = t.lookup(moved)
    check(bool(f.all()) and v.tolist() == [oracle.d[k] for k in moved],
          "merged keys")
    launches = read_counts()

    snap = T.to_numpy(t.state)
    check(not bool(snap["error"]), "error flag")
    check_invariants(cfg, snap)
    check(to_dict(cfg, snap) == oracle.d, "final content")
    check(launches["fused_probe"] > 0 and launches["fused_apply"] > 0
          and launches["probe"] == launches["grouped_apply"] == 0,
          f"launches {launches}")
    n_look = ROUNDS * LOOKUPS_PER_ROUND
    n_write = ROUNDS * MAIN_SPEC["n_lanes"]
    emit({"phase": "main_path", "spec": MAIN_SPEC, "preload_keys": PRELOAD,
          "preload_s": t_pre, "preload_inserts_per_s": PRELOAD / t_pre,
          "mixed_rounds": ROUNDS, "lookups": n_look, "writes": n_write,
          "mixed_s": t_mix, "mixed_ops_per_s": (n_look + n_write) / t_mix,
          "depth_after_preload": depth_pre, "depth": int(snap["depth"]),
          "live_buckets": int(snap["live"].sum()), "size": len(oracle.d),
          "launches": launches, "ok": True})
    return t, launches, oracle, absent


# ---------------------------------------------------------------------------
# phase 4: the wide path — restore the main table's image into 4,096-lane
# transactions, then the 90/10 mix at that width


def kernel_counts():
    from repro_torch.kernels.apply import fused_apply, grouped_apply
    from repro_torch.kernels.lookup import fused_probe, probe
    return {f.__name__: f for f in (fused_probe, fused_apply, probe,
                                    grouped_apply)}


def read_counts():
    torch.cuda.synchronize()
    return {name: f.launches for name, f in kernel_counts().items()}


def zero_counts():
    torch.cuda.synchronize()
    for f in kernel_counts().values():
        f.launches = 0


def wide_path(t_main, oracle: Oracle, absent, rng, dev):
    from repro_torch.core import table as T
    from repro_torch.core.invariants import check_invariants, to_dict
    from repro_torch.core.snapshot import load_image
    from repro_torch.table_api import Table, TableSpec

    spec = TableSpec(**WIDE_SPEC, backend="cuda")
    cfg = spec.table_config()
    plan = spec.plan("cuda")
    check(plan.backend == "cuda" and not plan.fused_lookup
          and not plan.fused_apply, f"wide path plan {plan}")
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    main_image = t_main.save(str(out_dir / "main.npz"))
    save_s = time.perf_counter() - t0
    image = load_image(main_image)
    check(image.n_items == len(oracle.d), "main image item count")

    zero_counts()
    t0 = time.perf_counter()
    tw = Table.restore(main_image, spec, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restore_launches = read_counts()
    snap = T.to_numpy(tw.state)
    check(not bool(snap["error"]), "restored error flag")
    check_invariants(cfg, snap)
    check(to_dict(cfg, snap) == oracle.d, "restored content")
    again = load_image(tw.save(str(out_dir / "wide.npz")))
    check(again.header == image.header
          and np.array_equal(again.keys, image.keys)
          and np.array_equal(again.values, image.values),
          "re-saved image differs")

    # the 90/10 mix at 4,096 lanes: new keys are neither live nor in the
    # never-inserted set the lookups and absent deletes draw from
    fresh = distinct_keys(rng, WIDE_ROUNDS * WIDE_SPEC["n_lanes"] // 2)
    fresh = fresh[~np.isin(fresh, np.fromiter(oracle.d, np.int32))
                  & ~np.isin(fresh, absent)]
    rounds = traffic(rng, oracle, iter(fresh.tolist()), absent, WIDE_ROUNDS,
                     WIDE_LOOKUPS, WIDE_SPEC["n_lanes"])
    zero_counts()
    tw, t_mix = run_rounds(tw, rounds, dev)
    mixed_launches = read_counts()
    snap = T.to_numpy(tw.state)
    check(not bool(snap["error"]), "wide error flag")
    check_invariants(cfg, snap)
    check(to_dict(cfg, snap) == oracle.d, "wide final content")
    for phase, launches in (("restore", restore_launches),
                            ("mixed", mixed_launches)):
        check(launches["probe"] + launches["grouped_apply"] > 0
              and launches["fused_probe"] == launches["fused_apply"] == 0,
              f"wide {phase} launches {launches}")
    check(mixed_launches["probe"] > 0 and restore_launches["grouped_apply"]
          > 0 and mixed_launches["grouped_apply"] > 0, "wide launches")
    n_look = WIDE_ROUNDS * WIDE_LOOKUPS
    n_write = WIDE_ROUNDS * WIDE_SPEC["n_lanes"]
    launches = {k: restore_launches[k] + mixed_launches[k]
                for k in restore_launches}
    emit({"phase": "wide_path", "spec": WIDE_SPEC,
          "plan": {"fused_lookup": plan.fused_lookup,
                   "fused_apply": plan.fused_apply},
          "image_items": image.n_items, "save_s": save_s,
          "restore_s": restore_s,
          "restore_items_per_s": image.n_items / restore_s,
          "restore_transactions": tw.seq - WIDE_ROUNDS,
          "resaved_image_identical": True, "mixed_rounds": WIDE_ROUNDS,
          "lookups": n_look, "writes": n_write, "mixed_s": t_mix,
          "mixed_ops_per_s": (n_look + n_write) / t_mix,
          "depth": int(snap["depth"]), "live_buckets": int(snap["live"].sum()),
          "size": len(oracle.d), "launches_restore": restore_launches,
          "launches_mixed": mixed_launches, "ok": True})
    return tw, launches, image.n_items / restore_s


# ---------------------------------------------------------------------------
# phase 5: the cuda plan against the plain plan


def plan_parity(t, rng, dev, spec_kw, steps, name):
    """``steps`` transactions and lookups under the ``"cuda"`` and the
    ``"plain"`` plan from one state: statuses and lookups equal, and the
    state equal with pool rows compared as sets."""
    from repro_torch.core import table as T
    from repro_torch.table_api import Table, TableSpec

    snap = T.to_numpy(t.state)
    tables = {b: Table.from_state(TableSpec(**spec_kw, backend=b),
                                  T.from_numpy_state(snap, dev), t.seq)
              for b in ("cuda", "plain")}
    live = snap["keys"][snap["live"]]
    live = live[live != EMPTY]
    n = spec_kw["n_lanes"]
    secs = {"cuda": 0.0, "plain": 0.0}
    for step in range(steps):
        kinds = rng.integers(0, 3, size=n).astype(np.int32)
        keys = np.where(rng.random(n) < 0.5, rng.choice(live, size=n),
                        rng.integers(1, 2**31 - 1, size=n)).astype(np.int32)
        vals = rng.integers(0, 2**31 - 1, size=n).astype(np.int32)
        q = torch.tensor(np.r_[keys, rng.choice(live, size=n)], device=dev)
        out = {}
        for b, tb in tables.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tb, res = tb.apply(kinds, keys, vals)
            found, v = tb.lookup(q)
            torch.cuda.synchronize()
            secs[b] += time.perf_counter() - t0
            tables[b] = tb
            out[b] = (res.status, found, v)
        for x, y in zip(out["cuda"], out["plain"]):
            check(torch.equal(x, y), f"plan parity step {step}")
    a, b = (T.to_numpy(tables[k].state) for k in ("cuda", "plain"))
    P = spec_kw["pool_size"]
    for f in a:
        x, y = a[f], b[f]
        if x.ndim and x.shape[0] == P + 1:
            x, y = x[:P], y[:P]
        if f in ("keys", "vals"):
            # rows as sets: the lane-order kernel and the single fast pass
            # may place a fresh insert in different free slots of a bucket
            order_x = np.argsort(a["keys"][:P], axis=1, kind="stable")
            order_y = np.argsort(b["keys"][:P], axis=1, kind="stable")
            x = np.take_along_axis(x, order_x, 1)
            y = np.take_along_axis(y, order_y, 1)
        check(np.array_equal(x, y), f"plan parity state field {f}")
    plan = tables["cuda"].plan()
    emit({"phase": "plan_parity", "path": name, "n_lanes": n,
          "cuda_plan_fused": [plan.fused_lookup, plan.fused_apply],
          "transactions": steps,
          "ms_per_transaction_cuda": secs["cuda"] / steps * 1e3,
          "ms_per_transaction_plain": secs["plain"] / steps * 1e3,
          "ok": True})


# ---------------------------------------------------------------------------
# phase 6: where a mixed round's time goes


def mixed_batches(rng, live, fresh, dev, rounds):
    """``rounds`` (queries, kinds, keys, values) of the main path's mix on
    the device: lookups half live keys; 128 new inserts, 128 updates, 128
    deletes of live keys, 128 deletes of never-inserted keys."""
    h = LOOKUPS_PER_ROUND // 2
    out = []
    for r in range(rounds):
        q = np.r_[rng.choice(live, h), rng.choice(fresh, h)]
        keys = np.r_[fresh[r * 128:(r + 1) * 128],
                     rng.choice(live, 256, replace=False),
                     rng.choice(fresh[-10_000:], 128)]
        kinds = np.r_[np.full(256, 1), np.full(256, 2)]
        perm = rng.permutation(512)
        vals = rng.integers(0, 2**31 - 1, 512)
        out.append(tuple(torch.tensor(x.astype(np.int32), device=dev) for x in
                         (rng.permutation(q), kinds[perm], keys[perm], vals)))
    return out


def profile_rounds(t, rng, dev, rounds=16):
    """Run A times the slow path (``apply_batch`` behind ST_FULL, wrapped
    with synchronizing host timers); run B traces the same kind of rounds
    with torch.profiler for the device's busy time and top kernels."""
    from torch.autograd import DeviceType

    from repro_torch.core import table as T

    snap = T.to_numpy(t.state)
    live = snap["keys"][snap["live"]]
    live = live[live != EMPTY]
    fresh = distinct_keys(rng, 2 * rounds * 128 + 20_000)
    fresh = fresh[~np.isin(fresh, live)]
    a, b = (mixed_batches(rng, live, fresh[i::2], dev, rounds)
            for i in range(2))

    slow = {"calls": 0, "s": 0.0}
    apply_batch = T.apply_batch

    def timed_apply_batch(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = apply_batch(*args)
        torch.cuda.synchronize()
        slow["s"] += time.perf_counter() - t0
        slow["calls"] += 1
        return out

    def run(t, batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for q, kinds, keys, vals in batches:
            t.lookup(q)
            t, res = t.apply(kinds, keys, vals)
        torch.cuda.synchronize()
        return t, time.perf_counter() - t0

    T.apply_batch = timed_apply_batch
    try:
        t, wall_a = run(t, a)
    finally:
        T.apply_batch = apply_batch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t, wall_b = run(t, b)
    busy, by_name = 0.0, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            busy += us
            name = e.name[:60]
            by_name[name] = by_name.get(name, 0.0) + us
    check(not bool(t.state.error), "error flag after profiled rounds")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    emit({"phase": "profile", "rounds": rounds,
          "ms_per_round": wall_a / rounds * 1e3,
          "slow_path_transactions": slow["calls"],
          "slow_path_share_of_wall": slow["s"] / wall_a,
          "traced_ms_per_round": wall_b / rounds * 1e3,
          "device_busy_ms_per_round": (busy / 1e3 / rounds if busy
                                       else "not measured"),
          "device_idle_share": 1 - busy / 1e3 / (wall_b * 1e3) if busy
          else "not measured",
          "top_device_ms_per_round": {k: v / 1e3 / rounds for k, v in top},
          "ok": True})
    return t


# ---------------------------------------------------------------------------
# phase 7: kernel times at the shapes of the path that launches them


def apply_bytes_needed(kinds, status, bids, B, lane_bytes):
    """Bytes one apply launch must move, from its own statuses: per lane
    ``lane_bytes`` (its op, status and, for ``fused_apply``, its directory
    and frozen entries and bid); one key-row read per bucket an op reached
    (TRUE, FALSE or FULL); a key-row and a value-row write per bucket a
    TRUE op changed (a fresh insert, or a delete that clears its slot and
    value); a value-row write per bucket whose only change is a FALSE
    upsert. Returns (bytes, buckets reached)."""
    from repro_torch.kernels.apply import ST_FALSE, ST_FULL, ST_TRUE
    row = B * 4

    def rows(mask):
        return int(torch.unique(bids[mask]).numel())

    hit = status == ST_TRUE
    reached = rows(hit | (status == ST_FALSE) | (status == ST_FULL))
    key_rows = rows(hit)
    val_rows = rows(hit | ((status == ST_FALSE) & (kinds == 1)))
    n = kinds.shape[0]
    return n * lane_bytes + (reached + key_rows + val_rows) * row, reached


def live_keys(t):
    from repro_torch.core import table as T
    snap = T.to_numpy(t.state)
    live = snap["keys"][snap["live"]]
    return live[live != EMPTY]


def half_live(rng, live, n):
    """``n`` keys, about half of them live: fresh per launch, so that the
    rows a launch reaches are cold in L2."""
    return np.where(rng.random(n) < 0.5, rng.choice(live, n),
                    rng.integers(1, 2**31 - 1, n)).astype(np.int32)


def write_ops(rng, live, n, dev, batches=64):
    """``batches`` write batches of ``n`` inserts and deletes, half on live
    keys."""
    return [[torch.tensor(x, device=dev) for x in (
        rng.integers(1, 3, size=n).astype(np.int32), half_live(rng, live, n),
        rng.integers(0, 2**31 - 1, n).astype(np.int32))]
        for _ in range(batches)]


def kernel_line(name, replaces, ms, plain, n_bytes, n_ops, launches, checks):
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu", "replaces": replaces,
            "launches": launches[name], "mismatches": checks[name][0],
            "max_abs_err": checks[name][1], "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def fused_times(t, rng, dev):
    """``fused_probe`` at 4,608 queries and ``fused_apply`` at 512 lanes on
    the main table."""
    from repro_torch.kernels.apply import fused_apply, fused_apply_plain
    from repro_torch.kernels.lookup import fused_probe, fused_probe_plain

    cfg, st = t.config, t.state
    B, n, N = cfg.bucket_size, cfg.n_lanes, LOOKUPS_PER_ROUND
    live = live_keys(t)
    qs = [torch.tensor(half_live(rng, live, N), device=dev)
          for _ in range(64)]
    pk, pv = st.keys[:-1], st.vals[:-1]
    kw = dict(dmax=cfg.dmax)
    probe_ms = cuda_ms(lambda i: fused_probe(st.directory, qs[i % 64], pk, pv,
                                             **kw), 200)
    probe_cold_ms = cold_ms(lambda i: fused_probe(
        st.directory, qs[i % 64], pk, pv, **kw), 200)
    probe_plain_ms = cuda_ms(lambda i: fused_probe_plain(
        st.directory, qs[i % 64], pk, pv, **kw), 20)
    hits = sum(int(fused_probe_plain(st.directory, q, pk, pv, **kw)[0].sum())
               for q in qs) / len(qs)
    probe_bytes = N * (4 + 4 + 4 * B + 1 + 4) + hits * 4

    # fused_apply on a scratch copy of the main state's pools
    ops = write_ops(rng, live, n, dev)
    spk, spv = st.keys.clone(), st.vals.clone()
    runs = []
    apply_ms = cuda_ms(lambda i: runs.append((i, fused_apply(
        st.directory, st.frozen, *ops[i % 64], spk, spv, **kw))), 200)
    apply_bytes, buckets = np.mean(
        [apply_bytes_needed(ops[i % 64][0], out[2], out[3], B, 12 + 4 + 1 + 8)
         for i, out in runs[2:]], axis=0)
    apply_plain_ms = host_ms(lambda i: fused_apply_plain(
        st.directory, st.frozen, *ops[i % 64], spk, spv, **kw), 20)
    return ({"fused_probe": (probe_ms, probe_plain_ms, probe_bytes,
                             N * (12 + 2 * B)),
             "fused_apply": (apply_ms, apply_plain_ms, apply_bytes,
                             n * (12 + 4 * B))},
            {"fused_probe_queries": N, "fused_probe_bytes": probe_bytes,
             "fused_probe_warm_ms": probe_ms,
             "fused_probe_cold_ms": probe_cold_ms,
             "fused_apply_lanes": n, "fused_apply_bytes": apply_bytes,
             "fused_apply_buckets": buckets})


def unfused_times(tw, rng, dev):
    """``probe`` at 36,864 queries and ``grouped_apply`` at 4,096 lanes in
    lane order on the wide table, with the route in PyTorch that the
    unfused path runs in front of them, the sort and un-sort it ran before
    and, for the lookup-route comparison, ``fused_probe`` on the same
    queries and table."""
    from repro_torch.core import table as T
    from repro_torch.kernels.apply import grouped_apply, grouped_apply_plain
    from repro_torch.kernels.lookup import fused_probe, probe, probe_plain

    cfg, st = tw.config, tw.state
    B, n, N, P = cfg.bucket_size, cfg.n_lanes, WIDE_LOOKUPS, cfg.pool_size
    live = live_keys(tw)
    qs = [torch.tensor(half_live(rng, live, N), device=dev)
          for _ in range(64)]
    pk, pv = st.keys[:-1], st.vals[:-1]
    bids = [T._route(cfg, st.directory, q)[1] for q in qs]
    route_ms = cuda_ms(lambda i: T._route(cfg, st.directory, qs[i % 64]),
                       200)
    probe_ms = cuda_ms(lambda i: probe(bids[i % 64], qs[i % 64], pk, pv), 200)
    probe_cold_ms = cold_ms(lambda i: probe(bids[i % 64], qs[i % 64], pk, pv),
                            200)
    fused_ms = cuda_ms(lambda i: fused_probe(st.directory, qs[i % 64], pk, pv,
                                             dmax=cfg.dmax), 200)
    probe_plain_ms = cuda_ms(lambda i: probe_plain(bids[i % 64], qs[i % 64],
                                                   pk, pv), 20)
    hits = sum(int(probe_plain(b, q, pk, pv)[0].sum())
               for b, q in zip(bids, qs)) / len(qs)
    probe_bytes = N * (4 + 4 + 4 * B + 1 + 4) + hits * 4

    # grouped_apply on a scratch copy of the wide state's pools, with the
    # ops routed as kernels/ops.py does it and left in lane order
    batches = [[kinds, keys, values, T._route(cfg, st.directory, keys)[1]]
               for kinds, keys, values in write_ops(rng, live, n, dev)]
    spk, spv = st.keys.clone(), st.vals.clone()
    runs = []
    apply_ms = cuda_ms(lambda i: runs.append((i, grouped_apply(
        *batches[i % 64], spk, spv))), 200)
    apply_bytes, buckets = np.mean(
        [apply_bytes_needed(batches[i % 64][0], out[2], batches[i % 64][3],
                            B, 16 + 1)
         for i, out in runs[2:]], axis=0)
    apply_plain_ms = host_ms(lambda i: grouped_apply_plain(
        *batches[i % 64], spk, spv), 20)

    status = torch.zeros(n, dtype=torch.int8, device=dev)
    raw = [write_ops(rng, live, n, dev, 1)[0] for _ in range(8)]
    raw_bids = [T._route(cfg, st.directory, k)[1] for _, k, _ in raw]
    live_mask = torch.ones(n, dtype=torch.bool, device=dev)

    def sort_unsort(i):
        kinds, keys, values = raw[i % 8]
        bid = raw_bids[i % 8]
        order = torch.argsort(torch.where(live_mask, bid, P + 1), stable=True)
        unsorted = torch.empty_like(status)
        unsorted[order] = status
        return kinds[order], keys[order], values[order], bid[order], unsorted

    # the stable sort and un-sort kernels/ops.py ran around grouped_apply
    # before the kernel grouped its ops itself: the yardstick of what the
    # kernel's grouping took away
    sort_ms = cuda_ms(sort_unsort, 200)
    return ({"probe": (probe_ms, probe_plain_ms, probe_bytes, N * 2 * B),
             "grouped_apply": (apply_ms, apply_plain_ms, apply_bytes,
                               n * 4 * B)},
            {"probe_queries": N, "probe_bytes": probe_bytes,
             "probe_warm_ms": probe_ms, "probe_cold_ms": probe_cold_ms,
             "route_torch_ms": route_ms,
             "routed_lookup_ms": route_ms + probe_ms,
             "fused_probe_same_queries_ms": fused_ms,
             "grouped_apply_lanes": n, "grouped_apply_bytes": apply_bytes,
             "grouped_apply_buckets": buckets, "sort_unsort_ms": sort_ms})


# the TPU kernel each CUDA kernel replaces (its jitted function's line)
REPLACES = {"fused_probe": "src/repro/kernels/lookup.py:190",
            "fused_apply": "src/repro/kernels/apply.py:307",
            "probe": "src/repro/kernels/lookup.py:92",
            "grouped_apply": "src/repro/kernels/apply.py:102"}


def ptxas_report():
    """Registers and spills of every kernel entry, from the ``ptxas -v``
    report the build keeps beside each library."""
    import re

    from repro_torch.kernels import _build
    out = {}
    for name in REPLACES:
        log = (_build.build_dir() / f"{name}.log").read_text()
        entries, cur = [], None
        for line in log.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                cur = {"entry": m.group(1)}
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m and cur is not None:
                cur.update(stack=int(m.group(1)), spill_stores=int(
                    m.group(2)), spill_loads=int(m.group(3)))
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m and cur is not None:
                cur["registers"] = int(m.group(1))
                entries.append(cur)
                cur = None
        check(entries, f"no ptxas report in {name}.log")
        out[name] = entries
    return out


def launch_floor_ms():
    """The device time of the cheapest launch, a one-element in-place add,
    timed with each of the kernels' harnesses: (``cuda_ms``, ``cold_ms``)."""
    x = torch.zeros(1, device="cuda")
    return cuda_ms(lambda i: x.add_(1), 200), cold_ms(lambda i: x.add_(1),
                                                      200)


def kernel_times(t, tw, rng, dev, launches, checks):
    times, info_main = fused_times(t, rng, dev)
    wide_times, info_wide = unfused_times(tw, rng, dev)
    times.update(wide_times)
    ptxas = ptxas_report()
    emit({"phase": "ptxas", "kernels": ptxas})
    for name in REPLACES:
        spills = [e for e in ptxas[name]
                  if e["spill_stores"] or e["spill_loads"]]
        check(not spills, f"{name} spills: {spills}")
    floor, floor_cold = launch_floor_ms()
    info = {**info_main, **info_wide}
    above = {}
    for k in ("fused_probe", "probe"):
        above[f"{k}_warm_above_floor_ms"] = info[f"{k}_warm_ms"] - floor
        above[f"{k}_cold_above_floor_ms"] = info[f"{k}_cold_ms"] - floor_cold
    emit({"phase": "kernel_times", **info, "launch_floor_ms": floor,
          "launch_floor_cold_ms": floor_cold, **above, "ok": True})
    lines = [kernel_line(name, REPLACES[name], *times[name], launches,
                         checks) for name in REPLACES]
    for line in lines:
        line["registers"] = [e["registers"] for e in ptxas[line["name"]]]
        if line["name"] in ("fused_probe", "probe"):
            line["cold_ms"] = info[f"{line['name']}_cold_ms"]
    return lines


# ---------------------------------------------------------------------------
# phase 8: the page-table path — a value schema at full size


class PageOracle:
    """The page table's expected content: ``(seq << BLOCK_BITS) | block`` →
    (page, length) for every block of every admitted, unevicted sequence,
    as arrays over (sequence, block)."""

    def __init__(self, n_rows: int, rng):
        self.rng = rng
        self.mapped = np.zeros(n_rows, bool)
        self.page = np.zeros((n_rows, PAGE_BLOCKS), np.int32)
        self.length = np.zeros((n_rows, PAGE_BLOCKS), np.int32)

    def admit(self, seqs, pages):
        """Map every block of ``seqs`` to ``pages`` [len(seqs), blocks]:
        full pages but the last, which holds 1..PAGE_TOKENS tokens."""
        self.mapped[seqs] = True
        self.page[seqs] = pages
        self.length[seqs] = PAGE_TOKENS
        self.length[seqs, -1] = self.rng.integers(1, PAGE_TOKENS + 1,
                                                  size=len(seqs))

    def expect(self, keys):
        """(found, page, length) a lookup of ``keys`` must return."""
        seq, block = keys >> BLOCK_BITS, keys & ((1 << BLOCK_BITS) - 1)
        found = self.mapped[seq]
        return (found, np.where(found, self.page[seq, block], 0),
                np.where(found, self.length[seq, block], 0))

    def live_keys(self):
        seqs = np.nonzero(self.mapped)[0]
        return page_keys(seqs)


def page_keys(seqs):
    """Every block's key of ``seqs``, sequence by sequence."""
    return ((np.asarray(seqs, np.int64)[:, None] << BLOCK_BITS)
            | np.arange(PAGE_BLOCKS)).reshape(-1).astype(np.int32)


def page_rounds(rng, po: PageOracle, active: list, next_seq: int, rounds,
                n_lookups):
    """Host-side rounds of the serving tier's page-table traffic and what
    each must return: a lookup of ``n_lookups`` keys (half blocks of live
    sequences, half of sequences never admitted), then one write
    transaction — the blocks of one evicted sequence deleted, the blocks of
    one admitted sequence inserted on the freed pages, and ``length``
    upserts (same page) of live blocks for the other lanes; lanes
    shuffled. Returns (rounds, next_seq)."""
    n = MAIN_SPEC["n_lanes"]
    n_upd = n - 2 * PAGE_BLOCKS
    never = np.arange(len(po.mapped) // 2, len(po.mapped))
    out = []
    for _ in range(rounds):
        live = np.asarray(active)
        h = n_lookups // 2
        q = np.r_[(rng.choice(live, h).astype(np.int64) << BLOCK_BITS)
                  | rng.integers(0, PAGE_BLOCKS, h),
                  (rng.choice(never, h).astype(np.int64) << BLOCK_BITS)
                  | rng.integers(0, PAGE_BLOCKS, h)]
        q = rng.permutation(q).astype(np.int32)
        want_q = po.expect(q)
        victim = active.pop(int(rng.integers(len(active))))
        pages = po.page[victim].copy()
        po.mapped[victim] = False
        new = next_seq
        next_seq += 1
        po.admit([new], pages[None])
        # distinct live blocks of the other sequences: one write per key
        flat = rng.choice(len(active) * PAGE_BLOCKS, n_upd, replace=False)
        upd_seq = np.asarray(active)[flat // PAGE_BLOCKS]
        upd_blk = flat % PAGE_BLOCKS
        po.length[upd_seq, upd_blk] = rng.integers(1, PAGE_TOKENS + 1,
                                                   size=n_upd)
        active.append(new)
        keys = np.r_[page_keys([victim]), page_keys([new]),
                     (upd_seq.astype(np.int64) << BLOCK_BITS) | upd_blk]
        kinds = np.r_[np.full(PAGE_BLOCKS, 2), np.full(PAGE_BLOCKS, 1),
                      np.full(n_upd, 1)]
        status = np.r_[np.ones(2 * PAGE_BLOCKS), np.zeros(n_upd)]
        perm = rng.permutation(len(keys))
        keys, kinds, status = (keys[perm].astype(np.int32),
                               kinds[perm].astype(np.int32),
                               status[perm].astype(np.int8))
        _, page, length = po.expect(keys)
        out.append((q, want_q, kinds, keys, page, length, status))
    return out, next_seq


def check_payloads(found, vals, want, what):
    check(np.array_equal(found.cpu().numpy(), want[0]), f"{what}: found")
    for name, w in zip(("page", "length"), want[1:]):
        check(np.array_equal(vals[name].cpu().numpy(), w),
              f"{what}: {name}")


def run_page_rounds(t, rounds, dev):
    """Drive the page-table rounds (a lookup, then a write transaction) and
    check every status and payload. Returns (table, seconds)."""
    dev_rounds = [tuple(torch.tensor(x, device=dev) for x in
                        (r[0], r[2], r[3], r[4], r[5])) for r in rounds]
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for q, kinds, keys, page, length in dev_rounds:
        outs.append(t.lookup(q))
        t, res = t.apply(kinds, keys, {"page": page, "length": length})
        outs.append(res.status)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    for r, (_, want_q, *_, status) in enumerate(rounds):
        check_payloads(*outs[2 * r], want_q, f"page round {r} lookup")
        check(np.array_equal(outs[2 * r + 1].cpu().numpy(), status),
              f"page round {r} statuses")
    return t, secs


SCHEMA_STAGES = ("pre_lookup", "allocation", "kernel_apply", "scatter",
                 "post_lookup", "reconciliation")


def timed_schema_writes(ts, rounds, dev):
    """The same write transactions on the page table and on a raw table
    holding the same state (``page`` as its value), in turns: host ms per
    transaction of each (a synchronize around every call), the schema
    transaction's stages on the stream (CUDA events around the facade's
    stage functions), its kernel launches, and the transactions that took
    the ``ST_FULL`` slow path. Both must return the expected statuses.
    Returns (page table, report)."""
    from repro_torch import table_api
    from repro_torch.core import table as T
    from repro_torch.table_api import Table, TableSpec

    raw = Table.from_state(TableSpec(**MAIN_SPEC, backend="cuda"),
                           T.from_numpy_state(T.to_numpy(ts.state), dev),
                           ts.seq)
    stage_fns = {"allocation": "_alloc_handles", "kernel_apply": "_raw_apply",
                 "scatter": "_write_payloads",
                 "reconciliation": "_reconcile_handles"}
    originals = {f: getattr(table_api, f) for f in
                 list(stage_fns.values()) + ["_raw_lookup"]}
    events = []

    def timed(name, fn):
        def run(*args):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            out = fn(*args)
            e1.record()
            events.append((name, e0, e1))
            return out
        return run

    lookups = []

    def timed_lookup(*args):
        lookups.append(None)
        name = "pre_lookup" if len(lookups) % 2 else "post_lookup"
        return timed(name, originals["_raw_lookup"])(*args)

    slow = {"raw": 0, "schema": 0}
    side = ["raw"]
    apply_batch = T.apply_batch

    def counted_apply_batch(*args):
        slow[side[0]] += 1
        return apply_batch(*args)

    counters = kernel_counts()
    secs = {"raw": 0.0, "schema": 0.0}
    per_txn = []
    T.apply_batch = counted_apply_batch
    try:
        for r, (_, _, kinds, keys, page, length, status) in enumerate(rounds):
            args = [torch.tensor(x, device=dev) for x in (kinds, keys, page,
                                                          length)]
            torch.cuda.synchronize()
            side[0] = "raw"
            t0 = time.perf_counter()
            raw, res_raw = raw.apply(args[0], args[1], args[2])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            before = {k: f.launches for k, f in counters.items()}
            side[0] = "schema"
            for name, fn in stage_fns.items():
                setattr(table_api, fn, timed(name, originals[fn]))
            table_api._raw_lookup = timed_lookup
            try:
                ts, res = ts.apply(args[0], args[1], {"page": args[2],
                                                      "length": args[3]})
                torch.cuda.synchronize()
            finally:
                for fn, orig in originals.items():
                    setattr(table_api, fn, orig)
            t2 = time.perf_counter()
            secs["raw"] += t1 - t0
            secs["schema"] += t2 - t1
            per_txn.append({k: f.launches - before[k]
                            for k, f in counters.items()})
            for res_, what in ((res_raw, "raw"), (res, "schema")):
                check(np.array_equal(res_.status.cpu().numpy(), status),
                      f"timed {what} round {r} statuses")
    finally:
        T.apply_batch = apply_batch
    torch.cuda.synchronize()
    stages = {k: 0.0 for k in SCHEMA_STAGES}
    for name, e0, e1 in events:
        stages[name] += e0.elapsed_time(e1)
    n = len(rounds)
    launches = {k: [p[k] for p in per_txn] for k in counters}
    check(all(x == 2 for x in launches["fused_probe"])
          and all(x == 1 for x in launches["fused_apply"])
          and not any(launches["probe"] + launches["grouped_apply"]),
          f"launches per schema transaction {launches}")
    return ts, {
        "transactions": n,
        "ms_per_transaction_raw": secs["raw"] / n * 1e3,
        "ms_per_transaction_schema": secs["schema"] / n * 1e3,
        "stage_ms_per_transaction": {k: v / n for k, v in stages.items()},
        "launches_per_schema_transaction": {
            k: sum(v) / n for k, v in launches.items()},
        "slow_path_transactions_raw": slow["raw"],
        "slow_path_transactions_schema": slow["schema"]}


def schema_path(rng, dev, raw_restore_rate):
    """The serving tier's page table at full size: the main geometry with
    the ``(page, length)`` value schema, 2**19 block mappings preloaded in
    512-lane inserts, the 90/10 rounds of ``page_rounds`` against the
    oracle, the schema transaction timed against a raw one, then a save and
    a restore into 4,096-lane transactions (``grouped_apply``, ``probe``)
    with every payload checked."""
    from repro_torch.core import table as T
    from repro_torch.core.invariants import check_invariants
    from repro_torch.table_api import Table, TableSpec

    spec = TableSpec(**MAIN_SPEC, backend="cuda", value_schema=PAGE_SCHEMA)
    cfg = spec.table_config()
    n_rows = 2 * (PAGE_SEQS + ROUNDS + PAGE_TIMED)
    po = PageOracle(n_rows, rng)
    active = list(range(PAGE_SEQS))
    po.admit(active, rng.permutation(PAGE_SEQS * PAGE_BLOCKS).astype(
        np.int32).reshape(PAGE_SEQS, PAGE_BLOCKS))
    pre = po.live_keys()
    _, pre_page, pre_len = po.expect(pre)
    rounds, next_seq = page_rounds(rng, po, active, PAGE_SEQS, ROUNDS,
                                   LOOKUPS_PER_ROUND)
    timed_rounds, _ = page_rounds(rng, po, active, next_seq, PAGE_TIMED,
                                  LOOKUPS_PER_ROUND)

    t = Table.create(spec, device=dev)
    check(t.plan().backend == "cuda" and t.plan().fused_apply
          and t.plan().fused_lookup, "page table plan")
    zero_counts()
    t0 = time.perf_counter()
    t, res = t.insert(torch.tensor(pre, device=dev), {
        "page": torch.tensor(pre_page, device=dev),
        "length": torch.tensor(pre_len, device=dev)})
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    check(bool((res.status == T.TRUE).all()), "page preload statuses")
    t, t_mix = run_page_rounds(t, rounds, dev)
    launches = read_counts()
    t, timing = timed_schema_writes(t, timed_rounds, dev)

    want = po.live_keys()
    size = int(t.size())
    snap = T.to_numpy(t.state)
    check(not bool(snap["error"]), "page table error flag")
    check_invariants(cfg, snap)
    check(size == want.size, f"page table size {size} != {want.size}")
    check(int(t.slab_live.sum()) == size + 1, "slab_live != size + 1")
    check_payloads(*t.lookup(torch.tensor(want, device=dev)),
                   po.expect(want), "page table content")
    check(launches["fused_probe"] > 0 and launches["fused_apply"] > 0
          and launches["probe"] == launches["grouped_apply"] == 0,
          f"page table launches {launches}")

    # the wide restore: the image into 4,096-lane transactions
    wspec = TableSpec(**WIDE_SPEC, backend="cuda", value_schema=PAGE_SCHEMA)
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    path = t.save(str(out_dir / "pages.npz"))
    save_s = time.perf_counter() - t0
    zero_counts()
    t0 = time.perf_counter()
    tw = Table.restore(path, wspec, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restore_launches = read_counts()
    check(not bool(tw.state.error), "restored page table error flag")
    check_invariants(wspec.table_config(), tw.state)
    check(int(tw.size()) == size and int(tw.slab_live.sum()) == size + 1,
          "restored page table size / slab_live")
    check_payloads(*tw.lookup(torch.tensor(want, device=dev)),
                   po.expect(want), "restored page table content")
    check(restore_launches["grouped_apply"] > 0
          and restore_launches["probe"] > 0
          and restore_launches["fused_probe"]
          == restore_launches["fused_apply"] == 0,
          f"page table restore launches {restore_launches}")
    n_look = ROUNDS * LOOKUPS_PER_ROUND
    n_write = ROUNDS * MAIN_SPEC["n_lanes"]
    emit({"phase": "schema_path", "spec": MAIN_SPEC,
          "value_schema": [list(f) for f in spec.value_schema],
          "slab_rows": spec.slab_rows, "sequences": PAGE_SEQS,
          "blocks_per_sequence": PAGE_BLOCKS, "preload_keys": int(pre.size),
          "preload_s": t_pre, "preload_inserts_per_s": pre.size / t_pre,
          "mixed_rounds": ROUNDS, "lookups": n_look, "writes": n_write,
          "mixed_s": t_mix, "mixed_ops_per_s": (n_look + n_write) / t_mix,
          "status_mismatches": 0, "payload_mismatches": 0,
          "content_mismatches": 0, "size": size,
          "slab_live": int(t.slab_live.sum()), "depth": int(t.depth()),
          "launches": launches, **timing, "save_s": save_s,
          "restore_s": restore_s, "restore_items_per_s": size / restore_s,
          "raw_restore_items_per_s": raw_restore_rate,
          "restore_transactions": tw.seq,
          "launches_restore": restore_launches,
          "restored_payloads_equal_oracle": True, "ok": True})
    return t


# ---------------------------------------------------------------------------
# phase 9: the elastic path — a fill → drain → refill trace with the policy


# policy calls traced with torch.profiler: eight in the fill, eight in the
# drain (one call per step: a step's mutations fit one 512-lane transaction)
PROFILED_POLICY_CALLS = {"fill": range(200, 208), "drain": range(1600, 1608)}


def elastic_replay(spec, trace, dev):
    """``replay`` of ``trace`` on a fresh ``spec`` table, with host timers
    (a synchronize around each call) on its write transactions and on the
    policy's passes, counts of the merge pass's host reads and of the
    transactions that took the ``ST_FULL`` slow path, and the device
    kernels of the ``PROFILED_POLICY_CALLS`` (torch.profiler: their count
    and device time per call, beside the call's wall time)."""
    from torch.autograd import DeviceType

    from repro_torch import table_api
    from repro_torch.core import policy
    from repro_torch.core import table as T
    from repro_torch.workloads import replay

    traced = {k: {"calls": 0, "device_kernels": 0, "device_ms": 0.0,
                  "wall_ms": 0.0} for k in PROFILED_POLICY_CALLS}

    def profiled(fn):
        def run(*args):
            phase = next((k for k, r in PROFILED_POLICY_CALLS.items()
                          if acc["policy"][0] in r), None)
            if phase is None:
                return fn(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                out = fn(*args)
                torch.cuda.synchronize()
            row = traced[phase]
            row["wall_ms"] += (time.perf_counter() - t0) * 1e3
            row["calls"] += 1
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    row["device_kernels"] += 1
                    row["device_ms"] += e.time_range.elapsed_us() / 1e3
            return out
        return run

    acc = {k: [0, 0.0] for k in ("transaction", "policy", "split_pass",
                                 "merge_pass")}
    reads = [0]

    def timed(name, fn):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            acc[name][0] += 1
            acc[name][1] += time.perf_counter() - t0
            return out
        return run

    def counted(fn, counter):
        def run(*args):
            counter[0] += 1
            return fn(*args)
        return run

    slow = [0]

    patches = [(table_api, "_raw_apply", timed("transaction",
                                                table_api._raw_apply)),
               (policy, "apply_policy", timed("policy", profiled(
                   policy.apply_policy))),
               (policy, "_policy_split", timed("split_pass",
                                               policy._policy_split)),
               (policy, "_policy_merge", timed("merge_pass",
                                               policy._policy_merge)),
               (policy, "_merge_candidate", counted(policy._merge_candidate,
                                                    reads)),
               (T, "apply_batch", counted(T.apply_batch, slow))]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    zero_counts()
    t0 = time.perf_counter()
    try:
        rep = replay(spec, trace, device=dev, oracle="streaming",
                     raise_on_mismatch=False)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    wall = time.perf_counter() - t0
    launches = read_counts()
    check(rep["status_mismatches"] == 0 and rep["content_mismatches"] == 0,
          f"elastic replay mismatches: {rep['mismatch_examples']}")
    check(rep["ok"], "elastic replay error flag")
    check(launches["fused_probe"] > 0 and launches["fused_apply"] > 0
          and launches["probe"] == launches["grouped_apply"] == 0,
          f"elastic launches {launches}")
    n = acc["transaction"][0]
    times = {f"ms_per_{k}": (v[1] / v[0] * 1e3 if v[0] else 0.0)
             for k, v in acc.items()}
    per_call = {k: {m: v / max(row["calls"], 1) for m, v in row.items()
                    if m != "calls"} for k, row in traced.items()}
    return rep, {"wall_s": wall, "transactions": n, **times,
                 "policy_share_of_transaction": (acc["policy"][1]
                                                 / acc["transaction"][1]),
                 "host_reads_per_transaction": reads[0] / n,
                 "slow_path_transactions": slow[0],
                 "traced_policy_call": per_call, "launches": launches}


def depth_by_phase(rep):
    """{phase: [depth at its start, min, max, at its end]} from the replay's
    per-step depth trajectory."""
    traj, out, i = rep["depth"]["trajectory"], {}, 0
    for row in rep["phases"]:
        seg = traj[i:i + row["steps"] + 1]
        out[row["name"]] = [seg[0], min(seg), max(seg), seg[-1]]
        i += row["steps"]
    return out


def elastic_path(seed, dev):
    """The scenarios' ``POLICY`` on the main geometry, pinned to its initial
    depth, driven by ``replay`` through ``trace.phased`` (fill → stable →
    drain → maintain → refill) against the streaming oracle; then the same
    trace on the same geometry without the policy."""
    from repro_torch.table_api import TableSpec
    from repro_torch.workloads.scenarios import POLICY
    from repro_torch.workloads.trace import phased

    policy = dataclasses.replace(POLICY, min_depth=MAIN_SPEC["initial_depth"])
    trace = phased("elastic", seed=seed, **ELASTIC_TRACE)
    rep, info = elastic_replay(
        TableSpec(**MAIN_SPEC, backend="cuda", resize_policy=policy), trace,
        dev)
    check(rep["policy"]["splits"] > 0 and rep["policy"]["merges"] > 0,
          f"elastic policy actions {rep['policy']}")
    rep0, info0 = elastic_replay(TableSpec(**MAIN_SPEC, backend="cuda"),
                                 trace, dev)
    emit({"phase": "elastic_path", "spec": MAIN_SPEC,
          "policy": dataclasses.asdict(policy), "trace": ELASTIC_TRACE,
          "phases": [[p.name, p.steps, p.mix] for p in trace.phases],
          "steps": rep["steps"], "mutations": rep["mutations"],
          "reads": rep["reads"], "status_mismatches": 0,
          "content_mismatches": 0, "auto_splits": rep["policy"]["splits"],
          "auto_merges": rep["policy"]["merges"],
          "depth": {k: v for k, v in rep["depth"].items()
                    if k != "trajectory"},
          "depth_by_phase": depth_by_phase(rep),
          "with_policy": info,
          "without_policy": {**info0, "depth": {
              k: v for k, v in rep0["depth"].items() if k != "trajectory"},
              "depth_by_phase": depth_by_phase(rep0)},
          "ok": True})


# ---------------------------------------------------------------------------
# phase 10: the serving path — the router over the main table


class ServeClients:
    """Closed-loop clients over the main path's mix: each keeps one
    request in flight; 90% lookups (half live keys, half never-inserted
    ones), 10% writes (a quarter each: new inserts, upserts and deletes of
    live keys, deletes of never-inserted keys). Results are checked
    against the dict oracle in the router's linearization order."""

    def __init__(self, rng, oracle: Oracle, fresh, absent, n, requests,
                 retry_s=None):
        from repro_torch.serving.router import DEL, INS, READ, shard_of
        self.kinds, self.shard_of = (READ, INS, DEL), shard_of
        self.rng, self.oracle = rng, oracle
        self.fresh, self.absent = iter(fresh.tolist()), absent
        self.remaining = [requests] * n
        self.ready = [(0.0, c) for c in range(n)]       # a heap
        self.in_flight = {}
        self.status_mm = self.content_mm = self.completed = 0
        self.examples = []
        # with retry_s, a shed request is counted by its home shard (per
        # shard count of the router's spec) and its client retries
        # retry_s later; without it, a shed fails the run
        self.retry_s, self.shed = retry_s, {}

    def pick(self):
        READ, INS, DEL = self.kinds
        r, live = self.rng, self.oracle.keys
        u = r.random()
        if u < 0.9:
            if u < 0.45:
                return READ, live[int(r.integers(len(live)))], 0
            return READ, int(self.absent[int(r.integers(len(self.absent)))]), 0
        w = int(r.integers(4))
        value = int(r.integers(0, 2**31 - 1))
        if w == 0:
            return INS, next(self.fresh), value
        if w == 3:
            return DEL, int(self.absent[int(r.integers(len(self.absent)))]), 0
        key = live[int(r.integers(len(live)))]
        return (INS if w == 1 else DEL), key, value

    def submit_ready(self, router, now):
        import heapq
        while self.ready and self.ready[0][0] <= now:
            _, c = heapq.heappop(self.ready)
            kind, key, value = self.pick()
            req, decision = router.submit(kind, key, value, now=now)
            if req is None:
                check(self.retry_s is not None, f"request shed: {decision}")
                spec = router.table.spec
                per = self.shed.setdefault(spec.n_shards, [0] * spec.n_shards)
                per[self.shard_of(key, spec)] += 1
                heapq.heappush(self.ready, (now + self.retry_s, c))
                continue
            self.in_flight[req.rid] = c

    def absorb(self, done):
        import heapq
        READ, INS, _ = self.kinds
        o = self.oracle
        for req in done:
            self.completed += 1
            c = self.in_flight.pop(req.rid)
            self.remaining[c] -= 1
            if self.remaining[c]:
                heapq.heappush(self.ready, (req.t_complete, c))
            if req.kind == READ:
                got = (req.found, req.result if req.found else None)
                want = (req.key in o.d, o.d.get(req.key))
                bad = got != want
                self.content_mm += bad
            else:
                want = (o.insert(req.key, req.value) if req.kind == INS
                        else o.delete(req.key))
                got = req.status
                bad = got != want
                self.status_mm += bad
            if bad and len(self.examples) < 8:
                self.examples.append([req.kind, req.key, got, want])

    def next_time(self, router, now, busy_until):
        """The next moment something can happen: a client's ready time,
        the oldest queued request's ``max_delay_s`` deadline, or now if a
        dispatch is due — never before the last dispatch completed."""
        if router.should_dispatch(now):
            return max(now, busy_until)
        times = [self.ready[0][0]] if self.ready else []
        if len(router.queues):
            times.append(now + router.config.max_delay_s
                         - router.queues.oldest_wait(now))
        if not times:
            return now
        # the deadline can round to ``now`` itself while the oldest request
        # is still an ulp short of ``max_delay_s``: step at least one ulp,
        # or the clock stands still and nothing ever dispatches
        return max(min(times), busy_until, float(np.nextafter(now, np.inf)))


class FacadeCalls:
    """While active, counts the facade's calls into its dispatch point:
    ``_raw_apply`` (one per write transaction) and ``_raw_lookup`` (one
    per lookup batch), each of which launches a kernel once per shard."""

    def __enter__(self):
        from repro_torch import table_api as TA
        self.n = {"apply": 0, "lookup": 0}
        self.saved = TA._raw_apply, TA._raw_lookup

        def counted(name, fn):
            def run(*args):
                self.n[name] += 1
                return fn(*args)
            return run

        TA._raw_apply = counted("apply", self.saved[0])
        TA._raw_lookup = counted("lookup", self.saved[1])
        return self

    def __exit__(self, *exc):
        from repro_torch import table_api as TA
        TA._raw_apply, TA._raw_lookup = self.saved

    def take(self) -> dict:
        out, self.n = self.n, {"apply": 0, "lookup": 0}
        return out


def queued_home_shards(router) -> list:
    """A recount of the router's queued requests by their keys' home shards
    under its table's spec."""
    from repro_torch.serving.router import shard_of
    spec = router.table.spec
    out = [0] * spec.n_shards
    for q in (router.queues._reads, router.queues._writes):
        for req in q:
            out[shard_of(req.key, spec)] += 1
    return out


def serve_requests(router, clients, wide_spec):
    """Drive ``clients`` through ``router`` on a virtual clock; hand over
    onto ``wide_spec`` once half the requests completed, with requests
    still queued. Returns (launches before, at and after the handover —
    with the facade's calls under ``calls_*`` and the per-shard queue
    depths just before and after the handover and their recount by home
    shard under ``queue_depths`` —, summed service seconds, handover
    seconds, virtual seconds)."""
    total = sum(clients.remaining)
    now = busy_until = service_s = 0.0
    launches, handover_s = {}, 0.0
    zero_counts()
    with FacadeCalls() as calls:
        while clients.ready or len(router.queues):
            clients.submit_ready(router, now)
            if (not launches and clients.completed >= total // 2
                    and len(router.queues)):
                launches["before"] = read_counts()
                launches["calls_before"] = calls.take()
                zero_counts()
                depths = router.queues.depths()
                t0 = time.perf_counter()
                router.handover(wide_spec)
                torch.cuda.synchronize()
                handover_s = time.perf_counter() - t0
                launches["queue_depths"] = {
                    "before": depths, "after": router.queues.depths(),
                    "recount_after": queued_home_shards(router)}
                launches["handover"] = read_counts()
                launches["calls_handover"] = calls.take()
                zero_counts()
            done = router.pump(now=now)
            if done:
                busy_until = done[0].t_complete
                service_s += done[0].t_complete - done[0].t_dispatch
                clients.absorb(done)
            now = clients.next_time(router, now, busy_until)
        launches["after"] = read_counts()
        launches["calls_after"] = calls.take()
    return launches, service_s, handover_s, now


def latency_ms(hist):
    s = hist.summary()
    return {k: s[k] for k in ("p50_ms", "p99_ms", "p999_ms", "mean_ms")}


def serving_path(rng, dev, seed):
    """The router at full size: the main image restored under MAIN_SPEC,
    its cost model measured, SERVE_CLIENTS x SERVE_REQUESTS closed-loop
    requests checked against a dict oracle, a handover onto WIDE_SPEC
    halfway; then ``serve_closed_loop`` on the main geometry with the
    scenarios' policy, handed over onto the wide geometry."""
    from repro_torch.core.invariants import check_invariants, to_dict
    from repro_torch.core.snapshot import load_image
    from repro_torch.serving.router import (Router, RouterConfig,
                                            measure_cost_model)
    from repro_torch.table_api import Table, TableSpec
    from repro_torch.workloads import serve_closed_loop
    from repro_torch.workloads.scenarios import POLICY

    t_phase = time.perf_counter()
    path = str(ROOT / "build" / "chip_smoke" / "main.npz")
    image = load_image(path)
    oracle = Oracle()
    for k, v in zip(image.keys.tolist(), image.values.tolist()):
        oracle.insert(k, v)
    spec = TableSpec(**MAIN_SPEC, backend="cuda")
    t0 = time.perf_counter()
    table = Table.restore(path, spec, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    cost = measure_cost_model(table)
    n_writes = SERVE_CLIENTS * SERVE_REQUESTS // 10
    keys = distinct_keys(rng, 2 * n_writes + 2**16)
    keys = keys[~np.isin(keys, image.keys)]
    fresh, absent = keys[:n_writes], keys[n_writes:]
    clients = ServeClients(rng, oracle, fresh, absent, SERVE_CLIENTS,
                           SERVE_REQUESTS)
    router = Router(table, RouterConfig(**SERVE_CONFIG), cost_model=cost)
    router.warmup()
    t0 = time.perf_counter()
    launches, service_s, handover_s, virtual_s = serve_requests(
        router, clients, TableSpec(**WIDE_SPEC, backend="cuda"))
    serve_s = time.perf_counter() - t0
    rep = router.report()
    check(clients.status_mm == 0 and clients.content_mm == 0,
          f"serving mismatches: {clients.examples}")
    check(rep["dropped"] == 0 and rep["handovers"] == 1
          and rep["admitted"] == rep["completed"]
          == SERVE_CLIENTS * SERVE_REQUESTS, f"serving counts {rep}")
    before, after = launches["before"], launches["after"]
    check(before["fused_probe"] > 0 and before["fused_apply"] > 0
          and before["probe"] == before["grouped_apply"] == 0,
          f"launches before the handover {before}")
    check(after["probe"] > 0 and after["grouped_apply"] > 0
          and after["fused_probe"] == after["fused_apply"] == 0,
          f"launches after the handover {after}")
    t = router.table
    check(not bool(t.state.error), "serving error flag")
    check_invariants(t.config, t.state)
    check(to_dict(t.config, t.state) == oracle.d, "serving final content")

    policy = dataclasses.replace(POLICY, min_depth=MAIN_SPEC["initial_depth"])
    zero_counts()
    t0 = time.perf_counter()
    loop = serve_closed_loop(
        TableSpec(**MAIN_SPEC, backend="cuda", resize_policy=policy),
        n_clients=LOOP_CLIENTS, ops_per_client=LOOP_OPS, device=dev,
        mix="churn", seed=seed, router_config=RouterConfig(**LOOP_CONFIG),
        handover_at=0.5, handover_spec=TableSpec(**WIDE_SPEC, backend="cuda",
                                                 resize_policy=policy))
    loop_s = time.perf_counter() - t0
    loop_launches = read_counts()
    check(loop["ok"], f"serve_closed_loop: {loop['mismatch_examples']}")
    check(loop["handovers"] == 1 and loop["dropped"] == 0
          and loop_launches["fused_apply"] > 0
          and loop_launches["grouped_apply"] > 0,
          f"serve_closed_loop launches {loop_launches}")
    n = rep["completed"]
    emit({"phase": "serving_path", "spec": MAIN_SPEC, "handover_to": WIDE_SPEC,
          "config": SERVE_CONFIG, "clients": SERVE_CLIENTS,
          "requests_per_client": SERVE_REQUESTS, "image_items": image.n_items,
          "restore_s": restore_s, "status_mismatches": clients.status_mm,
          "content_mismatches": clients.content_mm,
          "submitted": rep["submitted"], "admitted": rep["admitted"],
          "completed": n, "dropped": rep["dropped"],
          "handovers": rep["handovers"], "handover_s": handover_s,
          "shed_queue_full": rep["shed_queue_full"],
          "shed_pressure": rep["shed_pressure"],
          "deferred_rounds": rep["deferred_rounds"],
          "dispatches": rep["dispatches"], "mean_batch": rep["mean_batch"],
          "total_ms": latency_ms(router.metrics.total),
          "service_ms": latency_ms(router.metrics.service),
          "queue_wait_ms": latency_ms(router.metrics.queue_wait),
          "service_s": service_s,
          "requests_per_service_s": n / service_s,
          "virtual_s": virtual_s, "wall_s": serve_s,
          "cost_model": {k: rep["cost_model"][k]
                         for k in ("base_s", "chunk_s", "batch_floor")},
          "launches_before_handover": launches["before"],
          "launches_handover": launches["handover"],
          "launches_after_handover": launches["after"],
          "closed_loop": {
              "clients": LOOP_CLIENTS, "ops_per_client": LOOP_OPS,
              "mix": "churn", "config": LOOP_CONFIG, "ok": loop["ok"],
              "completed": loop["completed"],
              "status_mismatches": loop["status_mismatches"],
              "content_mismatches": loop["content_mismatches"],
              "handovers": loop["handovers"], "dropped": loop["dropped"],
              "peak_pressure": loop["peak_pressure"],
              "maintenance_rounds": loop["maintenance_rounds"],
              "deferred_rounds": loop["deferred_rounds"],
              "shed_pressure": loop["shed_pressure"],
              "dispatches": loop["dispatches"],
              "mean_batch": loop["mean_batch"],
              "total_ms": {k: loop["total"][k]
                           for k in ("p50_ms", "p99_ms", "p999_ms")},
              "cost_model": loop["cost_model"], "launches": loop_launches,
              "wall_s": loop_s},
          "seconds": time.perf_counter() - t_phase, "ok": True})


# ---------------------------------------------------------------------------
# phase 11: the chaos path — fault injection against the streaming oracle


def chaos_timed(spec, trace, schedule, dev):
    """``chaos_replay`` with host timers (a synchronize around each call)
    on the restores (``restore_from_image``: kill/revive, re-shard,
    handover, torn save) and the image extractions (saves and digest
    checks), and counts of the write transactions in and out of restores
    and of the calls of ``core/table.py::apply_batch`` (the ``plain``
    plan's transaction, and the ``cuda`` plan's ``ST_FULL`` slow path).
    Returns the report and {part: [calls, seconds] or counts}."""
    from repro_torch import table_api
    from repro_torch.core import snapshot as S
    from repro_torch.core import table as T
    from repro_torch.workloads.chaos import chaos_replay

    acc = {"restore": [0, 0.0], "extract": [0, 0.0]}
    counts = {"trace_transactions": 0, "restore_transactions": 0,
              "trace_apply_batch": 0, "restore_apply_batch": 0}
    in_restore = [False]

    def timed(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            in_restore[0] = name == "restore"
            try:
                out = fn(*args, **kw)
                torch.cuda.synchronize()
            finally:
                in_restore[0] = False
            acc[name][0] += 1
            acc[name][1] += time.perf_counter() - t0
            return out
        return run

    def counted(what, fn):
        def run(*args):
            counts[("restore_" if in_restore[0] else "trace_") + what] += 1
            return fn(*args)
        return run

    patches = [(S, "restore_from_image", timed("restore",
                                               S.restore_from_image)),
               (S, "extract_image", timed("extract", S.extract_image)),
               (table_api, "_raw_apply", counted("transactions",
                                                 table_api._raw_apply)),
               (T, "apply_batch", counted("apply_batch", T.apply_batch))]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    t0 = time.perf_counter()
    try:
        rep = chaos_replay(spec, trace, schedule, device=dev,
                           oracle="streaming", raise_on_mismatch=False)
        torch.cuda.synchronize()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    rest = time.perf_counter() - t0 - acc["restore"][1] - acc["extract"][1]
    return rep, {**acc, "trace_and_checks_s": rest, **counts}


def chaos_path(seed, dev):
    """``chaos_replay`` of ``chaos_setup("chaos_churn", ops=CHAOS_OPS)``
    on the card with a schedule of CHAOS_EVENTS events: every event kind,
    the streaming oracle, ``backend_swap`` cycling ``plain``/``cuda``/
    ``auto``."""
    from repro_torch.workloads.chaos import EVENT_KINDS, chaos_setup

    spec, trace, schedule = chaos_setup("chaos_churn", seed=seed,
                                        ops=CHAOS_OPS, n_events=CHAOS_EVENTS)
    full = chaos_setup("chaos_churn", seed=seed, ops=CHAOS_OPS)[2]
    zero_counts()
    t0 = time.perf_counter()
    rep, where = chaos_timed(spec, trace, schedule, dev)
    secs = time.perf_counter() - t0
    launches = read_counts()
    ops = rep["mutations"] + rep["reads"]
    check(rep["status_mismatches"] == 0 and rep["content_mismatches"] == 0,
          f"chaos mismatches: {rep['mismatch_examples']}")
    check(not rep["error_flag"] and rep["ok"], "chaos error flag")
    check(ops >= CHAOS_MIN_OPS, f"chaos checked {ops} ops")
    check(set(rep["event_counts"]) == set(EVENT_KINDS)
          and rep["events_skipped"] == 0, f"chaos events {rep['events']}")
    check(all(r["digest_ok"] for r in rep["events"]), "chaos event digests")
    check(launches["fused_probe"] > 0 and launches["fused_apply"] > 0,
          f"chaos launches {launches}")
    emit({"phase": "chaos_path", "scenario": "chaos_churn", "seed": seed,
          "ops_target": CHAOS_OPS,
          "reduced": {"n_events": [len(full), len(schedule)]},
          "spec": {k: getattr(spec, k) for k in ("dmax", "bucket_size",
                                                 "pool_size", "n_lanes")},
          "steps": rep["steps"], "mutations": rep["mutations"],
          "reads": rep["reads"], "checked_ops": ops,
          "event_counts": rep["event_counts"],
          "events_fired": rep["events_fired"],
          "events_skipped": rep["events_skipped"],
          "digest_ok_every_event": True, "final_digest_ok": True,
          "status_mismatches": 0, "content_mismatches": 0,
          "error_flag": rep["error_flag"],
          "backends": [r["backend"] for r in rep["events"]
                       if "backend" in r],
          "depth": {k: v for k, v in rep["depth"].items()
                    if k != "trajectory"},
          "auto_splits": rep["policy"]["splits"],
          "auto_merges": rep["policy"]["merges"], "launches": launches,
          "seconds": secs, "where": where, "ok": True})


# ---------------------------------------------------------------------------
# phase 12: the baselines path — LF-Split, LF-Freeze-M and Lock beside WF-Ext


class FreezeOracle:
    """Dict oracle of LF-Freeze-M: lane order within a bucket, and an
    insert of a new key into a bucket holding ``bucket_size`` keys reports
    -3 and leaves the table as it was."""

    def __init__(self, cfg):
        self.cfg, self.d = cfg, {}
        self.counts = np.zeros(cfg.nbuckets, np.int64)

    def bucket(self, keys):
        from repro_torch.core.hashing import hash_np
        return hash_np(self.cfg.hash_name, keys) >> (32 - self.cfg.depth)

    def apply(self, kinds, keys, values):
        out = []
        for c, k, v, b in zip(kinds.tolist(), keys.tolist(), values.tolist(),
                              self.bucket(keys).tolist()):
            if c == 0:
                out.append(-1)
            elif k in self.d:
                out.append(0 if c == 1 else 1)
                if c == 1:
                    self.d[k] = v
                else:
                    del self.d[k]
                    self.counts[b] -= 1
            elif c == 2:
                out.append(0)
            elif self.counts[b] == self.cfg.bucket_size:
                out.append(-3)
            else:
                out.append(1)
                self.d[k] = v
                self.counts[b] += 1
        return np.asarray(out, np.int8)


def baseline_configs(n_lanes: int):
    """The three baselines as ``benchmarks/paper_figs.py`` sizes them for
    ``BASE_KEYS`` keys."""
    from repro_torch.core import baselines as BL
    d = BASE_DEPTH
    return {"LF-Split": BL.SplitConfig(
                depth=d, max_nodes=2 * BASE_KEYS + (1 << d) + 64,
                n_lanes=n_lanes, max_walk=128),
            "LF-Freeze-M": BL.FreezeConfig(
                depth=d, bucket_size=8, pool_size=BASE_KEYS // 2 + (1 << d),
                n_lanes=n_lanes),
            "Lock": BL.LockConfig(depth=d, bucket_size=64, n_lanes=n_lanes)}


def baseline_ops(name, cfg):
    """(update, lookup) of one baseline: ``update(st, kinds, keys, values)
    -> (st, status)``; ``lookup(st, queries) -> (found, values)`` (Lock's
    lookups are kind-3 lanes of its sequential fold, ``n_lanes`` a call)."""
    from repro_torch.core import baselines as BL
    if name == "LF-Split":
        return (lambda st, *a: BL.split_update(cfg, st, *a),
                lambda st, q: BL.split_lookup(cfg, st, q))
    if name == "LF-Freeze-M":
        return (lambda st, *a: BL.freeze_update(cfg, st, *a),
                lambda st, q: BL.freeze_lookup(cfg, st, q))

    def lock_lookup(st, q):
        n = cfg.n_lanes
        threes = torch.full((n,), 3, dtype=torch.int32, device=q.device)
        outs = [BL.lock_step(cfg, st, threes, qq, qq)[1:]
                for qq in q.split(n)]
        return (torch.cat([s for s, _ in outs]) == 1,
                torch.cat([v for _, v in outs]))
    return (lambda st, *a: BL.lock_step(cfg, st, *a)[:2], lock_lookup)


def fill_baseline(name, cfg, keys, values, dev):
    """Insert ``keys`` at ``cfg.n_lanes`` lanes (the last chunk padded with
    idle lanes). Returns (state, statuses of the keys, seconds)."""
    from repro_torch.core import baselines as BL
    init = {"LF-Split": BL.split_init, "LF-Freeze-M": BL.freeze_init,
            "Lock": BL.lock_init}[name]
    update, _ = baseline_ops(name, cfg)
    n, m = cfg.n_lanes, len(keys)
    pad = -m % n
    kinds = torch.tensor(np.r_[np.ones(m), np.zeros(pad)].astype(np.int32),
                         device=dev)
    keys_d = torch.tensor(np.r_[keys, np.zeros(pad, np.int32)], device=dev)
    vals_d = torch.tensor(np.r_[values, np.zeros(pad, np.int32)], device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, statuses = init(cfg, dev), []
    for c, k, v in zip(kinds.split(n), keys_d.split(n), vals_d.split(n)):
        st, status = update(st, c, k, v)
        statuses.append(status)
    torch.cuda.synchronize()
    return st, torch.cat(statuses)[:m].cpu().numpy(), time.perf_counter() - t0


def paper_step_args(rng, keyspace, n, dev):
    """One directory-stable step's inputs as ``benchmarks/paper_figs.py``
    draws them at 90% lookups: n lookups, and an n-lane batch whose lanes
    are inserts or deletes with probability 0.2 (half each), idle
    otherwise. Like ``paper_figs``, every timed call takes these inputs
    from the same filled state (``step_ms``), so about half the inserts are
    fresh and half the deletes hit."""
    kinds = np.where(rng.random(n) < 0.5, 1, 2)
    kinds = np.where(rng.random(n) < 0.2, kinds, 0).astype(np.int32)
    keys = rng.choice(keyspace, size=n).astype(np.int32)
    vals = rng.integers(0, 1 << 20, size=n).astype(np.int32)
    q = rng.choice(keyspace, size=n).astype(np.int32)
    return [torch.tensor(x, device=dev) for x in (kinds, keys, vals, q)]


def copy_state(state):
    """A copy on the device of a baseline's state or of a ``Table`` (one
    without a value schema)."""
    from repro_torch.table_api import Table
    if isinstance(state, Table):
        return state._replace(state=copy_state(state.state))
    return type(state)(*(x.clone() for x in state))


def step_ms(step, state):
    """Host milliseconds of one ``step`` call (which synchronizes inside,
    the retry rounds reading a device flag), averaged over ``BASE_ITERS``
    calls after ``BASE_WARMUP``. As ``benchmarks/paper_figs.py`` does, every
    call starts from the same filled ``state``: each takes a fresh copy,
    made outside the timed region, and ``state`` itself is not written.
    ``step(st) -> (st, statuses)``. Returns (ms, whether any call's state
    set its error flag, the last call's statuses)."""
    total, error = 0.0, False
    for i in range(BASE_WARMUP + BASE_ITERS):
        st = copy_state(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, status = step(st)
        torch.cuda.synchronize()
        if i >= BASE_WARMUP:
            total += time.perf_counter() - t0
        error |= bool(getattr(st, "state", st).error)
    return total / BASE_ITERS * 1e3, error, status.cpu().numpy()


def check_round(name, r, got, want):
    for what, x, y in zip(("found", "values", "statuses"), got, want):
        check(np.array_equal(np.asarray(x.cpu()), y),
              f"{name} round {r} {what}")


def baselines_path(t, rng, dev):
    """The three baselines filled with the main table's live keys, then
    ``BASE_ROUNDS`` rounds of the main path's 90/10 mix at 512 lanes
    through all four structures (WF-Ext through the facade) against dict
    oracles, then the directory-stable step timed per width."""
    from repro_torch.core import table as T

    t_phase = time.perf_counter()
    n = MAIN_SPEC["n_lanes"]
    snap = T.to_numpy(t.state)
    rows = snap["live"][:-1]
    live_k, live_v = snap["keys"][:-1][rows], snap["vals"][:-1][rows]
    occ = live_k != EMPTY
    # in random order: the pool's order groups keys by bucket, which would
    # put a bucket's keys in one batch and time CAS retries, not inserts
    perm = rng.permutation(int(occ.sum()))
    live_k, live_v = live_k[occ][perm], live_v[occ][perm]
    cfgs = baseline_configs(n)
    # the oracles: WF-Ext, LF-Split and Lock hold every key; LF-Freeze-M
    # what its fill did not block
    oracle = Oracle()
    for k, v in zip(live_k.tolist(), live_v.tolist()):
        oracle.insert(k, v)
    foracle = FreezeOracle(cfgs["LF-Freeze-M"])
    new = distinct_keys(rng, 2 * BASE_ROUNDS * n + len(live_k))
    new = new[~np.isin(new, live_k)]
    fresh, absent = new[:BASE_ROUNDS * n // 4], new[BASE_ROUNDS * n // 4:]

    states, fills = {}, {}
    for name, cfg in cfgs.items():
        st, status, secs = fill_baseline(name, cfg, live_k, live_v, dev)
        want = (foracle.apply(np.ones(len(live_k), np.int32), live_k, live_v)
                if name == "LF-Freeze-M" else np.ones(len(live_k), np.int8))
        check(np.array_equal(status, want), f"{name} fill statuses")
        states[name] = st
        fills[name] = {"s": secs, "inserts_per_s": len(live_k) / secs,
                       "needs_resize": int((status == -3).sum())}

    # checked rounds: the same plan through all four structures
    plan = traffic(rng, oracle, iter(fresh.tolist()), absent, BASE_ROUNDS,
                   LOOKUPS_PER_ROUND, n)
    zero_counts()
    t, wf_secs = run_rounds(t, plan, dev)
    launches = read_counts()
    check(launches["fused_probe"] > 0 and launches["fused_apply"] > 0
          and launches["probe"] == launches["grouped_apply"] == 0,
          f"baselines path WF-Ext launches {launches}")
    round_s = {"WF-Ext": wf_secs}
    for name, cfg in cfgs.items():
        update, lookup = baseline_ops(name, cfg)
        st, secs = states[name], 0.0
        for r, (q, found, vals, kinds, keys, values, status) in enumerate(
                plan):
            if name == "LF-Freeze-M":
                found = np.array([k in foracle.d for k in q.tolist()])
                vals = np.array([foracle.d.get(k, -1) for k in q.tolist()],
                                np.int32)
                status = foracle.apply(kinds, keys, values)
            dq, dk, dkeys, dv = (torch.tensor(x, device=dev)
                                 for x in (q, kinds, keys, values))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f, v = lookup(st, dq)
            st, s = update(st, dk, dkeys, dv)
            torch.cuda.synchronize()
            secs += time.perf_counter() - t0
            check_round(name, r, (f, v, s), (found, vals, status))
        states[name], round_s[name] = st, secs

    # the directory-stable step per width: one fill serves every width
    keyspace = np.r_[live_k[:BASE_KEYS // 2], absent]
    timing, wf_launches = {}, {}
    timed_errors = dict.fromkeys(round_s, False)
    for lanes in BASE_LANES:
        args = paper_step_args(rng, keyspace, lanes, dev)
        writes = args[0].cpu().numpy() != 0

        def fresh_share(status):
            """Share of the step's writes that insert a fresh key or delete
            a present one (status 1)."""
            return float((status[writes] == 1).mean())
        row = {}
        for name, cfg in baseline_configs(lanes).items():
            update, lookup = baseline_ops(name, cfg)

            def step(st, update=update, lookup=lookup):
                lookup(st, args[3])
                return update(st, *args[:3])
            ms, err, status = step_ms(step, states[name])
            timed_errors[name] |= err
            row[name] = {"ms_per_step": ms, "ops_per_s": 2 * lanes / ms * 1e3,
                         "fresh_share": fresh_share(status)}

        def wf_step(tt):
            tt.lookup(args[3])
            tt, res = tt.apply(*args[:3])
            return tt, res.status
        zero_counts()
        ms, err, status = step_ms(wf_step, t)
        timed_errors["WF-Ext"] |= err
        counts = read_counts()
        wf_launches[lanes] = {k: v / (BASE_ITERS + BASE_WARMUP)
                              for k, v in counts.items()}
        row["WF-Ext"] = {"ms_per_step": ms, "ops_per_s": 2 * lanes / ms * 1e3,
                         "fresh_share": fresh_share(status),
                         "launches_per_step": wf_launches[lanes],
                         "nop_padded_to": n if lanes < n else None}
        timing[lanes] = row

    errors = {name: bool((t.state if name == "WF-Ext" else states[name])
                         .error) or timed_errors[name] for name in round_s}
    check(not any(errors.values()), f"baselines error flags {errors}")
    emit({"phase": "baselines_path", "keys": len(live_k),
          "universe": BASE_KEYS, "depth": BASE_DEPTH,
          "configs": {k: dataclasses.asdict(c) for k, c in cfgs.items()},
          "fill": fills, "checked_rounds": BASE_ROUNDS,
          "round_lookups": LOOKUPS_PER_ROUND, "round_writes": n,
          "status_mismatches": 0, "lookup_mismatches": 0,
          "round_s": round_s, "wfext_launches": launches,
          "error_flags": errors, "timing_iters": BASE_ITERS,
          "step_ops_per_s": {f"{name}@{lanes}": timing[lanes][name][
              "ops_per_s"] for lanes in BASE_LANES
              for name in timing[lanes]},
          "timing": timing, "reduced": {},
          "note": "WF-Ext runs the hand-written CUDA kernels (fused_probe, "
                  "fused_apply) and its PyTorch slow path; the baselines "
                  "run eager PyTorch. Not the paper's comparison until a "
                  "benchmark defines one.",
          "seconds": time.perf_counter() - t_phase, "ok": True})
    return t


# ---------------------------------------------------------------------------
# phase 13: sharded placement — four shards on the one card, then 4 -> 2


def image_of(oracle: "Oracle"):
    """The canonical image arrays of the oracle's content: keys and values
    sorted by (full hash, key), as ``extract_image`` orders them."""
    from repro_torch.core.hashing import hash_np
    keys = np.fromiter(oracle.d, np.int32, len(oracle.d))
    vals = np.fromiter(oracle.d.values(), np.int32, len(oracle.d))
    order = np.lexsort((keys, hash_np("fmix32", keys)))
    return keys[order], vals[order]


def sharded_check(t, cfg, oracle, what):
    """Per-shard invariants, the union content and the error flag."""
    from repro_torch.core import table as T
    from repro_torch.core.invariants import check_invariants, to_dict
    snap = T.to_numpy(t.state)
    check(not snap["error"].any(), f"{what}: error flag")
    check_invariants(cfg, snap)
    check(to_dict(cfg, snap) == oracle.d, f"{what}: content")
    return snap["depth"].tolist()


def sharded_path(t_main, rng, dev):
    """The main table's live keys into a 4-shard table at 512 lanes (its
    image must equal the main table's), ``SHARD_ROUNDS`` rounds of the
    90/10 mix and ``SHARD_TIMED`` timed write transactions against the
    oracle, then a 4 -> 2 re-shard through the image into 4,096-lane
    transactions and ``SHARD2_ROUNDS`` rounds at that width; the launches
    by kernel on each stage."""
    from repro_torch.core.snapshot import extract_image
    from repro_torch.table_api import Table, TableSpec

    t_phase = time.perf_counter()
    spec = TableSpec(**SHARD_SPEC, backend="cuda")
    cfg = spec.table_config()
    plan = spec.plan("cuda")
    check(plan.backend == "cuda" and plan.fused_apply and plan.fused_lookup
          and cfg.hash_shift == SHIFT, f"sharded plan {plan}, {cfg}")
    image = extract_image(t_main)
    n_items = image.n_items
    perm = rng.permutation(n_items)
    keys, vals = image.keys[perm], image.values[perm]
    oracle = Oracle()
    for k, v in zip(keys.tolist(), vals.tolist()):
        oracle.insert(k, v)
    new = distinct_keys(rng, 2**17)
    new = new[~np.isin(new, image.keys)]
    n_fresh = ((SHARD_ROUNDS + SHARD_TIMED) * SHARD_SPEC["n_lanes"]
               + SHARD2_ROUNDS * SHARD2_SPEC["n_lanes"]) // 4
    fresh, absent = iter(new[:n_fresh].tolist()), new[n_fresh:]

    ts = Table.create(spec, device=dev)
    zero_counts()
    t0 = time.perf_counter()
    ts, res = ts.insert(torch.tensor(keys, device=dev),
                        torch.tensor(vals, device=dev))
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    pre_launches = read_counts()
    pre_tx = ts.seq
    check(bool((res.status == 1).all()), "sharded preload statuses")
    img = extract_image(ts)
    check(img.n_items == n_items and np.array_equal(img.keys, image.keys)
          and np.array_equal(img.values, image.values),
          "the sharded table's image differs from the main table's")

    rounds = traffic(rng, oracle, fresh, absent, SHARD_ROUNDS,
                     LOOKUPS_PER_ROUND, SHARD_SPEC["n_lanes"])
    zero_counts()
    ts, t_mix = run_rounds(ts, rounds, dev)
    mix_launches = read_counts()
    # timed write transactions, one synchronize each
    writes = traffic(rng, oracle, fresh, absent, SHARD_TIMED, 0,
                     SHARD_SPEC["n_lanes"])
    secs = []
    for *_, kinds, keys_, values, status in writes:
        args = [torch.tensor(x, device=dev) for x in (kinds, keys_, values)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, res = ts.apply(*args)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        check(np.array_equal(res.status.cpu().numpy(), status),
              "sharded timed write statuses")
    depth4 = sharded_check(ts, cfg, oracle, "sharded")
    img4 = extract_image(ts)
    want_k, want_v = image_of(oracle)
    check(np.array_equal(img4.keys, want_k)
          and np.array_equal(img4.values, want_v), "sharded image")

    # the 4 -> 2 re-shard: save, restore into 4,096-lane transactions
    spec2 = TableSpec(**SHARD2_SPEC, backend="cuda")
    plan2 = spec2.plan("cuda")
    check(plan2.backend == "cuda" and not plan2.fused_apply
          and not plan2.fused_lookup, f"re-shard plan {plan2}")
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = ts.save(str(out_dir / "sharded.npz"))
    zero_counts()
    t0 = time.perf_counter()
    t2 = Table.restore(path, spec2, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restore_launches = read_counts()
    img2 = extract_image(t2)
    check(np.array_equal(img2.keys, img4.keys)
          and np.array_equal(img2.values, img4.values)
          and img2.header["policy_counts"] == img4.header["policy_counts"],
          "re-sharded image differs")
    restore_tx = t2.seq
    rounds2 = traffic(rng, oracle, fresh, absent, SHARD2_ROUNDS,
                      WIDE_LOOKUPS, SHARD2_SPEC["n_lanes"])
    zero_counts()
    t2, t_mix2 = run_rounds(t2, rounds2, dev)
    mix2_launches = read_counts()
    depth2 = sharded_check(t2, spec2.table_config(), oracle, "re-sharded")
    img2 = extract_image(t2)
    want_k, want_v = image_of(oracle)
    check(np.array_equal(img2.keys, want_k)
          and np.array_equal(img2.values, want_v), "re-sharded image")

    # one launch per shard per kernel call: the fused kernels before the
    # re-shard, the unfused ones after it
    s4, s2 = spec.n_shards, spec2.n_shards
    fused = ("fused_probe", "fused_apply")
    unfused = ("probe", "grouped_apply")
    for what, launches, want in (
            ("preload", pre_launches, {"fused_apply": s4 * pre_tx}),
            ("mixed", mix_launches, {"fused_probe": s4 * SHARD_ROUNDS,
                                     "fused_apply": s4 * SHARD_ROUNDS}),
            ("restore", restore_launches,
             {"grouped_apply": s2 * restore_tx}),
            ("re-sharded mixed", mix2_launches,
             {"probe": s2 * SHARD2_ROUNDS,
              "grouped_apply": s2 * SHARD2_ROUNDS})):
        got = {k: v for k, v in launches.items() if v}
        check(got == want, f"sharded {what} launches {launches}, want "
              f"{want}")
    main = LINES["main_path"]
    n_look = SHARD_ROUNDS * LOOKUPS_PER_ROUND
    n_write = SHARD_ROUNDS * SHARD_SPEC["n_lanes"]
    n_look2 = SHARD2_ROUNDS * WIDE_LOOKUPS
    n_write2 = SHARD2_ROUNDS * SHARD2_SPEC["n_lanes"]
    emit({"phase": "sharded_path", "spec": SHARD_SPEC,
          "n_shards": s4, "image_items": n_items,
          "image_equals_main": True, "preload_s": t_pre,
          "preload_inserts_per_s": n_items / t_pre,
          "main_preload_inserts_per_s": main["preload_inserts_per_s"],
          "mixed_rounds": SHARD_ROUNDS, "lookups": n_look,
          "writes": n_write, "mixed_s": t_mix,
          "mixed_ops_per_s": (n_look + n_write) / t_mix,
          "main_mixed_ops_per_s": main["mixed_ops_per_s"],
          "ms_per_write_transaction": 1e3 * float(np.mean(secs)),
          "ms_per_write_transaction_max": 1e3 * max(secs),
          "timed_write_transactions": SHARD_TIMED,
          "status_mismatches": 0, "lookup_mismatches": 0,
          "error_flag": False, "depth_by_shard": depth4,
          "size": len(oracle.d),
          "launches_preload": pre_launches,
          "launches_mixed": mix_launches,
          "launches_per_transaction": {
              k: v / SHARD_ROUNDS for k, v in mix_launches.items()},
          "reshard": {
              "spec": SHARD2_SPEC, "n_shards": s2,
              "plan": {"fused_lookup": plan2.fused_lookup,
                       "fused_apply": plan2.fused_apply},
              "restore_s": restore_s,
              "restore_items_per_s": img4.n_items / restore_s,
              "restore_transactions": restore_tx,
              "image_equal": True, "mixed_rounds": SHARD2_ROUNDS,
              "mixed_s": t_mix2,
              "mixed_ops_per_s": (n_look2 + n_write2) / t_mix2,
              "depth_by_shard": depth2,
              "launches_restore": restore_launches,
              "launches_mixed": mix2_launches,
              "launches_per_transaction": {
                  k: v / SHARD2_ROUNDS for k, v in mix2_launches.items()}},
          "reduced": {"mixed_rounds": [ROUNDS, SHARD_ROUNDS],
                      "reshard_mixed_rounds": [WIDE_ROUNDS, SHARD2_ROUNDS]},
          "seconds": time.perf_counter() - t_phase, "ok": True})
    return {k: pre_launches[k] + mix_launches[k] + restore_launches[k]
            + mix2_launches[k] for k in pre_launches}


# ---------------------------------------------------------------------------
# phase 14: the LLM serving path — the paged-KV engine at full width


class PageMirror:
    """The host's expectation of the paged cache: ``(seq, block) → [page,
    length]``, the free stack, the page watermark and the slot registry,
    advanced by the JAX package's allocation rule (boundary slots in lane
    order pop the free stack's top, then take the watermark) and eviction
    order (block by block, lane by lane)."""

    def __init__(self, batch: int, page_size: int, max_blocks: int):
        self.ps, self.max_blocks = page_size, max_blocks
        self.map, self.free, self.alloc = {}, [], 0
        self.seq, self.len = [-1] * batch, [0] * batch

    def admit(self, mask, ids):
        for b in np.nonzero(mask)[0]:
            self.seq[b], self.len[b] = int(ids[b]), 0

    def step(self):
        for b, s in enumerate(self.seq):
            if s < 0:
                continue
            blk, off = divmod(self.len[b], self.ps)
            if off == 0:
                if self.free:
                    page = self.free.pop()
                else:
                    page, self.alloc = self.alloc, self.alloc + 1
            else:
                page = self.map[(s, blk)][0]
            self.map[(s, blk)] = [page, off + 1]
            self.len[b] += 1

    def evict(self, mask):
        for blk in range(self.max_blocks):
            for b in np.nonzero(mask)[0]:
                key = (self.seq[b], blk)
                if self.seq[b] >= 0 and blk * self.ps < self.len[b] \
                        and key in self.map:
                    self.free.append(self.map.pop(key)[0])
        for b in np.nonzero(mask)[0]:
            self.seq[b], self.len[b] = -1, 0

    def grown(self, batch: int) -> "PageMirror":
        out = PageMirror(batch, self.ps, self.max_blocks)
        out.map = {k: list(v) for k, v in self.map.items()}
        out.free, out.alloc = list(self.free), self.alloc
        pad = batch - len(self.seq)
        out.seq, out.len = self.seq + [-1] * pad, self.len + [0] * pad
        return out


def paged_mismatches(pc, st, mirror: PageMirror) -> int:
    """Mismatches between a paged state and its mirror, each counted once:
    mapped keys, (page, length) payloads, allocator, slot registry,
    ``gather_kv``'s lengths, a page live twice or both live and free. The
    invariants and the error flag raise."""
    from repro_torch.core.invariants import check_invariants, to_dict
    from repro_torch.serving import kvcache as KV

    t = st.table
    check_invariants(t.config, t.state)
    check(not bool(t.state.error), "page table error flag")
    want = {(s << KV.BLOCK_BITS) | blk: v
            for (s, blk), v in mirror.map.items()}
    have = set(to_dict(t.config, t.state))
    bad = len(have ^ set(want))
    keys = np.array(sorted(want), np.int32)
    found, meta = t.lookup(keys)
    got = np.stack([meta["page"].cpu().numpy(),
                    meta["length"].cpu().numpy()], 1)
    bad += int((~found.cpu().numpy()).sum())
    bad += int((got != np.array([want[k] for k in keys.tolist()])).any(1)
               .sum()) if len(keys) else 0
    top = int(st.free_top)
    free = st.free_pages[:top].cpu().tolist()
    bad += int(free != mirror.free) + int(int(st.page_alloc) != mirror.alloc)
    bad += int(st.lengths.cpu().tolist() != mirror.len)
    bad += int(st.seq_ids.cpu().tolist() != mirror.seq)
    _, _, glens = KV.gather_kv(pc, st)
    bad += int(not torch.equal(glens, st.lengths))
    live = got[:, 0].tolist()
    bad += len(live) - len(set(live)) + len(set(live) & set(free))
    return bad


def logit_err(got, want, tol=2e-2):
    """(mismatched: not within rtol = atol = ``tol``, max abs error)."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    return (not torch.allclose(got, want, rtol=tol, atol=tol)), err


def llm_serving_path(seed, dev):
    """The paged-KV engine at full-width ``deepseek-7b`` against the dense
    decode, through admission, eviction with page reuse and a handover; the
    smoke engine's image round trip; every family's decode on the card
    against the CPU."""
    import warnings

    from torch.autograd import DeviceType

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving import engine as E
    from repro_torch.serving import kvcache as KV

    t_phase = time.perf_counter()
    cfg = get_config(LLM_ARCH)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           dev)
    n_params = M.count_params(params)
    B = LLM_BATCH
    pc = E.make_paged_config(cfg, batch=B, max_len=LLM_MAX_LEN,
                             page_size=LLM_PAGE)
    tbl = pc.table
    check((pc.max_blocks, pc.n_pages, tbl.dmax, tbl.pool_size, tbl.n_lanes,
           tbl.slab_capacity) == (64, 1024, 11, 4096, 16, 2048),
          f"paged geometry {pc}")
    est = E.init_engine(cfg, pc, dev)
    check(est.paged.table.plan().fused_apply, "page table not on the fused "
          "kernels")
    dense = M.init_cache(cfg, B, LLM_MAX_LEN, device=dev)
    mirror = PageMirror(B, LLM_PAGE, pc.max_blocks)
    rng = np.random.default_rng([seed, 14])

    def admit(est, dense, mirror, mask, ids):
        mirror.admit(mask, ids)
        dense["length"][torch.from_numpy(mask).to(dev)] = 0
        return est._replace(paged=KV.admit(pc, est.paged, mask, ids))

    est = admit(est, dense, mirror, np.ones(B, bool),
                np.arange(1, B + 1, dtype=np.int32))
    tok = torch.tensor(rng.integers(1, cfg.vocab_size, B), dtype=torch.int32,
                       device=dev)
    kernels = kernel_counts()
    per_step, host_reads, read_sites, marks = [], [], {}, {}
    ev = {"paged": [], "dense": [], "timed": []}

    def event():
        return torch.cuda.Event(enable_timing=True)

    def timed(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **k):
            e0, e1 = event(), event()
            e0.record()
            out = fn(*a, **k)
            e1.record()
            marks.setdefault(name, []).append((e0, e1))
            return out
        setattr(mod, name, wrapper)
        return fn

    def one_step(est, dense, tok, i, stage):
        """Dense then paged on ``tok``; returns (est, dense, paged logits,
        dense logits, dense argmax)."""
        e = [event() for _ in range(4)]
        e[0].record()
        ld, dense = M.decode_step(cfg, params, dense, tok[:, None])
        e[1].record()
        est = est._replace(tokens=tok)
        before = [f.launches for f in kernels.values()]
        count_reads = stage == "decode" and i in LLM_READS
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if count_reads:
                torch.cuda.set_sync_debug_mode("warn")
            e[2].record()
            est, lg = E.serve_step(cfg, pc, est, params)
            e[3].record()
            torch.cuda.set_sync_debug_mode(0)
        if count_reads:
            syncs = [w for w in caught if "synchroniz" in str(w.message)]
            host_reads.append(len(syncs))
            for w in syncs:
                site = f"{Path(w.filename).name}:{w.lineno}"
                read_sites[site] = read_sites.get(site, 0) + 1
        per_step.append([f.launches - b
                         for f, b in zip(kernels.values(), before)])
        if stage == "decode" and LLM_TIMED[0] <= i < LLM_TIMED[1]:
            ev["timed"].append((e[2], e[3]))
        elif stage == "decode" and i >= LLM_WARMUP and not count_reads:
            ev["dense"].append((e[0], e[1]))
            ev["paged"].append((e[2], e[3]))
        return est, dense, lg, ld[:, 0], torch.argmax(ld[:, 0], -1).to(
            torch.int32)

    zero_counts()
    stages = {}
    # stage 1: 96 steps in lockstep with the dense decode
    mm, worst, t0 = 0, 0.0, time.perf_counter()
    originals = {}
    for i in range(LLM_STEPS[0]):
        if i == LLM_TIMED[0]:
            originals = {(KV, "allocate_slots"): timed(KV, "allocate_slots"),
                         (E, "page_table_ids"): timed(E, "page_table_ids"),
                         (E, "paged_layers"): timed(E, "paged_layers")}
        if i == LLM_TIMED[1]:
            for (mod, name), fn in originals.items():
                setattr(mod, name, fn)
        est, dense, lg, ld, tok = one_step(est, dense, tok, i, "decode")
        mirror.step()
        bad, err = logit_err(lg, ld)
        mm, worst = mm + bad, max(worst, err)
    torch.cuda.synchronize()
    stages["decode"] = {"steps": LLM_STEPS[0], "logit_mismatches": mm,
                        "max_logit_err": worst,
                        "table_mismatches": paged_mismatches(pc, est.paged,
                                                             mirror),
                        "s": time.perf_counter() - t0}
    # stage 2: evict every other slot, admit new sequences on their pages
    t0 = time.perf_counter()
    mask = np.arange(B) % 2 == 0
    st = KV.evict(pc, est.paged, mask)
    mirror.evict(mask)
    freed = int(st.free_top)
    alloc_before = int(st.page_alloc)
    ids = np.where(mask, np.arange(B) + 100, 0).astype(np.int32)
    est = admit(est._replace(paged=st), dense, mirror, mask, ids)
    tok = torch.where(torch.from_numpy(mask).to(dev), 1, tok)
    mm, worst = 0, 0.0
    for i in range(LLM_STEPS[1]):
        est, dense, lg, ld, tok = one_step(est, dense, tok, i, "evict")
        mirror.step()
        bad, err = logit_err(lg, ld)
        mm, worst = mm + bad, max(worst, err)
    stages["evict_admit"] = {
        "steps": LLM_STEPS[1], "evicted_slots": int(mask.sum()),
        "pages_freed": freed, "page_alloc_before": alloc_before,
        "page_alloc_after": int(est.paged.page_alloc),
        "free_top_after": int(est.paged.free_top),
        "logit_mismatches": mm, "max_logit_err": worst,
        "table_mismatches": paged_mismatches(pc, est.paged, mirror),
        "s": time.perf_counter() - t0}
    check(stages["evict_admit"]["page_alloc_after"] == alloc_before,
          "freed pages not reused: page_alloc moved")
    # stage 3: hand over to twice the batch; both engines go on
    t0 = time.perf_counter()
    pc_big = E.make_paged_config(cfg, batch=2 * B, max_len=LLM_MAX_LEN,
                                 page_size=LLM_PAGE)
    check(pc_big.n_pages == 1536, f"handover geometry {pc_big}")
    torch.cuda.synchronize()
    t_h = time.perf_counter()
    est_big = E.handover_engine(pc, pc_big, est)
    torch.cuda.synchronize()
    handover_s = time.perf_counter() - t_h
    mirror_big = mirror.grown(2 * B)
    # the big engine's oracle: the dense decode at its batch (the same
    # product shapes), continuing the batch-8 dense cache's history
    dense_big = {k: torch.cat([v, torch.zeros_like(v)], dim=int(v.ndim > 1))
                 for k, v in dense.items()}
    mm, worst, mm_h, worst_h, shape_err = 0, 0.0, 0, 0.0, 0.0
    for i in range(LLM_STEPS[2]):
        tok_big = torch.cat([tok, torch.zeros_like(tok)])
        ld_big, dense_big = M.decode_step(cfg, params, dense_big,
                                          tok_big[:, None])
        est_big, lg_big = E.serve_step(cfg, pc_big,
                                       est_big._replace(tokens=tok_big),
                                       params)
        mirror_big.step()
        est, dense, lg, ld, tok = one_step(est, dense, tok, i, "handover")
        mirror.step()
        bad, err = logit_err(lg, ld)
        mm, worst = mm + bad, max(worst, err)
        bad, err = logit_err(lg_big[:B], ld_big[:B, 0])
        mm_h, worst_h = mm_h + bad, max(worst_h, err)
        shape_err = max(shape_err, logit_err(lg_big[:B], lg)[1])
    stages["handover"] = {
        "steps": LLM_STEPS[2], "batch": 2 * B, "n_pages": pc_big.n_pages,
        "handover_s": handover_s, "logit_mismatches": mm,
        "max_logit_err": worst, "handover_logit_mismatches": mm_h,
        "handover_max_logit_err": worst_h,
        "batch16_vs_batch8_max_logit_err": shape_err,
        "table_mismatches": paged_mismatches(pc, est.paged, mirror),
        "handover_table_mismatches": paged_mismatches(pc_big, est_big.paged,
                                                      mirror_big),
        "s": time.perf_counter() - t0}
    del est_big, dense, dense_big
    # the device's idle share over LLM_PROFILED paged steps back to back,
    # each on the engine's own next tokens
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        e_prof = [event(), event()]
        e_prof[0].record()
        for _ in range(LLM_PROFILED):
            est, _ = E.serve_step(cfg, pc, est, params)
            mirror.step()
        e_prof[1].record()
        torch.cuda.synchronize()
    ms_prof = e_prof[0].elapsed_time(e_prof[1]) / LLM_PROFILED
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA)
    check(paged_mismatches(pc, est.paged, mirror) == 0,
          "page table after the profiled steps")
    launches = read_counts()
    print(json.dumps({"llm_stages": stages}), flush=True)
    for name, s in stages.items():
        for k in ("logit_mismatches", "table_mismatches",
                  "handover_logit_mismatches", "handover_table_mismatches"):
            check(s.get(k, 0) == 0, f"{name}: {k} {s.get(k)}")
    steps = [dict(zip(kernels, s)) for s in per_step]
    check(all(s == steps[0] for s in steps), f"launches vary by step: "
          f"{sorted({tuple(s.values()) for s in steps})}")
    check(steps[0]["fused_probe"] > 0 and steps[0]["fused_apply"] > 0
          and steps[0]["probe"] == steps[0]["grouped_apply"] == 0,
          f"launches per decode step {steps[0]}")

    ms = {k: [a.elapsed_time(b) for a, b in v] for k, v in ev.items()}
    parts = {k: float(np.mean([a.elapsed_time(b) for a, b in v]))
             for k, v in marks.items()}
    ms_paged, ms_dense = float(np.mean(ms["paged"])), float(
        np.mean(ms["dense"]))
    parts["step"] = float(np.mean(ms["timed"]))
    parts["rest"] = parts["step"] - sum(parts[k] for k in marks)
    weight_bytes = sum(leaf.numel() * leaf.element_size()
                       for leaf in _leaves(params)) \
        - params["embed"].numel() * params["embed"].element_size() \
        + B * cfg.d_model * params["embed"].element_size()
    kv_per_token = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2
    mean_len = float(np.mean(np.arange(LLM_WARMUP, LLM_STEPS[0]) + 1))
    kv_bytes = B * mean_len * kv_per_token
    b_ms, b_by = bound_ms(weight_bytes + kv_bytes, 0)
    warm = warm_start_check(seed, dev)
    families = family_decode_checks(seed, dev)
    emit({"phase": "llm_serving_path", "model": LLM_ARCH,
          "params": n_params, "dtype": cfg.dtype,
          "geometry": {"batch": B, "max_len": LLM_MAX_LEN,
                       "page_size": LLM_PAGE, "max_blocks": pc.max_blocks,
                       "n_pages": pc.n_pages,
                       "pages_gb_each": est.paged.pages_k.numel() * 2 / 1e9,
                       "table": {"dmax": tbl.dmax, "pool_size":
                                 tbl.pool_size, "n_lanes": tbl.n_lanes,
                                 "slab_capacity": tbl.slab_capacity},
                       "dense_cache": [cfg.n_layers, B, LLM_MAX_LEN,
                                       cfg.n_kv_heads, cfg.head_dim]},
          "reduced": {"batch": [128, B], "max_len": [32768, LLM_MAX_LEN],
                      "warm_start": "smoke_config"},
          "decode_32k_kv_bytes": 128 * 32768 * kv_per_token,
          "stages": stages, "warm_start": warm, "families": families,
          "launches_per_decode_step": steps[0],
          "host_reads_per_decode_step": host_reads,
          "host_read_sites": read_sites,
          "ms_per_paged_step": ms_paged, "ms_per_dense_step": ms_dense,
          "paged_step_ms_by_part": parts,
          "tokens_per_s_paged": B / ms_paged * 1e3,
          "tokens_per_s_dense": B / ms_dense * 1e3,
          "bound": {"weight_bytes": weight_bytes, "kv_bytes": kv_bytes,
                    "bound_ms": b_ms, "bound_by": b_by},
          "timed_steps": len(ms["paged"]),
          "device_busy_ms_per_step": busy / 1e3 / LLM_PROFILED,
          "ms_per_profiled_step": ms_prof,
          "device_idle_share": 1 - busy / 1e3 / LLM_PROFILED / ms_prof,
          "phase_s": time.perf_counter() - t_phase, "ok": True})
    return launches


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def warm_start_check(seed, dev):
    """``save_engine`` / ``warm_start_engine`` on the card at the smoke
    config (the image holds fp32 pages): the restored engine, under a
    bigger batch, equals the saver in state and decodes the same logits."""
    from repro_torch.configs import smoke_config
    from repro_torch.core import snapshot as S
    from repro_torch.models import model as M
    from repro_torch.serving import engine as E
    from repro_torch.serving import kvcache as KV

    cfg = smoke_config(LLM_ARCH)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           dev)
    pc = E.make_paged_config(cfg, batch=4, max_len=64, page_size=8)
    pc_big = E.make_paged_config(cfg, batch=6, max_len=64, page_size=8)
    est = E.init_engine(cfg, pc, dev)
    est = est._replace(paged=KV.admit(pc, est.paged, np.ones(4, bool),
                                      np.arange(1, 5, dtype=np.int32)),
                       tokens=torch.ones(4, dtype=torch.int32, device=dev))
    for _ in range(20):
        est, _ = E.serve_step(cfg, pc, est, params)
    path = str(ROOT / "build" / "chip_smoke" / "engine_image")
    t0 = time.perf_counter()
    E.save_engine(path, pc, est)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm = E.warm_start_engine(pc_big, path, dev)
    restore_s = time.perf_counter() - t0
    a, b = S.extract_image(est.paged.table), S.extract_image(warm.paged.table)
    same = (np.array_equal(a.keys, b.keys)
            and all(np.array_equal(a.values[k], b.values[k])
                    for k in a.values)
            and torch.equal(warm.paged.lengths[:4], est.paged.lengths)
            and torch.equal(warm.paged.pages_k[:, :pc.n_pages],
                            est.paged.pages_k)
            and torch.equal(warm.tokens[:4], est.tokens))
    check(same, "warm-started engine differs from the saver")
    worst = 0.0
    for i in range(4):
        est, la = E.serve_step(cfg, pc, est, params)
        warm, lb = E.serve_step(cfg, pc_big, warm, params)
        bad, err = logit_err(lb[:4], la)
        check(not bad, f"warm start step {i}: max err {err}")
        worst = max(worst, err)
    return {"config": "smoke_config", "batch": [4, 6], "steps_before": 20,
            "steps_after": 4, "max_logit_err": worst, "save_s": save_s,
            "restore_s": restore_s, "image_equal": True}


FAMILY_TOLERANCES = (("float32", 1e-3), ("bfloat16", 2e-2))


def family_decode_checks(seed, dev, tolerances=FAMILY_TOLERANCES):
    """``decode_step`` of every family's smoke config, 4 steps on ``dev``
    against the CPU on the same weights and tokens: max logit error per
    (family, dtype), within each dtype's tolerance (rtol = atol)."""
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.models import model as M

    out = {}
    for arch in sorted(ARCHS):
        out[arch] = {}
        for dtype, tol in tolerances:
            cfg = dataclasses.replace(smoke_config(arch), dtype=dtype)
            p_cpu = M.init_params(cfg, torch.Generator().manual_seed(seed),
                                  "cpu")
            p_dev = M.params_from_numpy(tree_numpy(p_cpu), cfg, dev)
            enc = 16 if cfg.enc_layers else 0
            c_dev = M.init_cache(cfg, 2, 16, enc, dev)
            c_cpu = M.init_cache(cfg, 2, 16, enc, "cpu")
            if enc:
                mem = torch.randn(2, enc, cfg.d_model, generator=torch
                                  .Generator().manual_seed(seed + 1))
                c_dev["memory"] = mem.to(device=dev, dtype=cfg.torch_dtype)
                c_cpu["memory"] = mem.to(dtype=cfg.torch_dtype)
            tok = torch.ones(2, 1, dtype=torch.int32)
            worst = 0.0
            for i in range(4):
                lg, c_dev = M.decode_step(cfg, p_dev, c_dev, tok.to(dev))
                lc, c_cpu = M.decode_step(cfg, p_cpu, c_cpu, tok)
                bad, err = logit_err(lg.cpu(), lc, tol)
                check(not bad, f"{arch} {dtype} step {i}: max err {err}")
                worst = max(worst, err)
                tok = lc.argmax(-1).to(torch.int32)
            out[arch][dtype] = worst
    return out


def tree_numpy(tree):
    """A parameter tree as float32 numpy arrays (``params_from_numpy``'s
    input)."""
    return {k: tree_numpy(v) if isinstance(v, dict) else
            v.float().cpu().numpy() for k, v in tree.items()}


# ---------------------------------------------------------------------------
# phase 15: the sharded serving tier — routers across placements, the
# closed loop, chaos across placements


def one_per_shard(launches, calls, n_shards, kernels, what):
    """Each of the facade's calls launched each of ``kernels`` (a
    (probe, apply) pair) exactly once per shard, and nothing else ran."""
    want = {kernels[0]: n_shards * calls["lookup"],
            kernels[1]: n_shards * calls["apply"]}
    got = {k: v for k, v in launches.items() if v}
    check(calls["lookup"] > 0 and calls["apply"] > 0 and got == want,
          f"{what}: launches {launches} for calls {calls}, want {want}")


def served(router, clients, launches, service_s, virtual_s, wall_s):
    """The line's record of one router run."""
    rep = router.report()
    check(clients.status_mm == 0 and clients.content_mm == 0,
          f"serving mismatches: {clients.examples}")
    check(rep["dropped"] == 0 and rep["handovers"] == 1
          and rep["admitted"] == rep["completed"] == clients.completed,
          f"serving counts {rep}")
    n = rep["completed"]
    return {"submitted": rep["submitted"], "admitted": rep["admitted"],
            "completed": n, "dropped": rep["dropped"],
            "handovers": rep["handovers"],
            "shed_queue_full": rep["shed_queue_full"],
            "shed_by_shard": {str(k): v for k, v in clients.shed.items()},
            "dispatches": rep["dispatches"], "mean_batch": rep["mean_batch"],
            "total_ms": latency_ms(router.metrics.total),
            "service_ms": latency_ms(router.metrics.service),
            "queue_wait_ms": latency_ms(router.metrics.queue_wait),
            "service_s": service_s, "requests_per_service_s": n / service_s,
            "virtual_s": virtual_s, "wall_s": wall_s,
            "queue_depths_at_handover": launches["queue_depths"],
            "launches_before_handover": launches["before"],
            "calls_before_handover": launches["calls_before"],
            "launches_handover": launches["handover"],
            "launches_after_handover": launches["after"],
            "calls_after_handover": launches["calls_after"]}


def cross_placement_moves(rep, origin: str) -> int:
    """Re-shard and handover events whose target placement differs from
    the table's placement before them."""
    moves = 0
    for r in rep["events"]:
        if "to" in r and not r["skipped"]:
            moves += r["to"]["placement"] != origin
            origin = r["to"]["placement"]
    return moves


def sharded_serving_path(rng, dev, seed):
    """Routers across placements at the sharded path's geometry: a router
    on a 4-shard ``SHARD_SPEC`` table restored from the main image, its
    cost model measured there, SHARD_SERVE_CLIENTS x SHARD_SERVE_REQUESTS
    closed-loop requests of the 90/10 mix (hot shards shed, the client
    retries) handed over onto the local ``WIDE_SPEC`` halfway; then a
    local main-geometry router over the result, handed over onto
    ``SHARD_SPEC`` halfway with the submits after it re-homed. Then
    ``serve_closed_loop`` on ``SHARD_SPEC`` handed over onto the local main
    geometry, and a ``chaos_reshard`` run across 2 / 4 / 8 shards and
    local."""
    from repro_torch.core.invariants import to_dict
    from repro_torch.core.snapshot import extract_image, load_image
    from repro_torch.serving.router import (Router, RouterConfig,
                                            measure_cost_model)
    from repro_torch.table_api import Table, TableSpec
    from repro_torch.workloads import serve_closed_loop
    from repro_torch.workloads.chaos import chaos_replay, chaos_setup
    from repro_torch.workloads.scenarios import POLICY

    t_phase = time.perf_counter()
    shard_spec = TableSpec(**SHARD_SPEC, backend="cuda")
    wide_spec = TableSpec(**WIDE_SPEC, backend="cuda")
    main_spec = TableSpec(**MAIN_SPEC, backend="cuda")
    n_shards = shard_spec.n_shards
    path = str(ROOT / "build" / "chip_smoke" / "main.npz")
    image = load_image(path)
    oracle = Oracle()
    for k, v in zip(image.keys.tolist(), image.values.tolist()):
        oracle.insert(k, v)
    # a shed pick may draw a fresh key too: room for four picks a request
    n_fresh = 4 * (SHARD_SERVE_CLIENTS * SHARD_SERVE_REQUESTS // 10)
    keys = distinct_keys(rng, 2 * n_fresh + 2**16)
    keys = keys[~np.isin(keys, image.keys)]
    fresh_a, fresh_b = keys[:n_fresh], keys[n_fresh:2 * n_fresh]
    absent = keys[2 * n_fresh:]
    totals = {k: 0 for k in kernel_counts()}

    def add(*counts):
        for c in counts:
            for k in totals:
                totals[k] += c[k]

    # A: sharded -> local
    table = Table.restore(path, shard_spec, device=dev)
    cost = measure_cost_model(table)
    router = Router(table, RouterConfig(**SHARD_SERVE_CONFIG),
                    cost_model=cost)
    router.warmup()
    clients = ServeClients(rng, oracle, fresh_a, absent, SHARD_SERVE_CLIENTS,
                           SHARD_SERVE_REQUESTS, retry_s=SHARD_RETRY_S)
    t0 = time.perf_counter()
    la, service_a, handover_a, virtual_a = serve_requests(router, clients,
                                                          wide_spec)
    run_a = served(router, clients, la, service_a, virtual_a,
                   time.perf_counter() - t0)
    add(la["before"], la["handover"], la["after"])
    one_per_shard(la["before"], la["calls_before"], n_shards,
                  ("fused_probe", "fused_apply"), "sharded router")
    after = {k: v for k, v in la["after"].items() if v}
    check(set(after) == {"probe", "grouped_apply"},
          f"launches after the handover onto WIDE_SPEC {la['after']}")
    check(len(la["queue_depths"]["before"]) == n_shards
          and la["queue_depths"]["after"] == [sum(la["queue_depths"]
                                                  ["before"])],
          f"queue depths at handover {la['queue_depths']}")
    check(run_a["shed_queue_full"] > 0
          and len(clients.shed.get(n_shards, [])) == n_shards,
          f"no per-shard shedding: {clients.shed}")
    t = router.table
    check(to_dict(t.config, t.state) == oracle.d, "router A final content")

    # B: local -> sharded, submits after the handover
    served_path = t.save(str(ROOT / "build" / "chip_smoke" / "served.npz"))
    table = Table.restore(served_path, main_spec, device=dev)
    router = Router(table, RouterConfig(**SERVE_CONFIG),
                    cost_model=measure_cost_model(table))
    router.warmup()
    clients = ServeClients(rng, oracle, fresh_b, absent, SHARD_SERVE_CLIENTS,
                           SHARD_SERVE_REQUESTS)
    t0 = time.perf_counter()
    lb, service_b, handover_b, virtual_b = serve_requests(router, clients,
                                                          shard_spec)
    run_b = served(router, clients, lb, service_b, virtual_b,
                   time.perf_counter() - t0)
    add(lb["before"], lb["handover"], lb["after"])
    one_per_shard(lb["before"], lb["calls_before"], 1,
                  ("fused_probe", "fused_apply"), "local router")
    one_per_shard(lb["after"], lb["calls_after"], n_shards,
                  ("fused_probe", "fused_apply"), "router after the handover")
    qd = lb["queue_depths"]
    check(len(qd["before"]) == 1 and qd["after"] == qd["recount_after"]
          and len(qd["after"]) == n_shards
          and sum(qd["after"]) == qd["before"][0],
          f"re-homed queue depths {qd}")
    t = router.table
    check(not bool(t.state.error.any()), "router B error flag")
    check(to_dict(t.config, t.state) == oracle.d, "router B final content")
    want_k, want_v = image_of(oracle)
    img = extract_image(t)
    check(np.array_equal(img.keys, want_k)
          and np.array_equal(img.values, want_v), "router B image")

    # C: serve_closed_loop on SHARD_SPEC, handed over onto the local main
    # geometry (the same aggregate bits)
    zero_counts()
    t0 = time.perf_counter()
    loop = serve_closed_loop(
        TableSpec(**SHARD_SPEC, backend="cuda", resize_policy=dataclasses
                  .replace(POLICY, min_depth=SHARD_SPEC["initial_depth"])),
        n_clients=LOOP_CLIENTS, ops_per_client=LOOP_OPS, device=dev,
        mix="churn", seed=seed, router_config=RouterConfig(**LOOP_CONFIG),
        handover_at=0.5, handover_spec=TableSpec(
            **MAIN_SPEC, backend="cuda", resize_policy=dataclasses.replace(
                POLICY, min_depth=MAIN_SPEC["initial_depth"])))
    loop_s = time.perf_counter() - t0
    loop_launches = read_counts()
    add(loop_launches)
    check(loop["ok"] and loop["handovers"] == 1 and loop["dropped"] == 0,
          f"sharded serve_closed_loop: {loop['mismatch_examples']}")
    check(loop_launches["fused_apply"] > 0 and loop_launches["fused_probe"]
          > 0, f"sharded serve_closed_loop launches {loop_launches}")

    # D: chaos across placements
    spec, trace, schedule = chaos_setup(
        "chaos_reshard", placement="sharded", seed=seed,
        ops=SHARD_CHAOS_OPS, kinds=SHARD_CHAOS_KINDS,
        n_events=SHARD_CHAOS_EVENTS)
    full = chaos_setup("chaos_reshard", placement="sharded", seed=seed,
                       ops=CHAOS_OPS, kinds=SHARD_CHAOS_KINDS)[2]
    zero_counts()
    t0 = time.perf_counter()
    rep = chaos_replay(spec, trace, schedule, device=dev,
                       shard_counts=(2, 4, 8), raise_on_mismatch=False)
    torch.cuda.synchronize()
    chaos_s = time.perf_counter() - t0
    chaos_launches = read_counts()
    add(chaos_launches)
    moves = cross_placement_moves(rep, spec.placement)
    check(rep["ok"] and not rep["error_flag"]
          and rep["status_mismatches"] == rep["content_mismatches"] == 0,
          f"sharded chaos: {rep['mismatch_examples']}")
    check(rep["events_skipped"] == 0
          and all(r["digest_ok"] for r in rep["events"]),
          f"sharded chaos events {rep['events']}")
    check(moves > 0, f"no cross-placement move: {rep['events']}")
    check(chaos_launches["fused_apply"] > 0, f"chaos launches "
          f"{chaos_launches}")

    main_serving = LINES["serving_path"]
    emit({"phase": "sharded_serving_path", "spec": SHARD_SPEC,
          "n_shards": n_shards,
          "mismatches": {"status": 0, "content": 0},
          "dropped": run_a["dropped"] + run_b["dropped"],
          "handovers": run_a["handovers"] + run_b["handovers"],
          "sharded_to_local": dict(run_a, config=SHARD_SERVE_CONFIG,
                                   handover_to=WIDE_SPEC,
                                   handover_s=handover_a,
                                   cost_model={"base_s": cost.base_s,
                                               "chunk_s": cost.chunk_s}),
          "local_to_sharded": dict(run_b, config=SERVE_CONFIG,
                                   spec=MAIN_SPEC, handover_to=SHARD_SPEC,
                                   handover_s=handover_b),
          "main_serving_requests_per_service_s":
              main_serving["requests_per_service_s"],
          "main_serving_total_ms": main_serving["total_ms"],
          "clients": SHARD_SERVE_CLIENTS,
          "requests_per_client": SHARD_SERVE_REQUESTS,
          "closed_loop": {
              "clients": LOOP_CLIENTS, "ops_per_client": LOOP_OPS,
              "mix": "churn", "ok": loop["ok"],
              "completed": loop["completed"],
              "status_mismatches": loop["status_mismatches"],
              "content_mismatches": loop["content_mismatches"],
              "handovers": loop["handovers"], "dropped": loop["dropped"],
              "queue_depths": loop["queue_depths"],
              "total_ms": {k: loop["total"][k]
                           for k in ("p50_ms", "p99_ms", "p999_ms")},
              "launches": loop_launches, "wall_s": loop_s},
          "chaos": {
              "scenario": "chaos_reshard", "seed": seed,
              "kinds": list(SHARD_CHAOS_KINDS), "shard_counts": [2, 4, 8],
              "spec": {k: getattr(spec, k) for k in (
                  "placement", "shard_bits", "dmax", "pool_size",
                  "n_lanes")},
              "checked_ops": rep["mutations"] + rep["reads"],
              "steps": rep["steps"], "event_counts": rep["event_counts"],
              "events_skipped": rep["events_skipped"],
              "moves": [r["to"] for r in rep["events"] if "to" in r],
              "cross_placement_moves": moves,
              "invariant_shards": [r["invariant_shards"]
                                   for r in rep["events"]],
              "digest_ok": [r["digest_ok"] for r in rep["events"]],
              "final_placement": rep["placement"],
              "error_flag": rep["error_flag"], "launches": chaos_launches,
              "seconds": chaos_s},
          "reduced": {"requests_per_client": [SERVE_REQUESTS,
                                              SHARD_SERVE_REQUESTS],
                      "ops": [CHAOS_OPS, SHARD_CHAOS_OPS],
                      "n_events": [len(full), len(schedule)]},
          "seconds": time.perf_counter() - t_phase, "ok": True})
    return totals


# ---------------------------------------------------------------------------
# phase 16: the training path — the launcher at full width, checkpoints
# with the main table alongside, resume, every family against the CPU


def n_params(cfg) -> int:
    from repro_torch.models import model as M
    return sum(int(np.prod(leaf.shape)) for leaf in _spec_leaves(
        M.param_spec(cfg)))


def _spec_leaves(spec):
    for v in spec.values():
        yield from _spec_leaves(v) if isinstance(v, dict) else (v,)


def attention_pairs(cfg, seq: int) -> int:
    """(query, key) pairs the causal attention of every layer computes:
    the whole prefix on global layers, the last ``window`` positions on
    windowed ones."""
    from repro_torch.models.model import is_global_layer
    if not cfg.has_attn():
        return 0
    q = np.arange(seq, dtype=np.int64) + 1
    total = 0
    for i in range(cfg.n_layers):
        glob = cfg.layer_kind == "hybrid" and is_global_layer(cfg, i)
        w = 0 if glob else cfg.window
        total += int(np.minimum(q, w).sum() if w > 0 else q.sum())
    return total


def train_flops(cfg, batch: int, seq: int) -> float:
    """A training step's FLOPs: 6 x parameters x tokens, plus the
    attention's QK^T and PV products (2 x 2 x head_dim FLOPs a head and a
    pair forward, three times that with the backward)."""
    attn = 3 * 4 * batch * cfg.n_heads * cfg.head_dim * attention_pairs(
        cfg, seq)
    return 6.0 * n_params(cfg) * batch * seq + attn


class TrainRun:
    """``repro_torch.launch.train.main`` with its standard output captured
    (the per-step JSON lines parsed), CUDA events around every train step,
    host timers around checkpoint saves and restores, and the peak device
    memory."""

    def __init__(self, argv, tables=None):
        import contextlib
        import io
        from repro_torch.launch import train as launch
        from repro_torch.training import checkpoint as C

        self.events, self.ckpt = [], {"save_s": [], "restore_s": []}
        make_step, save, restore = launch.make_train_step, C.save, C.restore

        def timed_step(cfg, tc):
            step = make_step(cfg, tc)

            def run(state, batch):
                e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                e[0].record()
                out = step(state, batch)
                e[1].record()
                self.events.append(e)
                return out
            return run

        def timed(name, fn):
            def run(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                self.ckpt[name].append(time.perf_counter() - t0)
                return out
            return run

        buf = io.StringIO()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        launch.make_train_step = timed_step
        C.save, C.restore = timed("save_s", save), timed("restore_s", restore)
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                rc = launch.main(argv, tables=tables)
        finally:
            launch.make_train_step, C.save, C.restore = make_step, save, \
                restore
        torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - t0
        check(rc == 0, f"launcher exited {rc}")
        self.max_memory = torch.cuda.max_memory_allocated()
        self.lines = buf.getvalue().splitlines()
        self.steps = [json.loads(ln.split(" STRAGGLER")[0])
                      for ln in self.lines if ln.startswith("{")]
        self.step_ms = [a.elapsed_time(b) for a, b in self.events]

    def summary(self, cfg, batch, seq):
        ms = float(np.mean(self.step_ms[1:])) if len(self.step_ms) > 1 \
            else self.step_ms[0]
        flops = train_flops(cfg, batch, seq)
        return {"losses": [r["loss"] for r in self.steps],
                "grad_norms": [r["grad_norm"] for r in self.steps],
                "step_ms": self.step_ms, "ms_per_step": ms,
                "tokens_per_s": batch * seq / ms * 1e3,
                "max_memory_allocated": self.max_memory,
                "step_flops": flops,
                "bound_ms": flops / PEAK_BF16_FLOPS * 1e3,
                "bound_by": "operations (dense bf16 peak 989 TFLOP/s)",
                "wall_s": self.wall_s}


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def training_path(t_main, dev, seed):
    """The launcher at full-width smollm-135m with checkpoints (the main
    table alongside) and a resume that replays steps 5-8; the checkpointed
    table restored into SHARD_SPEC; full-width hymba-1.5b; every family's
    smoke train step on the card against the CPU."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.core.snapshot import extract_image
    from repro_torch.table_api import TableSpec
    from repro_torch.training import checkpoint as C

    t_phase = time.perf_counter()
    base = ROOT / "build" / "chip_smoke"
    ck, ck4 = base / "ckpt", base / "ckpt_resume"
    for d in (ck, ck4):
        shutil.rmtree(d, ignore_errors=True)
    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS),
            "--seq-len", str(TRAIN_SEQ), "--global-batch", str(TRAIN_BATCH),
            "--ckpt-every", str(TRAIN_CKPT_EVERY), "--device", str(dev)]
    cfg = get_config(TRAIN_ARCH)
    run = TrainRun(argv + ["--ckpt-dir", str(ck)], tables={"main": t_main})
    losses = [r["loss"] for r in run.steps]
    check([r["step"] for r in run.steps] == list(range(1, TRAIN_STEPS + 1))
          and all(np.isfinite(losses)), f"{TRAIN_ARCH} steps {run.steps}")
    check(sorted(p.name for p in ck.iterdir())
          == [f"step_{TRAIN_CKPT_EVERY}", f"step_{TRAIN_STEPS}"],
          f"checkpoints {list(ck.iterdir())}")
    # auto-resume takes the newest step: resume on a copy holding step 4
    # (hard links: the launcher only reads it)
    ck4.mkdir(parents=True)
    shutil.copytree(ck / f"step_{TRAIN_CKPT_EVERY}",
                    ck4 / f"step_{TRAIN_CKPT_EVERY}", copy_function=os.link)
    resumed = TrainRun(argv + ["--ckpt-dir", str(ck4)])
    check(resumed.lines[0] == f"resumed from step {TRAIN_CKPT_EVERY} "
          f"(data offset {TRAIN_CKPT_EVERY})", f"resume: {resumed.lines[:2]}")
    replay = [r["loss"] for r in resumed.steps]
    cont = losses[TRAIN_CKPT_EVERY:]
    check([r["step"] for r in resumed.steps]
          == list(range(TRAIN_CKPT_EVERY + 1, TRAIN_STEPS + 1)),
          f"resumed steps {resumed.steps}")
    resume_err = max(abs(a - b) / abs(b) for a, b in zip(replay, cont))
    check(resume_err <= 1e-3, f"resume losses {replay} against {cont}")

    # the checkpointed table into the sharded geometry
    spec = TableSpec(**SHARD_SPEC, backend="cuda")
    zero_counts()
    t0 = time.perf_counter()
    ts = C.restore_table(str(ck), TRAIN_STEPS, "main", spec, dev)
    torch.cuda.synchronize()
    table_restore_s = time.perf_counter() - t0
    table_launches = read_counts()
    want = {"fused_apply": spec.n_shards * ts.seq}
    check({k: v for k, v in table_launches.items() if v} == want,
          f"table restore launches {table_launches}, want {want}")
    a, b = extract_image(t_main), extract_image(ts)
    check(np.array_equal(a.keys, b.keys)
          and np.array_equal(a.values, b.values),
          "the checkpointed table's image differs from the main one")
    del ts
    smollm = dict(run.summary(cfg, TRAIN_BATCH, TRAIN_SEQ),
                  params=n_params(cfg))

    hcfg = get_config(HYBRID_ARCH)
    hrun = TrainRun(["--arch", HYBRID_ARCH, "--steps", str(HYBRID_STEPS),
                     "--seq-len", str(HYBRID_SEQ), "--global-batch",
                     str(HYBRID_BATCH), "--device", str(dev)])
    hymba = dict(hrun.summary(hcfg, HYBRID_BATCH, HYBRID_SEQ),
                 params=n_params(hcfg))
    check(len(hrun.steps) == HYBRID_STEPS
          and all(np.isfinite(hymba["losses"]))
          and all(np.isfinite(hymba["grad_norms"])),
          f"{HYBRID_ARCH} steps {hrun.steps}")

    t0 = time.perf_counter()
    families = family_train_checks(seed, dev)
    families_s = time.perf_counter() - t0
    ckpt_dir = ck / f"step_{TRAIN_CKPT_EVERY}"
    emit({"phase": "training_path", "gpu": smi_line(),
          "smollm": dict(smollm, arch=TRAIN_ARCH, seq=TRAIN_SEQ,
                         batch=TRAIN_BATCH, steps=TRAIN_STEPS,
                         config={k: getattr(cfg, k) for k in (
                             "n_layers", "d_model", "n_heads", "n_kv_heads",
                             "head_dim", "d_ff", "vocab_size", "dtype",
                             "remat")}),
          "resume": {"from_step": TRAIN_CKPT_EVERY, "losses": replay,
                     "continuous": cont, "max_rel_loss_diff": resume_err,
                     "restore_s": resumed.ckpt["restore_s"],
                     "ms_per_step": float(np.mean(resumed.step_ms))},
          "checkpoint": {"save_s": run.ckpt["save_s"],
                         "bytes_per_step": dir_bytes(ckpt_dir),
                         "table_image_bytes": (ckpt_dir / "table_main.npz")
                         .stat().st_size},
          "table_restore": {"spec": SHARD_SPEC, "seconds": table_restore_s,
                            "transactions": int(want["fused_apply"]
                                                // spec.n_shards),
                            "launches": table_launches,
                            "image_equals_main": True},
          "hymba": dict(hymba, arch=HYBRID_ARCH, seq=HYBRID_SEQ,
                        batch=HYBRID_BATCH, steps=HYBRID_STEPS,
                        config={k: getattr(hcfg, k) for k in (
                            "n_layers", "d_model", "n_heads", "n_kv_heads",
                            "head_dim", "ssm_state", "window",
                            "global_every", "dtype", "remat")}),
          "families": families, "families_s": families_s,
          "seconds": time.perf_counter() - t_phase, "ok": True})
    return table_launches


def family_train_checks(seed, dev, tolerances=FAMILY_TOLERANCES):
    """One ``train_step`` of every family's smoke config on ``dev`` against
    the CPU from the same weights and batch: loss and gradient norm
    (relative) and every updated parameter (rtol = atol) within each
    dtype's tolerance. Returns the worst error per (family, dtype)."""
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.models import model as M
    from repro_torch.training import train_step as TS
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.optimizer import init_opt_state, tree_leaves

    out = {}
    for arch in sorted(ARCHS):
        out[arch] = {}
        for dtype, tol in tolerances:
            cfg = dataclasses.replace(smoke_config(arch), dtype=dtype)
            extras = {}
            if cfg.n_prefix_embeds:
                extras["prefix_embeds"] = ((cfg.n_prefix_embeds,
                                            cfg.d_model), "float32")
            if cfg.enc_layers:
                extras["enc_frames"] = ((64, cfg.d_model), "float32")
            batch = SyntheticLM(cfg.vocab_size, 64, 2, seed=seed,
                                extras=extras).batch_at(0)
            p_cpu = M.init_params(cfg, torch.Generator().manual_seed(seed),
                                  "cpu")
            p_dev = M.params_from_numpy(tree_numpy(p_cpu), cfg, dev)
            res = []
            for p, d in ((p_cpu, "cpu"), (p_dev, dev)):
                st = TS.TrainState(p, init_opt_state(p))
                st, m = TS.train_step(cfg, TS.TrainConfig(), st, {
                    k: torch.from_numpy(v).to(d) for k, v in batch.items()})
                res.append((st, m))
            (sc, mc), (sd, md) = res
            worst = 0.0
            for k in ("loss", "grad_norm"):
                err = abs(float(md[k]) - float(mc[k])) / abs(float(mc[k]))
                check(err <= tol, f"{arch} {dtype} {k}: {md[k]} against "
                      f"{mc[k]}")
                worst = max(worst, err)
            for a, b in zip(tree_leaves(sd.params), tree_leaves(sc.params)):
                bad, err = logit_err(a.cpu(), b, tol)
                check(not bad, f"{arch} {dtype} params: max err {err}")
                worst = max(worst, err)
            out[arch][dtype] = worst
    return out


# ---------------------------------------------------------------------------
# phase 17: the launch tier — the int8 compressed all-reduce on a one-rank
# NCCL group, the dry-run's one-card record against a real train step, a
# timed sweep of dry-run records


def f32_ulps(got, want, mag):
    """Largest |got - want| in float32 ulps at magnitude ``mag`` (float64
    tensors; the ulp of a float32 in [2**e, 2**(e+1)) is 2**(e - 23))."""
    _, e = torch.frexp(mag.abs().clamp(min=2.0**-126))
    ulp = torch.ldexp(torch.ones_like(mag), e - 24)
    return float(((got.double() - want).abs() / ulp).max())


def compression_check(dev, seed):
    """``make_compressed_allreduce`` over a one-rank ``make_local_mesh``
    group (NCCL on the card) on the full-width gradient tree of
    ``TRAIN_ARCH``, 3 steps carrying the feedback, each held against the
    plain arithmetic (float32 quantization, the dequantization, mean and
    residual in float64): reduced grads and residual within 1 float32 ulp.
    Then ms per call (CUDA events), the bytes the call must move and their
    bound."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import compression as DC
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import tree_leaves

    cfg = get_config(TRAIN_ARCH)
    spec = M.param_spec(cfg)
    gen = torch.Generator(dev).manual_seed(seed)

    def draw():
        return M._map_spec(lambda leaf, path: torch.randn(
            leaf.shape, generator=gen, device=dev).mul_(1e-3).to(leaf.dtype),
            spec)

    mesh = make_local_mesh(device_type=dev.type)
    try:
        backend = dist.get_backend()
        check(backend == ("nccl" if dev.type == "cuda" else "gloo"),
              f"compression group backend {backend}")
        grads = draw()
        leaves = tree_leaves(grads)
        n = sum(g.numel() for g in leaves)
        world = mesh.size()
        check(n == n_params(cfg), f"{n} gradient elements")
        fn = DC.make_compressed_allreduce(mesh, grads, axes=("data",))
        fb = DC.init_feedback(grads)
        worst = {"reduced_ulps": 0.0, "residual_ulps": 0.0}
        for step in range(3):
            if step:
                grads = draw()
            red, new_fb = fn(grads, fb)
            for g, r, got, got_r in zip(*(tree_leaves(t) for t in (
                    grads, fb.residual, red, new_fb.residual))):
                x = g.float() + r
                s = torch.clamp(x.abs().max(), min=1e-12) / 127.0
                qs = torch.clamp(torch.round(x / s), -127, 127).double() \
                    * s.double()
                want = qs / world
                want_r = x.double() - qs
                check(got.dtype == got_r.dtype == torch.float32,
                      "compressed all-reduce dtypes")
                worst["reduced_ulps"] = max(worst["reduced_ulps"],
                                            f32_ulps(got, want, want))
                worst["residual_ulps"] = max(
                    worst["residual_ulps"],
                    f32_ulps(got_r, want_r, torch.maximum(x.double().abs(),
                                                          qs.abs())))
            fb = new_fb
            del red
        check(max(worst.values()) <= 1.0, f"compression against the plain "
              f"arithmetic: {worst} ulps")
        ms = cuda_ms(lambda i: fn(grads, fb), 5) if dev.type == "cuda" \
            else None
        # read: the gradient and the residual; written: the reduced
        # gradient and the new residual (float32)
        n_bytes = sum(g.numel() * (g.element_size() + 12)
                      for g in tree_leaves(grads))
    finally:
        dist.destroy_process_group()
    b_ms, b_by = bound_ms(n_bytes, 0)
    return dict(worst, arch=TRAIN_ARCH, elements=n, leaves=len(leaves),
                steps=3, backend=backend, world=world, ms_per_call=ms,
                bytes_moved=n_bytes, bound_ms=b_ms, bound_by=b_by,
                bytes_per_s=n_bytes / ms * 1e3 if ms else None)


def dryrun_train_check(dev, seed):
    """The dry-run's ``h100x1`` record at phase 16's ``TRAIN_ARCH`` shape
    against one real ``train_step`` on the card: FlopCounterMode's total
    and per-op counts, and the argument bytes (state plus batch); the
    record's model FLOPs beside phase 16's FLOP bound, the real step's peak
    memory beside the argument bytes."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import Shape
    from repro_torch.launch import dryrun as DR
    from repro_torch.training import train_step as TS
    from repro_torch.training.checkpoint import _flat
    from repro_torch.training.data import SyntheticLM

    cfg = get_config(TRAIN_ARCH)
    shape = Shape("train_phase16", TRAIN_SEQ, TRAIN_BATCH, "train")
    rec = DR.one_card_record(cfg, shape)
    torch.cuda.empty_cache()
    st = TS.init_train_state(cfg, torch.Generator(dev).manual_seed(seed), dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(
        cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=seed).batch_at(0).items()}
    real_bytes = sum(x.numel() * x.element_size()
                     for tree in (st, batch) for x in _flat(tree).values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counter = FlopCounterMode(display=False)
    with counter:
        st, metrics = TS.train_step(cfg, TS.TrainConfig(), st, batch)
    loss = float(metrics["loss"])
    peak = torch.cuda.max_memory_allocated()
    real = counter.get_total_flops()
    by_op = {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}
    del st, batch, metrics
    torch.cuda.empty_cache()
    check(np.isfinite(loss), f"real step loss {loss}")
    check(rec["traced_flops"] == real, f"traced FLOPs {rec['traced_flops']} "
          f"against the real step's {real} ({by_op})")
    check(rec["memory"]["argument_bytes_per_device"] == real_bytes,
          f"argument bytes {rec['memory']['argument_bytes_per_device']} "
          f"against the real state and batch's {real_bytes}")
    step_flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    return {"arch": TRAIN_ARCH, "seq": TRAIN_SEQ, "batch": TRAIN_BATCH,
            "traced_flops": rec["traced_flops"], "real_flops": real,
            "flops_by_op": by_op, "trace_s": rec["trace_s"],
            "analytic_flops": rec["analytic_flops_per_device"],
            "model_flops": rec["model_flops"],
            "model_flops_bound_ms": rec["model_flops"] / PEAK_BF16_FLOPS * 1e3,
            "phase16_step_flops": step_flops,
            "phase16_bound_ms": step_flops / PEAK_BF16_FLOPS * 1e3,
            "argument_bytes": real_bytes, "real_step_peak_bytes": peak,
            "hbm_bytes": rec["memory"]["hbm_bytes"],
            "card_total_memory":
                torch.cuda.get_device_properties(dev).total_memory,
            "peak_over_argument_bytes": peak / real_bytes,
            "real_step_loss": loss}


# the dry-run sweep's cells: every arch's decode_32k records on one card and
# on the production mesh, and its train_4k layout there. The one-card
# train_4k traces (10 to 90 s each on the host, PERF.md) are left to the
# CLI's --all sweep; phase 17(b) holds one such record against a real step.
SWEEP_CELLS = (("decode_32k", "h100x1"), ("decode_32k", "pod16x16"),
               ("train_4k", "pod16x16"))
# worker processes: the host's cores less the main process's, at most 4
SWEEP_WORKERS = max(1, min(4, (os.cpu_count() or 2) - 1))


def _sweep_cell(cell):
    """One dry-run cell in a sweep worker (a fake world of 256 ranks for
    the production mesh, started once per worker)."""
    import contextlib
    import io
    import torch.distributed as dist
    from repro_torch.launch import dryrun as DR
    arch, shape, mesh_name, out = cell
    if DR.MESHES[mesh_name] is not None and not dist.is_initialized():
        DR.fake_world(256)
    with contextlib.redirect_stdout(io.StringIO()):
        return DR.run_cell(arch, shape, mesh_name, out)


def dryrun_sweep(during):
    """The ``SWEEP_CELLS`` records of every arch (the full ``--all`` sweep
    stays a CLI run) in a pool of spawned processes (meta tensors only: no
    worker touches the card), while ``during()`` runs here. Each record
    must be ``ok``. Returns (``during()``'s result, the records' seconds
    and the sweep's wall time)."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch.configs import ARCHS

    out = str(ROOT / "build" / "chip_smoke" / "dryrun")
    cells = [(a, s, m, out) for s, m in SWEEP_CELLS for a in sorted(ARCHS)]
    t0 = time.perf_counter()
    with ProcessPoolExecutor(SWEEP_WORKERS,
                             mp_context=mp.get_context("spawn")) as pool:
        futures = [pool.submit(_sweep_cell, c) for c in cells]
        side = during()
        recs = [f.result() for f in futures]
    wall = time.perf_counter() - t0
    bad = [r["cell"] for r in recs if r["status"] != "ok"]
    check(not bad, f"dry-run cells not ok: {bad}")
    cells_out = {r["cell"]: {
        "seconds": r["seconds"],
        "argument_bytes_per_device": r["memory"]["argument_bytes_per_device"],
        "fits_80gb": r["memory"]["fits_80gb"],
        "bottleneck": r["roofline"]["bottleneck"],
        **({"traced_flops": r["traced_flops"],
            "traced_vs_analytic": r["traced_vs_analytic"]}
           if r["mesh"] == "h100x1" else
           {"replicated_params": len(r["replicated_params"])})}
        for r in recs}
    return side, {"cells": cells_out, "n_cells": len(recs), "wall_s": wall,
                  "workers": SWEEP_WORKERS,
                  "cell_seconds_sum": sum(r["seconds"] for r in recs)}


def launch_tier_path(dev, seed):
    """Phase 17: the dry-run sweep in a process pool while this process
    runs the compression check and the dry-run's one-card record against a
    real step. Launches none of the table's kernels."""
    t_phase = time.perf_counter()
    zero_counts()
    (compression, train), sweep = dryrun_sweep(lambda: (
        compression_check(dev, seed), dryrun_train_check(dev, seed)))
    launches = read_counts()
    check(not any(launches.values()), f"launch tier launches {launches}")
    emit({"phase": "launch_tier", "gpu": smi_line(),
          "compression": compression, "dryrun_train": train,
          "dryrun_sweep": sweep, "launches": launches,
          "seconds": time.perf_counter() - t_phase, "ok": True})
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    smi = smi_line()
    build_s = _build.build_all()
    emit({"phase": "build", "build_s": build_s, "gpu": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    checks = kernel_checks(rng, dev)
    extra = [shift_cases(np.random.default_rng([args.seed, SHIFT]), dev),
             page_table_cases(np.random.default_rng([args.seed, 14]), dev)]
    for name, (mm, err) in (kv for d in extra for kv in d.items()):
        checks[name] = (checks[name][0] + mm, max(checks[name][1], err))
    t, launches, oracle, absent = main_path(rng, dev)
    tw, wide_launches, raw_restore_rate = wide_path(t, oracle, absent, rng,
                                                    dev)
    launches.update({k: wide_launches[k] for k in ("probe", "grouped_apply")})
    plan_parity(t, rng, dev, MAIN_SPEC, 64, "main")
    plan_parity(tw, rng, dev, WIDE_SPEC, 16, "wide")
    t = profile_rounds(t, rng, dev)
    kernels = kernel_times(t, tw, rng, dev, launches, checks)
    schema_path(rng, dev, raw_restore_rate)
    elastic_path(args.seed, dev)
    serving_path(rng, dev, args.seed)
    chaos_path(args.seed, dev)
    t = baselines_path(t, rng, dev)
    sharded = sharded_path(t, rng, dev)
    llm = llm_serving_path(args.seed, dev)
    sharded_serving = sharded_serving_path(rng, dev, args.seed)
    training = training_path(t, dev, args.seed)
    launch_tier = launch_tier_path(dev, args.seed)
    for k in kernels:
        k["launches_sharded"] = sharded[k["name"]]
        k["launches_llm"] = llm[k["name"]]
        k["launches_sharded_serving"] = sharded_serving[k["name"]]
        k["launches_training"] = training[k["name"]]
        k["launches_launch_tier"] = launch_tier[k["name"]]
    print(smi_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
