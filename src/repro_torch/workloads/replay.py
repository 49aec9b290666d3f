"""Trace replayer: run a workload through the facade, check it against the
paper-literal sequential oracle, and report what the elastic policy did.

The port of ``repro/workloads/replay.py``: the same checks and the same
report, on a ``repro_torch`` table (local or sharded) on one device.

The replayer is the differential harness of the churn engine. Every step it

1. applies the step's mutation batch through :meth:`Table.apply` and
   compares the per-lane statuses with the oracle applied in lane order
   (the combining transaction's linearization within a bucket);
2. runs the step's read batch through :meth:`Table.lookup` and compares
   found/value against the oracle's map (misses included — the generator
   plants guaranteed-absent probes);
3. samples the logical directory depth, counting increases and decreases —
   the externally observable trace of splits and merges.

Phases whose name starts with ``snapshot_restore`` additionally **kill and
revive the table** on entry: the live handle is serialized to a durable
image on disk (``Table.save``), dropped, and restored (``Table.restore``,
optionally under a different ``restore_spec`` — another geometry,
placement or shard count: the re-shard path),
while the oracle runs uninterrupted. Every subsequent differential
check is therefore parity evidence for the snapshot subsystem itself, and
the depth trajectory after the revive proves the restored table still
auto-splits and auto-merges.

A final sweep checks exact content parity. Mismatches raise
:class:`ReplayMismatch` (or are collected when ``raise_on_mismatch=False``);
the returned report carries depth trajectory, policy action counts, phase
throughput, and check totals.

Two interchangeable oracles back the differential check (``oracle=``):

* ``"streaming"`` (default) — :class:`repro_torch.core.reference.StreamingOracle`:
  O(1) per op, O(live) memory; final-content parity is a rolling multiset
  digest compared against the digest of the table's canonical snapshot
  image, so million-op traces stay cheap to verify end to end;
* ``"materializing"`` — the original :class:`SeqExtHash` transcription
  (real directory, real splits), kept as the structural cross-check; the
  final sweep re-looks-up every key the trace ever touched;
* ``"both"`` — run both oracles over the same table run and additionally
  assert they agree with *each other* on every status and read (any
  divergence raises immediately: that is an oracle bug, not a table bug).

The oracle has no resize policy — which is the point: the policy must be
content-transparent, so a policy-driven table and the policy-free oracle
must agree on every status and every lookup, while the depth trajectory
proves the table really did resize under the workload.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

import torch

from repro_torch.core.reference import (SeqExtHash, StreamingOracle,
                                        content_digest)
from repro_torch.workloads.generators import DEL, INS, NOP
from repro_torch.workloads.trace import Trace, gen_steps

ORACLES = ("streaming", "materializing", "both")


class ReplayMismatch(AssertionError):
    """A differential check against the sequential oracle failed."""


def oracle_for(spec, kind: str = "streaming"):
    """Build the sequential oracle matching ``spec``'s aggregate addressing
    (``dmax + shard_bits`` top hash bits: a sharded table's shard id
    consumes the top ``shard_bits``). ``kind`` is ``"streaming"`` or
    ``"materializing"`` — statuses and content are identical; see the
    module docstring for the trade-off."""
    if kind not in ("streaming", "materializing"):
        raise ValueError(f"oracle kind {kind!r}")
    cls = SeqExtHash if kind == "materializing" else StreamingOracle
    extra = spec.shard_bits if spec.placement == "sharded" else 0
    return cls(dmax=spec.dmax + extra, bucket_size=spec.bucket_size,
               hash_name=spec.hash_name)


def replay(
    spec,
    trace: Trace,
    device=None,
    check: bool = True,
    depth_every: int = 1,
    lookup_chunk: int = 4096,
    raise_on_mismatch: bool = True,
    max_examples: int = 8,
    restore_spec=None,
    oracle: str = "streaming",
) -> dict:
    """Run ``trace`` through a fresh table built from ``spec`` on
    ``device`` (default ``"cuda"``).

    ``check=False`` skips the oracle entirely (benchmark mode: no per-step
    host sync beyond the ``depth_every`` sampling). ``restore_spec``
    (default: ``spec``) is the target spec for ``snapshot_restore`` phase
    revives — pass a different one to revive into another geometry or
    placement (re-shard mid-trace).
    ``oracle``
    selects the reference implementation (see module docstring):
    ``"streaming"`` | ``"materializing"`` | ``"both"``. Returns the
    report dict described in the module docstring."""
    import tempfile

    from repro_torch.table_api import Table

    if spec.value_schema is not None:
        raise ValueError("replay drives the raw i32 value mode")
    if oracle not in ORACLES:
        raise ValueError(f"oracle {oracle!r} not in {ORACLES}")
    table = Table.create(spec, device)
    device = table.device

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    refs: list = []
    if check:
        if oracle in ("materializing", "both"):
            refs.append(oracle_for(spec, "materializing"))
        if oracle in ("streaming", "both"):
            refs.append(oracle_for(spec, "streaming"))
    ref = refs[0] if refs else None  # primary (drives `want`)
    mat_ref = next((r for r in refs if isinstance(r, SeqExtHash)), None)
    stream_ref = next(
        (r for r in refs if isinstance(r, StreamingOracle)), None)
    snapshot_restores = 0
    # revives rebuild the table with a clean error flag; accumulate the
    # pre-revive flags so capacity saturation can never be laundered away
    error_seen = False

    mutations = reads = steps = 0
    status_mismatches = content_mismatches = 0
    examples: list = []
    touched: set = set()

    depth_traj = [int(table.depth())]
    increases = decreases = 0
    phase_rows: list = []
    cur_phase = None
    phase_t0 = time.perf_counter()
    phase_ops = phase_steps = 0

    def note(kind: str, detail) -> None:
        nonlocal status_mismatches, content_mismatches
        if kind == "status":
            status_mismatches += 1
        else:
            content_mismatches += 1
        if len(examples) < max_examples:
            examples.append({"kind": kind, "detail": detail})
        if raise_on_mismatch:
            raise ReplayMismatch(f"{kind} mismatch: {detail}")

    def flush_phase(next_name: Optional[str]) -> None:
        nonlocal cur_phase, phase_t0, phase_ops, phase_steps
        if cur_phase is not None:
            sync()
            dt = time.perf_counter() - phase_t0
            phase_rows.append(
                {
                    "name": cur_phase,
                    "steps": phase_steps,
                    "ops": phase_ops,
                    "seconds": round(dt, 6),
                    "mops": round(phase_ops / dt / 1e6, 6) if dt > 0 else 0.0,
                }
            )
        cur_phase = next_name
        phase_t0 = time.perf_counter()
        phase_ops = phase_steps = 0

    for step in gen_steps(trace):
        if step.phase != cur_phase:
            flush_phase(step.phase)
            if step.phase.startswith("snapshot_restore"):
                # kill & revive: durable image round trip through disk,
                # while the oracle (the surviving truth) runs uninterrupted
                error_seen |= bool(table.state.error.any())
                with tempfile.TemporaryDirectory() as td:
                    path = table.save(os.path.join(td, "table.npz"))
                    del table
                    table = Table.restore(path, restore_spec or spec, device)
                snapshot_restores += 1
        steps += 1
        phase_steps += 1

        m = int(step.kinds.shape[0])
        if m:
            table, res = table.apply(step.kinds, step.keys, step.vals)
            mutations += step.n_mutations
            phase_ops += m
            if mat_ref is not None:
                touched.update(int(k) for k in step.keys[step.kinds != NOP])
            if refs:
                got = res.status.cpu().numpy()
                for lane in range(m):
                    kind = int(step.kinds[lane])
                    if kind == NOP:
                        continue
                    key = int(step.keys[lane])
                    if kind == INS:
                        val = int(step.vals[lane])
                        wants = [r.insert(key, val) for r in refs]
                    else:
                        assert kind == DEL
                        wants = [r.delete(key) for r in refs]
                    if len(wants) == 2 and wants[0] != wants[1]:
                        # the two oracles disagreeing is an oracle bug —
                        # always raise, never collect
                        raise ReplayMismatch(
                            f"oracle divergence at step {steps} lane "
                            f"{lane}: materializing={wants[0]} "
                            f"streaming={wants[1]} (op "
                            f"{'ins' if kind == INS else 'del'} key {key})")
                    want = wants[0]
                    if int(got[lane]) != want:
                        note(
                            "status",
                            {
                                "step": steps,
                                "lane": lane,
                                "op": "ins" if kind == INS else "del",
                                "key": key,
                                "got": int(got[lane]),
                                "want": want,
                            },
                        )

        r = int(step.reads.shape[0])
        if r:
            found, vals = table.lookup(step.reads)
            reads += r
            phase_ops += r
            if refs:
                found = found.cpu().numpy()
                vals = vals.cpu().numpy()
                for i in range(r):
                    key = int(step.reads[i])
                    wants = [ref.lookup(key) for ref in refs]
                    if len(wants) == 2 and wants[0] != wants[1]:
                        raise ReplayMismatch(
                            f"oracle divergence at step {steps} read "
                            f"{i}: materializing={wants[0]} "
                            f"streaming={wants[1]} (key {key})")
                    w_found, w_val = wants[0]
                    got_f, got_v = bool(found[i]), int(vals[i])
                    if got_f != w_found or (w_found and got_v != w_val):
                        note(
                            "content",
                            {
                                "step": steps,
                                "key": key,
                                "got": (got_f, got_v),
                                "want": (w_found, w_val),
                            },
                        )

        if depth_every and steps % depth_every == 0:
            d = int(table.depth())
            if d > depth_traj[-1]:
                increases += 1
            elif d < depth_traj[-1]:
                decreases += 1
            depth_traj.append(d)
    flush_phase(None)

    # final content parity, streaming flavor: the canonical snapshot image
    # of the table must digest to exactly the oracle's rolling multiset
    # digest (whole-content evidence in O(n) host work, no touched-set)
    if stream_ref is not None:
        from repro_torch.core import snapshot as _snapshot

        image = _snapshot.extract_image(table)
        got_digest = content_digest(image.keys, image.values)
        if got_digest != stream_ref.digest:
            note(
                "content",
                {
                    "final_digest": got_digest,
                    "want": stream_ref.digest,
                    "n_items": image.n_items,
                    "want_items": stream_ref.size,
                },
            )
        elif image.n_items != stream_ref.size:
            note(
                "content",
                {"final_size": image.n_items, "want": stream_ref.size},
            )

    # final sweep, materializing flavor: re-look-up every key the trace
    # ever mutated, plus the absent band
    if mat_ref is not None:
        ref_map = mat_ref.as_dict()
        probe = np.asarray(sorted(touched), np.int32)
        for lo in range(0, len(probe), lookup_chunk):
            q = probe[lo : lo + lookup_chunk]
            found, vals = table.lookup(q)
            found = found.cpu().numpy()
            vals = vals.cpu().numpy()
            for i, key in enumerate(q):
                key = int(key)
                want = ref_map.get(key)
                got = int(vals[i]) if bool(found[i]) else None
                if got != want:
                    note(
                        "content",
                        {"final": True, "key": key, "got": got, "want": want},
                    )
        if int(table.size()) != len(ref_map):
            note(
                "content",
                {"final_size": int(table.size()), "want": len(ref_map)},
            )

    stats = table.policy_stats()
    policy_row = None
    if spec.resize_policy is not None:
        policy_row = {
            "split_watermark": spec.resize_policy.split_watermark,
            "merge_watermark": spec.resize_policy.merge_watermark,
            "splits": int(stats["splits"]),
            "merges": int(stats["merges"]),
        }
    report = {
        "trace": trace.name,
        "placement": spec.placement,
        "backend": spec.backend,
        "policy": policy_row,
        "steps": steps,
        "mutations": mutations,
        "reads": reads,
        "checked": ref is not None,
        "oracle": oracle if ref is not None else None,
        "status_mismatches": status_mismatches,
        "content_mismatches": content_mismatches,
        "mismatch_examples": examples,
        "depth": {
            "start": depth_traj[0],
            "max": max(depth_traj),
            "final": depth_traj[-1],
            "increases": increases,
            "decreases": decreases,
            "trajectory": depth_traj,
        },
        "error_flag": error_seen | bool(table.state.error.any()),
        "snapshot_restores": snapshot_restores,
        "phases": phase_rows,
    }
    # a set error flag means the scenario saturated capacity (pool rows or
    # hash bits) — scenarios are sized to resize, not to exhaust, so that
    # is a failure even when every differential check agreed
    report["ok"] = (
        status_mismatches == 0
        and content_mismatches == 0
        and not report["error_flag"]
    )
    return report
