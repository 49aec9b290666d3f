"""Table integration of the kernels: the plan-driven lookup and apply.

``plan_lookup`` / ``plan_apply`` are the facade's dispatch targets. Under a
``"cuda"`` plan a lookup is one ``fused_probe`` launch, or a route in
PyTorch and one ``probe`` launch; a write transaction is one
``fused_apply`` launch, or a route in PyTorch and one ``grouped_apply``
launch on the ops in lane order. The probes launch in the plan's lookup
tiles and ``grouped_apply`` in its apply tiles (``kernels/tuning.py``).
The bookkeeping around the kernels is shared: seq gating, occupancy
counts from the kernel's statuses, the frozen / replay / NOP status
overlays; ops the kernel reports ``ST_FULL`` go to ``resize_apply``
(``kernels/resize.py``), which runs the bounded split rounds in one launch
on the card and as the plain transaction on the CPU — the paper's fast
(ApplyWFOp) / slow (ResizeWF) structure.
"""
from __future__ import annotations

import torch

from repro_torch import telemetry
from repro_torch.core import table as T
from repro_torch.kernels import apply as kapply
from repro_torch.kernels import lookup as klookup
from repro_torch.kernels import resize as kresize
from repro_torch.kernels.apply import ST_FROZEN, ST_FULL
from repro_torch.kernels.plan import KernelPlan


def _kernel_lookup_impl(cfg: T.TableConfig, state: T.TableState, queries,
                        fused: bool, block: int = klookup.DEFAULT_BLOCK):
    """Rule-A lookup through the fused probe, or through the route in
    PyTorch and the pre-routed probe (pools without the trash row; neither
    kernel has a directory-depth bound), ``block`` threads a block."""
    if fused:
        return klookup.fused_probe(
            state.directory, queries, state.keys[:-1], state.vals[:-1],
            dmax=cfg.dmax, hash_name=cfg.hash_name,
            hash_shift=cfg.hash_shift, block=block)
    _, bid = T._route(cfg, state.directory, queries)
    return klookup.probe(bid, queries, state.keys[:-1], state.vals[:-1],
                         block=block)


def _count_applied(cfg, state, ops, status, bid, live, frozen_hit):
    """Occupancy deltas from a kernel's statuses (TRUE = net ±1 for
    insert/delete) — no pool recount — and ``applied_seq`` for the ops
    completed without the slow path."""
    P = cfg.pool_size
    applied = live & (status != ST_FULL)
    hit = applied & (status == T.TRUE)
    delta = ((hit & (ops.kind == T.INS)).to(torch.int32)
             - (hit & (ops.kind == T.DEL)).to(torch.int32))
    state.counts.index_add_(0, torch.where(applied, bid, P).long(), delta)
    telemetry.host_write("applied", state.counts, P, 0)
    return state._replace(applied_seq=torch.where(
        applied | frozen_hit, ops.seq, state.applied_seq))


def _finish_kernel_apply(cfg, st, ops, status, live, frozen_hit, replay):
    """Shared tail of a kernel transaction: the ST_FULL slow path and the
    replay/frozen/NOP status overlays. Only ops that hit a full bucket
    enter the slow path (``resize_apply``); everyone else is masked to
    NOP."""
    need_slow = live & (status == ST_FULL)
    telemetry.count_device("txn.live_lanes", live)
    telemetry.count_device("slow.lanes", need_slow)
    slow_status = status
    if telemetry.host_read("need_slow", need_slow.any()):
        telemetry.count("slow.calls")
        slow_ops = T.OpBatch(kind=torch.where(need_slow, ops.kind, T.NOP),
                             key=ops.key, value=ops.value, seq=ops.seq)
        st, res = kresize.resize_apply(cfg, st, slow_ops)
        slow_status = res.status
    final = torch.where(need_slow, slow_status, status).to(torch.int8)
    final = torch.where(frozen_hit, T.FROZEN, final).to(torch.int8)
    final = torch.where(replay, st.last_status, final)
    final = torch.where(ops.kind == T.NOP, st.last_status, final)
    st = st._replace(last_status=final)
    return st, T.BatchResult(status=final, error=st.error)


def _gate(state: T.TableState, ops: T.OpBatch):
    """Exactly-once gating: (fresh, replay) lane masks."""
    fresh = (ops.kind != T.NOP) & (ops.seq > state.applied_seq)
    return fresh, (ops.kind != T.NOP) & ~fresh


def _apply_batch_fused_impl(cfg: T.TableConfig, state: T.TableState,
                            ops: T.OpBatch):
    """One write transaction through ``fused_apply``, which routes and
    completes frozen-destination ops itself (ST_FROZEN == table.FROZEN).
    The pools are updated in place: ``state`` is consumed."""
    fresh, replay = _gate(state, ops)
    kinds = torch.where(fresh, ops.kind, T.NOP).to(torch.int32)
    pk, pv, status, bid = kapply.fused_apply(
        state.directory, state.frozen, kinds, ops.key, ops.value,
        state.keys, state.vals, dmax=cfg.dmax, hash_name=cfg.hash_name,
        hash_shift=cfg.hash_shift)
    frozen_hit = fresh & (status == ST_FROZEN)
    live = fresh & ~frozen_hit
    st = _count_applied(cfg, state._replace(keys=pk, vals=pv), ops, status,
                        bid, live, frozen_hit)
    return _finish_kernel_apply(cfg, st, ops, status, live, frozen_hit,
                                replay)


def _apply_batch_kernel_impl(cfg: T.TableConfig, state: T.TableState,
                             ops: T.OpBatch,
                             chunk: int = kapply.GROUPED_CHUNK):
    """One write transaction through ``grouped_apply``, ``chunk`` lanes a
    chunk: route, complete the frozen-destination ops here (the kernel
    ignores freezing), apply the ops in lane order with the frozen and
    replayed lanes masked to NOP (the kernel groups them by bucket itself).
    The pools are updated in place: ``state`` is consumed."""
    fresh, replay = _gate(state, ops)
    _, bid = T._route(cfg, state.directory, ops.key)
    frozen_hit = fresh & state.frozen[bid.long()]
    live = fresh & ~frozen_hit
    kinds = torch.where(live, ops.kind, T.NOP).to(torch.int32)
    pk, pv, status = kapply.grouped_apply(kinds, ops.key, ops.value, bid,
                                          state.keys, state.vals,
                                          chunk=chunk)
    st = _count_applied(cfg, state._replace(keys=pk, vals=pv), ops, status,
                        bid, live, frozen_hit)
    return _finish_kernel_apply(cfg, st, ops, status, live, frozen_hit,
                                replay)


def plan_lookup(plan: KernelPlan, cfg: T.TableConfig, state: T.TableState,
                queries):
    """Rule-A lookup under a resolved plan, in its lookup tiles."""
    with telemetry.span("repro.dispatch.lookup"):
        if plan.backend == "plain":
            return T.lookup(cfg, state, queries)
        return _kernel_lookup_impl(cfg, state, queries, plan.fused_lookup,
                                   block=plan.lookup_tiles.block)


def plan_apply(plan: KernelPlan, cfg: T.TableConfig, state: T.TableState,
               ops: T.OpBatch):
    """Combining transaction under a resolved plan: the fused kernel where
    the plan allows, else the grouped kernel in the plan's apply tiles."""
    with telemetry.span("repro.dispatch.apply"):
        if plan.backend == "plain":
            return T.apply_batch(cfg, state, ops)
        if plan.fused_apply:
            return _apply_batch_fused_impl(cfg, state, ops)
        return _apply_batch_kernel_impl(cfg, state, ops,
                                        chunk=plan.apply_tiles.chunk)
