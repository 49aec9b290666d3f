"""Table integration of the kernels: the plan-driven lookup and apply.

``plan_lookup`` / ``plan_apply`` are the facade's dispatch targets. Under a
``"cuda"`` plan a lookup is one ``fused_probe`` launch and a write
transaction is one ``fused_apply`` launch plus the bookkeeping around it
(seq gating, occupancy counts from the kernel's statuses, the frozen /
replay / NOP status overlays); ops the kernel reports ``ST_FULL`` re-enter
the plain transaction, which runs the bounded split rounds — the paper's
fast (ApplyWFOp) / slow (ResizeWF) structure.
"""
from __future__ import annotations

import torch

from repro_torch.core import table as T
from repro_torch.kernels import apply as kapply
from repro_torch.kernels import lookup as klookup
from repro_torch.kernels.apply import ST_FROZEN, ST_FULL
from repro_torch.kernels.plan import KernelPlan


def _kernel_lookup_impl(cfg: T.TableConfig, state: T.TableState, queries):
    """Rule-A lookup through the fused probe (pools without the trash
    row; the CUDA kernel has no directory-depth bound)."""
    return klookup.fused_probe(
        state.directory, queries, state.keys[:-1], state.vals[:-1],
        dmax=cfg.dmax, hash_name=cfg.hash_name, hash_shift=cfg.hash_shift)


def _finish_kernel_apply(cfg, st, ops, status, live, frozen_hit, replay):
    """Shared tail of a kernel transaction: the ST_FULL slow path and the
    replay/frozen/NOP status overlays. Only ops that hit a full bucket
    re-enter the plain transaction; everyone else is masked to NOP."""
    need_slow = live & (status == ST_FULL)
    slow_status = status
    if bool(need_slow.any()):
        slow_ops = T.OpBatch(kind=torch.where(need_slow, ops.kind, T.NOP),
                             key=ops.key, value=ops.value, seq=ops.seq)
        st, res = T.apply_batch(cfg, st, slow_ops)
        slow_status = res.status
    final = torch.where(need_slow, slow_status, status).to(torch.int8)
    final = torch.where(frozen_hit, T.FROZEN, final).to(torch.int8)
    final = torch.where(replay, st.last_status, final)
    final = torch.where(ops.kind == T.NOP, st.last_status, final)
    st = st._replace(last_status=final)
    return st, T.BatchResult(status=final, error=st.error)


def _apply_batch_fused_impl(cfg: T.TableConfig, state: T.TableState,
                            ops: T.OpBatch):
    """One write transaction through ``fused_apply``. The pools are updated
    in place: ``state`` is consumed."""
    P = cfg.pool_size
    fresh = (ops.kind != T.NOP) & (ops.seq > state.applied_seq)
    replay = (ops.kind != T.NOP) & ~fresh
    kinds = torch.where(fresh, ops.kind, T.NOP).to(torch.int32)

    pk, pv, status, bid = kapply.fused_apply(
        state.directory, state.frozen, kinds, ops.key, ops.value,
        state.keys, state.vals, dmax=cfg.dmax, hash_name=cfg.hash_name,
        hash_shift=cfg.hash_shift)

    # the kernel completes frozen-destination ops itself (ST_FROZEN ==
    # table.FROZEN); occupancy deltas come from its statuses (TRUE = net
    # ±1 for insert/delete) — no pool recount
    frozen_hit = fresh & (status == ST_FROZEN)
    live = fresh & ~frozen_hit
    applied = live & (status != ST_FULL)
    hit = applied & (status == T.TRUE)
    delta = ((hit & (ops.kind == T.INS)).to(torch.int32)
             - (hit & (ops.kind == T.DEL)).to(torch.int32))
    state.counts.index_add_(0, torch.where(applied, bid, P).long(), delta)
    state.counts[P] = 0

    st = state._replace(
        keys=pk, vals=pv,
        applied_seq=torch.where(applied | frozen_hit, ops.seq,
                                state.applied_seq))
    return _finish_kernel_apply(cfg, st, ops, status, live, frozen_hit,
                                replay)


def plan_lookup(plan: KernelPlan, cfg: T.TableConfig, state: T.TableState,
                queries):
    """Rule-A lookup under a resolved plan."""
    if plan.backend == "plain":
        return T.lookup(cfg, state, queries)
    return _kernel_lookup_impl(cfg, state, queries)


def plan_apply(plan: KernelPlan, cfg: T.TableConfig, state: T.TableState,
               ops: T.OpBatch):
    """Combining transaction under a resolved plan."""
    if plan.backend == "plain":
        return T.apply_batch(cfg, state, ops)
    return _apply_batch_fused_impl(cfg, state, ops)
