"""Mixture-of-Experts FFN: shared + fine-grained routed experts
(DeepSeekMoE, arXiv:2401.06066; granite-style top-k), the JAX package's
``models/moe.py``.

Dispatch is sort-based: the (token, expert) pairs are sorted by expert,
each expert keeps its first ``cap`` pairs, the kept tokens are gathered
into ``[E_pad, cap, D]`` and run through batched expert GEMMs, and the
outputs are scattered back weighted by their gates. Experts are padded to
a multiple of 16 (``ModelConfig.e_pad``) with never-routed dummies.

On DTensors the block keeps the JAX model's placements at its sites: the
grouped tokens, the expert hidden and the expert outputs with the expert
dim on ``model``, the output on the batch. The parts that have no DTensor
sharding strategy (``sort``/``argsort``, ``cummax``, the index writes and
``index_add_``) run under ``local_map``: the routing and the dispatch
ranks on the replicated router logits (a few integers a token; capacity
and ranks are global, as in the JAX block), the gather into each rank's
own experts, and the weighted scatter-add of each rank's experts, a
partial sum over ``model`` that the output constraint reduces.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import sharding as MS
from repro_torch.models.layers import gated_mlp


def stable_top_k(x, k: int):
    """The ``k`` largest entries of the last axis and their indices, ties
    broken by the lower index (``jax.lax.top_k``'s rule): a stable
    descending sort keeps equal entries in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(logits, *, n_experts, top_k, cap, router_z_coef):
    """Routing and the sort-based dispatch ranks from the router logits
    [T, E_pad] (fp32): (kept pair weights ``wf_s``, token ids ``tok_s``,
    ``keep``, expert bin ``e_idx`` (``E_pad`` for a dropped pair), slot
    ``s_idx``, aux loss), the pairs in expert order."""
    T, E_pad = logits.shape
    E = n_experts
    dev = logits.device
    if E_pad > E:  # padded dummy experts are never routable
        logits = torch.where(torch.arange(E_pad, device=dev)[None, :] < E,
                             logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_idx = stable_top_k(probs, top_k)                # [T,k]
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp(min=1e-9)

    # aux losses: load-balance (Switch) + router z-loss
    density = F.one_hot(gate_idx, E_pad).float().mean(dim=(0, 1))
    aux = E * (density * probs.mean(0)).sum()
    zloss = router_z_coef * (torch.logsumexp(logits, dim=-1) ** 2).mean()

    # ---- sort-based dispatch ----
    ef = gate_idx.reshape(-1)                                    # [T*k]
    tok = torch.arange(T, device=dev).repeat_interleave(top_k)
    wf = gate_w.reshape(-1)
    order = torch.argsort(ef, stable=True)
    ef_s, tok_s, wf_s = ef[order], tok[order], wf[order]
    iota = torch.arange(T * top_k, device=dev)
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          ef_s[1:] != ef_s[:-1]])
    start = torch.cummax(torch.where(is_start, iota, -1), dim=0).values
    slot = iota - start                                          # rank
    keep = slot < cap
    e_idx = torch.where(keep, ef_s, E_pad)                       # drop bin
    s_idx = torch.where(keep, slot, 0)
    return wf_s, tok_s, keep, e_idx, s_idx, aux + zloss


def _expert_block(n_local: int) -> int:
    """The first expert of this rank's block of ``n_local`` experts (0 when
    the experts are not split)."""
    return MS.mesh_coordinate("model") * n_local


def moe_block(p, x, *, n_experts, top_k: int, capacity_factor=1.25,
              n_shared=0, router_z_coef=1e-3):
    """x [B,S,D] → (y [B,S,D], aux_loss).

    p: {router [D, E_pad], w_gate/w_up [E_pad, D, F], w_down [E_pad, F, D],
        shared: optional gated-mlp params with F_shared}.
    """
    Bsz, S, Dm = x.shape
    T = Bsz * S
    E_pad = p["router"].shape[-1]
    xt = x.reshape(T, Dm)
    cap = int(max(8, -(-capacity_factor * top_k * T // E_pad)))  # ceil

    logits = torch.einsum("td,de->te", xt.float(), p["router"].float())
    rep = MS.where(logits.shape)              # replicated (None: no mesh)
    rep1 = MS.where((T * top_k,))
    wf_s, tok_s, keep, e_idx, s_idx, aux_loss = MS.local_call(
        lambda lg: _route(lg, n_experts=n_experts, top_k=top_k, cap=cap,
                          router_z_coef=router_z_coef),
        (rep1,) * 5 + (MS.where(()),), (rep,), logits)

    # gather this rank's experts' tokens into [E_local, cap, D]
    pg = MS.where((E_pad, cap, Dm), "model", None, None)
    split = pg is not None and any(q.is_shard() for q in pg)
    n_local = E_pad // MS.axis_size("model") if split else E_pad
    rep_x = MS.where(xt.shape)
    grad_x = None if pg is None else MS.partial_where_split(pg)

    def gather(xt, tok_s, keep, e_idx, s_idx):
        lo = _expert_block(n_local) if split else 0
        mine = keep & (e_idx >= lo) & (e_idx < lo + n_local)
        e_loc = torch.where(mine, e_idx - lo, n_local)           # drop bin
        grouped = torch.zeros((n_local + 1, cap, Dm), dtype=xt.dtype,
                              device=xt.device)
        grouped[e_loc, s_idx] = torch.where(mine[:, None], xt[tok_s], 0)
        return grouped[:n_local]

    grouped = MS.local_call(gather, pg, (rep_x,) + (rep1,) * 4,
                            xt, tok_s, keep, e_idx, s_idx,
                            grad_placements=(grad_x,) + (rep1,) * 4)
    grouped = MS.constrain(grouped, "model", None, None)

    # grouped expert GEMMs (SwiGLU experts)
    h = F.silu(torch.einsum("ecd,edf->ecf", grouped, p["w_gate"])) * \
        torch.einsum("ecd,edf->ecf", grouped, p["w_up"])
    h = MS.constrain(h, "model", None, None)
    y_exp = torch.einsum("ecf,efd->ecd", h, p["w_down"])
    y_exp = MS.constrain(y_exp, "model", None, None)

    # combine back: weighted scatter-add of this rank's experts' outputs
    # into token rows (a partial sum over the model axis when split)
    def combine(y_exp, keep, e_idx, s_idx, wf_s, tok_s):
        lo = _expert_block(n_local) if split else 0
        mine = keep & (e_idx >= lo) & (e_idx < lo + n_local)
        flat = y_exp.reshape(n_local * cap, Dm)
        src = torch.where(mine, (e_idx - lo) * cap + s_idx,
                          n_local * cap - 1)
        contrib = torch.where(mine[:, None],
                              flat[src] * wf_s[:, None].to(y_exp.dtype), 0)
        return torch.zeros((T, Dm), dtype=y_exp.dtype,
                           device=y_exp.device).index_add_(0, tok_s,
                                                           contrib)

    py = None if pg is None else [
        MS.Partial() if q.is_shard() else MS.Replicate() for q in pg]
    y = MS.local_call(combine, py, (pg,) + (rep1,) * 5,
                      y_exp, keep, e_idx, s_idx, wf_s, tok_s,
                      grad_placements=(pg, rep1, rep1, rep1, grad_x, rep1))

    if n_shared:
        y = y + gated_mlp(p["shared"], x).reshape(T, Dm)
    y = MS.constrain(y.reshape(Bsz, S, Dm), "batch", None, None)
    return y, aux_loss
