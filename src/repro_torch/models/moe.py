"""Mixture-of-Experts FFN: shared + fine-grained routed experts
(DeepSeekMoE, arXiv:2401.06066; granite-style top-k), the JAX package's
``models/moe.py``.

Dispatch is sort-based: the (token, expert) pairs are sorted by expert,
each expert keeps its first ``cap`` pairs, the kept tokens are gathered
into ``[E_pad, cap, D]`` and run through batched expert GEMMs, and the
outputs are scattered back weighted by their gates. Experts are padded to
a multiple of 16 (``ModelConfig.e_pad``) with never-routed dummies.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import gated_mlp


def stable_top_k(x, k: int):
    """The ``k`` largest entries of the last axis and their indices, ties
    broken by the lower index (``jax.lax.top_k``'s rule): a stable
    descending sort keeps equal entries in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_block(p, x, *, n_experts, top_k: int, capacity_factor=1.25,
              n_shared=0, router_z_coef=1e-3):
    """x [B,S,D] → (y [B,S,D], aux_loss).

    p: {router [D, E_pad], w_gate/w_up [E_pad, D, F], w_down [E_pad, F, D],
        shared: optional gated-mlp params with F_shared}.
    """
    Bsz, S, Dm = x.shape
    T = Bsz * S
    E = n_experts
    E_pad = p["router"].shape[-1]
    dev = x.device
    xt = x.reshape(T, Dm)

    logits = torch.einsum("td,de->te", xt.float(), p["router"].float())
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
    aux_loss = aux + zloss

    # ---- sort-based dispatch ----
    cap = int(max(8, -(-capacity_factor * top_k * T // E_pad)))  # ceil
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

    # gather tokens into [E_pad(+drop), cap, D]
    grouped = torch.zeros((E_pad + 1, cap, Dm), dtype=x.dtype, device=dev)
    grouped[e_idx, s_idx] = torch.where(keep[:, None], xt[tok_s], 0)
    grouped = grouped[:E_pad]

    # grouped expert GEMMs (SwiGLU experts)
    h = F.silu(torch.einsum("ecd,edf->ecf", grouped, p["w_gate"])) * \
        torch.einsum("ecd,edf->ecf", grouped, p["w_up"])
    y_exp = torch.einsum("ecf,efd->ecd", h, p["w_down"])

    # combine back: weighted scatter-add into token rows
    flat = y_exp.reshape(E_pad * cap, Dm)
    src = torch.where(keep, ef_s * cap + s_idx, E_pad * cap - 1)
    contrib = torch.where(keep[:, None],
                          flat[src] * wf_s[:, None].to(x.dtype), 0)
    y = torch.zeros((T, Dm), dtype=x.dtype, device=dev).index_add_(
        0, tok_s, contrib)

    if n_shared:
        y = y + gated_mlp(p["shared"], x).reshape(T, Dm)
    return y.reshape(Bsz, S, Dm), aux_loss

