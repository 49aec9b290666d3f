"""Serving engine: batched decode over the paged (WF-Ext) KV cache.

`serve_step` = one decode iteration for the whole request batch:
  1. embed the current tokens;
  2. one table transaction allocates the step's pages and resolves every
     slot's (page, offset) (:func:`~repro_torch.serving.kvcache.
     allocate_slots`), then one rule-A lookup resolves every slot's page
     ids (:func:`page_table_ids`);
  3. per layer (:func:`paged_layers`): q/k/v, the new K/V written into the
     resolved (page, offset) of the active slots, attention over the
     slot's gathered pages;
  4. the head, and the argmax next tokens.
Request admission and eviction are table transactions too, so the cache
grows and shrinks with the live set.

The JAX package's ``serving/engine.py``, for the dense-attention families
it serves (``layer_kind="attn"``, a SwiGLU or GeGLU MLP, no encoder). The
dense decode path, ``models/model.py::decode_step``, is its oracle.
Inactive slots write nothing (the JAX engine writes their stale values
back into page ``n_pages - 1``, a repeated index that can race an active
slot's write there). Entry points that build state run on ``"cuda"``
unless given another device; ``serve_step`` consumes the state it is
given.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.spec import TableSpec
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.model import ModelConfig
from repro_torch.serving import kvcache as KV


class EngineState(NamedTuple):
    paged: KV.PagedState
    tokens: torch.Tensor       # i32[batch] current token per slot


def make_paged_config(cfg: ModelConfig, batch: int, max_len: int,
                      page_size: int = 16) -> KV.PagedConfig:
    max_blocks = -(-max_len // page_size)
    n_pages = max_blocks * batch + 8
    n_pages = -(-n_pages // 512) * 512   # the JAX package's page-dim rounding
    # table spec sized for the worst-case live set, lanes = batch; page
    # metadata travels through the (page, length) value schema
    tbl = TableSpec(
        dmax=max(4, (n_pages - 1).bit_length() + 1),
        bucket_size=8,
        pool_size=max(64, 4 * n_pages),
        n_lanes=max(batch, 16),
        value_schema=dict(KV.PAGE_SCHEMA),
        slab_capacity=2 * n_pages,   # live mappings ≤ n_pages (+ transient)
    )
    return KV.PagedConfig(
        n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, page_size=page_size, n_pages=n_pages,
        max_blocks=max_blocks, batch=batch, table=tbl, dtype=cfg.dtype)


def init_engine(cfg: ModelConfig, pc: KV.PagedConfig,
                device=None) -> EngineState:
    """An empty engine on ``device`` (default ``"cuda"``)."""
    paged = KV.init_paged(pc, device)
    return EngineState(paged=paged, tokens=torch.zeros(
        pc.batch, dtype=torch.int32, device=paged.lengths.device))


def save_engine(path: str, pc: KV.PagedConfig, est: EngineState) -> str:
    """Durable engine image: the paged cache (:func:`~repro_torch.serving.
    kvcache.save_paged`) plus the per-slot tokens, written atomically as
    one image directory, the JAX package's."""
    return KV.save_paged(pc, est.paged, path, extras={"tokens": est.tokens})


def warm_start_engine(pc_new: KV.PagedConfig, path: str,
                      device=None) -> EngineState:
    """Revive a saved engine (either package's image) under ``pc_new`` on
    ``device`` (default ``"cuda"``) and resume decoding mid-sequence. New
    slots start empty (token 0, seq_id -1)."""
    paged = KV.restore_paged(pc_new, path, device)
    tokens = KV.load_extra(path, "tokens")
    pad = pc_new.batch - tokens.shape[0]
    tokens = np.concatenate([tokens, np.zeros(pad, np.int32)])
    return EngineState(paged=paged, tokens=torch.tensor(
        tokens, dtype=torch.int32, device=paged.lengths.device))


def handover_engine(pc_old: KV.PagedConfig, pc_new: KV.PagedConfig,
                    est: EngineState) -> EngineState:
    """Drain-free in-memory handover: the successor engine under
    ``pc_new`` continues every live request at its exact decode position.
    ``est`` stays usable."""
    paged = KV.handover(pc_old, est.paged, pc_new)
    pad = pc_new.batch - pc_old.batch
    tokens = torch.cat([est.tokens, est.tokens.new_zeros(pad)])
    return EngineState(paged=paged, tokens=tokens)


def check_servable(cfg: ModelConfig) -> None:
    """``serve_step`` serves the dense-attention families, as the JAX
    engine does."""
    if cfg.layer_kind != "attn" or cfg.mlp_kind not in ("swiglu", "geglu") \
            or cfg.enc_layers:
        raise NotImplementedError(
            f"serve_step serves dense-attention families (layer_kind "
            f"'attn', a SwiGLU/GeGLU MLP, no encoder), as the JAX engine "
            f"does; {cfg.name} has layer_kind={cfg.layer_kind!r}, "
            f"mlp_kind={cfg.mlp_kind!r}, enc_layers={cfg.enc_layers}")


def page_table_ids(pc: KV.PagedConfig, st: KV.PagedState):
    """Every slot's page ids [B, max_blocks] (0 where unmapped): one rule-A
    lookup of all ``B * max_blocks`` keys."""
    blocks = torch.arange(pc.max_blocks, dtype=torch.int32,
                          device=st.lengths.device)
    keys = KV._key(st.seq_ids[:, None], blocks[None, :]).reshape(-1)
    found, meta = st.table.lookup(keys)
    return torch.where(found, meta["page"], 0).reshape(
        pc.batch, pc.max_blocks).long()


def paged_layers(cfg: ModelConfig, pc: KV.PagedConfig, params, st, x,
                 positions, active, page_cur, offset, page_ids):
    """The layer stack of one step: per layer, q/k/v, the active slots' new
    K/V written into their (``page_cur``, ``offset``), attention over the
    gathered pages ``page_ids`` up to ``st.lengths`` (which includes this
    token). Writes ``st``'s pages in place; returns x."""
    B = pc.batch
    S = pc.max_blocks * pc.page_size
    for i in range(cfg.n_layers):
        lp = M.layer_views(params["layers"], i)
        q, k, v = M.project_qkv(cfg, lp, x, positions)
        pk, pv = st.pages_k[i], st.pages_v[i]      # [NP, page, KV, hd]
        KV.masked_put(pk, (page_cur, offset), k[:, 0], active)
        KV.masked_put(pv, (page_cur, offset), v[:, 0], active)
        k_c = pk[page_ids].reshape(B, S, pc.n_kv_heads, pc.head_dim)
        v_c = pv[page_ids].reshape(B, S, pc.n_kv_heads, pc.head_dim)
        o = L.decode_attention(q, k_c, v_c, st.lengths, window=cfg.window)
        x = x + torch.einsum("bshk,hkd->bsd", o, lp["attn"]["wo"])
        x = M.feed_forward(cfg, lp, x)
    return x


def serve_step(cfg: ModelConfig, pc: KV.PagedConfig, est: EngineState,
               params):
    """One batched decode step over the paged cache. Returns (est',
    logits [B, V_pad]); ``est`` is consumed.

    One WF-Ext combining transaction allocates the step's pages (block
    boundaries only) and resolves every slot's destination; the per-layer
    K/V writes and gathers are then plain indexed ops against the resolved
    pages — rule-A reads, no further table synchronization."""
    check_servable(cfg)
    st = est.paged
    x = M.embed_tokens(cfg, params, est.tokens)
    positions = st.lengths[:, None]
    active = st.seq_ids >= 0

    # the step's single table transaction + rule-A page-id resolution
    st, page_cur, offset = KV.allocate_slots(pc, st)
    page_ids = page_table_ids(pc, st)
    x = paged_layers(cfg, pc, params, st, x, positions, active, page_cur,
                     offset, page_ids)
    logits = M.lm_head(cfg, params, x)[:, 0]
    next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    next_tokens = torch.where(st.seq_ids >= 0, next_tokens, 0)
    return EngineState(paged=st, tokens=next_tokens), logits
