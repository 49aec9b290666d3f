"""Transformer building blocks: RMSNorm, RoPE, chunked GQA attention for
training and prefill (causal or not, sliding window), single-position GQA
attention over a cache (whole or a window slice), encoder-decoder cross
attention and the gated MLPs. The JAX package's ``models/layers.py``, op
for op in its dtypes: bf16 products, fp32 norm, RoPE angles, attention
logits and softmax.

JAX's ``preferred_element_type=float32`` on a bf16 product is written as
the product of the fp32 upcasts: bf16 × bf16 is exact in fp32, so both sum
the same exact terms in fp32.

On DTensors (an ambient mesh, ``models/sharding.py``) the blocks carry the
JAX model's constraints at its sites: q/k/v/o heads on ``model``, the
cross attention's q, the MLP hidden on ``model``. The attention core runs
under ``local_map`` on each rank's heads and batch rows.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import sharding as MS

NEG_INF = -1e30


def rms_norm(x, weight, eps=1e-6):
    """``x * rsqrt(mean(x²) + eps) * (1 + weight)`` in fp32, cast back to
    ``x``'s dtype. On DTensors it runs on each rank's rows (the normalized
    dim whole); the weight's gradient is a partial sum over the axes that
    split the rows."""
    if MS.is_distributed(x, weight):
        px = MS.rows_of(x)
        pw = [MS.Replicate()] * len(px)
        return MS.local_call(lambda x, w: _rms_norm(x, w, eps), px, (px, pw),
                             x, weight,
                             grad_placements=(px, MS.partial_where_split(px)))
    return _rms_norm(x, weight, eps)


def _rms_norm(x, weight, eps):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + weight.float())).to(dt)


def rope(x, positions, theta=10000.0):
    """x: [..., S, H, D]; positions: [..., S]. Angles in fp32. On DTensors
    it runs on each rank's rows and heads (positions laid out as x's
    leading dims)."""
    if MS.is_distributed(x, positions):
        px = MS.rows_of(x)
        pp = [q if q.is_shard() and q.dim < positions.dim() else
              MS.Replicate() for q in px]
        return MS.local_call(lambda x, p: _rope(x, p, theta), px, (px, pp),
                             x, positions, grad_placements=(px, pp))
    return _rope(x, positions, theta)


def _rope(x, positions, theta):
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., :, None, None].float() * freqs   # [...,S,1,half]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _attend_block(q, k, v, mask, scale):
    """One (q-chunk × kv-chunk) attention block with fp32 logits.

    q [B,Tq,H,D], k/v [B,Tk,KV,D] with H = KV*G; ``mask`` broadcasts to
    [B,KV,G,Tq,Tk]. Returns unnormalized (out [B,Tq,H,D] fp32, row_max
    [B,H,Tq], row_sum [B,H,Tq])."""
    B, Tq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Tq, KV, G, D)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1)                            # [B,KV,G,Tq]
    # a fully masked row has m = NEG_INF and exp(0) = 1 on its masked
    # entries: they are zeroed explicitly
    p = torch.where(logits > NEG_INF * 0.5,
                    torch.exp(logits - m[..., None]), 0.0)
    s = p.sum(dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    return (out.reshape(B, Tq, H, D), m.reshape(B, KV * G, Tq),
            s.reshape(B, KV * G, Tq))


def flash_attention(q, k, v, *, causal=True, window=0, chunk=1024,
                    differentiable=False):
    """Memory-bounded attention, the JAX package's chunked online softmax:
    a loop over q chunks and, inside it, over the kv chunks that can hold
    an unmasked key (``lo .. hi``: up to the diagonal for causal attention
    and only the window's chunks for sliding-window attention).

    ``window`` > 0 keeps the last ``window`` positions; 0 (or less) is
    global. q [B,S,H,D]; k,v [B,S,KV,D] → [B,S,H,D]. A length that is not
    a chunk multiple is padded and the padded keys masked.

    The JAX package walks every kv chunk with masking when
    ``differentiable`` (reverse-mode AD cannot cross its dynamic loop
    bounds). Eager autograd crosses a Python loop with any bounds, and a
    fully masked chunk adds exactly nothing to the online softmax (its
    weight is exp(NEG_INF - m) = 0), so both modes take the skip-ahead
    loop here and equal the JAX function's; the argument is kept for the
    JAX signature."""
    del differentiable
    B, S_real, H, D = q.shape
    KV = k.shape[2]
    scale = D ** -0.5
    c = min(chunk, S_real)
    pad = -S_real % c
    if pad:  # pad to a chunk multiple; padded keys are masked out below
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    S = S_real + pad
    nq = S // c
    w = window if window > 0 else S
    G = H // KV
    pos = torch.arange(S, device=q.device)
    outs = []
    for qi in range(nq):
        q_i = q[:, qi * c:(qi + 1) * c]
        qpos = pos[qi * c:(qi + 1) * c, None]            # [c,1]
        acc = torch.zeros((B, c, H, D), dtype=torch.float32, device=q.device)
        m = torch.full((B, H, c), NEG_INF, dtype=torch.float32,
                       device=q.device)
        s = torch.zeros((B, H, c), dtype=torch.float32, device=q.device)
        lo = max(0, qi - (w + c - 1) // c) if window > 0 else 0
        hi = qi + 1 if causal else nq
        for j in range(lo, hi):
            kpos = pos[None, j * c:(j + 1) * c]          # [1,c]
            mask = kpos <= qpos if causal else torch.ones(
                (c, c), dtype=torch.bool, device=q.device)
            mask = mask & (kpos < S_real)                # padded keys
            if window > 0:
                mask = mask & (kpos > qpos - w)
            o_j, m_j, s_j = _attend_block(
                q_i, k[:, j * c:(j + 1) * c], v[:, j * c:(j + 1) * c],
                mask.expand(B, KV, G, c, c), scale)
            m_new = torch.maximum(m, m_j)
            alpha = torch.exp(m - m_new)
            beta = torch.exp(m_j - m_new)
            acc = acc * alpha.transpose(1, 2)[..., None] + \
                o_j * beta.transpose(1, 2)[..., None]
            s = s * alpha + s_j * beta
            m = m_new
        out = acc / s.transpose(1, 2)[..., None].clamp(min=1e-30)
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1)[:, :S_real]


def attention_block(p, x, positions, *, n_heads, n_kv_heads, head_dim,
                    causal=True, window=0, chunk=1024, rope_theta=10000.0,
                    qkv_bias=False, differentiable=False):
    """Full attention sub-layer (projections + flash attention)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = MS.constrain(q, "batch", None, "model", None)
    k = MS.constrain(k, "batch", None, "model", None)
    v = MS.constrain(v, "batch", None, "model", None)
    q = rope(q, positions, rope_theta)
    k = rope(k, positions, rope_theta)
    o = over_heads(lambda q, k, v: flash_attention(
        q, k, v, causal=causal, window=window, chunk=chunk,
        differentiable=differentiable), q, k, v)
    o = MS.constrain(o, "batch", None, "model", None)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


def over_heads(core, q, k, v, *rows):
    """``core(q, k, v, *rows)`` — attention of q [B,S,H,D] over k/v
    [B,T,KV,D], ``rows`` batch-leading extras such as masks — on each
    rank's batch rows and heads when the inputs are DTensors: q's heads as
    ``constrain(q, "batch", None, "model", None)`` places them, k/v's
    likewise (a cache split over its sequence comes back whole). When the
    model axis splits the query heads but not the KV heads (smollm's 3, a
    smoke config's 2 over 4), each rank takes the KV heads its own query
    heads read (GQA: head h reads KV head h // (H / KV)), and their
    gradients are partial sums over the model axis. The output is laid
    out as q."""
    pq = MS.where(q.shape, "batch", None, "model", None)
    if pq is None or not MS.is_distributed(q, k, v):
        return core(q, k, v, *rows)
    pk = MS.where(k.shape, "batch", None, "model", None)
    H, KV = q.shape[2], k.shape[2]
    q_split = any(p == MS.Shard(2) for p in pq)
    kv_split = any(p == MS.Shard(2) for p in pk)
    grad_kv = pk
    if q_split and not kv_split:
        grad_kv = [MS.Partial() if p == MS.Shard(2) else k_p
                   for p, k_p in zip(pq, pk)]
    prow = [MS.where(r.shape, "batch", *(None,) * (r.dim() - 1))
            for r in rows]

    def local(q, k, v, *rows):
        if q_split and not kv_split:
            h = q.shape[2]
            idx = (MS.mesh_coordinate("model") * h
                   + torch.arange(h, device=q.device)) // (H // KV)
            k, v = k[:, :, idx], v[:, :, idx]
        return core(q, k, v, *rows)

    return MS.local_call(local, pq, (pq, pk, pk, *prow), q, k, v, *rows,
                         grad_placements=(pq, grad_kv, grad_kv, *prow))


def _attend_cached(q, k, v, valid, bf16_partials):
    """Single-position attention of q [B,1,H,D] over k/v [B,S,KV,D] where
    ``valid`` [B,S] holds: fp32 logits and softmax, the probabilities cast
    to the cache's dtype, the output summed in fp32 (rounded to bf16 with
    ``bf16_partials``) and cast to q's dtype."""
    B, S, KVh, D = k.shape
    H = q.shape[2]
    G = H // KVh
    logits = torch.einsum("bkgd,bskd->bkgs",
                          q[:, 0].reshape(B, KVh, G, D).float(),
                          k.float()) * D ** -0.5
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype).float(), v.float())
    if bf16_partials:
        out = out.to(torch.bfloat16)
    return out.reshape(B, 1, H, D).to(q.dtype)


def decode_attention(q, k_cache, v_cache, length, *, window=0,
                     bf16_partials=False):
    """Single-position decode: q [B,1,H,D] over caches [B,Smax,KV,D] with
    valid prefix ``length`` [B]. ``window`` > 0 keeps the last ``window``
    positions; 0 is global. ``bf16_partials`` rounds the output sum to
    bf16, as the JAX package's bf16 partial sums do."""
    Smax = k_cache.shape[1]
    idx = MS.place(torch.arange(Smax, device=q.device)[None, :], length,
                   None, None)
    valid = idx < length[:, None]
    if window > 0:
        valid = valid & (idx >= (length[:, None] - window).clamp(min=0))
    return over_heads(lambda q, k, v, valid: _attend_cached(
        q, k, v, valid, bf16_partials), q, k_cache, v_cache, valid)


def decode_attention_sliced(q, k_win, v_win, kpos, length, *,
                            bf16_partials=False):
    """Decode attention over a window already sliced from the cache:
    k_win/v_win [B,W,KV,D] at absolute positions ``kpos`` [B,W]."""
    return over_heads(lambda q, k, v, valid: _attend_cached(
        q, k, v, valid, bf16_partials), q, k_win, v_win,
        kpos < length[:, None])


def cross_attention_block(p, x, memory, *, n_heads, n_kv_heads, head_dim,
                          chunk=1024):
    """Encoder-decoder cross attention (no RoPE on memory keys)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", memory, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", memory, p["wv"])
    q = MS.constrain(q, "batch", None, "model", None)
    o = over_heads(_cross_core, q, k, v)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


def _cross_core(q, k, v):
    """Unmasked attention of q [B,S,H,D] over k/v [B,T,KV,D], fp32 logits
    and softmax."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    logits = torch.einsum("bqkgd,bskd->bkgqs",
                          q.reshape(B, S, KV, G, D).float(),
                          k.float()) * D ** -0.5
    pr = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", pr.to(v.dtype), v)
    return o.reshape(B, S, H, D)


def gated_mlp(p, x, *, activation="silu"):
    """SwiGLU (llama) / GeGLU (gemma, the tanh approximation of GELU).

    On DTensors the block runs under ``local_map`` as a column- then
    row-parallel pair (Megatron's MLP): each rank takes its batch rows and
    its block of the hidden dim (the JAX constraint on the hidden,
    ``("batch", None, "model")``), and the output is a partial sum over
    ``model`` that the residual's constraint reduces."""
    if not MS.is_distributed(x, p["w_gate"]):
        return _gated_mlp(p["w_gate"], p["w_up"], p["w_down"], x, activation)
    px = MS.where(x.shape, "batch", None, None)
    pw, pd = p["w_gate"].placements, p["w_down"].placements
    out = [MS.Partial() if q == MS.Shard(0) else r for q, r in zip(pd, px)]
    grad_x = out

    def grad_w(pl):
        # each rank's weight gradient covers its own batch rows
        return [MS.Partial() if r.is_shard() else q for q, r in zip(pl, px)]

    return MS.local_call(
        lambda wg, wu, wd, x: _gated_mlp(wg, wu, wd, x, activation), out,
        (pw, pw, pd, px), p["w_gate"], p["w_up"], p["w_down"], x,
        grad_placements=(grad_w(pw), grad_w(pw), grad_w(pd), grad_x))


def _gated_mlp(w_gate, w_up, w_down, x, activation):
    g = torch.einsum("bsd,df->bsf", x, w_gate)
    g = F.silu(g) if activation == "silu" else F.gelu(g, approximate="tanh")
    h = g * torch.einsum("bsd,df->bsf", x, w_up)
    return torch.einsum("bsf,fd->bsd", h, w_down)
