"""Transformer building blocks for decoding: RMSNorm, RoPE, single-position
GQA attention over a cache (whole or a window slice), encoder-decoder cross
attention and the gated MLPs. The JAX package's ``models/layers.py``, op
for op in its dtypes: bf16 products, fp32 norm, RoPE angles, attention
logits and softmax.

JAX's ``preferred_element_type=float32`` on a bf16 product is written as
the product of the fp32 upcasts: bf16 × bf16 is exact in fp32, so both sum
the same exact terms in fp32.

The flash-attention forward (``flash_attention``, ``attention_block``) is
the training and prefill path and is not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def rms_norm(x, weight, eps=1e-6):
    """``x * rsqrt(mean(x²) + eps) * (1 + weight)`` in fp32, cast back to
    ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + weight.float())).to(dt)


def rope(x, positions, theta=10000.0):
    """x: [..., S, H, D]; positions: [..., S]. Angles in fp32."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., :, None, None].float() * freqs   # [...,S,1,half]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


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
    idx = torch.arange(Smax, device=q.device)[None, :]
    valid = idx < length[:, None]
    if window > 0:
        valid = valid & (idx >= (length[:, None] - window).clamp(min=0))
    return _attend_cached(q, k_cache, v_cache, valid, bf16_partials)


def decode_attention_sliced(q, k_win, v_win, kpos, length, *,
                            bf16_partials=False):
    """Decode attention over a window already sliced from the cache:
    k_win/v_win [B,W,KV,D] at absolute positions ``kpos`` [B,W]."""
    return _attend_cached(q, k_win, v_win, kpos < length[:, None],
                          bf16_partials)


def cross_attention_block(p, x, memory, *, n_heads, n_kv_heads, head_dim,
                          chunk=1024):
    """Encoder-decoder cross attention (no RoPE on memory keys)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", memory, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", memory, p["wv"])
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    logits = torch.einsum("bqkgd,bskd->bkgqs",
                          q.reshape(B, S, KV, G, D).float(),
                          k.float()) * D ** -0.5
    pr = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", pr.to(v.dtype), v)
    o = o.reshape(B, S, H, D)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


def gated_mlp(p, x, *, activation="silu"):
    """SwiGLU (llama) / GeGLU (gemma, the tanh approximation of GELU)."""
    g = torch.einsum("bsd,df->bsf", x, p["w_gate"])
    g = F.silu(g) if activation == "silu" else F.gelu(g, approximate="tanh")
    h = g * torch.einsum("bsd,df->bsf", x, p["w_up"])
    return torch.einsum("bsf,fd->bsd", h, p["w_down"])
