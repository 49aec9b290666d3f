"""The 10 assigned architectures: the JAX package's configs, field for field.

`get_config` names one by its architecture; `smoke_config` derives the
reduced same-family config used by the per-arch CPU tests. ``chip_smoke.py`` runs full-width ``deepseek-7b``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.model import ModelConfig

# --- LM-family transformers -------------------------------------------------

INTERNVL2_2B = ModelConfig(
    name="internvl2-2b",            # InternViT stub + InternLM2 [2404.16821]
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=92553, layer_kind="attn", mlp_kind="swiglu",
    n_prefix_embeds=256, tie_embeddings=False,
)

SEAMLESS_M4T_LARGE_V2 = ModelConfig(
    name="seamless-m4t-large-v2",   # enc-dec, speech frontend stub [2308.11596]
    n_layers=24, enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    head_dim=64, d_ff=8192, vocab_size=256206, layer_kind="attn",
    mlp_kind="swiglu", enc_frame_input=True, tie_embeddings=False,
)

DEEPSEEK_MOE_16B = ModelConfig(
    name="deepseek-moe-16b",        # 2 shared + 64 routed top-6 [2401.06066]
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=102400, layer_kind="attn", mlp_kind="moe",
    n_experts=64, n_shared_experts=2, top_k=6, tie_embeddings=False,
)

GRANITE_MOE_3B_A800M = ModelConfig(
    name="granite-moe-3b-a800m",    # 40 experts top-8 [hf:ibm-granite]
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155, layer_kind="attn", mlp_kind="moe",
    n_experts=40, n_shared_experts=0, top_k=8, tie_embeddings=True,
)

HYMBA_1_5B = ModelConfig(
    name="hymba-1.5b",              # parallel attn+mamba heads [2411.13676]
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001, layer_kind="hybrid", mlp_kind="swiglu",
    ssm_state=16, ssm_headdim=64, ssm_expand=2,
    window=1024, global_every=8,    # full attention every 8th layer
    tie_embeddings=True,
)

DEEPSEEK_7B = ModelConfig(
    name="deepseek-7b",             # llama-arch [2401.02954]
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=11008, vocab_size=102400, layer_kind="attn", mlp_kind="swiglu",
    tie_embeddings=False,
)

CODEQWEN1_5_7B = ModelConfig(
    name="codeqwen1.5-7b",          # qwen1.5-arch [hf:Qwen/CodeQwen1.5-7B]
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=13440, vocab_size=92416, layer_kind="attn", mlp_kind="swiglu",
    qkv_bias=True, tie_embeddings=False,
)

SMOLLM_135M = ModelConfig(
    name="smollm-135m",             # llama-arch small [hf:HuggingFaceTB]
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, head_dim=64,
    d_ff=1536, vocab_size=49152, layer_kind="attn", mlp_kind="swiglu",
    tie_embeddings=True,
)

GEMMA_7B = ModelConfig(
    name="gemma-7b",                # GeGLU, head_dim=256 [2403.08295]
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab_size=256000, layer_kind="attn", mlp_kind="geglu",
    tie_embeddings=True,
)

MAMBA2_2_7B = ModelConfig(
    name="mamba2-2.7b",             # SSD, attn-free [2405.21060]
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50280, layer_kind="mamba", mlp_kind="none",
    ssm_state=128, ssm_headdim=64, ssm_expand=2, tie_embeddings=True,
)

ARCHS = {
    c.name: c
    for c in [
        INTERNVL2_2B, SEAMLESS_M4T_LARGE_V2, DEEPSEEK_MOE_16B,
        GRANITE_MOE_3B_A800M, HYMBA_1_5B, DEEPSEEK_7B, CODEQWEN1_5_7B,
        SMOLLM_135M, GEMMA_7B, MAMBA2_2_7B,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: small widths/depths/vocabs, few experts —
    runnable forward/train step on CPU."""
    cfg = get_config(name)
    kv = 2 if cfg.n_kv_heads and cfg.n_kv_heads < cfg.n_heads else 4
    upd = dict(
        n_layers=2, d_model=128, d_ff=256 if cfg.d_ff else 0,
        vocab_size=512, attn_chunk=64, ssm_chunk=32, remat=False,
    )
    if cfg.has_attn():
        upd.update(n_heads=4, n_kv_heads=kv, head_dim=32)
    if cfg.has_ssm():
        upd.update(ssm_headdim=32, ssm_state=min(cfg.ssm_state, 16))
    if cfg.mlp_kind == "moe":
        upd.update(n_experts=8, top_k=2,
                   n_shared_experts=min(cfg.n_shared_experts, 1), d_ff=64)
    if cfg.enc_layers:
        upd.update(enc_layers=2)
    if cfg.n_prefix_embeds:
        upd.update(n_prefix_embeds=8)
    if cfg.window:
        upd.update(window=32, global_every=2)
    return dataclasses.replace(cfg, **upd)
