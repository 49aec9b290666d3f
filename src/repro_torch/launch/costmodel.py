"""Analytic roofline cost model: the port's own copy of the JAX package's
``benchmarks/costmodel.py`` (``analytic_costs``, ``sharded_param_bytes``,
``param_count``), formula for formula, so the dry-run's analytic numbers
are the JAX dry-run's.

``analytic_costs`` gives first-principles FLOPs and HBM bytes for each
(arch, shape, mesh) from the model structure. The JAX module's HLO
collective parse (``collective_bytes_scaled``) has no counterpart: the
port's dry-run traces no mesh program yet.
"""
from __future__ import annotations


def analytic_costs(cfg, shape, n_chips: int, model_axis: int, batch_axes: int,
                   attn_dshard: bool = False):
    """Per-device analytic FLOPs and HBM bytes for one step.

    Returns dict(flops_per_device, bytes_per_device, notes).
    FLOPs: matmul-only (2·m·n·k), attention quadratic term included;
    training multiplies by 3 (fwd+bwd) + remat refwd (≈ +1 fwd ⇒ ×4/3);
    the differentiable flash path computes full S² (not S²/2) — included.
    Bytes: param traffic (fwd+bwd+refwd reads + grad writes + AdamW state
    r/w) + boundary activations (layers × ~10 tensors) + decode cache r/w.
    """
    d = cfg.d_model
    B, S = shape.global_batch, shape.seq_len
    mode = shape.mode
    tokens = B * (1 if mode == "decode" else S)
    bpp = 2  # bf16

    # ---- per-token matmul flops (2x MACs), full model ----
    lin = 0.0
    if cfg.has_attn():
        lin += 2 * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
        lin += 2 * cfg.n_heads * cfg.head_dim * d
    if cfg.has_ssm():
        lin += 2 * d * (2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads)
        lin += 2 * cfg.d_inner * d
    if cfg.mlp_kind in ("swiglu", "geglu"):
        lin += 3 * 2 * d * cfg.d_ff
    elif cfg.mlp_kind == "moe":
        lin += 3 * 2 * d * cfg.d_ff * (cfg.top_k + cfg.n_shared_experts)
        lin += 2 * d * cfg.e_pad  # router
    per_layer_lin = lin
    lin_flops = tokens * per_layer_lin * cfg.n_layers
    if cfg.enc_layers and mode != "decode":
        enc_tokens = B * min(S, 4096)
        enc_lin = (2 * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
                   + 2 * cfg.n_heads * cfg.head_dim * d + 6 * d * cfg.d_ff)
        lin_flops += enc_tokens * enc_lin * cfg.enc_layers
    if cfg.enc_layers:  # cross attention
        mem_len = min(S, 4096)
        lin_flops += tokens * (2 * d * (cfg.n_heads + 2 * cfg.n_kv_heads)
                               * cfg.head_dim + 2 * cfg.n_heads * cfg.head_dim
                               * d) * cfg.n_layers
        lin_flops += 4 * tokens * mem_len * cfg.n_heads * cfg.head_dim \
            * cfg.n_layers
    lin_flops += 2 * tokens * d * cfg.padded_vocab  # unembed (+embed gather ~0)

    # ---- attention quadratic flops ----
    attn_flops = 0.0
    if cfg.has_attn():
        hk = cfg.n_heads * cfg.head_dim
        if mode == "decode":
            ctx = min(S, cfg.window) if (cfg.window and not cfg.global_every) \
                else S
            # hybrid: (k-1)/k windowed layers + 1/k global layers
            if cfg.global_every and cfg.window:
                g = cfg.n_layers // cfg.global_every
                attn_flops = 4 * B * hk * (g * S + (cfg.n_layers - g)
                                           * min(S, cfg.window))
            else:
                attn_flops = 4 * B * hk * ctx * cfg.n_layers
        else:
            # differentiable path computes the full S×S block grid
            full = 4 * B * S * S * hk
            if cfg.window and cfg.global_every:
                g = cfg.n_layers // cfg.global_every
                win = 4 * B * S * min(2 * cfg.window, S) * hk
                attn_flops = g * full + (cfg.n_layers - g) * win
            elif cfg.window:
                attn_flops = cfg.n_layers * 4 * B * S * min(2 * cfg.window, S) * hk
            else:
                attn_flops = cfg.n_layers * full
            if cfg.enc_layers:
                attn_flops += cfg.enc_layers * 4 * B * min(S, 4096) ** 2 * hk
    if cfg.has_ssm():
        c = cfg.ssm_chunk
        H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
        if mode == "decode":
            attn_flops += cfg.n_layers * B * H * N * P * 6
        else:
            per_tok = 2 * c * H * P + 2 * c * N + 4 * N * H * P  # intra + state
            attn_flops += cfg.n_layers * tokens * per_tok

    fwd = lin_flops + attn_flops
    if mode == "train":
        total = fwd * 3 + (fwd if cfg.remat else 0)  # bwd ≈ 2×fwd, remat refwd
    else:
        total = fwd

    # ---- bytes ----
    n_params = param_count(cfg)
    # replication-aware local parameter footprint: categories whose sharded
    # dim doesn't divide the model axis are fully replicated (smollm's 9
    # heads, granite's 24, hymba's 25/5) — they pay full-read per device
    p_local = sharded_param_bytes(cfg, model_axis, bpp, attn_dshard)
    if mode == "train":
        # reads: fwd + bwd + refwd (3×), grad write (1×), AdamW: master/m/v
        # fp32 read+write (24 B/param) + bf16 param write
        opt_bytes = p_local / bpp * (24 + 2 + 4)
        param_traffic = 4 * p_local + opt_bytes
    else:
        param_traffic = p_local
    act = tokens / max(batch_axes, 1) * d * bpp
    n_act_tensors = 12 if mode == "train" else 6
    act_traffic = act * n_act_tensors * (cfg.n_layers + cfg.enc_layers)
    cache_traffic = 0.0
    if mode == "decode" and cfg.has_attn():
        kv_bpp = 1 if getattr(cfg, "kv_quant", "none") == "int8" else bpp
        scale_b = (4 / cfg.head_dim) if getattr(cfg, "kv_quant", "none") == \
            "int8" else 0.0
        # effective positions read per layer: the baseline reads the FULL
        # cache and masks; decode_window_slice reads only the window for
        # the windowed layers of a hybrid stack (§Perf cell 1)
        if getattr(cfg, "decode_window_slice", False) and cfg.window and \
                cfg.global_every:
            g = cfg.n_layers // cfg.global_every
            eff = g * S + (cfg.n_layers - g) * min(cfg.window, S)
        else:
            eff = cfg.n_layers * S
        kvb = B * eff * cfg.n_kv_heads * cfg.head_dim * (kv_bpp + scale_b) * 2
        cache_traffic = kvb / n_chips  # sharded read (+ tiny write)
    logits_traffic = tokens / max(batch_axes, 1) * cfg.padded_vocab / \
        max(model_axis, 1) * 4 * (2 if mode == "train" else 1)

    flops_per_device = total / n_chips
    bytes_per_device = (param_traffic + act_traffic + cache_traffic
                        + logits_traffic)
    return {
        "flops_per_device": flops_per_device,
        "bytes_per_device": bytes_per_device,
        "fwd_flops_total": fwd,
        "params": n_params,
    }


def sharded_param_bytes(cfg, model_axis: int, bpp: float,
                        attn_dshard: bool = False) -> float:
    """Per-device parameter bytes under the launch/shardings.py rules
    (replicated categories pay full size; attn_dshard re-shards
    indivisible-head attention on the d_model dim)."""
    d = cfg.d_model
    m = max(model_axis, 1)

    def shard(size, dim):
        if dim % m == 0:
            return size / m
        if attn_dshard and d % m == 0:
            return size / m      # contraction-dim fallback
        return size

    total = shard(cfg.padded_vocab * d * (1 if cfg.tie_embeddings else 2),
                  cfg.padded_vocab)
    per = 0.0
    if cfg.has_attn():
        attn = (d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
                + cfg.n_heads * cfg.head_dim * d)
        per += shard(attn, cfg.n_heads)   # q/o shard by heads; kv by kv-heads
    if cfg.has_ssm():
        per += shard(d * (2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads)
                     + cfg.d_inner * d, cfg.d_inner)
    if cfg.mlp_kind in ("swiglu", "geglu"):
        per += shard(3 * d * cfg.d_ff, cfg.d_ff)
    elif cfg.mlp_kind == "moe":
        per += shard(cfg.e_pad * 3 * d * cfg.d_ff, cfg.e_pad)
        per += cfg.n_shared_experts * shard(3 * d * cfg.d_ff, cfg.d_ff)
    total += cfg.n_layers * per
    if cfg.enc_layers:
        enc = (d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
               + cfg.n_heads * cfg.head_dim * d)
        total += cfg.enc_layers * (shard(enc, cfg.n_heads)
                                   + shard(3 * d * cfg.d_ff, cfg.d_ff))
        total += cfg.n_layers * shard(enc, cfg.n_heads)  # cross attn
    return total * bpp


def param_count(cfg) -> int:
    d = cfg.d_model
    n = cfg.padded_vocab * d * (1 if cfg.tie_embeddings else 2)
    per = 0
    if cfg.has_attn():
        per += d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
        per += cfg.n_heads * cfg.head_dim * d
    if cfg.has_ssm():
        per += d * (2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads)
        per += cfg.d_inner * d + cfg.ssm_conv * (cfg.d_inner + 2 * cfg.ssm_state)
    if cfg.mlp_kind in ("swiglu", "geglu"):
        per += 3 * d * cfg.d_ff
    elif cfg.mlp_kind == "moe":
        per += cfg.e_pad * 3 * d * cfg.d_ff + d * cfg.e_pad
        per += cfg.n_shared_experts * 3 * d * cfg.d_ff
    n += cfg.n_layers * per
    if cfg.enc_layers:
        enc_per = (d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
                   + cfg.n_heads * cfg.head_dim * d + 3 * d * cfg.d_ff)
        n += cfg.enc_layers * enc_per
        # cross attention in decoder
        n += cfg.n_layers * (d * (cfg.n_heads + 2 * cfg.n_kv_heads)
                             * cfg.head_dim + cfg.n_heads * cfg.head_dim * d)
    return int(n)
