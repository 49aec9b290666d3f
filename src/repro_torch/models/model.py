"""The decode side of the unified language model, in PyTorch: the JAX
package's ``models/model.py`` for every assigned family (dense GQA decoders,
fine-grained MoE, pure SSM, hybrid attention + SSM, encoder-decoder, VLM
decoders with stubbed frontends).

Parameters are the JAX package's nested dict, layers stacked on a leading
``[L, ...]`` axis, so every leaf has one counterpart:
:func:`params_from_numpy` carries a JAX tree across. Entry points run on
``"cuda"`` unless given another device, and :func:`init_params` draws
from an explicit ``torch.Generator`` (its values differ from
``jax.random``'s).

:func:`decode_step` writes the cache in place: the cache passed in is
consumed, as JAX's donated buffers are. The layer stack is a Python loop
over views of the stacked cache. The JAX package's sharding constraints
(``_constrain_kv``, ``constrain``) are the identity on one device and have
no counterpart here.

The training and prefill forward (``forward``, ``encode``) and the mesh
sharding (``models/sharding.py``) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.table import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S


def pad_vocab(v: int, multiple: int = 1024) -> int:
    return -(-v // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab_size: int = 1024
    # layer structure
    layer_kind: str = "attn"          # attn | mamba | hybrid
    mlp_kind: str = "swiglu"          # swiglu | geglu | moe | none
    qkv_bias: bool = False
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # attention structure
    window: int = 0                   # sliding window size; 0 = global
    global_every: int = 0             # hybrid: every k-th layer global attn
    rope_theta: float = 10000.0
    attn_chunk: int = 1024
    # encoder-decoder
    enc_layers: int = 0
    # modality stubs
    n_prefix_embeds: int = 0          # VLM patch embeddings (precomputed)
    enc_frame_input: bool = False     # audio: encoder eats frame embeddings
    # numerics / engineering
    dtype: str = "bfloat16"
    remat: bool = True
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    # decode options (default off): kv_quant="int8" stores the KV cache
    # int8 with per-(pos, head) scales; decode_bf16_partials rounds the
    # attention output sum to bf16; decode_window_slice: windowed layers of
    # a hybrid stack read only a window-sized slice of the cache
    kv_quant: str = "none"            # none | int8
    decode_bf16_partials: bool = False
    decode_window_slice: bool = False

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def e_pad(self) -> int:
        """experts padded to a multiple of 16 for expert parallelism."""
        return -(-self.n_experts // 16) * 16 if self.n_experts else 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def has_attn(self) -> bool:
        return self.layer_kind in ("attn", "hybrid")

    def has_ssm(self) -> bool:
        return self.layer_kind in ("mamba", "hybrid")


# ---------------------------------------------------------------------------
# parameters: one (shape, dtype, init) description drives init_params and
# params_from_numpy


@dataclasses.dataclass(frozen=True)
class _Leaf:
    shape: tuple
    dtype: torch.dtype
    init: str = "normal"             # normal | zeros | ones | a_log
    scale: float = 0.02


def _dense(shape, dtype, scale=0.02):
    return _Leaf(tuple(shape), dtype, "normal", scale)


def _norm(shape):
    return _Leaf(tuple(shape), torch.float32, "zeros")


def _stack_spec(cfg: ModelConfig, Lx: int, cross: bool) -> Dict[str, Any]:
    """The leaves of one stacked tree of ``Lx`` identical layers."""
    d, hd = cfg.d_model, cfg.head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    dt = cfg.torch_dtype
    out = 0.02 / (2 * Lx) ** 0.5

    def attn():
        return {"wq": _dense((Lx, d, H, hd), dt),
                "wk": _dense((Lx, d, KV, hd), dt),
                "wv": _dense((Lx, d, KV, hd), dt),
                "wo": _dense((Lx, H, hd, d), dt, out)}

    def mlp(f):
        return {"w_gate": _dense((Lx, d, f), dt),
                "w_up": _dense((Lx, d, f), dt),
                "w_down": _dense((Lx, f, d), dt, out)}

    p: Dict[str, Any] = {}
    if cfg.has_attn():
        p["attn"] = attn()
        if cfg.qkv_bias:
            p["attn"].update(bq=_Leaf((Lx, H, hd), dt, "zeros"),
                             bk=_Leaf((Lx, KV, hd), dt, "zeros"),
                             bv=_Leaf((Lx, KV, hd), dt, "zeros"))
        p["ln1"] = _norm((Lx, d))
    if cross:
        p["cross"] = attn()
        p["ln_cross"] = _norm((Lx, d))
    if cfg.has_ssm():
        di, N, Hs = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        p["ssm"] = {
            "in_proj": _dense((Lx, d, 2 * di + 2 * N + Hs), dt),
            "conv": _dense((Lx, cfg.ssm_conv, di + 2 * N), dt),
            "dt_bias": _Leaf((Lx, Hs), torch.float32, "zeros"),
            "A_log": _Leaf((Lx, Hs), torch.float32, "a_log"),
            "D": _Leaf((Lx, Hs), torch.float32, "ones"),
            "norm": _norm((Lx, di)),
            "out_proj": _dense((Lx, di, d), dt, out),
        }
        p["ln_ssm"] = _norm((Lx, d))
    if cfg.mlp_kind in ("swiglu", "geglu"):
        p["mlp"] = mlp(cfg.d_ff)
        p["ln2"] = _norm((Lx, d))
    elif cfg.mlp_kind == "moe":
        E, f = cfg.e_pad, cfg.d_ff
        p["moe"] = {
            "router": _dense((Lx, d, E), torch.float32),
            "w_gate": _dense((Lx, E, d, f), dt),
            "w_up": _dense((Lx, E, d, f), dt),
            "w_down": _dense((Lx, E, f, d), dt, out),
        }
        if cfg.n_shared_experts:
            p["moe"]["shared"] = mlp(cfg.n_shared_experts * f)
        p["ln2"] = _norm((Lx, d))
    return p


def param_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree as ``_Leaf`` descriptions: the JAX package's
    ``init_params`` keys, shapes and dtypes."""
    dt = cfg.torch_dtype
    spec: Dict[str, Any] = {
        "embed": _dense((cfg.padded_vocab, cfg.d_model), dt),
        "ln_f": _norm((cfg.d_model,)),
        "layers": _stack_spec(cfg, cfg.n_layers, cross=cfg.enc_layers > 0),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = _dense((cfg.d_model, cfg.padded_vocab), dt)
    if cfg.enc_layers:
        enc_cfg = dataclasses.replace(
            cfg, layer_kind="attn",
            mlp_kind=cfg.mlp_kind if cfg.mlp_kind != "moe" else "swiglu")
        spec["encoder"] = {
            "layers": _stack_spec(enc_cfg, cfg.enc_layers, cross=False),
            "ln_f": _norm((cfg.d_model,)),
        }
        if cfg.enc_frame_input:
            spec["frame_proj"] = _dense((cfg.d_model, cfg.d_model), dt)
    return spec


def _map_spec(fn, spec, *trees, path=""):
    """``fn(leaf, *tree_leaves, path)`` over ``spec``'s leaves, keeping its
    nesting; every tree must have exactly ``spec``'s keys."""
    if isinstance(spec, _Leaf):
        return fn(spec, *trees, path)
    out = {}
    for t in trees:
        if not isinstance(t, dict) or sorted(t) != sorted(spec):
            got = sorted(t) if isinstance(t, dict) else type(t).__name__
            raise ValueError(f"parameter tree at {path or '/'} has {got}, "
                             f"want {sorted(spec)}")
    for k, sub in spec.items():
        out[k] = _map_spec(fn, sub, *(t[k] for t in trees),
                           path=f"{path}/{k}")
    return out


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random parameters for ``cfg`` on ``device`` (default ``"cuda"``):
    dense weights N(0, 0.02²) (output projections scaled by
    1/sqrt(2·layers)) drawn in fp32 from ``gen`` on its own device and cast
    to the model dtype; norms zero; SSM ``A_log`` = log(linspace(1, 16)),
    ``D`` one, ``dt_bias`` zero; QKV biases zero."""
    dev = resolve_device(device)

    def make(leaf: _Leaf, path):
        if leaf.init == "normal":
            x = torch.randn(leaf.shape, generator=gen, device=gen.device,
                            dtype=torch.float32).mul_(leaf.scale)
            return x.to(device=dev, dtype=leaf.dtype)
        if leaf.init == "a_log":
            Hs = leaf.shape[-1]
            a = torch.log(torch.linspace(1.0, 16.0, Hs, device=dev))
            return a.expand(leaf.shape).contiguous()
        fill = torch.zeros if leaf.init == "zeros" else torch.ones
        return fill(leaf.shape, dtype=leaf.dtype, device=dev)

    return _map_spec(make, param_spec(cfg))


def params_from_numpy(tree, cfg: ModelConfig, device=None) -> Dict[str, Any]:
    """The port's parameter tree from the JAX ``init_params`` tree given as
    numpy arrays (``ml_dtypes.bfloat16`` or float32 for the bf16 leaves):
    same keys and shapes, every value converted exactly (bf16 values are
    exact in float32 and back)."""
    dev = resolve_device(device)

    def conv(leaf: _Leaf, arr, path):
        arr = np.asarray(arr)
        if tuple(arr.shape) != leaf.shape:
            raise ValueError(f"parameter {path} has shape {arr.shape}, "
                             f"want {leaf.shape}")
        x = torch.tensor(np.asarray(arr, np.float32))
        return x.to(device=dev, dtype=leaf.dtype)

    return _map_spec(conv, param_spec(cfg), tree)


def count_params(params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return params.numel()


# ---------------------------------------------------------------------------
# decode (serving)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int = 0,
               device=None) -> Dict[str, torch.Tensor]:
    """Dense decode cache on ``device`` (default ``"cuda"``); the paged
    layout lives in ``serving/kvcache.py``."""
    dev = resolve_device(device)
    dt = cfg.torch_dtype

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    cache: Dict[str, Any] = {"length": zeros(batch, torch.int32)}
    Lx = cfg.n_layers
    if cfg.has_attn():
        shape = (Lx, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        if cfg.kv_quant == "int8":
            cache["k"] = zeros(shape, torch.int8)
            cache["v"] = zeros(shape, torch.int8)
            cache["k_scale"] = zeros(shape[:-1], torch.float32)
            cache["v_scale"] = zeros(shape[:-1], torch.float32)
        else:
            cache["k"] = zeros(shape)
            cache["v"] = zeros(shape)
    if cfg.has_ssm():
        cache["ssm_state"] = zeros(
            (Lx, batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim))
        cache["conv_state"] = zeros(
            (Lx, batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state))
    if cfg.enc_layers:
        cache["memory"] = zeros((batch, enc_len, cfg.d_model))
    return cache


def _store_kv(cfg, lc, k, v, pos):
    """Write the new position into one layer's cache views, in place; int8
    mode quantizes with per-(pos, head) absmax scales."""
    ar = torch.arange(k.shape[0], device=k.device)
    pos = pos.long()
    if cfg.kv_quant == "int8":
        ks = k[:, 0].abs().amax(-1).clamp(min=1e-6) / 127.0      # [B,KV]
        vs = v[:, 0].abs().amax(-1).clamp(min=1e-6) / 127.0
        kq = torch.round(k[:, 0] / ks[..., None]).clamp(-127, 127)
        vq = torch.round(v[:, 0] / vs[..., None]).clamp(-127, 127)
        lc["k"][ar, pos] = kq.to(torch.int8)
        lc["v"][ar, pos] = vq.to(torch.int8)
        lc["k_scale"][ar, pos] = ks.float()
        lc["v_scale"][ar, pos] = vs.float()
    else:
        lc["k"][ar, pos] = k[:, 0]
        lc["v"][ar, pos] = v[:, 0]


def _dequant_kv(cfg, k, v, ks=None, vs=None):
    if cfg.kv_quant == "int8":
        dt = cfg.torch_dtype
        return (k.to(dt) * ks[..., None].to(dt),
                v.to(dt) * vs[..., None].to(dt))
    return k, v


def _window_slice(c, start, W):
    """Rows ``start[b] .. start[b] + W`` of each batch row of ``c``."""
    idx = start.long()[:, None] + torch.arange(W, device=c.device)[None, :]
    return c[torch.arange(c.shape[0], device=c.device)[:, None], idx]


def _decode_layer(cfg: ModelConfig, lp, lc, x, pos, positions, memory,
                  attn_mode, win):
    """One decode layer over ``lc``, that layer's cache views, written in
    place. attn_mode: 'full' (read the whole cache, masked) or 'win_slice'
    (read only a window-sized slice)."""
    outs = []
    if cfg.has_attn():
        q, k, v = project_qkv(cfg, lp, x, positions)
        _store_kv(cfg, lc, k, v, pos)
        length = pos + 1
        if attn_mode == "win_slice":
            Smax = lc["k"].shape[1]
            W = min(cfg.window, Smax)
            start = (length - W).clamp(0, Smax - W)               # [B]
            k_w = _window_slice(lc["k"], start, W)
            v_w = _window_slice(lc["v"], start, W)
            if cfg.kv_quant == "int8":
                k_w, v_w = _dequant_kv(cfg, k_w, v_w,
                                       _window_slice(lc["k_scale"], start, W),
                                       _window_slice(lc["v_scale"], start, W))
            kpos = start[:, None] + torch.arange(W, device=x.device)[None, :]
            o = L.decode_attention_sliced(
                q, k_w, v_w, kpos, length,
                bf16_partials=cfg.decode_bf16_partials)
        else:
            if cfg.kv_quant == "int8":
                k_read, v_read = _dequant_kv(cfg, lc["k"], lc["v"],
                                             lc["k_scale"], lc["v_scale"])
            else:
                k_read, v_read = lc["k"], lc["v"]
            o = L.decode_attention(q, k_read, v_read, length, window=win,
                                   bf16_partials=cfg.decode_bf16_partials)
        outs.append(torch.einsum("bshk,hkd->bsd", o, lp["attn"]["wo"]))
    if cfg.has_ssm():
        h = L.rms_norm(x, lp["ln_ssm"], cfg.norm_eps)
        y, s_c, cv_c = S.ssm_decode_step(
            lp["ssm"], h, lc["ssm_state"], lc["conv_state"],
            headdim=cfg.ssm_headdim, d_state=cfg.ssm_state,
            conv_width=cfg.ssm_conv)
        outs.append(y)
        lc["ssm_state"].copy_(s_c)
        lc["conv_state"].copy_(cv_c)
    if cfg.layer_kind == "hybrid":
        x = x + 0.5 * outs[0] + 0.5 * outs[1]
    else:
        x = x + outs[0]

    if memory is not None:
        h = L.rms_norm(x, lp["ln_cross"], cfg.norm_eps)
        x = x + L.cross_attention_block(
            lp["cross"], h, memory, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim)

    return feed_forward(cfg, lp, x)


def project_qkv(cfg: ModelConfig, lp, x, positions):
    """A layer's attention inputs from the residual x [B,S,D]: the
    normalized projections (plus the QKV biases), q and k rotated."""
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", h, lp["attn"]["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, lp["attn"]["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, lp["attn"]["wv"])
    if cfg.qkv_bias:
        q = q + lp["attn"]["bq"]
        k = k + lp["attn"]["bk"]
        v = v + lp["attn"]["bv"]
    return (L.rope(q, positions, cfg.rope_theta),
            L.rope(k, positions, cfg.rope_theta), v)


def feed_forward(cfg: ModelConfig, lp, x):
    """x plus the layer's gated MLP or MoE block on its normalized x."""
    if cfg.mlp_kind in ("swiglu", "geglu"):
        h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        act = "silu" if cfg.mlp_kind == "swiglu" else "gelu"
        x = x + L.gated_mlp(lp["mlp"], h, activation=act)
    elif cfg.mlp_kind == "moe":
        h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        y, _ = M.moe_block(lp["moe"], h, n_experts=cfg.n_experts,
                           top_k=cfg.top_k,
                           capacity_factor=cfg.capacity_factor,
                           n_shared=cfg.n_shared_experts)
        x = x + y
    return x


def layer_views(tree, i):
    """Layer ``i`` of a stacked tree: views of its leaves."""
    return {k: layer_views(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def is_global_layer(cfg: ModelConfig, i: int) -> bool:
    """A hybrid stack's every ``global_every``-th layer attends globally."""
    return bool(cfg.global_every) and i % cfg.global_every == \
        cfg.global_every - 1


def embed_tokens(cfg: ModelConfig, params, tokens):
    """tokens [B] → x [B,1,D]: the embedding rows scaled by sqrt(d_model)
    rounded to the model dtype first, as the JAX package does."""
    dt = cfg.torch_dtype
    x = params["embed"].to(dt)[tokens.long()][:, None]
    # a device fill, not a host-to-device copy (which would synchronize)
    return x * torch.full((), cfg.d_model ** 0.5, dtype=dt, device=x.device)


def lm_head(cfg: ModelConfig, params, x):
    """Final norm and the (tied or separate) head: x [B,S,D] → logits
    [B,S,V_pad] in the model dtype."""
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.einsum("bsd,dv->bsv", x, head.to(cfg.torch_dtype))


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """One-token decode. tokens [B,1] → (logits [B,1,V], cache'). The cache
    is written in place and returned with ``length`` advanced; the cache
    passed in is consumed.

    With ``decode_window_slice`` (and a hybrid windowed arch) the stack is
    segmented: windowed layers read window-sized cache slices, global
    layers the whole cache."""
    x = embed_tokens(cfg, params, tokens[:, 0])
    pos = cache["length"]                                 # [B]
    positions = pos[:, None]
    memory = cache.get("memory")
    layer_cache = {k: v for k, v in cache.items()
                   if k not in ("length", "memory")}

    # a segmented hybrid stack: windowed layers read a window-sized slice
    # of the cache, global layers the whole cache (the JAX package's
    # _segmented_stack); otherwise every layer reads the whole cache
    segmented = (cfg.decode_window_slice and cfg.window
                 and cfg.layer_kind == "hybrid")
    for i in range(cfg.n_layers):
        glob = is_global_layer(cfg, i)
        mode = "win_slice" if segmented and not glob else "full"
        x = _decode_layer(cfg, layer_views(params["layers"], i),
                          layer_views(layer_cache, i), x, pos, positions,
                          memory, mode, 0 if glob else cfg.window)

    logits = lm_head(cfg, params, x)
    cache = dict(cache)
    cache["length"] = cache["length"] + 1
    return logits, cache


def forward(cfg: ModelConfig, params, batch, differentiable: bool = True):
    """The training / prefill forward: not ported yet."""
    raise NotImplementedError(
        "forward (flash attention, the SSD chunked scan, the encoder) is "
        "the training slice of ROADMAP.md §1 item 6, not ported yet")


def encode(cfg: ModelConfig, params, enc_inputs):
    """The encoder of the enc-dec archs: not ported yet."""
    raise NotImplementedError(
        "encode is the training slice of ROADMAP.md §1 item 6, not ported "
        "yet; decode_step reads the encoder memory from the cache")
