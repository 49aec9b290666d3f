"""The unified language model, in PyTorch: the JAX package's
``models/model.py`` for every assigned family (dense GQA decoders,
fine-grained MoE, pure SSM, hybrid attention + SSM, encoder-decoder, VLM
decoders with stubbed frontends) — the training and prefill forward
(:func:`forward`, :func:`encode`) and the decode step.

Parameters are the JAX package's nested dict, layers stacked on a leading
``[L, ...]`` axis, so every leaf has one counterpart:
:func:`params_from_numpy` carries a JAX tree across. Entry points run on
``"cuda"`` unless given another device, and :func:`init_params` draws
from an explicit ``torch.Generator`` (its values differ from
``jax.random``'s).

:func:`decode_step` writes the cache in place: the cache passed in is
consumed, as JAX's donated buffers are. The layer stack is a Python loop
over views of the stacked cache.

:func:`forward` runs the layer stack as a Python loop over layer views of
the stacked parameters, each layer under ``torch.utils.checkpoint`` when
``cfg.remat`` (the JAX package's ``jax.checkpoint`` of the scan body).

On DTensors (parameters and inputs laid out by ``launch/shardings.py``
under an ambient mesh, ``models/sharding.py``) the model carries the JAX
model's sharding constraints at its sites (``constrain`` here and in
``layers.py``, ``ssm.py``, ``moe.py``): the residual on the batch after
the embedding and every layer, the logits' vocab on ``model``, the decode
caches' layout after every write. The tensors the model builds at their
global shape (positions, masks) are put on the mesh beside the activations
they meet (``sharding.place``); nothing is replicated implicitly.
:func:`abstract_params` is the meta-device tree the dry-run traces.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.table import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import sharding as MS
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


def abstract_params(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree as meta tensors: ``init_params``' keys, shapes and
    dtypes, with nothing allocated and nothing drawn (the JAX package's
    ``jax.eval_shape`` of ``init_params``)."""
    return _map_spec(lambda leaf, path: torch.empty(
        leaf.shape, dtype=leaf.dtype, device="meta"), param_spec(cfg))


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
    if cfg.kv_quant == "int8":
        ks = k[:, 0].abs().amax(-1).clamp(min=1e-6) / 127.0      # [B,KV]
        vs = v[:, 0].abs().amax(-1).clamp(min=1e-6) / 127.0
        kq = torch.round(k[:, 0] / ks[..., None]).clamp(-127, 127)
        vq = torch.round(v[:, 0] / vs[..., None]).clamp(-127, 127)
        write_rows([lc["k"], lc["v"], lc["k_scale"], lc["v_scale"]],
                   [kq.to(torch.int8), vq.to(torch.int8), ks.float(),
                    vs.float()], pos)
    else:
        write_rows([lc["k"], lc["v"]], [k[:, 0], v[:, 0]], pos)


def write_rows(caches, rows, pos):
    """``cache[b, pos[b]] = row[b]`` for each cache [B, S, ...] and its
    rows [B, ...], in place. On DTensors each rank writes into its own
    shards under ``local_map``: the rows of its batch block, at the
    positions its sequence block holds (the cache keeps its layout; the
    rows and positions are laid out to match it)."""
    dist = MS.is_distributed(caches[0])
    seq_split = dist and MS.Shard(1) in caches[0].placements

    def local(pos, *tensors):
        n = len(tensors) // 2
        cs, rs = tensors[:n], tensors[n:]
        S_loc = cs[0].shape[1]
        p = pos.long() - (MS.mesh_coordinate("model") * S_loc
                          if seq_split else 0)
        mine = (p >= 0) & (p < S_loc)
        p = p.clamp(0, S_loc - 1)
        ar = torch.arange(cs[0].shape[0], device=p.device)
        for c, r in zip(cs, rs):
            keep = mine.reshape((-1,) + (1,) * (r.dim() - 1))
            c[ar, p] = torch.where(keep, r.to(c.dtype), c[ar, p])

    if not dist:
        return local(pos, *caches, *rows)
    pl = caches[0].placements
    row_pl = [p if p == MS.Shard(0) else MS.Shard(p.dim - 1)
              if p.is_shard() and p.dim > 1 else MS.Replicate()
              for p in pl]
    pos_pl = [p if p == MS.Shard(0) else MS.Replicate() for p in pl]
    MS.local_call(local, (None,), [pos_pl] + [c.placements for c in caches]
                  + [row_pl] * len(rows), pos, *caches, *rows)


def _dequant_kv(cfg, k, v, ks=None, vs=None):
    if cfg.kv_quant == "int8":
        dt = cfg.torch_dtype
        return (k.to(dt) * ks[..., None].to(dt),
                v.to(dt) * vs[..., None].to(dt))
    return k, v


def _window_slice(c, start, W):
    """Rows ``start[b] .. start[b] + W`` of each batch row of ``c``; on
    DTensors each rank reads its batch block with the rest of the cache
    gathered."""
    def take(c, start):
        idx = start.long()[:, None] + torch.arange(W, device=c.device)[None, :]
        return c[torch.arange(c.shape[0], device=c.device)[:, None], idx]

    pb = [p if p == MS.Shard(0) else MS.Replicate() for p in c.placements] \
        if MS.is_distributed(c) else None
    return MS.local_call(take, pb, (pb, pb), c, start)


def _constrain_kv(cfg, lc):
    """A layer's cache views under the JAX model's cache constraint: KV
    heads on ``model`` when they divide it, else the sequence (hymba's 5,
    smollm's 3). The views are returned laid out so; a write went into
    the cache itself before."""
    lc = dict(lc)
    if cfg.n_kv_heads % max(MS.axis_size("model"), 1) == 0:
        spec = ("batch", None, "model", None)
    else:
        spec = ("batch", "model", None, None)
    lc["k"] = MS.constrain(lc["k"], *spec)
    lc["v"] = MS.constrain(lc["v"], *spec)
    if cfg.kv_quant == "int8":
        lc["k_scale"] = MS.constrain(lc["k_scale"], *spec[:3])
        lc["v_scale"] = MS.constrain(lc["v_scale"], *spec[:3])
    return lc


def _decode_layer(cfg: ModelConfig, lp, lc, x, pos, positions, memory,
                  attn_mode, win):
    """One decode layer over ``lc``, that layer's cache views, written in
    place. attn_mode: 'full' (read the whole cache, masked) or 'win_slice'
    (read only a window-sized slice)."""
    outs = []
    if cfg.has_attn():
        q, k, v = project_qkv(cfg, lp, x, positions)
        _store_kv(cfg, lc, k, v, pos)
        lc = _constrain_kv(cfg, lc)
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
            kpos = start[:, None] + MS.place(
                torch.arange(W, device=x.device)[None, :], start, None, None)
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
        # the carried state's layout (the JAX model pins its heads on
        # ``model`` only when 16 divides them)
        spec_h = "model" if cfg.ssm_heads % 16 == 0 else None
        lc["ssm_state"].copy_(MS.constrain(s_c, "batch", spec_h, None, None))
        lc["conv_state"].copy_(MS.constrain(cv_c, "batch", None, "model"))
    if cfg.layer_kind == "hybrid":
        x = x + 0.5 * outs[0] + 0.5 * outs[1]
    else:
        x = x + outs[0]

    if memory is not None:
        h = L.rms_norm(x, lp["ln_cross"], cfg.norm_eps)
        x = x + L.cross_attention_block(
            lp["cross"], h, memory, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim)

    return mlp_block(cfg, lp, x)[0]


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


def mlp_block(cfg: ModelConfig, lp, x):
    """(x plus the layer's gated MLP or MoE block on its normalized x, the
    MoE aux loss or a float32 zero)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.mlp_kind in ("swiglu", "geglu"):
        h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        act = "silu" if cfg.mlp_kind == "swiglu" else "gelu"
        x = x + L.gated_mlp(lp["mlp"], h, activation=act)
    elif cfg.mlp_kind == "moe":
        h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        y, aux = M.moe_block(lp["moe"], h, n_experts=cfg.n_experts,
                             top_k=cfg.top_k,
                             capacity_factor=cfg.capacity_factor,
                             n_shared=cfg.n_shared_experts)
        x = x + y
    return x, aux


def layer_views(tree, i):
    """Layer ``i`` of a stacked tree: views of its leaves."""
    return {k: layer_views(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def is_global_layer(cfg: ModelConfig, i: int) -> bool:
    """A hybrid stack's every ``global_every``-th layer attends globally."""
    return bool(cfg.global_every) and i % cfg.global_every == \
        cfg.global_every - 1


def embed_lookup(table, tokens, dt):
    """``table.to(dt)[tokens]``. On DTensors with the vocab split over
    ``model`` (the embedding's layout) each rank looks up the tokens in its
    own vocab block, zero elsewhere, under ``local_map``; the partial sum
    over the model axis completes the lookup (the residual's constraint
    reduces it). The table's gradient is a partial sum over the batch
    axes."""
    if not MS.is_distributed(table, tokens):
        return table.to(dt)[tokens.long()]
    pt = MS.where(tokens.shape, "batch", *(None,) * (tokens.dim() - 1))
    pe = [MS.Replicate() if q.is_partial() else q for q in table.placements]
    split = MS.Shard(0) in pe
    out = [MS.Partial() if e == MS.Shard(0) else t for e, t in zip(pe, pt)]
    grad = [e if e == MS.Shard(0) else MS.Partial() if t.is_shard()
            else MS.Replicate() for e, t in zip(pe, pt)]

    def local(table, tokens):
        V = table.shape[0]
        t = tokens.long() - (MS.mesh_coordinate("model") * V if split else 0)
        hit = (t >= 0) & (t < V)
        rows = table.to(dt)[t.clamp(0, V - 1)]
        return torch.where(hit[..., None], rows, 0)

    return MS.local_call(local, out, (pe, pt), table, tokens,
                         grad_placements=(grad, pt))


def embed_tokens(cfg: ModelConfig, params, tokens):
    """tokens [B] → x [B,1,D]: the embedding rows scaled by sqrt(d_model)
    rounded to the model dtype first, as the JAX package does."""
    dt = cfg.torch_dtype
    x = embed_lookup(params["embed"], tokens, dt)[:, None]
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


# ---------------------------------------------------------------------------
# forward (training / prefill)


def _layer_fwd(cfg: ModelConfig, lp, x, positions, memory, window,
               differentiable):
    """One decoder layer: x [B,S,D] → (x', MoE aux). ``window`` is the
    layer's attention window (0 on a hybrid stack's global layers)."""
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.head_dim, chunk=cfg.attn_chunk,
              rope_theta=cfg.rope_theta, qkv_bias=cfg.qkv_bias,
              differentiable=differentiable)
    ssm_kw = dict(headdim=cfg.ssm_headdim, d_state=cfg.ssm_state,
                  chunk=cfg.ssm_chunk, conv_width=cfg.ssm_conv)
    if cfg.layer_kind == "attn":
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        x = x + L.attention_block(lp["attn"], h, positions, causal=True,
                                  window=window, **kw)
    elif cfg.layer_kind == "mamba":
        h = L.rms_norm(x, lp["ln_ssm"], cfg.norm_eps)
        x = x + S.ssm_block(lp["ssm"], h, **ssm_kw)
    else:  # hybrid: parallel attention + SSM heads (Hymba)
        ha = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        hs = L.rms_norm(x, lp["ln_ssm"], cfg.norm_eps)
        attn_out = L.attention_block(lp["attn"], ha, positions, causal=True,
                                     window=window, **kw)
        ssm_out = S.ssm_block(lp["ssm"], hs, **ssm_kw)
        x = x + 0.5 * attn_out + 0.5 * ssm_out

    if memory is not None:
        h = L.rms_norm(x, lp["ln_cross"], cfg.norm_eps)
        x = x + L.cross_attention_block(lp["cross"], h, memory,
                                        n_heads=cfg.n_heads,
                                        n_kv_heads=cfg.n_kv_heads,
                                        head_dim=cfg.head_dim)
    x, aux = mlp_block(cfg, lp, x)
    return MS.constrain(x, "batch", None, None), aux


def _run_stack(cfg: ModelConfig, stack, x, positions, memory, n_layers,
               differentiable):
    """The layer stack, each layer recomputed in the backward pass when
    ``cfg.remat``; returns (x, the layers' summed aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_layers):
        # a hybrid stack's global layers attend over everything; the attn
        # layers keep the config's window (the JAX forward's rule)
        glob = cfg.layer_kind == "hybrid" and is_global_layer(cfg, i)
        window = 0 if glob else cfg.window

        def body(x, lp, window=window):
            return _layer_fwd(cfg, lp, x, positions, memory, window,
                              differentiable)

        lp = layer_views(stack, i)
        if cfg.remat and torch.is_grad_enabled():
            x, a = checkpoint(body, x, lp, use_reentrant=False)
        else:
            x, a = body(x, lp)
        aux = aux + a
    return x, aux


def encode(cfg: ModelConfig, params, enc_inputs):
    """Encoder for enc-dec archs. enc_inputs: frame embeddings [B,S,D]
    (the modality frontend is a stub)."""
    x = enc_inputs.to(cfg.torch_dtype)
    if "frame_proj" in params:
        x = torch.einsum("bsd,de->bse", x, params["frame_proj"])
    x = MS.constrain(x, "batch", None, None)
    pos = MS.place(torch.arange(x.shape[1], device=x.device)
                   .expand(x.shape[:2]).contiguous(), x, "batch", None)
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.head_dim, chunk=cfg.attn_chunk,
              rope_theta=cfg.rope_theta, qkv_bias=cfg.qkv_bias)

    def body(x, lp):
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        x = x + L.attention_block(lp["attn"], h, pos, causal=False, **kw)
        h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        return MS.constrain(x + L.gated_mlp(lp["mlp"], h), "batch", None,
                            None)

    stack = params["encoder"]["layers"]
    for i in range(cfg.enc_layers):
        lp = layer_views(stack, i)
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(body, x, lp, use_reentrant=False)
        else:
            x = body(x, lp)
    return L.rms_norm(x, params["encoder"]["ln_f"], cfg.norm_eps)


def forward(cfg: ModelConfig, params, batch, differentiable: bool = True):
    """Training/prefill forward. batch: tokens [B,S] (+ optional
    prefix_embeds [B,P,D], enc_frames [B,Se,D]). Returns (logits
    [B,S,V_pad] in the model dtype, aux: the MoE aux loss summed over
    layers, float32)."""
    tokens = batch["tokens"]
    B = tokens.shape[0]
    dt = cfg.torch_dtype
    x = embed_lookup(params["embed"], tokens, dt)
    # gemma-style scale, rounded to the model dtype first
    x = x * torch.full((), cfg.d_model ** 0.5, dtype=dt, device=x.device)
    if cfg.n_prefix_embeds:
        x = torch.cat([batch["prefix_embeds"].to(dt), x], dim=1)
    x = MS.constrain(x, "batch", None, None)
    S_all = x.shape[1]
    positions = MS.place(torch.arange(S_all, device=x.device)
                         .expand(B, S_all).contiguous(), x, "batch", None)

    memory = None
    if cfg.enc_layers:
        memory = encode(cfg, params, batch["enc_frames"])

    x, aux = _run_stack(cfg, params["layers"], x, positions, memory,
                        cfg.n_layers, differentiable)
    logits = MS.constrain(lm_head(cfg, params, x), "batch", None, "model")
    if cfg.n_prefix_embeds:
        logits = logits[:, cfg.n_prefix_embeds:]
    return logits, aux
