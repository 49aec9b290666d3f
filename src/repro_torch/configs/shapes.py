"""Assigned input shapes × architecture cells and their meta-tensor input
specs: the JAX package's ``configs/shapes.py``, with meta tensors in place
of ``jax.ShapeDtypeStruct`` (the dry-run contract: shapes and dtypes,
nothing allocated).

LM shapes are seq_len × global_batch. decode_*/long_* trace
``decode_step`` (one new token over a seq_len KV cache), not
``train_step``. long_500k needs sub-quadratic attention: it runs for the
SSM/hybrid archs (mamba2, hymba) and is SKIPPED for pure full-attention
archs (recorded per cell, with the JAX package's reason).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch

from repro_torch.configs.archs import ARCHS, get_config
from repro_torch.models.model import ModelConfig, init_cache


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                    # train | prefill | decode


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}

# sub-quadratic archs that run the 500k cell
LONG_CONTEXT_ARCHS = ("hymba-1.5b", "mamba2-2.7b")

ENC_LEN = 4096  # encoder memory length for the enc-dec arch's decode cells


def cell_supported(arch: str, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return False, "pure full-attention arch: 500k decode cache/quadratic prefill infeasible (DESIGN.md §6)"
    return True, ""


def cells():
    """All (arch, shape, supported, reason) cells — 40 total."""
    out = []
    for arch in ARCHS:
        for shape in SHAPES:
            ok, why = cell_supported(arch, shape)
            out.append((arch, shape, ok, why))
    return out


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(arch: str, shape: Union[str, Shape],
                cfg: Optional[ModelConfig] = None) -> Dict[str, object]:
    """Meta-tensor stand-ins for every input of the step function.

    ``shape`` is a ``SHAPES`` name or a ``Shape``. train/prefill →
    {"tokens", "targets"?, extras}; decode → {"tokens", "cache": dict of
    meta tensors}, whose keys are ``init_cache``'s."""
    cfg = cfg or get_config(arch)
    sh = SHAPES[shape] if isinstance(shape, str) else shape
    B, S = sh.global_batch, sh.seq_len
    dt = cfg.torch_dtype

    if sh.mode in ("train", "prefill"):
        batch = {"tokens": _meta((B, S), torch.int32)}
        if sh.mode == "train":
            batch["targets"] = _meta((B, S), torch.int32)
        if cfg.n_prefix_embeds:
            batch["prefix_embeds"] = _meta((B, cfg.n_prefix_embeds,
                                            cfg.d_model), dt)
        if cfg.enc_layers:
            batch["enc_frames"] = _meta((B, min(S, ENC_LEN), cfg.d_model), dt)
        return batch

    # decode: one token over an S-long cache
    cache = init_cache(cfg, batch=1, max_len=1, enc_len=1,
                       device="meta")  # structure only
    spec_cache = {}
    Lx = cfg.n_layers
    if cfg.has_attn():
        kv_dt = torch.int8 if cfg.kv_quant == "int8" else dt
        spec_cache["k"] = _meta((Lx, B, S, cfg.n_kv_heads, cfg.head_dim),
                                kv_dt)
        spec_cache["v"] = _meta((Lx, B, S, cfg.n_kv_heads, cfg.head_dim),
                                kv_dt)
        if cfg.kv_quant == "int8":
            spec_cache["k_scale"] = _meta((Lx, B, S, cfg.n_kv_heads),
                                          torch.float32)
            spec_cache["v_scale"] = _meta((Lx, B, S, cfg.n_kv_heads),
                                          torch.float32)
    if cfg.has_ssm():
        spec_cache["ssm_state"] = _meta(
            (Lx, B, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim), dt)
        spec_cache["conv_state"] = _meta(
            (Lx, B, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state), dt)
    if cfg.enc_layers:
        spec_cache["memory"] = _meta((B, ENC_LEN, cfg.d_model), dt)
    spec_cache["length"] = _meta((B,), torch.int32)
    if set(spec_cache) != set(cache):
        raise AssertionError(f"cache keys {sorted(spec_cache)} against "
                             f"init_cache's {sorted(cache)}")
    return {"tokens": _meta((B, 1), torch.int32), "cache": spec_cache}
