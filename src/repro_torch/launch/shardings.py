"""Parameter/input sharding rules (path + shape → per-dimension mesh axes):
the JAX package's ``launch/shardings.py`` on a ``DeviceMesh``.

A spec is the counterpart of a ``PartitionSpec``: a tuple with one entry
per leading tensor dimension, each ``None`` (replicated), a mesh axis name
or a tuple of names (e.g. the batch over ``("pod", "data")``).
The spec type, :func:`placements` (a spec as DTensor placements on the
mesh) and the divisibility rule come from :mod:`repro_torch.models.sharding`,
which the model's constraints share.

Rules degrade per-dimension: a dim that does not divide its mesh axis is
replicated (smollm's 9 heads, hymba's 5 KV heads, granite's 24 heads),
while the rest of the tree still shards — recorded per arch in the
dry-run's records, so the cost of replication shows.

Trees are the port's nested NamedTuples and dicts; a leaf's path key is
the JAX package's (``tree_flatten_with_path``: a NamedTuple field ``f`` as
``.f``, a dict key as itself, joined by ``/``). Note that
``repro_torch.models.model.param_spec(cfg)`` is another function: the
parameter tree's leaf descriptions.
"""
from __future__ import annotations

from typing import Any

from repro_torch.models.sharding import (Spec, divides, fit_spec,
                                         mesh_sizes, placements)
from repro_torch.models.sharding import mesh_batch_axes as batch_axes
from repro_torch.training.checkpoint import _flat, _rebuild

__all__ = ["Spec", "batch_axes", "batch_shardings", "mesh_sizes",
           "param_spec", "placements", "state_shardings"]


def param_spec(mesh, path: str, shape, attn_dshard: bool = False) -> Spec:
    """Tensor-parallel layout for a parameter leaf, keyed by tree path.

    attn_dshard: when the head dim doesn't divide the model axis (smollm 9H,
    granite 24H, hymba 25H/5KV), shard attention projections on their
    d_model contraction/output dim instead of replicating — a small
    per-layer activation all-reduce for 16× fewer parameter reads at
    decode."""
    sizes = mesh_sizes(mesh)
    nd = len(shape)
    if "embed" in path:                       # [V, D]
        return fit_spec(sizes, shape, ("model", None))
    if "lm_head" in path:                     # [D, V]
        return fit_spec(sizes, shape, (None, "model"))
    if "frame_proj" in path:
        return fit_spec(sizes, shape, (None, "model"))
    last = path.rsplit("/", 1)[-1]
    if last in ("wq", "wk", "wv"):            # [L, D, H, hd]
        if attn_dshard and not divides(shape[2], sizes, "model"):
            return fit_spec(sizes, shape, (None, "model", None, None))
        return fit_spec(sizes, shape, (None, None, "model", None))
    if last in ("bq", "bk", "bv"):            # [L, H, hd]
        return fit_spec(sizes, shape, (None, "model", None))
    if last == "wo":                          # [L, H, hd, D]
        if attn_dshard and not divides(shape[1], sizes, "model"):
            return fit_spec(sizes, shape, (None, None, None, "model"))
        return fit_spec(sizes, shape, (None, "model", None, None))
    if "moe" in path:
        if last == "router":                  # [L, D, E]
            return fit_spec(sizes, shape, (None, None, "model"))
        if last in ("w_gate", "w_up") and nd == 4:   # [L, E, D, F]
            return fit_spec(sizes, shape, (None, "model", None, None))
        if last == "w_down" and nd == 4:      # [L, E, F, D]
            return fit_spec(sizes, shape, (None, "model", None, None))
    if last in ("w_gate", "w_up"):            # [L, D, F] (dense or shared)
        return fit_spec(sizes, shape, (None, None, "model"))
    if last == "w_down":                      # [L, F, D]
        return fit_spec(sizes, shape, (None, "model", None))
    if last == "in_proj":                     # [L, D, X]
        return fit_spec(sizes, shape, (None, None, "model"))
    if last == "out_proj":                    # [L, di, D]
        return fit_spec(sizes, shape, (None, "model", None))
    if last == "conv":                        # [L, w, ch]
        return fit_spec(sizes, shape, (None, None, "model"))
    return ()                                 # norms, scalars: replicated


def state_shardings(mesh, state_struct, attn_dshard: bool = False) -> Any:
    """Specs for a TrainState / params tree, in its structure (opt state
    mirrors its parameter leaf — identical shapes → identical rules)."""
    out = {}
    for key, leaf in _flat(state_struct).items():
        if leaf.ndim == 0 or "step" in key:
            out[key] = ()
        else:
            out[key] = param_spec(mesh, key, tuple(leaf.shape), attn_dshard)
    return _rebuild(state_struct, out)


def batch_shardings(mesh, batch_struct) -> Any:
    """Specs for an input batch / decode cache, in its structure."""
    sizes = mesh_sizes(mesh)
    ba = batch_axes(mesh)

    def leaf_spec(key: str, shape):
        if key.endswith("length"):
            return fit_spec(sizes, shape, (ba,))
        if key.startswith("cache/") or key in ("k", "v", "ssm_state",
                                               "conv_state", "memory",
                                               "k_scale", "v_scale"):
            name = key.rsplit("/", 1)[-1]
            if name in ("k", "v"):            # [L, B, S, KV, hd]
                if divides(shape[3], sizes, "model"):
                    return fit_spec(sizes, shape,
                                    (None, ba, None, "model", None))
                return fit_spec(sizes, shape, (None, ba, "model", None, None))
            if name in ("k_scale", "v_scale"):  # [L, B, S, KV]
                if divides(shape[3], sizes, "model"):
                    return fit_spec(sizes, shape, (None, ba, None, "model"))
                return fit_spec(sizes, shape, (None, ba, "model", None))
            if name == "ssm_state":           # [L, B, H, N, P]
                return fit_spec(sizes, shape, (None, ba, "model", None, None))
            if name == "conv_state":          # [L, B, w, ch]
                return fit_spec(sizes, shape, (None, ba, None, "model"))
            if name == "memory":              # [B, S, D]
                return fit_spec(sizes, shape, (ba, None, None))
        if key == "tokens" or key == "targets":
            return fit_spec(sizes, shape, (ba,) + (None,) * (len(shape) - 1))
        if key in ("prefix_embeds", "enc_frames"):
            return fit_spec(sizes, shape, (ba, None, None))
        return fit_spec(sizes, shape, (ba,) + (None,) * (len(shape) - 1))

    flat = _flat(batch_struct)
    return _rebuild(batch_struct, {key: leaf_spec(key, tuple(leaf.shape))
                                   for key, leaf in flat.items()})
