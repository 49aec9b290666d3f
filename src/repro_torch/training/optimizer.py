"""AdamW with fp32 master weights over bf16 params, cosine schedule,
global-norm clipping: the JAX package's ``training/optimizer.py``.

Trees are the model's nested dicts of tensors. :func:`adamw_update` updates
the state in place — the params, master weights and moments passed in are
consumed, as the JAX step donates them — which keeps one copy of the
optimizer state on the card. The scalar arithmetic (the schedule,
``b ** step``, the clip scale) runs on float32 tensors, as JAX's does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    master: Any   # fp32 copy of params
    m: Any        # fp32 first moment
    v: Any        # fp32 second moment
    step: torch.Tensor


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (keys in sorted order, the
    JAX package's leaf order), keeping the nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts in the JAX package's order (sorted
    keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def init_opt_state(params) -> OptState:
    """fp32 master copies (never aliasing an fp32 parameter leaf) and zero
    moments on each leaf's device."""
    return OptState(
        master=tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                        params),
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params),
        v=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params),
        step=torch.zeros((), dtype=torch.int32,
                         device=tree_leaves(params)[0].device),
    )


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_ratio``; float32."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    decay_t = ((step - cfg.warmup_steps)
               / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * \
        (1 + torch.cos(math.pi * decay_t))
    return cfg.lr * torch.minimum(warm, cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: OptConfig, params, grads, opt: OptState):
    """One AdamW step on ``grads`` (any float dtype, summed in fp32).

    Returns (params, OptState, metrics): the same tensors as were passed
    in, updated in place — ``params`` take the new master weights in their
    own dtype."""
    step = opt.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1 - b1 ** step.to(torch.float32)
    c2 = 1 - b2 ** step.to(torch.float32)

    for g, m, v, master, p in zip(*(tree_leaves(t) for t in
                                    (grads, opt.m, opt.v, opt.master,
                                     params))):
        g = g.to(torch.float32) * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        mhat = m / c1
        vhat = v / c2
        master.sub_(lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                          + cfg.weight_decay * master))
        p.copy_(master)
    opt.step.copy_(step)
    metrics = {"lr": lr, "grad_norm": gnorm, "clip_scale": scale}
    return params, opt, metrics
