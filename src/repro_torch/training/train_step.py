"""Training step: loss (CE + z-loss + MoE aux), gradient-accumulation
microbatching, AdamW update — the JAX package's ``training/train_step.py``
in eager PyTorch on one device.

``train_step`` consumes the state it is given (its tensors are updated in
place, as the JAX step donates its state) and returns it with the
metrics.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from repro_torch.models.model import (ModelConfig, _map_spec,
                                      abstract_params, forward, init_params,
                                      param_spec, params_from_numpy)
from repro_torch.training.optimizer import (OptConfig, OptState,
                                            adamw_update, init_opt_state,
                                            tree_leaves, tree_map)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    microbatches: int = 1          # gradient-accumulation steps
    z_loss: float = 1e-4
    moe_aux: float = 1e-2


class TrainState(NamedTuple):
    params: Any
    opt: OptState


def init_train_state(cfg: ModelConfig, gen: torch.Generator,
                     device=None) -> TrainState:
    """Random parameters from ``gen`` (``init_params``) on ``device``
    (default ``"cuda"``) and a fresh optimizer state."""
    params = init_params(cfg, gen, device)
    return TrainState(params=params, opt=init_opt_state(params))


def abstract_train_state(cfg: ModelConfig) -> TrainState:
    """The train state as meta tensors — ``abstract_params`` and the
    optimizer state mirroring them (fp32 master and moments, an int32
    step) — with nothing allocated and nothing drawn: the JAX package's
    ``jax.eval_shape(partial(init_train_state, cfg), key)``. A restore
    target (``checkpoint.restore`` with a device) and the dry-run's
    trace input."""
    params = abstract_params(cfg)
    return TrainState(params, init_opt_state(params))


def train_state_from_numpy(state, cfg: ModelConfig, device=None
                           ) -> TrainState:
    """The port's train state from a JAX ``TrainState`` (or any object with
    ``params`` and ``opt.{master,m,v,step}``) whose leaves convert to numpy:
    the parameters through ``params_from_numpy``, the fp32 master weights
    and moments and the step exactly."""
    params = params_from_numpy(state.params, cfg, device)
    dev = tree_leaves(params)[0].device

    def f32(tree):
        def conv(leaf, arr, path):
            arr = np.asarray(arr, np.float32)
            if tuple(arr.shape) != leaf.shape:
                raise ValueError(f"optimizer leaf {path} has shape "
                                 f"{arr.shape}, want {leaf.shape}")
            return torch.tensor(arr, device=dev)
        return _map_spec(conv, param_spec(cfg), tree)

    opt = state.opt
    return TrainState(params, OptState(
        master=f32(opt.master), m=f32(opt.m), v=f32(opt.v),
        step=torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32,
                          device=dev)))


def loss_fn(cfg: ModelConfig, tc: TrainConfig, params, batch):
    """(loss, parts): mean cross entropy over the real vocabulary (padded
    rows masked out of the softmax), the z-loss on the log-partition and
    the weighted MoE aux loss, all float32."""
    logits, aux = forward(cfg, params, batch)
    targets = batch["targets"].long()
    logits = logits.float()
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=logits.device) \
            >= cfg.vocab_size
        logits = torch.where(pad[None, None, :], -1e30, logits)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    ce = (lse - gold).mean()
    zl = tc.z_loss * torch.square(lse).mean()
    loss = ce + zl + tc.moe_aux * aux
    return loss, {"ce": ce, "z_loss": zl, "moe_aux": aux}


def _grads(cfg, tc, params, batch):
    """(loss, parts, gradient tree) of ``loss_fn`` at ``params``, through
    detached aliases of the leaves: the state's own tensors never require
    grad."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, parts = loss_fn(cfg, tc, live, batch)
    grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
    tree = tree_map(lambda _: next(grads), params)
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, tree


def train_step(cfg: ModelConfig, tc: TrainConfig, state: TrainState,
               batch: Dict[str, torch.Tensor]):
    """One optimizer step (with optional microbatch accumulation).

    batch tensors lead with the global batch dim; microbatches are its
    ``tc.microbatches`` equal slices, their gradients summed in fp32 and
    divided by the count after the sum, the loss likewise; ``parts`` are
    the last microbatch's. Returns (state, metrics)."""
    n_micro = tc.microbatches
    if n_micro == 1:
        loss, parts, grads = _grads(cfg, tc, state.params, batch)
    else:
        loss = torch.zeros((), dtype=torch.float32,
                           device=tree_leaves(state.params)[0].device)
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), state.params)
        for i in range(n_micro):
            mb = {k: v.reshape((n_micro, v.shape[0] // n_micro)
                               + tuple(v.shape[1:]))[i]
                  for k, v in batch.items()}
            loss_i, parts, g = _grads(cfg, tc, state.params, mb)
            loss = loss + loss_i
            for a, b in zip(tree_leaves(grads), tree_leaves(g)):
                a.add_(b.to(torch.float32))
            del g
        loss = loss / n_micro
        grads = tree_map(lambda g: g / n_micro, grads)

    params, opt, om = adamw_update(tc.opt, state.params, grads, state.opt)
    metrics = {"loss": loss, **parts, **om}
    return TrainState(params, opt), metrics


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """``step(state, batch)``: :func:`train_step` for this config (it
    consumes the state it is given)."""
    def step(state, batch):
        return train_step(cfg, tc, state, batch)
    return step
