"""Training step: loss (CE + z-loss + MoE aux), gradient-accumulation
microbatching, AdamW update — the JAX package's ``training/train_step.py``
in eager PyTorch on one device.

``train_step`` consumes the state it is given (its tensors are updated in
place, as the JAX step donates its state) and returns it with the
metrics.

On a mesh the same functions run on DTensors: :func:`shard_train_state`
lays a state out per ``launch/shardings.state_shardings`` (and
:func:`shard_batch` a batch per ``batch_shardings``), and ``train_step``
runs under the ambient mesh (``models/sharding.set_mesh``). Each gradient
is reduced to its parameter's layout (the data axes' all-reduce) before
the update.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from repro_torch.models import sharding as MS
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
        pad = MS.place(torch.arange(cfg.padded_vocab, device=logits.device)
                       >= cfg.vocab_size, logits, "model")
        logits = torch.where(pad[None, None, :], -1e30, logits)
    lse = torch.logsumexp(logits, dim=-1)
    gold = target_logits(logits, targets)
    ce = (lse - gold).mean()
    zl = tc.z_loss * torch.square(lse).mean()
    loss = ce + zl + tc.moe_aux * aux
    return loss, {"ce": ce, "z_loss": zl, "moe_aux": aux}


def target_logits(logits, targets):
    """``logits[b, s, targets[b, s]]``. On DTensors with the vocab split
    over ``model`` (the logits' constraint) each rank picks the targets in
    its own vocab block, zero elsewhere, and the partial sum over the model
    axis completes the pick."""
    pl = MS.where(logits.shape, "batch", None, "model")
    if pl is None or not MS.is_distributed(logits):
        return torch.gather(logits, -1, targets[..., None])[..., 0]
    split = MS.Shard(2) in pl
    pt = MS.where(targets.shape, "batch", None)

    def pick(lg, tg):
        V = lg.shape[-1]
        t = tg.long() - (MS.mesh_coordinate("model") * V if split else 0)
        hit = (t >= 0) & (t < V)
        g = torch.gather(lg, -1, t.clamp(0, V - 1)[..., None])[..., 0]
        return torch.where(hit, g, 0.0)

    out = [MS.Partial() if p == MS.Shard(2) else p for p in pl]
    return MS.local_call(pick, out, (pl, pt), logits, targets,
                         grad_placements=(pl, pt))


def _grads(cfg, tc, params, batch):
    """(loss, parts, gradient tree) of ``loss_fn`` at ``params``, through
    detached aliases of the leaves: the state's own tensors never require
    grad."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, parts = loss_fn(cfg, tc, live, batch)
    grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
    # on a mesh each gradient takes its parameter's layout: partial sums
    # over the batch axes are all-reduced here
    tree = tree_map(lambda p: _like(next(grads), p), params)
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, tree


def _like(g, p):
    if isinstance(p, MS.DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def shard_train_state(state: TrainState, mesh, attn_dshard: bool = False
                      ) -> TrainState:
    """``state`` (full tensors on this rank's device, or meta) laid out on
    ``mesh`` per ``launch/shardings.state_shardings``: each rank keeps its
    slices (``sharding.distribute_tree``; no collective). The state passed
    in is consumed."""
    from repro_torch.launch.shardings import state_shardings
    return MS.distribute_tree(state, state_shardings(mesh, state,
                                                     attn_dshard), mesh)


def shard_batch(batch: Dict[str, torch.Tensor], mesh):
    """A global batch laid out on ``mesh`` per
    ``launch/shardings.batch_shardings`` (its rows over the batch axes)."""
    from repro_torch.launch.shardings import batch_shardings
    return MS.distribute_tree(batch, batch_shardings(mesh, batch), mesh)


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
    # on a mesh the scalar metrics come back as full (plain) tensors
    metrics = {k: v.full_tensor() if isinstance(v, MS.DTensor) else v
               for k, v in {"loss": loss, **parts, **om}.items()}
    return TrainState(params, opt), metrics


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """``step(state, batch)``: :func:`train_step` for this config (it
    consumes the state it is given)."""
    def step(state, batch):
        return train_step(cfg, tc, state, batch)
    return step
