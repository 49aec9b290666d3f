"""int8-quantized gradient all-reduce with error feedback: the JAX
package's ``distributed/compression.py`` on ``torch.distributed``.

At multi-pod scale the data-parallel gradient all-reduce crosses slow
links; quantizing to int8 with a per-tensor scale cuts the payload the
algorithm needs 4× (fp32) / 2× (bf16). Error feedback (Seide et al. '14;
Karimireddy et al. '19) keeps SGD convergence: the quantization residual is
carried into the next step.

The arithmetic is the JAX package's, leaf for leaf: ``x = g + r`` in
float32, ``q, scale = _quantize(x)``, an all-reduce (sum) of the
dequantized ``q * scale`` over the group, divided by the group's size; the
new residual is ``x - q * scale``. As in the JAX package, what crosses the
wire is the dequantized float32 tensor (the JAX ``psum`` of ``q * scale``):
the exchange is exact, and the int8 payload is what the scheme allows.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
import torch.distributed as dist

from repro_torch.training.optimizer import tree_leaves, tree_map


class FeedbackState(NamedTuple):
    residual: Any   # tree like grads (fp32)


def init_feedback(grads_struct) -> FeedbackState:
    """Zero fp32 residuals shaped like ``grads_struct``'s leaves, on each
    leaf's device."""
    return FeedbackState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_struct))


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 q, scale): ``scale = max(max|x|, 1e-12) / 127`` in ``x``'s
    dtype, ``q = clip(round_half_even(x / scale), -127, 127)``."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum_grads(grads, feedback: FeedbackState, group,
                          world: int):
    """Per-leaf int8 quantize + all-reduce + dequantize + error feedback.
    grads: this rank's gradient tree (already local averages); ``group``:
    the process group to reduce over (``None``: the default group), or a
    list of groups summed over in turn; ``world``: the ranks they span
    together. Returns (reduced fp32 grads, new feedback); the inputs are
    not modified."""
    groups = group if isinstance(group, list) else [group]

    def one(g, r):
        x = g.to(torch.float32) + r
        q, scale = _quantize(x)
        # the exact per-rank scaled values are summed (the JAX psum)
        acc = q.to(torch.int32).to(torch.float32) * scale
        for grp in groups:
            dist.all_reduce(acc, group=grp)
        reduced = acc / world
        new_r = x - q.to(torch.float32) * scale   # local residual
        return reduced, new_r

    outs = iter([one(g, r) for g, r in zip(tree_leaves(grads),
                                          tree_leaves(feedback.residual))])
    pairs = tree_map(lambda _: next(outs), grads)
    return (tree_map(lambda p: p[0], pairs),
            FeedbackState(residual=tree_map(lambda p: p[1], pairs)))


def make_compressed_allreduce(mesh, grads_struct, axes=("data",)):
    """``fn(grads, feedback) -> (reduced grads, feedback)``: the compressed
    all-reduce over the mesh dims ``axes`` (over several, the sum runs over
    each axis's group in turn). Each rank passes its own local gradient
    tree, with ``grads_struct``'s leaf shapes."""
    world = 1
    for a in axes:
        world *= mesh.size(mesh.mesh_dim_names.index(a))
    groups = [mesh.get_group(a) for a in axes]
    shapes = [tuple(g.shape) for g in tree_leaves(grads_struct)]

    def body(grads, fb: FeedbackState):
        got = [tuple(g.shape) for g in tree_leaves(grads)]
        if got != shapes:
            raise ValueError(f"gradient leaf shapes {got[:4]} ... against "
                             f"{shapes[:4]} ...")
        return compressed_psum_grads(grads, fb, groups, world)

    return body
