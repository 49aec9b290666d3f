"""Training launcher: config → mesh → train loop with checkpoint/restart
and straggler accounting — the JAX package's ``launch/train.py``.

    python -m repro_torch.launch.train --arch smollm-135m --smoke \\
        --device cpu --steps 20
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch smollm-135m --data 2 --model 2

Runs on the card unless ``--device`` names another. Fault-tolerance
contract, as in the JAX launcher:
  * step-atomic checkpoints every --ckpt-every steps (+ final);
  * on start, auto-resume from the newest checkpoint (params, opt state,
    data offset);
  * the data pipeline is stateless-addressable, so a restart replays no
    data and skips none;
  * per-step wall times are logged; steps slower than
    --straggler-factor × the median of the last 20 are flagged.

Each step prints one JSON line (``step``, ``loss``, ``lr``, ``grad_norm``,
``s``), followed by `` STRAGGLER`` when flagged. A resume restores into
``abstract_train_state`` (meta tensors) on ``--device``, so it holds one
train state; the random state is drawn only when there is nothing to
resume.

``--data D --model M`` with D·M > 1 trains on a ``(D, M)`` ``("data",
"model")`` mesh (``launch/mesh.make_local_mesh``), one rank per card:
NCCL ranks on ``cuda:LOCAL_RANK`` (``--device cuda``), gloo ranks for
``--device cpu``. The process group starts from ``--dist-init``, with the
rank and world size from ``RANK`` and ``WORLD_SIZE``: ``env://`` (the
default, as ``torchrun`` sets it up) or ``file:///path``, ranks joined
through a shared file with no TCP port (the CPU tests' rehearsal). A group
that is already started is used as it is. ``WORLD_SIZE`` must equal D·M
(``ValueError``). Every rank draws the same state (or restores the
newest checkpoint, whatever mesh wrote it) and keeps its shards of it
(``state_shardings``); every rank reads the same global batch and keeps
its rows (``batch_shardings``); the step runs on DTensors under the mesh.
Rank 0 prints the JSON lines and writes the checkpoints, which every rank
gathers. D = M = 1 is the one-device path.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.shardings import state_shardings
from repro_torch.core.table import resolve_device
from repro_torch.models import sharding as MS
from repro_torch.training import checkpoint as C
from repro_torch.training.data import Prefetcher, SyntheticLM
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_step import (TrainConfig,
                                             abstract_train_state,
                                             init_train_state,
                                             make_train_step, shard_batch,
                                             shard_train_state)


def start_mesh(data: int, model: int, device: str, init_method: str):
    """(mesh, this rank's device, whether the group was started here) for
    a ``(data, model)`` mesh over a world of exactly data × model ranks."""
    from repro_torch.launch.mesh import make_local_mesh
    n = data * model
    env_world = os.environ.get("WORLD_SIZE")
    if env_world is not None and int(env_world) != n:
        raise ValueError(f"--data {data} --model {model} needs {n} ranks; "
                         f"WORLD_SIZE is {env_world}")
    if not dist.is_initialized() and env_world is None:
        raise ValueError(f"--data {data} --model {model} needs {n} ranks: "
                         f"start them with torchrun (or set RANK and "
                         f"WORLD_SIZE)")
    kind = torch.device(device).type
    if kind == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(kind)
    started = False
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if kind == "cuda" else "gloo", init_method=init_method,
            rank=int(os.environ["RANK"]), world_size=n,
            device_id=dev if kind == "cuda" else None)
        started = True
    return make_local_mesh(model=model, data=data, device_type=kind), dev, \
        started


def main(argv=None, tables=None):
    """Run the launcher on ``argv``. ``tables`` ({name: Table}), when
    given, are saved alongside every checkpoint (``checkpoint.save``'s
    ``tables``). Returns 0."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--data", type=int, default=1, help="data-axis size")
    ap.add_argument("--model", type=int, default=1, help="model-axis size")
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    ap.add_argument("--dist-init", default="env://",
                    help="process-group init method on a mesh: env:// "
                    "(torchrun) or file:///path")
    args = ap.parse_args(argv)

    mesh, started = None, False
    if args.data * args.model > 1:
        mesh, dev, started = start_mesh(args.data, args.model, args.device,
                                        args.dist_init)
    else:
        dev = resolve_device(args.device)
    try:
        return _train(args, dev, mesh, tables)
    finally:
        if started:
            dist.destroy_process_group()


def _train(args, dev, mesh, tables):
    """The run on ``dev``, on ``mesh`` when one is given: the state drawn
    or restored, then :func:`_loop` under the mesh."""
    lead = mesh is None or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tc = TrainConfig(opt=OptConfig(lr=args.lr, warmup_steps=10,
                                   total_steps=args.steps),
                     microbatches=args.microbatches)

    # the extras stay float64 on the host: the forward rounds them to the
    # model dtype once, as the JAX launcher's bfloat16 extras round
    extras = {}
    if cfg.n_prefix_embeds:
        extras["prefix_embeds"] = ((cfg.n_prefix_embeds, cfg.d_model),
                                   "float64")
    if cfg.enc_layers:
        extras["enc_frames"] = ((args.seq_len, cfg.d_model), "float64")
    source = SyntheticLM(cfg.vocab_size, args.seq_len, args.global_batch,
                         seed=0, extras=extras)

    # a resume restores into the meta structure; only a fresh run draws
    start_step = 0
    last = C.latest_step(args.ckpt_dir) if args.ckpt_dir else None
    if last is not None:
        like = abstract_train_state(cfg)
        shard = {} if mesh is None else dict(
            shardings=state_shardings(mesh, like), mesh=mesh)
        state, extra = C.restore(args.ckpt_dir, last, like, dev, **shard)
        start_step = extra.get("data_step", last)
        say(f"resumed from step {last} (data offset {start_step})",
            flush=True)
    else:
        state = init_train_state(cfg, torch.Generator(dev).manual_seed(0),
                                 dev)
        if mesh is not None:
            state = shard_train_state(state, mesh)

    step_fn = make_train_step(cfg, tc)
    pf = Prefetcher(source, start_step=start_step, depth=2)
    with MS.set_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        _loop(args, dev, mesh, tables, state, step_fn, pf, start_step, say,
              lead)
    return 0


def _loop(args, dev, mesh, tables, state, step_fn, pf, start_step, say,
          lead):
    """Steps ``start_step`` .. ``--steps`` with the checkpoints; every
    rank saves (a mesh state is gathered), the lead rank writes."""
    times = []
    try:
        for step in range(start_step, args.steps):
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in pf.next().items()}
            if mesh is not None:
                batch = shard_batch(batch, mesh)
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            times.append(dt)
            med = statistics.median(times[-20:])
            flag = " STRAGGLER" if (len(times) > 5 and
                                    dt > args.straggler_factor * med) else ""
            say(json.dumps({"step": step + 1, "loss": round(loss, 4),
                            "lr": round(float(metrics["lr"]), 6),
                            "grad_norm": round(float(metrics["grad_norm"]),
                                               3),
                            "s": round(dt, 3)}) + flag, flush=True)
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                C.save(args.ckpt_dir, step + 1, state,
                       extra={"data_step": step + 1},
                       tables=tables if lead else None)
    finally:
        pf.close()
    if args.ckpt_dir:
        C.save(args.ckpt_dir, args.steps, state,
               extra={"data_step": args.steps},
               tables=tables if lead else None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
