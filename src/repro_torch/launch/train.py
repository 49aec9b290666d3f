"""Training launcher: config → train loop with checkpoint/restart and
straggler accounting — the JAX package's ``launch/train.py`` on one device.

    python -m repro_torch.launch.train --arch smollm-135m --smoke \\
        --device cpu --steps 20

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
resume. A mesh (``--data`` or ``--model`` above 1) needs the multi-card
launcher, which is not ported yet.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.table import resolve_device
from repro_torch.training import checkpoint as C
from repro_torch.training.data import Prefetcher, SyntheticLM
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_step import (TrainConfig,
                                             abstract_train_state,
                                             init_train_state,
                                             make_train_step)


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
    args = ap.parse_args(argv)

    if args.data > 1 or args.model > 1:
        raise NotImplementedError(
            "--data/--model above 1 need the multi-card launcher "
            "(ROADMAP.md §1 item 3), not ported yet")
    dev = resolve_device(args.device)
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
        state, extra = C.restore(args.ckpt_dir, last,
                                 abstract_train_state(cfg), dev)
        start_step = extra.get("data_step", last)
        print(f"resumed from step {last} (data offset {start_step})",
              flush=True)
    else:
        state = init_train_state(cfg, torch.Generator(dev).manual_seed(0),
                                 dev)

    step_fn = make_train_step(cfg, tc)
    pf = Prefetcher(source, start_step=start_step, depth=2)
    times = []
    try:
        for step in range(start_step, args.steps):
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in pf.next().items()}
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            times.append(dt)
            med = statistics.median(times[-20:])
            flag = " STRAGGLER" if (len(times) > 5 and
                                    dt > args.straggler_factor * med) else ""
            print(json.dumps({"step": step + 1, "loss": round(loss, 4),
                              "lr": round(float(metrics["lr"]), 6),
                              "grad_norm": round(float(metrics["grad_norm"]),
                                                 3),
                              "s": round(dt, 3)}) + flag, flush=True)
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                C.save(args.ckpt_dir, step + 1, state,
                       extra={"data_step": step + 1}, tables=tables)
    finally:
        pf.close()
    if args.ckpt_dir:
        C.save(args.ckpt_dir, args.steps, state,
               extra={"data_step": args.steps}, tables=tables)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
