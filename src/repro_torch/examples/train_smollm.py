"""End-to-end training run: smollm-family reduced config, a few hundred
steps with checkpoint/resume. The same launcher runs the full config on
the card and on a mesh (see ``repro_torch/launch/train.py``).

The port of ``examples/train_smollm.py``: the JAX example's arguments
plus ``--device``; any launcher argument given here overrides them (the
last occurrence wins), e.g. ``--steps 10``. Checkpoints go to
``repro_torch_smollm_ckpt`` in the temporary directory unless
``--ckpt-dir`` says otherwise; a later run resumes from them.

Run: PYTHONPATH=src python -m repro_torch.examples.train_smollm \
[--device cpu] [launcher arguments]
"""
import argparse
import os
import tempfile

from repro_torch.launch.train import main as launch

ARGV = ["--arch", "smollm-135m", "--smoke",
        "--steps", "200", "--seq-len", "128", "--global-batch", "8",
        "--lr", "3e-3", "--ckpt-every", "100"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args, rest = ap.parse_known_args(argv)
    ckpt = os.path.join(tempfile.gettempdir(), "repro_torch_smollm_ckpt")
    return launch(ARGV + ["--ckpt-dir", ckpt, "--device", args.device]
                  + rest)


if __name__ == "__main__":
    raise SystemExit(main())
