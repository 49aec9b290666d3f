"""The port's examples (``repro_torch/examples/``) against the JAX
package's ``examples/*.py``.

Each example's ``main(["--device", "cpu"])`` runs in this process and
keeps its own asserts; its last printed line is the JAX example's.
``quickstart``, ``resize_demo`` and ``elastic_churn`` print exactly what
the JAX examples print, line for line: the JAX example runs once per
test, in a subprocess on the CPU (started first, so that the two run side
by side). ``save_restore_reshard`` differs from the JAX example only in
where its 8 shards live (one device here, 8 fake host devices there),
``train_smollm`` takes ``--steps 10`` and a checkpoint directory of the
test's own.
"""
import importlib
import json
import os
import subprocess
import sys

import pytest

from repro_torch.examples import EXAMPLES

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))

# the last line each example prints, as the JAX example prints it
LAST_LINES = {
    "quickstart": "final content (raw handles): {7: 0, 8: 1, 9: 2}",
    "resize_demo": "done: wait-free growth from 2 buckets to depth 12",
    "elastic_churn": ("done: the directory grew, shrank, and grew again "
                      "— elastically"),
    "save_restore_reshard": "refilled: size= 1500 — local → image → 8-way "
                            "sharded, content-identical",
    "serve_paged": "paged serving OK",
    "serving_router": "serving router example OK",
}
SAME_AS_JAX = ("quickstart", "resize_demo", "elastic_churn")


def jax_example(name):
    """The JAX example as a subprocess on the CPU (not yet waited on)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen([sys.executable, os.path.join(
        ROOT, "examples", f"{name}.py")], env=env, cwd=ROOT, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def test_every_jax_example_has_a_port():
    jax_names = sorted(f[:-3] for f in os.listdir(os.path.join(
        ROOT, "examples")) if f.endswith(".py"))
    assert sorted(EXAMPLES) == jax_names


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu(name, capsys, tmp_path):
    proc = jax_example(name) if name in SAME_AS_JAX else None
    argv = ["--device", "cpu"]
    if name == "train_smollm":
        argv += ["--steps", "10", "--ckpt-dir", str(tmp_path / "ck")]
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    assert mod.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    if name == "train_smollm":
        steps = [json.loads(line) for line in lines if line.startswith("{")]
        assert [s["step"] for s in steps] == list(range(1, 11))
        assert all(s["loss"] == s["loss"] for s in steps)     # finite
        assert steps[-1]["loss"] < steps[0]["loss"]
        return
    assert lines[-1] == LAST_LINES[name]
    if proc is not None:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        assert lines == out.splitlines()
