"""The PyTorch port's model on DTensors across a mesh against the JAX
package's model under the same mesh, and the multi-rank launcher.

* Four gloo ranks of this file, joined through a ``FileStore`` under the
  module's temporary directory (no TCP port), spawned once per module. On
  ``(2, 2)`` and ``(1, 4)`` ``("data", "model")`` meshes each rank lays a
  float32 smoke train state out per ``state_shardings`` (carried from the
  JAX ``init_train_state`` through ``train_state_from_numpy``) and takes 2
  ``train_step``s with the constraints live, for ``smollm-135m`` (4 heads,
  2 KV heads: ``(1, 4)`` splits the query heads and replicates the KV
  heads), ``deepseek-moe-16b`` (16 padded experts over ``model``) and
  ``hymba-1.5b`` (attention beside the SSM). The JAX ``train_step`` runs on
  an automatic-axis mesh of the same shape, in a subprocess with 4 forced
  host devices (one process per mesh shape), at the same time. Loss and
  gradient norm at each step (1e-4 relative) and every gathered state leaf
  at the end
  (``assert_states_close``'s rule: 1e-4 of the leaf's largest value) equal
  the JAX run's and the port's one-device run's.
* The same ranks then run the launcher at ``--data 2 --model 2 --device
  cpu --smoke`` (bf16, checkpoints every 2 steps), and resume its step-2
  checkpoint on ``(4, 1)``; this process resumes it on one device. The
  losses equal the one-device launcher's (1e-3 relative: the printed
  losses carry 4 decimals, and bf16 partial sums meet in another order on
  the mesh) and both resumes replay steps 3-4.
* The (2, 2) run's last checkpoint restored onto ``(1, 4)`` (``restore``
  with ``state_shardings``) and gathered equals its one-device restore,
  leaf for leaf.
* ``WORLD_SIZE`` other than ``data × model`` raises ``ValueError``, and so
  does a mesh with no ranks to run on.
"""
import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import smoke_config
from repro_torch.launch import train as launch
from repro_torch.training import checkpoint as C
from repro_torch.training import train_step as T
from repro_torch.training.data import SyntheticLM

HERE = os.path.abspath(__file__)
SRC = os.path.abspath(os.path.join(os.path.dirname(HERE), "..", "src"))
WORLD = 4
ARCHS = ("smollm-135m", "deepseek-moe-16b", "hymba-1.5b")
MESHES = ((2, 2), (1, 4))
SEQ, BATCH, STEPS = 64, 4, 2
LAUNCH = ["--arch", "smollm-135m", "--smoke", "--device", "cpu",
          "--steps", "4", "--seq-len", "32", "--global-batch", "8"]


def f32_config(arch):
    return dataclasses.replace(smoke_config(arch), dtype="float32")


def batches(cfg):
    src = SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=5)
    return [src.batch_at(s) for s in range(STEPS)]


def start_state(arch, start):
    """The port's train state from the JAX start leaves of ``arch``."""
    cfg = f32_config(arch)
    flat = {k.split("|", 2)[2]: v for k, v in start.items()
            if k.startswith(arch + "|")}
    return T.train_state_from_numpy(
        C._rebuild(T.abstract_train_state(cfg), flat), cfg, "cpu")


def mesh_name(shape):
    return f"{shape[0]}x{shape[1]}"


# ---------------------------------------------------------------------------
# the JAX side (subprocess, 4 forced host devices)


def _jax_main(start_path, out_path, shape):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro import compat
    from repro.configs.archs import smoke_config as jax_smoke_config
    from repro.launch.shardings import batch_shardings, state_shardings
    from repro.training import checkpoint as JC
    from repro.training import train_step as JT

    with np.load(start_path) as z:
        start = dict(z)
    out = {}
    for arch in ARCHS:
        jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
        like = jax.eval_shape(lambda: JT.init_train_state(
            jcfg, jax.random.key(0)))
        flat, treedef = jax.tree_util.tree_flatten_with_path(like)
        keys = ["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                         for p in path) for path, _ in flat]
        st0 = treedef.unflatten([start[f"{arch}|start|{k}"] for k in keys])
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        name = f"{arch}|{mesh_name(shape)}"
        with compat.set_mesh(mesh):
            st = jax.device_put(jax.tree.map(jnp.asarray, st0),
                                state_shardings(mesh, st0))
            step = JT.make_train_step(jcfg, JT.TrainConfig())
            for s, b in enumerate(batches(jcfg)):
                jb = jax.device_put({k: jnp.asarray(v) for k, v in b.items()},
                                    batch_shardings(mesh, b))
                st, m = step(st, jb)
                out[f"{name}|loss|{s}"] = np.float64(m["loss"])
                out[f"{name}|grad_norm|{s}"] = np.float64(m["grad_norm"])
            for k, v in JC._flat(st).items():
                out[f"{name}|end|{k}"] = np.asarray(v)
    np.savez(out_path, **out)
    return 0


# ---------------------------------------------------------------------------
# the port's ranks (4 processes of this file)


def _rank_main(rank, tmp):
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import sharding as MS

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, "store"), WORLD), rank=rank, world_size=WORLD)
    try:
        with np.load(os.path.join(tmp, "start.npz")) as z:
            start = dict(z)
        out = {}
        for arch in ARCHS:
            cfg = f32_config(arch)
            for shape in MESHES:
                mesh = make_local_mesh(data=shape[0], model=shape[1],
                                       device_type="cpu")
                name = f"{arch}|{mesh_name(shape)}"
                st = T.shard_train_state(start_state(arch, start), mesh)
                for s, b in enumerate(batches(cfg)):
                    batch = T.shard_batch({k: torch.from_numpy(v)
                                           for k, v in b.items()}, mesh)
                    with MS.set_mesh(mesh):
                        st, m = T.train_step(cfg, T.TrainConfig(), st, batch)
                    out[f"{name}|loss|{s}"] = float(m["loss"])
                    out[f"{name}|grad_norm|{s}"] = float(m["grad_norm"])
                for k, v in C._flat(MS.gather_tree(st)).items():
                    out[f"{name}|end|{k}"] = v.numpy()
        if rank == 0:
            np.savez(os.path.join(tmp, "port.npz"), **out)

        # the launcher on (2, 2), then its step-2 checkpoint on (4, 1)
        d22, d41 = os.path.join(tmp, "ck22"), os.path.join(tmp, "ck41")
        runs = {}
        for name, argv in (
                ("2x2", ["--data", "2", "--model", "2", "--ckpt-dir", d22,
                         "--ckpt-every", "2"]),
                ("4x1", ["--data", "4", "--model", "1", "--ckpt-dir", d41])):
            if name == "4x1":
                if rank == 0:
                    shutil.copytree(os.path.join(d22, "step_2"),
                                    os.path.join(d41, "step_2"))
                dist.barrier()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert launch.main(LAUNCH + argv) == 0
            runs[name] = buf.getvalue()
        if rank == 0:
            with open(os.path.join(tmp, "launch.json"), "w") as f:
                json.dump(runs, f)
        else:
            assert not any(runs.values()), runs   # rank 0 alone prints

        # the (2, 2) run's last checkpoint restored onto (1, 4)
        from repro_torch.launch.shardings import state_shardings
        mesh = make_local_mesh(data=1, model=4, device_type="cpu")
        like = T.abstract_train_state(smoke_config("smollm-135m"))
        st, _ = C.restore(d22, 4, like, "cpu",
                          shardings=state_shardings(mesh, like), mesh=mesh)
        assert all(isinstance(x, MS.DTensor) for x in C._flat(st).values())
        full = {k: v.float().numpy()
                for k, v in C._flat(MS.gather_tree(st)).items()}
        if rank == 0:
            np.savez(os.path.join(tmp, "restored_1x4.npz"), **full)
    finally:
        dist.destroy_process_group()
    return 0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start states from the JAX ``init_train_state``; the JAX mesh runs
    and the port's four ranks side by side; then (JAX results, port
    results, launcher output, the temporary directory)."""
    import jax
    from repro.configs.archs import smoke_config as jax_smoke_config
    from repro.training import checkpoint as JC
    from repro.training import train_step as JT

    tmp = str(tmp_path_factory.mktemp("mesh_train"))
    start = {}
    for i, arch in enumerate(ARCHS):
        jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
        st = JT.init_train_state(jcfg, jax.random.key(i))
        for k, v in JC._flat(st).items():
            start[f"{arch}|start|{k}"] = np.asarray(v)
    np.savez(os.path.join(tmp, "start.npz"), **start)

    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    jenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4")
    # one JAX process per mesh shape: their compiles run side by side
    jax_procs = [subprocess.Popen(
        [sys.executable, HERE, "--jax-side", os.path.join(tmp, "start.npz"),
         os.path.join(tmp, f"jax_{mesh_name(shape)}.npz"), mesh_name(shape)],
        env=jenv, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for shape in MESHES]
    ranks = [subprocess.Popen([sys.executable, HERE, str(r), tmp],
                              env=dict(env, RANK=str(r),
                                       WORLD_SIZE=str(WORLD)),
                              text=True, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE)
             for r in range(WORLD)]
    for p in jax_procs + ranks:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, (p.args, out[-2000:], err[-4000:])
    jax_out = {}
    for shape in MESHES:
        with np.load(os.path.join(tmp, f"jax_{mesh_name(shape)}.npz")) as z:
            jax_out.update(z)
    with np.load(os.path.join(tmp, "port.npz")) as z:
        port_out = dict(z)
    with open(os.path.join(tmp, "launch.json")) as f:
        launched = json.load(f)
    return start, jax_out, port_out, launched, tmp


def close_leaves(got, want, rtol=1e-4, what=""):
    """Every leaf within ``rtol`` of the leaf's largest value."""
    assert sorted(got) == sorted(want), what
    for k in want:
        w = np.asarray(want[k], np.float64)
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(np.asarray(got[k], np.float64) / scale,
                                   w / scale, rtol=0, atol=rtol,
                                   err_msg=f"{what} {k}")


def one_device(arch, start):
    """The port's one-device run: per-step (loss, grad norm), end leaves."""
    cfg = f32_config(arch)
    st = start_state(arch, start)
    metrics = []
    for b in batches(cfg):
        st, m = T.train_step(cfg, T.TrainConfig(), st,
                             {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, {k: v.numpy() for k, v in C._flat(st).items()}


@pytest.mark.parametrize("shape", MESHES, ids=mesh_name)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_train_step_matches_jax_and_one_device(runs, arch, shape):
    start, jax_out, port_out, _, _ = runs
    name = f"{arch}|{mesh_name(shape)}"
    ref_metrics, ref_leaves = one_device(arch, start)
    for s in range(STEPS):
        for i, key in enumerate(("loss", "grad_norm")):
            got = port_out[f"{name}|{key}|{s}"]
            assert got == pytest.approx(float(jax_out[f"{name}|{key}|{s}"]),
                                        rel=1e-4), (key, s, "jax")
            assert got == pytest.approx(ref_metrics[s][i], rel=1e-4), \
                (key, s, "one device")
    prefix = f"{name}|end|"
    got = {k[len(prefix):]: v for k, v in port_out.items()
           if k.startswith(prefix)}
    want = {k[len(prefix):]: v for k, v in jax_out.items()
            if k.startswith(prefix)}
    close_leaves(got, want, what=f"{name} against JAX")
    close_leaves(got, ref_leaves, what=f"{name} against one device")
    assert int(got[".opt/.step"]) == STEPS


def losses(text):
    return [json.loads(ln)["loss"] for ln in text.splitlines()
            if ln.startswith("{")]


def test_launcher_on_a_mesh_resumes_anywhere(runs, monkeypatch):
    _, _, _, launched, tmp = runs
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    ref = io.StringIO()
    with contextlib.redirect_stdout(ref):
        assert launch.main(LAUNCH + ["--data", "1", "--model", "1"]) == 0
    want = losses(ref.getvalue())
    assert len(want) == 4
    assert losses(launched["2x2"]) == pytest.approx(want, rel=1e-3)
    assert sorted(os.listdir(os.path.join(tmp, "ck22"))) == ["step_2",
                                                            "step_4"]
    # the (2, 2) checkpoint on (4, 1) and on one device replays steps 3-4
    d1 = os.path.join(tmp, "ck1")
    shutil.copytree(os.path.join(tmp, "ck22", "step_2"),
                    os.path.join(d1, "step_2"))
    one = io.StringIO()
    with contextlib.redirect_stdout(one):
        assert launch.main(LAUNCH + ["--ckpt-dir", d1]) == 0
    for text in (launched["4x1"], one.getvalue()):
        assert text.splitlines()[0] == "resumed from step 2 (data offset 2)"
        assert losses(text) == pytest.approx(want[2:], rel=1e-3)


def test_checkpoint_from_2x2_restores_onto_1x4_exactly(runs):
    """The elastic re-shard: the (2, 2) launcher's step-4 checkpoint laid
    out on a (1, 4) mesh and gathered equals it restored on one device,
    leaf for leaf."""
    tmp = runs[4]
    like = T.abstract_train_state(smoke_config("smollm-135m"))
    one, _ = C.restore(os.path.join(tmp, "ck22"), 4, like, "cpu")
    with np.load(os.path.join(tmp, "restored_1x4.npz")) as z:
        got = dict(z)
    want = {k: v.float().numpy() for k, v in C._flat(one).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_launcher_mesh_needs_its_world(monkeypatch):
    assert not dist.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        launch.main(LAUNCH + ["--data", "2", "--model", "2"])
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        launch.main(LAUNCH + ["--data", "4"])
    assert not dist.is_initialized()


if __name__ == "__main__":
    if sys.argv[1] == "--jax-side":
        sys.exit(_jax_main(sys.argv[2], sys.argv[3], tuple(
            int(n) for n in sys.argv[4].split("x"))))
    sys.exit(_rank_main(int(sys.argv[1]), sys.argv[2]))
