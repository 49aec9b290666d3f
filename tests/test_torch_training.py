"""The PyTorch port's training substrate against the JAX package's, on the
CPU: the counterpart of ``tests/test_training.py``.

A JAX ``TrainState`` crosses into the port through
``train_state_from_numpy``; one ``train_step`` (params, fp32 master
weights, both moments, the step counter and every metric) and the
2-microbatch step equal the JAX ``train_step`` in float32 (1e-4 relative
to each leaf's largest value); the microbatched step stays close to the
single-batch step (``test_arch_smoke.py``'s bound). ``SyntheticLM``
batches are bit-equal to the JAX class's. Checkpoints cross both ways: a
JAX-written checkpoint (tables alongside) restores in the port and the
port's in JAX, with the same leaf keys, the same manifest and equal
leaves. Then the JAX package's own checks on the port: a crashed save
leaves no partial step, restore-and-continue follows the same trajectory,
the loss drops when one batch is overfit, the launcher resumes and replays
the same losses (restoring into the meta structure, with no random state
drawn beside it), and ``lr_at``'s shape (its values equal JAX's). A
restore into meta tensors needs a device; ``abstract_train_state`` has
``init_train_state``'s (and the JAX ``jax.eval_shape``'s) keys, shapes and
dtypes for every smoke arch, as meta tensors.
"""
import dataclasses
import json
import os
import shutil
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import smoke_config as jax_smoke_config
from repro.table_api import Table as JaxTable
from repro.table_api import TableSpec as JaxSpec
from repro.training import checkpoint as JC
from repro.training import data as JD
from repro.training import optimizer as JO
from repro.training import train_step as JT
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.launch import train as launch
from repro_torch.table_api import Table, TableSpec
from repro_torch.training import checkpoint as C
from repro_torch.training.data import Prefetcher, SyntheticLM
from repro_torch.training.optimizer import OptConfig, lr_at, tree_leaves
from repro_torch.training import train_step as T

jax.config.update("jax_platform_name", "cpu")

ARCH = "smollm-135m"


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def state_leaves(st):
    """(name, array) for every leaf of a train state, JAX or port, in the
    checkpoint's key order."""
    flat = JC._flat(st) if not isinstance(st, T.TrainState) else C._flat(st)
    return {k: np.asarray(v.detach().float() if isinstance(v, torch.Tensor)
                          else np.asarray(v, np.float32) if
                          np.asarray(v).dtype.name == "bfloat16" else v)
            for k, v in flat.items()}


def assert_states_close(st, jst, rtol=1e-4):
    got, want = state_leaves(st), state_leaves(jst)
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k], np.float64)
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(np.asarray(got[k], np.float64) / scale,
                                   w / scale, rtol=0, atol=rtol, err_msg=k)


@pytest.fixture(scope="module")
def jax_start():
    """A float32 smoke state, a batch and the JAX step's outputs at 1 and
    2 microbatches (each JAX step compiled once)."""
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), dtype="float32")
    batch = JD.SyntheticLM(jcfg.vocab_size, 64, 4, seed=3).batch_at(0)
    start = np_tree(JT.init_train_state(jcfg, jax.random.key(3)))
    out = {}
    for n in (1, 2):
        step = JT.make_train_step(jcfg, JT.TrainConfig(microbatches=n))
        st, m = step(jax.tree.map(jnp.asarray, start),
                     {k: jnp.asarray(v) for k, v in batch.items()})
        out[n] = (np_tree(st), {k: float(v) for k, v in m.items()})
    return start, batch, out


@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches_jax(jax_start, micro):
    start, batch, out = jax_start
    cfg = dataclasses.replace(smoke_config(ARCH), dtype="float32")
    st = T.train_state_from_numpy(start, cfg, "cpu")
    assert_states_close(st, start, rtol=0)   # carried exactly
    st, m = T.train_step(cfg, T.TrainConfig(microbatches=micro), st,
                         port_batch(batch))
    jst, jm = out[micro]
    assert int(st.opt.step) == int(jst.opt.step) == 1
    assert_states_close(st, jst)
    assert sorted(m) == sorted(jm)
    for k, v in jm.items():
        assert float(m[k]) == pytest.approx(v, rel=1e-5, abs=1e-7), k


def test_microbatched_step_close_to_single(jax_start):
    """``test_arch_smoke.py``'s microbatch equivalence on the port (the
    same bounds), in the model's bf16."""
    cfg = smoke_config(ARCH)
    _, batch, _ = jax_start
    runs = []
    for n in (1, 2):
        st = T.init_train_state(cfg, torch.Generator().manual_seed(3), "cpu")
        st, m = T.train_step(cfg, T.TrainConfig(microbatches=n), st,
                             port_batch(batch))
        runs.append((st, float(m["loss"])))
    (s1, l1), (s2, l2) = runs
    assert l1 == pytest.approx(l2, rel=2e-2)
    a, b = tree_leaves(s1.params)[0], tree_leaves(s2.params)[0]
    np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                               atol=1e-2)


def test_synthetic_lm_matches_jax():
    extras = {"prefix_embeds": ((3, 8), "float32"),
              "enc_frames": ((16, 8), "float64")}
    ours = SyntheticLM(1000, seq_len=16, global_batch=4, seed=9,
                       extras=extras)
    theirs = JD.SyntheticLM(1000, seq_len=16, global_batch=4, seed=9,
                            extras=extras)
    for step in (0, 1, 5, 1234):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    b1 = ours.batch_at(5)
    assert b1["tokens"].max() < 1000
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["targets"][:, :-1])
    pf = Prefetcher(ours, start_step=2, depth=2)
    try:
        for step in (2, 3, 4):
            np.testing.assert_array_equal(pf.next()["tokens"],
                                          theirs.batch_at(step)["tokens"])
    finally:
        pf.close()


def test_checkpoints_cross_packages(tmp_path):
    """A JAX-written checkpoint (bf16 params, fp32 optimizer state, a table
    alongside) restores in the port, and the port's in JAX: the same leaf
    keys and manifest, equal leaves, and the tables revive under another
    geometry (the port's into a sharded spec too)."""
    jcfg, cfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    jst = JT.init_train_state(jcfg, jax.random.key(4))
    keys = np.arange(1, 200, dtype=np.int32)
    jt, _ = JaxTable.create(JaxSpec(dmax=9, pool_size=256, n_lanes=16)
                            ).insert(keys, keys * 2)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JC.save(jdir, 3, jst, extra={"data_step": 3}, tables={"kv": jt})

    like = T.init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    st, extra = C.restore(jdir, 3, like, "cpu")
    assert extra == {"data_step": 3} and C.latest_step(jdir) == 3
    assert st.params["embed"].dtype == torch.bfloat16
    assert_states_close(st, jst, rtol=0)
    assert C.table_names(jdir, 3) == ["kv"]
    t2 = C.restore_table(jdir, 3, "kv", TableSpec(dmax=11, pool_size=512,
                                                  n_lanes=16), "cpu")
    found, vals = t2.lookup(keys)
    assert found.all() and (vals.numpy() == keys * 2).all()

    pt, _ = Table.create(TableSpec(dmax=9, pool_size=256, n_lanes=16),
                         "cpu").insert(keys, keys * 3)
    C.save(pdir, 5, st, extra={"data_step": 5}, tables={"kv": pt})
    with open(os.path.join(jdir, "step_3", "manifest.json")) as f:
        jman = json.load(f)
    with open(os.path.join(pdir, "step_5", "manifest.json")) as f:
        pman = json.load(f)
    assert pman["keys"] == jman["keys"] and ".opt/.step" in pman["keys"]
    assert sorted(os.listdir(os.path.join(pdir, "step_5"))) == sorted(
        os.listdir(os.path.join(jdir, "step_3")))
    back, jextra = JC.restore(pdir, 5, jax.eval_shape(lambda: jst))
    assert jextra == {"data_step": 5}
    assert_states_close(st, back, rtol=0)
    assert back.params["embed"].dtype == jnp.bfloat16
    jt2 = JC.restore_table(pdir, 5, "kv", JaxSpec(dmax=10, pool_size=512,
                                                  n_lanes=16))
    jf, jv = jt2.lookup(keys)
    assert np.asarray(jf).all() and (np.asarray(jv) == keys * 3).all()
    sharded = C.restore_table(pdir, 5, "kv", TableSpec(
        dmax=8, pool_size=256, n_lanes=16, placement="sharded",
        shard_bits=1), "cpu")
    found, vals = sharded.lookup(keys)
    assert found.all() and (vals.numpy() == keys * 3).all()
    with pytest.raises(FileNotFoundError, match="kv"):
        C.restore_table(pdir, 5, "nope", TableSpec(dmax=9), "cpu")
    C.save(pdir, 6, st)
    assert C.table_names(pdir, 6) == []
    with pytest.raises(ValueError, match="mismatch"):
        C.restore(pdir, 6, {"other": like.params["embed"]})


def test_checkpoint_crash_leaves_no_partial(tmp_path):
    """A .tmp dir (simulated mid-crash) is invisible to latest_step."""
    st = T.init_train_state(smoke_config(ARCH),
                            torch.Generator().manual_seed(2), "cpu")
    ck = str(tmp_path / "ck")
    C.save(ck, 1, st)
    os.makedirs(os.path.join(ck, "step_2.tmp"))
    assert C.latest_step(ck) == 1 and JC.latest_step(ck) == 1
    assert C.latest_step(str(tmp_path / "none")) is None


def test_checkpoint_roundtrip_and_resume(tmp_path):
    """Restore into a fresh structure and continue: the trajectories are
    the same."""
    cfg = smoke_config(ARCH)
    st = T.init_train_state(cfg, torch.Generator().manual_seed(1), "cpu")
    tc = T.TrainConfig()
    src = SyntheticLM(cfg.vocab_size, seq_len=32, global_batch=2, seed=1)
    for i in range(3):
        st, _ = T.train_step(cfg, tc, st, port_batch(src.batch_at(i)))
    ck = str(tmp_path / "ck")
    C.save(ck, 3, st, extra={"data_step": 3})
    like = T.init_train_state(cfg, torch.Generator().manual_seed(9), "cpu")
    restored, extra = C.restore(ck, 3, like)
    assert extra["data_step"] == 3
    for i in range(3, 5):
        st, ma = T.train_step(cfg, tc, st, port_batch(src.batch_at(i)))
        restored, mb = T.train_step(cfg, tc, restored,
                                    port_batch(src.batch_at(i)))
        assert float(ma["loss"]) == float(mb["loss"])


def test_loss_decreases_over_steps():
    cfg = smoke_config(ARCH)
    st = T.init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    tc = T.TrainConfig(opt=OptConfig(lr=3e-3, warmup_steps=2))
    batch0 = port_batch(SyntheticLM(cfg.vocab_size, seq_len=64,
                                    global_batch=4, seed=7).batch_at(0))
    losses = []
    for _ in range(8):
        st, m = T.train_step(cfg, tc, st, batch0)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.05, losses


def _run(capsys, *args):
    assert launch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--seq-len", "32", "--global-batch", "4",
                        *args]) == 0
    lines = capsys.readouterr().out.splitlines()
    return lines, [json.loads(ln.split(" STRAGGLER")[0]) for ln in lines
                   if ln.startswith("{")]


def test_launcher_resumes_and_replays(tmp_path, capsys, monkeypatch):
    """The launcher's JSON lines, its checkpoints every --ckpt-every steps,
    and auto-resume: a fresh run on a copy of the checkpoint directory that
    holds only step 3 replays steps 4-6 with the same losses, restoring
    into the meta structure (``abstract_train_state``) without drawing a
    random state beside it."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _, full = _run(capsys, "--steps", "6", "--ckpt-dir", a,
                   "--ckpt-every", "3")
    assert [r["step"] for r in full] == [1, 2, 3, 4, 5, 6]
    assert all(set(r) == {"step", "loss", "lr", "grad_norm", "s"}
               for r in full)
    assert sorted(os.listdir(a)) == ["step_3", "step_6"]
    os.makedirs(b)
    shutil.copytree(os.path.join(a, "step_3"), os.path.join(b, "step_3"))
    drawn, targets = [], []
    restore = C.restore

    def spy_restore(ckpt_dir, step, like, device=None):
        targets.append(([leaf.is_meta for leaf in C._flat(like).values()],
                        device))
        return restore(ckpt_dir, step, like, device)

    monkeypatch.setattr(launch, "init_train_state",
                        lambda *a, **k: drawn.append(a))
    monkeypatch.setattr(C, "restore", spy_restore)
    lines, resumed = _run(capsys, "--steps", "6", "--ckpt-dir", b,
                          "--ckpt-every", "3")
    assert lines[0] == "resumed from step 3 (data offset 3)"
    assert [r["step"] for r in resumed] == [4, 5, 6]
    for x, y in zip(full[3:], resumed):
        assert (x["loss"], x["lr"], x["grad_norm"]) == (
            y["loss"], y["lr"], y["grad_norm"])
    assert drawn == []
    assert len(targets) == 1 and all(targets[0][0])
    assert torch.device(targets[0][1]) == torch.device("cpu")


def test_restore_into_meta_needs_a_device(tmp_path):
    """A meta ``like`` restores only onto a named device: with none,
    ``restore`` raises instead of returning meta tensors (which would drop
    the checkpoint's data)."""
    st = T.init_train_state(smoke_config(ARCH),
                            torch.Generator().manual_seed(4), "cpu")
    ck = str(tmp_path / "ck")
    C.save(ck, 2, st, extra={"data_step": 2})
    meta_copy = C._rebuild(st, {k: torch.empty_like(v, device="meta")
                                for k, v in C._flat(st).items()})
    with pytest.raises(ValueError, match="meta"):
        C.restore(ck, 2, meta_copy)
    like = T.abstract_train_state(smoke_config(ARCH))
    with pytest.raises(ValueError, match="meta"):
        C.restore(ck, 2, like)
    got, extra = C.restore(ck, 2, like, "cpu")
    assert extra == {"data_step": 2}
    want = C._flat(st)
    for k, leaf in C._flat(got).items():
        assert leaf.device.type == "cpu" and leaf.dtype == want[k].dtype, k
        assert torch.equal(leaf, want[k]), k


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_abstract_train_state_matches_init(arch):
    """``abstract_train_state`` has ``init_train_state``'s keys, shapes and
    dtypes (and the JAX ``jax.eval_shape`` of its ``init_train_state``'s),
    every leaf a meta tensor: nothing allocated, nothing drawn."""
    cfg = smoke_config(arch)
    gen = torch.Generator().manual_seed(0)
    before = gen.get_state()
    abstract = C._flat(T.abstract_train_state(cfg))
    assert torch.equal(gen.get_state(), before)
    assert all(leaf.is_meta for leaf in abstract.values())
    real = C._flat(T.init_train_state(cfg, gen, "cpu"))
    assert sorted(abstract) == sorted(real)
    for k, leaf in real.items():
        assert (tuple(abstract[k].shape), abstract[k].dtype) == (
            tuple(leaf.shape), leaf.dtype), k
    jst = jax.eval_shape(partial(JT.init_train_state, jax_smoke_config(arch)),
                         jax.random.key(0))
    jflat = JC._flat(jst)
    assert sorted(jflat) == sorted(abstract)
    for k, s in jflat.items():
        assert tuple(s.shape) == tuple(abstract[k].shape), k
        assert str(s.dtype) == str(abstract[k].dtype).replace("torch.", ""), k


def test_launcher_refuses_a_mesh(monkeypatch):
    """A mesh (``--data`` or ``--model`` above 1) with no ranks to run on
    is refused: ``ValueError`` before any process group starts (the mesh
    itself runs in ``tests/test_torch_mesh_train.py``)."""
    import torch.distributed as dist
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for flag in ("--data", "--model"):
        with pytest.raises(ValueError, match="needs 2 ranks"):
            launch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                         flag, "2"])
    assert not dist.is_initialized()


def test_lr_schedule_shape():
    oc = OptConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                   min_lr_ratio=0.1)
    joc = JO.OptConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                       min_lr_ratio=0.1)

    def lr(s):
        return float(lr_at(oc, torch.tensor(s, dtype=torch.int32)))

    assert lr(0) == 0.0
    assert abs(lr(10) - 1e-3) < 1e-9
    assert lr(100) <= 1e-4 + 1e-9
    assert lr(55) < 1e-3
    for s in (0, 1, 5, 10, 11, 37, 55, 99, 100, 150):
        assert lr(s) == pytest.approx(float(JO.lr_at(joc, jnp.int32(s))),
                                      rel=1e-6, abs=1e-12), s
