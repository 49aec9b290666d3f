"""The PyTorch port's dry-run and its analytic cost model against the JAX
package's.

* ``launch/costmodel.py`` equals ``benchmarks/costmodel.py`` (the JAX
  dry-run's cost model) to 1e-12 relative for all 40 cells on one device
  and on both production meshes, ``attn_dshard`` both ways, and with the
  decode variants' configs;
* ``model_flops_per_step`` equals the JAX dry-run's for every cell and
  variant, the JAX side computed in a subprocess (importing the JAX
  dry-run rewrites ``XLA_FLAGS``);
* a smoke-config ``--all --both-meshes`` sweep (the four shapes cut to a
  few hundred tokens, names and modes kept) on meta tensors writes one
  record per cell and mesh: the 8 ``long_500k`` full-attention cells
  skipped with the JAX reason, everything else ``ok``; with ``--variant
  paged`` the decode cells fail for the stated cause (the WF-Ext table
  has no meta plan), the rest stay ``ok``; every other variant's decode
  cells are ``ok``; every ``ok`` mesh record carries the traced step's
  collective bytes, ``collective_s`` and local FLOPs;
* an ``h100x1`` record's traced FLOPs equal ``FlopCounterMode`` over one
  real ``train_step`` on the CPU at the same shape, and its argument bytes
  the real state's and batch's; a mesh record's per-device argument bytes
  equal each leaf's elements over its spec's axis sizes;
* the mesh trace's counter (``costmodel.MeshTrace``) equals a hand count
  on a column- then row-parallel matmul pair (FLOPs, bytes by kind, axis
  and link, ``collective_s``); a smoke ``train_4k`` record on a fake
  (4, 4) world has collective bytes, a data-axis gradient all-reduce at
  least the gradients' bytes, and 16 ranks' local FLOPs at least the
  one-card trace's, with the JAX dry-run's per-kind bytes for the cell
  beside them in the messages.
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import archs as JA
from repro_torch.configs import archs as A
from repro_torch.configs import shapes as S
from repro_torch.configs.shapes import Shape
from repro_torch.launch import costmodel as CM
from repro_torch.launch import dryrun as D
from repro_torch.launch.shardings import mesh_sizes
from repro_torch.training import train_step as T
from repro_torch.training.checkpoint import _flat
from repro_torch.training.data import SyntheticLM

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
MESH_ARGS = {"h100x1": (1, 1, 1), "pod16x16": (256, 16, 16),
             "pod2x16x16": (512, 16, 32)}
# the four shapes cut to a smoke size, names and modes kept
SMOKE_SHAPES = {"train_4k": Shape("train_4k", 64, 4, "train"),
                "prefill_32k": Shape("prefill_32k", 128, 2, "prefill"),
                "decode_32k": Shape("decode_32k", 128, 4, "decode"),
                "long_500k": Shape("long_500k", 256, 1, "decode")}


def _bench_costmodel():
    spec = importlib.util.spec_from_file_location(
        "bench_costmodel", os.path.join(ROOT, "benchmarks", "costmodel.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


@pytest.mark.parametrize("arch", sorted(A.ARCHS))
def test_costmodel_matches_benchmarks(arch):
    B = _bench_costmodel()
    for variant in ("", "kvq8", "winslice+kvq8+bf16psum"):
        cfg, _ = D.variant_config(A.get_config(arch), variant)
        jcfg = dataclasses.replace(JA.get_config(arch), **{
            k: v for k, v in D.VARIANTS.get(variant, {}).items()
            if not k.startswith("_")})
        assert CM.param_count(cfg) == B.param_count(jcfg)
        for shape in S.SHAPES.values():
            for n, model, batch in MESH_ARGS.values():
                for dshard in (False, True):
                    ours = CM.analytic_costs(cfg, shape, n, model, batch,
                                             attn_dshard=dshard)
                    want = B.analytic_costs(jcfg, shape, n, model, batch,
                                            attn_dshard=dshard)
                    assert set(ours) == set(want)
                    for k in want:
                        assert _rel(ours[k], want[k]) <= 1e-12, (shape, k)
                    assert _rel(CM.sharded_param_bytes(cfg, model, 2, dshard),
                                B.sharded_param_bytes(jcfg, model, 2,
                                                      dshard)) <= 1e-12


_JAX_FLOPS = """
import json, dataclasses, sys
from repro.launch import dryrun as D
from repro.configs import ARCHS, SHAPES, get_config
out = {}
for arch in ARCHS:
    for v in [""] + sorted(D.VARIANTS):
        over = {k: x for k, x in D.VARIANTS.get(v, {}).items()
                if not k.startswith("_")}
        cfg = dataclasses.replace(get_config(arch), **over)
        for name, shape in SHAPES.items():
            out[f"{arch}|{v}|{name}"] = D.model_flops_per_step(cfg, shape)
json.dump(out, sys.stdout)
"""


def test_model_flops_match_jax():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_FLOPS], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout)
    assert len(want) == 10 * (1 + len(D.VARIANTS)) * 4
    for key, flops in want.items():
        arch, variant, name = key.split("|")
        cfg, _ = D.variant_config(A.get_config(arch), variant)
        assert D.model_flops_per_step(cfg, S.SHAPES[name]) == flops, key


@pytest.fixture
def smoke(monkeypatch):
    monkeypatch.setattr(D, "get_config", A.smoke_config)
    for name, shape in SMOKE_SHAPES.items():
        monkeypatch.setitem(S.SHAPES, name, shape)
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def _records(out):
    return {f[:-5]: json.load(open(os.path.join(out, f)))
            for f in os.listdir(out)}


def test_smoke_sweep_all_meshes(smoke, tmp_path):
    out = str(tmp_path / "dry")
    assert D.main(["--all", "--both-meshes", "--out", out]) == 0
    recs = _records(out)
    assert len(recs) == 40 * 3
    for arch, shape, ok, why in S.cells():
        for mesh in D.MESHES:
            r = recs[f"{arch}__{shape}__{mesh}"]
            assert (r["arch"], r["shape"], r["mesh"]) == (arch, shape, mesh)
            if not ok:
                assert (r["status"], r["reason"]) == ("skipped", why)
                continue
            assert r["status"] == "ok", r.get("error")
            assert r["n_chips"] == MESH_ARGS[mesh][0]
            assert r["model_flops"] == D.model_flops_per_step(
                A.smoke_config(arch), SMOKE_SHAPES[shape])
            assert r["memory"]["fits_80gb"]
            if mesh == "h100x1":
                assert r["traced_flops"] > 0
            else:
                coll = r["collective_bytes_per_device"]
                assert coll["total"] == sum(
                    v for k, v in coll.items() if k != "total") > 0
                assert r["roofline"]["collective_s"] == r["collective_s"] > 0
                assert r["traced_flops_per_device"] > 0
                assert r["trace_s"] > 0
    assert sum(r["status"] == "skipped" for r in recs.values()) == 8 * 3


def test_smoke_sweep_variants(smoke, tmp_path):
    out = str(tmp_path / "paged")
    assert D.main(["--all", "--variant", "paged", "--out", out]) == 1
    recs = _records(out)
    assert len(recs) == 40 * 2
    for arch, shape, ok, _ in S.cells():
        for mesh in ("h100x1", "pod16x16"):
            r = recs[f"{arch}__{shape}__{mesh}__paged"]
            if not ok:
                assert r["status"] == "skipped"
            elif SMOKE_SHAPES[shape].mode == "decode":
                assert r["status"] == "failed"
                assert r["error"].startswith("NotImplementedError: "
                                             + D.PAGED_CAUSE)
            else:
                assert r["status"] == "ok", r.get("error")
    for variant in sorted(set(D.VARIANTS) - {"paged"}):
        for arch in ("hymba-1.5b", "smollm-135m"):
            assert D.main(["--arch", arch, "--shape", "decode_32k",
                           "--variant", variant, "--out", out]) == 0


def test_one_card_record_matches_a_real_step():
    cfg = A.smoke_config("smollm-135m")
    shape = Shape("train_smoke", 64, 2, "train")
    rec = D.one_card_record(cfg, shape)
    st = T.init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(
        cfg.vocab_size, 64, 2, seed=0).batch_at(0).items()}
    real = sum(x.numel() * x.element_size()
               for tree in (st, batch) for x in _flat(tree).values())
    assert rec["memory"]["argument_bytes_per_device"] == real
    counter = FlopCounterMode(display=False)
    with counter:
        T.train_step(cfg, T.TrainConfig(), st, batch)
    assert rec["traced_flops"] == counter.get_total_flops() > 0


def test_mesh_record_bytes_per_device():
    cfg = A.get_config("smollm-135m")
    shape = S.SHAPES["decode_32k"]
    D.fake_world(256)
    try:
        mesh = D.make_production_mesh(device_type="cpu")
        rec = D.mesh_record(cfg, shape, mesh)
        sizes = mesh_sizes(mesh)
        _, args = D.step_inputs(cfg, shape)
        specs = (D.state_shardings(mesh, args[0]),
                 D.batch_shardings(mesh, args[1]),
                 D.batch_shardings(mesh, {"tokens": args[2]})["tokens"])
        want = 0
        for tree, spec in zip(args, specs):
            flat_spec = _flat(spec)
            for k, leaf in _flat(tree).items():
                div = 1
                for ax in flat_spec[k]:
                    for a in (ax if isinstance(ax, tuple) else (ax,)):
                        div *= sizes.get(a, 1) if a else 1
                want += leaf.numel() // div * leaf.element_size()
        assert rec["memory"]["argument_bytes_per_device"] == want
        assert "layers/attn/wq" in rec["replicated_params"]   # 9 heads
        assert "embed" not in rec["replicated_params"]
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the mesh trace: collectives and FLOPs per device


@pytest.fixture
def world16():
    assert not dist.is_initialized()
    D.fake_world(16)
    try:
        yield init_device_mesh("cpu", (4, 4), mesh_dim_names=("data",
                                                               "model"))
    finally:
        dist.destroy_process_group()


def test_collective_counter_hand_count(world16):
    """A column- then row-parallel matmul pair on a (4, 4) world: rank 0
    runs both local matmuls, one all-reduce of its [B/4, D] partial output
    over ``model`` (ranks 0-3: one node, NVLink) and, to gather the rows,
    one all-gather over ``data`` (ranks 0, 4, 8, 12: two nodes, the NIC)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = world16
    B, Dm, F = 64, 128, 512

    def put(shape, pl):
        return DTensor.from_local(torch.empty(shape, device="meta"), mesh,
                                  pl, run_check=False)

    x = put((B // 4, Dm), [Shard(0), Replicate()])
    w1 = put((Dm, F // 4), [Replicate(), Shard(1)])
    w2 = put((F // 4, Dm), [Replicate(), Shard(0)])
    with CM.MeshTrace(mesh) as trace:
        y = ((x @ w1) @ w2).redistribute(mesh, [Shard(0), Replicate()])
        y.redistribute(mesh, [Replicate(), Replicate()])
    reduced, gathered = B // 4 * Dm * 4, B * Dm * 4
    assert trace.flops == 2 * (B // 4) * Dm * (F // 4) * 2
    assert dict(trace.bytes_by_kind) == {"all-reduce": reduced,
                                         "all-gather": gathered}
    assert {a: dict(k) for a, k in trace.bytes_by_axis.items()} == {
        "model": {"all-reduce": reduced}, "data": {"all-gather": gathered}}
    assert dict(trace.bytes_by_link) == {"nvlink": reduced, "nic": gathered}
    assert trace.collective_s == pytest.approx(
        reduced / CM.NVLINK_BYTES_S + gathered / CM.NIC_BYTES_S, rel=1e-12)
    assert dict(trace.calls) == {"all-reduce": 1, "all-gather": 1}


_JAX_RECORD = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, Mesh
from repro import compat
from repro.configs.archs import smoke_config
from repro.launch.shardings import batch_shardings, state_shardings
from repro.training.train_step import TrainConfig, init_train_state, train_step
from benchmarks.costmodel import collective_bytes_scaled
arch, B, S = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
cfg = smoke_config(arch)
mesh = Mesh(np.array(jax.devices()[:16]).reshape(4, 4), ("data", "model"),
            axis_types=(AxisType.Auto,) * 2)
specs = {k: jax.ShapeDtypeStruct((B, S), jnp.int32)
         for k in ("tokens", "targets")}
with compat.set_mesh(mesh):
    st = jax.eval_shape(lambda k: init_train_state(cfg, k), jax.random.key(0))
    step = jax.jit(lambda s, b: train_step(cfg, TrainConfig(), s, b),
                   in_shardings=(state_shardings(mesh, st),
                                 batch_shardings(mesh, specs)))
    hlo = step.lower(st, specs).compile().as_text()
trips = (cfg.n_layers, cfg.enc_layers, max(S // cfg.attn_chunk, 1),
         max(S // max(cfg.ssm_chunk, 1), 1))
json.dump(collective_bytes_scaled(hlo, plausible_trips=trips)[0], sys.stdout)
"""


def test_mesh_train_record_on_a_4x4_world(world16):
    """A smoke ``train_4k``-shaped record on a fake (4, 4) world: collective
    bytes by kind, by axis and by link, the data axis's gradient all-reduce
    at least the bytes of the gradients of the data-replicated parameters
    (every parameter), and the local FLOPs of 16 ranks at least the
    one-card trace's. The JAX dry-run's per-kind bytes for the same cell
    (automatic-axis (4, 4) mesh, HLO parse) are written beside the port's
    in the assertion messages."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=16")
    shape = SMOKE_SHAPES["train_4k"]
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_RECORD, "smollm-135m",
         str(shape.global_batch), str(shape.seq_len)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    cfg = A.smoke_config("smollm-135m")
    rec = D.mesh_record(cfg, shape, world16)
    out, err = jax_proc.communicate(timeout=300)
    assert jax_proc.returncode == 0, err[-3000:]
    beside = f"port {rec['collective_bytes_per_device']}, JAX {out}"

    coll = rec["collective_bytes_per_device"]
    assert coll["total"] == sum(v for k, v in coll.items()
                                if k != "total") > 0, beside
    assert rec["roofline"]["collective_s"] == rec["collective_s"] > 0
    assert set(rec["collective_bytes_by_link"]) == {"nvlink", "nic"}, beside
    _, args = D.step_inputs(cfg, shape)
    grads = D.local_bytes(world16, args[0].params,
                          D.state_shardings(world16, args[0].params))
    assert rec["collective_bytes_by_axis"]["data"]["all-reduce"] >= grads, \
        beside
    one = D.one_card_record(cfg, shape)["traced_flops"]
    assert rec["traced_flops_per_device"] * 16 >= one, beside
    assert rec["traced_flops_per_device"] < one, beside
    assert rec["collective_link"]["source"] == CM.LINK_SOURCE
