"""Dry-run of every (arch × shape × mesh) cell: the JAX package's
``launch/dryrun.py``, its one-card half and its layout half.

Per cell the dry-run builds the step's inputs as meta tensors
(``configs/shapes.input_specs``, ``training/train_step.abstract_train_state``,
``models/model.abstract_params``: nothing allocated, nothing drawn) and
writes one JSON record per cell into ``--out``:

* ``h100x1`` (one H100): the step itself — ``train_step`` (train),
  ``forward(differentiable=False)`` (prefill) or ``decode_step`` (decode) —
  runs on the meta tensors under ``torch.utils.flop_counter.FlopCounterMode``.
  The record holds the traced FLOPs beside ``analytic_costs`` at one device
  and ``model_flops``, the argument bytes (state or parameters, batch or
  cache) and whether they fit the card's memory;
* ``pod16x16`` / ``pod2x16x16`` (the production meshes of
  ``launch/mesh.py``, built over a fake process group of 256 / 512 ranks
  in this one process, the counterpart of the JAX dry-run's 512 forced host
  devices): the same meta trees laid out by ``launch/shardings.py`` as
  DTensors (rank 0's shards), and the step itself traced on them under the
  mesh, its constraints live, inside ``costmodel.MeshTrace``. The record
  holds the per-device argument bytes (the JAX record's
  ``argument_size_in_bytes``), the collectives rank 0 issues by kind (the
  JAX record's ``collective_bytes_per_device``, result bytes), by mesh
  axis and by link, ``collective_s`` at the link rates the record states
  (``collective_link``), ``traced_flops_per_device`` (rank 0's local ops),
  ``trace_s``, ``analytic_costs`` per device and ``model_flops``.

Roofline denominators are one H100's (SXM, dense bf16, 700 W): 989e12
FLOP/s and 3.35e12 B/s; the collectives' are ``costmodel.LINK_SOURCE``'s.
The bottleneck is the largest of ``compute_s``, ``memory_s`` and
``collective_s``. A failing cell is recorded and the sweep goes on;
the exit code is 1 if any cell failed. The ``paged`` variant's decode runs
the WF-Ext table transaction, which reads the device and has no meta plan:
its decode cells are recorded as failed with that cause.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b \\
      --shape train_4k [--multi-pod] [--out artifacts]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \
      --shape train_4k --meshes pod16x16,pod2x16x16
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.archs import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, Shape, cell_supported, input_specs
from repro_torch.launch.costmodel import (GPUS_PER_NODE, LINK_SOURCE,
                                          NIC_BYTES_S, NVLINK_BYTES_S,
                                          MeshTrace, analytic_costs,
                                          param_count)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shardings import (batch_shardings, mesh_sizes,
                                          placements, state_shardings)
from repro_torch.models import sharding as MS
from repro_torch.models.model import (ModelConfig, abstract_params,
                                      decode_step, forward)
from repro_torch.training.checkpoint import _flat
from repro_torch.training.train_step import (TrainConfig,
                                             abstract_train_state,
                                             train_step)

# one H100 SXM (roofline denominators; NVIDIA's data sheet, 700 W)
PEAK_FLOPS = 989e12        # dense bf16 FLOP/s
HBM_BW = 3.35e12           # B/s
# device memory: what ``torch.cuda.get_device_properties(0).total_memory``
# reads on an NVIDIA H100 80GB HBM3 (chip_smoke.py phase 17 prints it),
# 79.18 GiB, below the nominal 80 GiB. ``fits_80gb`` is argument bytes <=
# this; each record carries it as ``hbm_bytes`` with ``HBM_SOURCE``.
HBM_BYTES = 85_017_493_504
HBM_SOURCE = "total_memory of one NVIDIA H100 80GB HBM3"

# mesh name → production mesh (None: one card, traced)
MESHES = {"h100x1": None, "pod16x16": False, "pod2x16x16": True}

COLLECTIVE_LINK = {"nvlink_bytes_per_s": NVLINK_BYTES_S,
                   "nic_bytes_per_s": NIC_BYTES_S,
                   "gpus_per_node": GPUS_PER_NODE, "source": LINK_SOURCE}
PAGED_CAUSE = ("the paged variant's decode runs the WF-Ext table "
               "transaction, which reads the device (its ST_FULL read) and "
               "has no meta plan")


def model_flops_per_step(cfg: ModelConfig, shape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE) for training,
    2·N_active·D for inference steps (N excludes embedding tables)."""
    d = cfg.d_model
    per_layer = 0
    if cfg.has_attn():
        per_layer += d * cfg.n_heads * cfg.head_dim * 2
        per_layer += d * cfg.n_kv_heads * cfg.head_dim * 2
    if cfg.has_ssm():
        per_layer += d * (2 * cfg.d_inner + 2 * cfg.ssm_state +
                          cfg.ssm_heads) + cfg.d_inner * d
    if cfg.mlp_kind in ("swiglu", "geglu"):
        per_layer += 3 * d * cfg.d_ff
    elif cfg.mlp_kind == "moe":
        per_layer += 3 * d * cfg.d_ff * (cfg.top_k + cfg.n_shared_experts)
    n_active = cfg.n_layers * per_layer
    n_active += cfg.padded_vocab * d  # unembed
    if cfg.enc_layers:
        n_active += cfg.enc_layers * (per_layer + 3 * d * cfg.d_ff)
    tokens = shape.global_batch * (shape.seq_len if shape.mode != "decode" else 1)
    mult = 6 if shape.mode == "train" else 2
    return float(mult) * n_active * tokens


VARIANTS = {
    # decode options beyond the paper (baseline = no variant)
    "kvq8": {"kv_quant": "int8"},
    "bf16psum": {"decode_bf16_partials": True},
    "kvq8+bf16psum": {"kv_quant": "int8", "decode_bf16_partials": True},
    "winslice": {"decode_window_slice": True},
    "winslice+kvq8": {"decode_window_slice": True, "kv_quant": "int8"},
    "winslice+kvq8+bf16psum": {"decode_window_slice": True,
                               "kv_quant": "int8",
                               "decode_bf16_partials": True},
    "paged": {},   # decode via the WF-Ext paged serving engine
    # contraction-dim sharding of indivisible-head attention params
    "dshard": {"_shard_opts": {"attn_dshard": True}},
    "winslice+kvq8+dshard": {"decode_window_slice": True, "kv_quant": "int8",
                             "_shard_opts": {"attn_dshard": True}},
}


def variant_config(cfg: ModelConfig, variant: str):
    """(cfg with the variant's overrides, its sharding options)."""
    if not variant:
        return cfg, {}
    overrides = dict(VARIANTS[variant])
    shard_opts = overrides.pop("_shard_opts", {})
    return dataclasses.replace(cfg, **overrides), shard_opts


def step_inputs(cfg: ModelConfig, shape: Shape, variant: str = ""):
    """(step function, its argument trees as meta tensors) for one cell."""
    specs = input_specs(cfg.name, shape, cfg)
    if shape.mode == "train":
        tc = TrainConfig()
        return (lambda state, batch: train_step(cfg, tc, state, batch),
                (abstract_train_state(cfg), specs))
    params = abstract_params(cfg)
    if shape.mode == "prefill":
        def prefill(params, batch):
            with torch.no_grad():
                return forward(cfg, params, batch, differentiable=False)[0]
        return prefill, (params, specs)
    if variant == "paged":
        from repro_torch.serving import engine as E
        pc = E.make_paged_config(cfg, batch=shape.global_batch,
                                 max_len=shape.seq_len)
        try:
            est = E.init_engine(cfg, pc, "meta")
        except ValueError as e:
            raise NotImplementedError(f"{PAGED_CAUSE} ({e})") from e
        return (lambda est, params: E.serve_step(cfg, pc, est, params),
                (est, params))

    def decode(params, cache, tokens):
        with torch.no_grad():
            return decode_step(cfg, params, cache, tokens)[0]
    return decode, (params, specs["cache"], specs["tokens"])


def tree_bytes(tree) -> int:
    return sum(leaf.numel() * leaf.element_size()
               for leaf in _flat(tree).values())


def local_bytes(mesh, tree, specs) -> int:
    """Bytes of ``tree``'s shards on the mesh's first device under
    ``specs`` (one spec per leaf, in ``tree``'s structure)."""
    total = 0
    want = _flat(specs)
    for key, leaf in _flat(tree).items():
        shape, _ = compute_local_shape_and_global_offset(
            tuple(leaf.shape), mesh, placements(mesh, want[key]))
        n = 1
        for s in shape:
            n *= s
        total += n * leaf.element_size()
    return total


def roofline(ana, collective_s=None) -> dict:
    r = {"compute_s": ana["flops_per_device"] / PEAK_FLOPS,
         "memory_s": ana["bytes_per_device"] / HBM_BW}
    if collective_s is not None:
        r["collective_s"] = collective_s
    return dict(r, collective_s=collective_s, bottleneck=max(r, key=r.get))


def one_card_record(cfg: ModelConfig, shape: Shape, variant: str = ""):
    """The ``h100x1`` record's numbers: the step traced on meta tensors
    under ``FlopCounterMode`` at one device."""
    cfg, shard_opts = variant_config(cfg, variant)
    fn, args = step_inputs(cfg, shape, variant)
    arg_bytes = sum(tree_bytes(a) for a in args)
    t0 = time.perf_counter()
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args)
    trace_s = time.perf_counter() - t0
    traced = float(counter.get_total_flops())
    ana = analytic_costs(cfg, shape, 1, 1, 1,
                         attn_dshard=shard_opts.get("attn_dshard", False))
    mf = model_flops_per_step(cfg, shape)
    return {"n_chips": 1, "params": param_count(cfg), "trace_s": trace_s,
            "traced_flops": traced,
            "analytic_flops_per_device": ana["flops_per_device"],
            "analytic_bytes_per_device": ana["bytes_per_device"],
            "traced_vs_analytic": traced / ana["flops_per_device"],
            "memory": {"argument_bytes_per_device": arg_bytes,
                       "hbm_bytes": HBM_BYTES, "hbm_source": HBM_SOURCE,
                       "fits_80gb": arg_bytes <= HBM_BYTES},
            "roofline": roofline(ana), "model_flops": mf,
            "model_vs_traced": mf / traced if traced else None}


def mesh_record(cfg: ModelConfig, shape: Shape, mesh, variant: str = ""):
    """A production mesh's record: the step's meta arguments laid out on
    the mesh as DTensors and the step traced on them (``MeshTrace``): the
    per-device argument bytes, collectives and FLOPs, and the analytic
    costs per device."""
    cfg, shard_opts = variant_config(cfg, variant)
    fn, args = step_inputs(cfg, shape, variant)
    sizes = mesh_sizes(mesh)
    n_chips = mesh.size()
    model_axis = sizes.get("model", 1)
    if shape.mode == "decode":
        params, cache, tokens = args
        arg_specs = (state_shardings(mesh, params, **shard_opts),
                     batch_shardings(mesh, cache),
                     batch_shardings(mesh, {"tokens": tokens})["tokens"])
    else:
        state, batch = args
        arg_specs = (state_shardings(mesh, state, **shard_opts),
                     batch_shardings(mesh, batch))
    per_device = sum(local_bytes(mesh, a, s) for a, s in zip(args, arg_specs))
    params = args[0].params if shape.mode == "train" else args[0]
    p_specs = _flat(state_shardings(mesh, params, **shard_opts))
    replicated = sorted(k for k, leaf in _flat(params).items()
                        if not any(p_specs[k]))
    placed = [MS.distribute_leaf(a, mesh, s) if isinstance(a, torch.Tensor)
              else MS.distribute_tree(a, s, mesh)
              for a, s in zip(args, arg_specs)]
    t0 = time.perf_counter()
    with MS.set_mesh(mesh), MeshTrace(mesh) as trace:
        fn(*placed)
    trace_s = time.perf_counter() - t0
    traced = trace.summary()
    ana = analytic_costs(cfg, shape, n_chips, model_axis,
                         n_chips // model_axis,
                         attn_dshard=shard_opts.get("attn_dshard", False))
    mf = model_flops_per_step(cfg, shape)
    return {"n_chips": n_chips, "mesh_shape": sizes,
            "params": param_count(cfg), "trace_s": trace_s,
            "memory": {"argument_bytes_per_device": per_device,
                       "hbm_bytes": HBM_BYTES, "hbm_source": HBM_SOURCE,
                       "fits_80gb": per_device <= HBM_BYTES},
            "replicated_params": replicated,
            "analytic_flops_per_device": ana["flops_per_device"],
            "analytic_bytes_per_device": ana["bytes_per_device"],
            **traced, "collective_link": COLLECTIVE_LINK,
            "roofline": roofline(ana, traced["collective_s"]),
            "model_flops": mf,
            "model_vs_analytic": mf / (ana["flops_per_device"] * n_chips),
            "traced_vs_analytic": traced["traced_flops_per_device"]
            / ana["flops_per_device"]}


def fake_world(size: int) -> bool:
    """Start a fake process group of ``size`` ranks (this process is rank
    0; collectives do nothing) unless a group of at least that size exists.
    Returns whether one was started (the caller destroys it)."""
    if dist.is_initialized():
        if dist.get_world_size() < size:
            raise ValueError(f"the process group has "
                             f"{dist.get_world_size()} ranks; the meshes "
                             f"need {size}")
        return False
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    _forget_meshes()
    return True


def _forget_meshes():
    """Drop DTensor's cached sharding decisions: they hold the meshes of an
    earlier world (equal to this world's by shape and names, but with its
    destroyed process groups)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._redistribute import _gen_transform_infos
    prop = DTensor._op_dispatcher.sharding_propagator
    prop.propagate_op_sharding.cache_clear()
    prop._propagate_tensor_meta_cached.cache_clear()
    _gen_transform_infos.cache_clear()
    clear = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                    None)
    if clear is not None:
        clear()


def run_cell(arch: str, shape_name: str, mesh_name: str, out_dir: str,
             variant: str = ""):
    """One cell's record, written to ``out_dir`` and returned. A production
    mesh needs a process group of its size (``fake_world``)."""
    suffix = f"__{variant}" if variant else ""
    cell_id = f"{arch}__{shape_name}__{mesh_name}{suffix}"
    ok, why = cell_supported(arch, shape_name)
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "cell": cell_id, "variant": variant}
    if not ok:
        record.update(status="skipped", reason=why)
        _write(out_dir, cell_id, record)
        print(f"[skip] {cell_id}: {why}")
        return record

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    t0 = time.perf_counter()
    try:
        if MESHES[mesh_name] is None:
            rec = one_card_record(cfg, shape, variant)
        else:
            mesh = make_production_mesh(multi_pod=MESHES[mesh_name],
                                        device_type="cpu")
            rec = mesh_record(cfg, shape, mesh, variant)
        record.update(status="ok", seconds=time.perf_counter() - t0, **rec)
        r = rec["roofline"]
        coll = ("" if r["collective_s"] is None
                else f"collective={r['collective_s']:.3e}s ")
        print(f"[ok]   {cell_id}  compute={r['compute_s']:.3e}s "
              f"memory={r['memory_s']:.3e}s {coll} dom={r['bottleneck']}  "
              f"args={rec['memory']['argument_bytes_per_device']}  "
              f"trace={rec['trace_s']:.1f}s")
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        record.update(status="failed", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
        print(f"[FAIL] {cell_id}: {type(e).__name__}: {e}")
    _write(out_dir, cell_id, record)
    return record


def _write(out_dir, cell_id, record):
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, cell_id + ".json"), "w") as f:
        json.dump(record, f, indent=1, default=str)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--variant", default="", choices=[""] + sorted(VARIANTS))
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--meshes", default=None,
                    help="comma-separated mesh names (default: h100x1 and "
                    "the pod meshes the other flags choose)")
    ap.add_argument("--out", default="artifacts")
    args = ap.parse_args(argv)

    pods = (["pod16x16", "pod2x16x16"] if args.both_meshes
            else ["pod2x16x16"] if args.multi_pod else ["pod16x16"])
    meshes = ["h100x1"] + pods
    if args.meshes:
        meshes = args.meshes.split(",")
        unknown = sorted(set(meshes) - set(MESHES))
        if unknown:
            ap.error(f"unknown meshes {unknown}; known {sorted(MESHES)}")
        pods = [m for m in meshes if MESHES[m] is not None]
    if args.all:
        todo = [(arch, shape) for arch in ARCHS for shape in SHAPES]
    elif args.arch and args.shape:
        todo = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")

    started = fake_world(512 if "pod2x16x16" in pods else 256) if pods \
        else False
    n_fail = 0
    try:
        for arch, shape in todo:
            for mesh_name in meshes:
                rec = run_cell(arch, shape, mesh_name, args.out, args.variant)
                n_fail += rec["status"] == "failed"
    finally:
        if started:
            dist.destroy_process_group()
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
