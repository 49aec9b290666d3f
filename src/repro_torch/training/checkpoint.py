"""Step-atomic checkpointing: the JAX package's ``training/checkpoint.py``
on-disk layout, so a checkpoint written by either package restores in the
other.

Layout: <dir>/step_<N>.tmp → (write leaves + manifest) → atomic rename to
<dir>/step_<N>. Each leaf is an .npy keyed by its tree path, spelled as the
JAX package spells it (a NamedTuple field ``f`` as ``.f``, a dict key as
itself, joined by ``/``); bf16 leaves are stored as their lossless fp32
upcast. ``manifest.json`` holds ``step``, ``keys``, ``tables`` and
``extra``. :func:`restore` takes a target tree (``like``: its leaves give
each leaf's shape and dtype) and a device.

A state on a mesh (DTensor leaves) saves in the same format: every rank
gathers each leaf and rank 0 writes, so an image crosses meshes, the one
device and the JAX package. :func:`restore` with ``shardings`` (a spec tree,
``launch/shardings.state_shardings``) and a ``mesh`` lays the image out on
any mesh — the JAX package's elastic re-shard (new mesh shape, new DP/TP
degree).

WF-Ext tables checkpoint alongside the model state: pass ``tables`` (a
``{name: Table}`` dict) to :func:`save` and each is serialized as a
canonical placement-independent image (``table_<name>.npz``, see
:mod:`repro_torch.core.snapshot`) inside the same atomic step directory.
:func:`restore_table` revives one by name under a caller-chosen spec (local
→ sharded, N → M shards, resized pools).

Fault-tolerance contract: a crash mid-save leaves only a .tmp dir (ignored
by :func:`latest_step`); training resumes from the last renamed step with
the data-pipeline offset from the manifest.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.models.sharding import distribute_leaf
from repro_torch.models.sharding import flatten as _flat


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _rebuild(like, leaves, prefix=()):
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(getattr(like, f), leaves,
                                     prefix + (f".{f}",))
                            for f in like._fields))
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves, prefix + (str(k),))
                for k in like}
    return leaves["/".join(prefix)]


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    t = leaf.detach()
    if isinstance(t, DTensor):
        t = t.full_tensor()
    if t.dtype == torch.bfloat16:
        # .npy cannot hold bfloat16; the fp32 upcast is lossless
        t = t.float()
    return t.cpu().numpy()


def save(ckpt_dir: str, step: int, state: Any, extra: Optional[dict] = None,
         tables: Optional[dict] = None) -> str:
    """Write ``state`` (nested NamedTuples and dicts of tensors) as step
    ``step``; ``tables`` ({name: repro_torch.table_api.Table}) ride in the
    same atomic step directory as canonical images. A state with DTensor
    leaves is gathered leaf by leaf on every rank of its mesh (each must
    call this), rank 0 writes and the ranks meet at a barrier once the
    step is renamed into place."""
    leaves = _flat(state)
    if any(isinstance(x, DTensor) for x in leaves.values()):
        writer = dist.get_rank() == 0
        arrays = {}
        for k, x in leaves.items():
            full = _to_numpy(x)            # every rank joins the gather
            if writer:
                arrays[k] = full
        if writer:
            _write(ckpt_dir, step, arrays, extra, tables)
        dist.barrier()
        return os.path.join(ckpt_dir, f"step_{step}")
    return _write(ckpt_dir, step, {k: _to_numpy(x) for k, x in
                                   leaves.items()}, extra, tables)


def _write(ckpt_dir, step, arrays, extra, tables):
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    for key, arr in arrays.items():
        np.save(os.path.join(tmp, key.replace("/", "__") + ".npy"), arr)
    if tables:
        from repro_torch.core import snapshot
        for name, tbl in sorted(tables.items()):
            snapshot.save_table(tbl, os.path.join(tmp, f"table_{name}.npz"))
    manifest = {
        "step": step,
        "keys": sorted(arrays),
        "tables": sorted(tables) if tables else [],
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomicity point
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                steps.append(int(name.split("_", 1)[1]))
            except ValueError:
                continue
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: Any, device=None,
            shardings: Optional[Any] = None, mesh=None):
    """Restore step ``step`` into the structure of ``like`` (its leaves'
    shapes and dtypes), on ``device`` (default: each leaf's of ``like``).
    ``like`` may hold meta tensors (``train_step.abstract_train_state``)
    only when ``device`` is given: a meta leaf with no device raises
    ``ValueError``, since its own device holds no data. With ``shardings``
    (a spec tree in ``like``'s structure) every leaf is laid out on
    ``mesh`` by its spec (``models/sharding.distribute_leaf``: each rank
    keeps its slices of the image, whatever mesh wrote it). Returns
    (state, manifest extra)."""
    if shardings is not None and mesh is None:
        raise ValueError("restore with shardings needs the mesh")
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    want = _flat(like)
    if device is None:
        meta = [k for k, leaf in want.items() if leaf.is_meta]
        if meta:
            raise ValueError(
                f"restore into meta tensors ({meta[:3]}) needs a device")
    if sorted(want) != manifest["keys"]:
        raise ValueError(
            f"checkpoint/tree mismatch at {path}: "
            f"{sorted(set(want) ^ set(manifest['keys']))[:8]}")
    specs = _flat(shardings) if shardings is not None else {}
    restored = {}
    for key, leaf in want.items():
        arr = np.load(os.path.join(path, key.replace("/", "__") + ".npy"))
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape}, want "
                             f"{tuple(leaf.shape)}")
        dev = leaf.device if device is None else torch.device(device)
        x = torch.from_numpy(arr).to(device=dev, dtype=leaf.dtype)
        restored[key] = distribute_leaf(x, mesh, specs[key]) if specs else x
    return _rebuild(like, restored), manifest["extra"]


def table_names(ckpt_dir: str, step: int) -> list:
    """Names of the table images saved alongside step ``step`` (may be
    empty; checkpoints written before table support report [])."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        return list(json.load(f).get("tables", []))


def restore_table(ckpt_dir: str, step: int, name: str, spec, device=None):
    """Revive the table image saved as ``name`` alongside step ``step``
    under the *target* ``spec`` (it may differ from the spec the table was
    saved under: local → sharded, N → M shards, resized pools) on
    ``device`` (default ``"cuda"``). Returns a
    ``repro_torch.table_api.Table``."""
    from repro_torch.table_api import Table
    path = os.path.join(ckpt_dir, f"step_{step}", f"table_{name}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no table image {name!r} at step {step} "
            f"(have {table_names(ckpt_dir, step)})")
    return Table.restore(path, spec, device)
