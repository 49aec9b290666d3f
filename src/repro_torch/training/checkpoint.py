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


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flat(tree, prefix=()):
    """{key: leaf} with the JAX package's path keys."""
    if _is_namedtuple(tree):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    else:
        return {"/".join(prefix): tree}
    out = {}
    for k, sub in items:
        out.update(_flat(sub, prefix + (k,)))
    return out


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
    if t.dtype == torch.bfloat16:
        # .npy cannot hold bfloat16; the fp32 upcast is lossless
        t = t.float()
    return t.cpu().numpy()


def save(ckpt_dir: str, step: int, state: Any, extra: Optional[dict] = None,
         tables: Optional[dict] = None) -> str:
    """Write ``state`` (nested NamedTuples and dicts of tensors) as step
    ``step``; ``tables`` ({name: repro_torch.table_api.Table}) ride in the
    same atomic step directory as canonical images."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = _flat(state)
    for key, leaf in leaves.items():
        np.save(os.path.join(tmp, key.replace("/", "__") + ".npy"),
                _to_numpy(leaf))
    if tables:
        from repro_torch.core import snapshot
        for name, tbl in sorted(tables.items()):
            snapshot.save_table(tbl, os.path.join(tmp, f"table_{name}.npz"))
    manifest = {
        "step": step,
        "keys": sorted(leaves),
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


def restore(ckpt_dir: str, step: int, like: Any, device=None):
    """Restore step ``step`` into the structure of ``like`` (its leaves'
    shapes and dtypes), on ``device`` (default: each leaf's of ``like``).
    ``like`` may hold meta tensors (``train_step.abstract_train_state``)
    only when ``device`` is given: a meta leaf with no device raises
    ``ValueError``, since its own device holds no data. Returns (state,
    manifest extra)."""
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
    restored = {}
    for key, leaf in want.items():
        arr = np.load(os.path.join(path, key.replace("/", "__") + ".npy"))
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape}, want "
                             f"{tuple(leaf.shape)}")
        dev = leaf.device if device is None else torch.device(device)
        restored[key] = torch.from_numpy(arr).to(device=dev,
                                                 dtype=leaf.dtype)
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
