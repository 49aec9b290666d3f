"""Durable table images: save a table's content, restore it into any spec.

The same image as the JAX package's ``repro/core/snapshot.py`` — the same
npz file, ``FORMAT_MAGIC``, ``FORMAT_VERSION = 1`` and header keys — so an
image crosses between the two packages in both directions.
:func:`extract_image` turns a ``repro_torch.table_api.Table`` into a
canonical, layout-independent :class:`TableImage`:

* **logical-bucket order** — items are sorted by (full 32-bit hash, key),
  the order a directory walk at maximal depth would visit them, so two
  tables with the same key → value content give the same image whatever
  their split order, free-stack state or slot permutations;
* **frozen/tombstone lanes normalized** — only live buckets' occupied
  slots are extracted; frozen flags, retired parents and the write-trash
  row never reach the image;
* **a versioned header** — readers are registered per version, so an
  image from a *newer* writer fails with a clear error.

Restore replays the image through the ordinary combining transaction:
:func:`restore_from_image` builds a fresh table for the **target** spec —
which may differ from the save spec in ``dmax``, ``pool_size``,
``n_lanes`` or backend — and inserts the items through ``Table.apply``, so
every item re-routes through the directory math and the reactive splits.
Infeasible targets (a ``dmax`` too shallow for the image's densest
hash-prefix group, too few slots, a value schema the port does not hold)
are rejected on the host before any device work.

Policy counters survive the round trip through the header. Per-lane
transaction state (``applied_seq``, ``last_status``) is session state, not
content. The save-side error flag is recorded as provenance but not
re-imposed.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
from typing import Any, Dict, Union

import numpy as np
import torch

from repro_torch.core.hashing import EMPTY_KEY, HASH_BITS, hash_np
from repro_torch.core.spec import TableSpec

FORMAT_MAGIC = "wfext-table-image"
FORMAT_VERSION = 1


@dataclasses.dataclass
class TableImage:
    """A canonical, layout-independent table image (host arrays).

    ``values`` is ``i32[n]`` for raw values, or ``{field: [n, *shape]}``
    for an image the JAX package saved with a value schema (which the port
    reads but cannot restore). ``header`` carries the versioned metadata
    written to disk (see :func:`extract_image`)."""

    header: Dict[str, Any]
    keys: np.ndarray
    values: Union[np.ndarray, Dict[str, np.ndarray]]

    @property
    def n_items(self) -> int:
        return int(self.keys.shape[0])

    @property
    def schema(self):
        return self.header.get("value_schema")


# ---------------------------------------------------------------------------
# extraction (save side)


def extract_image(table) -> TableImage:
    """Canonical image of a ``Table`` handle: one host copy of the pools,
    then mask live buckets' occupied slots and sort by (full hash, key)."""
    spec = table.spec
    st = table.state
    keys, vals, live = (t.cpu().numpy() for t in (st.keys, st.vals,
                                                   st.live))
    slot_mask = live[:, None] & (keys != EMPTY_KEY)
    item_keys = keys[slot_mask].astype(np.int32)
    item_vals = vals[slot_mask].astype(np.int32)
    order = np.lexsort((item_keys, hash_np(spec.hash_name, item_keys)))
    header = {
        "format": FORMAT_MAGIC,
        "version": FORMAT_VERSION,
        "n_items": int(item_keys.shape[0]),
        "hash_name": spec.hash_name,
        "value_schema": None,
        "policy_counts": [int(x) for x in st.policy_counts.cpu().tolist()],
        "error": bool(st.error),
        "saved_spec": {
            "placement": spec.placement,
            "shard_bits": spec.shard_bits,
            "dmax": spec.dmax,
            "bucket_size": spec.bucket_size,
            "pool_size": spec.pool_size,
        },
    }
    return TableImage(header=header, keys=item_keys[order],
                      values=item_vals[order])


# ---------------------------------------------------------------------------
# on-disk format (versioned npz)


class InjectedFault(RuntimeError):
    """Raised by a save-path fault hook to simulate a crash mid-save."""


# test-only fault injection around the save path's atomicity point: a hook
# that raises InjectedFault at "pre_rename" models a torn save — the tmp
# file is left behind and the destination keeps its previous intact image.
# None in production.
_FAULT_HOOK = None


def set_fault_hook(hook):
    """Install (or clear, with ``None``) the save-path fault hook.

    ``hook(point, path)`` is called at ``"pre_rename"`` (tmp file written,
    destination untouched) and ``"post_rename"`` (destination replaced).
    Returns the previously installed hook (restore it in a ``finally``)."""
    global _FAULT_HOOK
    prev, _FAULT_HOOK = _FAULT_HOOK, hook
    return prev


def save_image(image: TableImage, path: str) -> str:
    """Write a raw-value ``image`` to ``path`` as a single npz file (atomic
    rename)."""
    buf = io.BytesIO()
    np.savez(buf, __header__=np.frombuffer(
        json.dumps(image.header, sort_keys=True).encode(), np.uint8),
        keys=image.keys, vals=image.values)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    if _FAULT_HOOK is not None:
        _FAULT_HOOK("pre_rename", path)
    os.replace(tmp, path)  # the atomicity point
    if _FAULT_HOOK is not None:
        _FAULT_HOOK("post_rename", path)
    return path


def _read_v1(z, header: Dict[str, Any]) -> TableImage:
    keys = np.asarray(z["keys"], np.int32)
    if header.get("value_schema") is None:
        values: Union[np.ndarray, Dict[str, np.ndarray]] = np.asarray(
            z["vals"], np.int32)
    else:
        values = {str(name): np.asarray(z[f"field__{name}"])
                  for name, _dtype, _shape in header["value_schema"]}
    return TableImage(header=header, keys=keys, values=values)


# version → reader. New format versions append here; existing readers are
# never edited, so every image ever written keeps loading.
_READERS = {1: _read_v1}


def load_image(path: str) -> TableImage:
    """Read an image written by any supported :data:`FORMAT_VERSION`."""
    with np.load(path, allow_pickle=False) as z:
        if "__header__" not in z:
            raise ValueError(f"{path}: not a {FORMAT_MAGIC} file "
                             "(missing header)")
        header = json.loads(bytes(z["__header__"]).decode())
        if header.get("format") != FORMAT_MAGIC:
            raise ValueError(
                f"{path}: bad magic {header.get('format')!r} "
                f"(want {FORMAT_MAGIC!r})")
        version = int(header.get("version", -1))
        reader = _READERS.get(version)
        if reader is None:
            raise ValueError(
                f"{path}: image version {version} is newer than this "
                f"reader (supports {sorted(_READERS)}); upgrade the repo "
                "to restore it")
        return reader(z, header)


# ---------------------------------------------------------------------------
# feasibility (host-side, before any device work)


def check_restorable(image: TableImage, spec: TableSpec) -> None:
    """Raise ``ValueError`` when ``spec`` cannot hold ``image``.

    Exact checks: the value schema must match (the port's specs hold raw
    values, so an image with a schema is refused); the densest group of
    keys sharing all of the target's ``dmax`` top hash bits must fit one
    bucket — a larger group would OVERFLOW however the table splits; and
    the items must fit the pool's slots. Pool exhaustion depends on the
    split trajectory and is checked after the replay instead."""
    if image.schema is not None:
        raise ValueError(
            "value schema mismatch: image has "
            f"{[str(f[0]) for f in image.schema]}, restore spec has None; "
            "save and restore specs must declare the same fields (dtype "
            "and shape included)")
    if image.n_items == 0:
        return

    bits = spec.dmax
    h = hash_np(spec.hash_name, image.keys)
    _, group_sizes = np.unique(h >> np.uint32(HASH_BITS - bits),
                               return_counts=True)
    worst = int(group_sizes.max())
    if worst > spec.bucket_size:
        # smallest depth that thins every group to <= bucket_size
        for need in range(bits + 1, HASH_BITS + 1):
            _, sizes = np.unique(h >> np.uint32(HASH_BITS - need),
                                 return_counts=True)
            if int(sizes.max()) <= spec.bucket_size:
                break
        else:
            need = HASH_BITS + 1  # duplicate hashes beyond bucket capacity
        raise ValueError(
            f"restore target too shallow: {worst} keys share all "
            f"{bits} aggregate hash bits (shard_bits + dmax) but buckets "
            f"hold {spec.bucket_size}; need dmax >= {need} for "
            f"placement={spec.placement!r} (image has {image.n_items} "
            "items)")

    capacity = spec.pool_size * spec.bucket_size
    if image.n_items > capacity:
        raise ValueError(
            f"restore target too small: image has {image.n_items} items, "
            f"spec caps out at {capacity} "
            "(n_shards * pool_size * bucket_size)")


# ---------------------------------------------------------------------------
# restore (replay through the ordinary combining transaction)


def restore_from_image(image: TableImage, spec: TableSpec, device=None):
    """Build a fresh ``Table`` for ``spec`` on ``device`` (default
    ``"cuda"``) holding ``image``'s content: the items go in as inserts
    through ``Table.apply``, one ``n_lanes``-wide transaction per chunk,
    and the image's policy counters are reinstalled."""
    from repro_torch.table_api import Table  # table_api imports this module

    check_restorable(image, spec)
    table = Table.create(spec, device)
    n = image.n_items
    if n:
        dev = table.device
        keys = torch.tensor(image.keys, dtype=torch.int32, device=dev)
        values = torch.tensor(image.values, dtype=torch.int32, device=dev)
        table, res = table.insert(keys, values)
        if bool(res.error):
            seen = torch.unique(res.status).tolist()
            raise RuntimeError(
                f"restore exhausted the target geometry while replaying "
                f"{n} items (statuses {seen}); raise pool_size "
                "(bucket-pool rows) or dmax and retry")
    counts = torch.tensor(image.header.get("policy_counts", [0, 0]),
                          dtype=torch.int32, device=table.device)
    return table._replace(state=table.state._replace(policy_counts=counts))


# ---------------------------------------------------------------------------
# facade entry points (Table.save / Table.restore delegate here)


def save_table(table, path: str) -> str:
    """Serialize ``table`` to a durable image file at ``path``."""
    return save_image(extract_image(table), path)


def restore_table(path: str, spec: TableSpec, device=None):
    """Load the image at ``path`` into a fresh table built for ``spec``."""
    return restore_from_image(load_image(path), spec, device)
