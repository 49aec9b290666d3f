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
* **payloads resolved** — in value-schema mode the i32 handle words are
  dereferenced through the slabs at save time (a gather on the device,
  then one copy of the items' rows), so the image stores typed per-item
  payload rows and is independent of handle allocation order and
  ``slab_capacity``;
* **a versioned header** — readers are registered per version, so an
  image from a *newer* writer fails with a clear error;
* **placement-independent** — a sharded table's stacked state flattens
  its shard axis (each shard is more pool rows of one logical table), and
  the header's policy counters are summed over shards. A mesh table's
  shards are first gathered over its ``model`` group, so every rank
  extracts the stacked image; :func:`save_table` writes it on global
  rank 0, behind a barrier.

Restore replays the image through the ordinary combining transaction:
:func:`restore_from_image` builds a fresh table for the **target** spec —
which may differ from the save spec in ``dmax``, ``pool_size``,
``n_lanes``, ``slab_capacity``, backend, placement, shard count or mesh
(local → sharded, sharded N → M, sharded → local, one mesh → another or
onto one device) — and inserts the items
through ``Table.apply``, so every item re-routes through hash → shard →
directory and the reactive splits. Infeasible targets (a ``dmax`` too
shallow for the image's densest hash-prefix group, too few slots or slab
rows, a value schema that differs from the image's) are rejected on the
host before any device work.

Policy counters survive the round trip through the header: the elastic
policy is detached during the load (the replay's splits must not count as
its actions) and the image's counters are reinstalled after it (on shard
0 of a sharded target, as the JAX package does). Per-lane
transaction state (``applied_seq``, ``last_status``) is session state, not
content. The save-side error flag is recorded as provenance but not
re-imposed.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.core.hashing import EMPTY_KEY, HASH_BITS, hash_np
from repro_torch.core.spec import TableSpec, signed_view

FORMAT_MAGIC = "wfext-table-image"
FORMAT_VERSION = 1


@dataclasses.dataclass
class TableImage:
    """A canonical, layout-independent table image (host arrays).

    ``values`` is ``i32[n]`` for raw values, or ``{field: [n, *shape]}``
    in value-schema mode. ``header`` carries the versioned metadata
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


def _schema_header(spec: TableSpec):
    if spec.value_schema is None:
        return None
    return [[f.name, f.dtype, list(f.shape)] for f in spec.value_schema]


def _aggregate_bits(spec: TableSpec) -> int:
    """Top hash bits the spec's addressing can spend: the shard id's
    ``shard_bits`` before the per-shard directory's ``dmax``."""
    extra = spec.shard_bits if spec.placement == "sharded" else 0
    return spec.dmax + extra


def _schema_key(schema) -> Optional[tuple]:
    """Hashable normal form of a schema header (or a spec's value_schema)."""
    if schema is None:
        return None
    return tuple((str(n), str(d), tuple(int(x) for x in s))
                 for n, d, s in schema)


def extract_image(table) -> TableImage:
    """Canonical image of a ``Table`` handle: live buckets' occupied slots
    masked on the device, their keys, words and (schema mode) payload rows
    copied to the host, then sorted by (full hash, key). Every rank of a
    mesh table calls this (its shards' rows are gathered over ``model``)
    and gets the whole image."""
    spec = table.spec
    st = table.state
    if table.mesh is not None:
        from repro_torch.core.dist import gather_shards
        st = st._replace(**gather_shards(
            spec.dist_config(), st, table.mesh,
            ("keys", "vals", "live", "policy_counts", "error")))
    B = spec.bucket_size
    # a stacked sharded state: its shards are more pool rows
    keys, vals = st.keys.reshape(-1, B), st.vals.reshape(-1, B)
    slot_mask = st.live.reshape(-1)[:, None] & (keys != EMPTY_KEY)
    words = vals[slot_mask]
    item_keys = keys[slot_mask].cpu().numpy().astype(np.int32)
    order = np.lexsort((item_keys, hash_np(spec.hash_name, item_keys)))
    if spec.value_schema is None:
        values: Union[np.ndarray, Dict[str, np.ndarray]] = (
            words.cpu().numpy().astype(np.int32)[order])
    else:
        h = words.long()
        values = {name: _rows_numpy(slab, h)[order]
                  for name, slab in table.slabs.items()}
    header = {
        "format": FORMAT_MAGIC,
        "version": FORMAT_VERSION,
        "n_items": int(item_keys.shape[0]),
        "hash_name": spec.hash_name,
        "value_schema": _schema_header(spec),
        "policy_counts": [int(x) for x in st.policy_counts.reshape(
            -1, 2).sum(dim=0).cpu().tolist()],
        "error": bool(st.error.any()),
        "saved_spec": {
            "placement": spec.placement,
            "shard_bits": spec.shard_bits,
            "dmax": spec.dmax,
            "bucket_size": spec.bucket_size,
            "pool_size": spec.pool_size,
        },
    }
    return TableImage(header=header, keys=item_keys[order], values=values)


def _rows_numpy(slab: torch.Tensor, rows: torch.Tensor) -> np.ndarray:
    """``slab[rows]`` as a host array, gathered through a signed view (no
    unsigned gather is assumed on the device). A ``bfloat16`` field, which
    numpy lacks, becomes its raw 2-byte words (dtype ``V2``): the bytes
    and the dtype the JAX package's image file holds for such a field."""
    x = signed_view(slab)[rows].cpu()
    if slab.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view("V2")
    return x.view(slab.dtype).numpy()


def _from_numpy(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """An image's payload array as a tensor of the field's ``dtype``. A
    ``bfloat16`` field is bit-cast from its 2-byte words, whether they load
    as ``V2`` (an image file), ``ml_dtypes.bfloat16`` (the JAX package's
    in-memory image) or 16-bit integers."""
    arr = np.ascontiguousarray(arr)
    if dtype == torch.bfloat16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


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
    """Write ``image`` to ``path`` as a single npz file (atomic rename)."""
    arrays = {"keys": image.keys}
    if isinstance(image.values, dict):
        for name, arr in image.values.items():
            arrays[f"field__{name}"] = arr
    else:
        arrays["vals"] = image.values
    buf = io.BytesIO()
    np.savez(buf, __header__=np.frombuffer(
        json.dumps(image.header, sort_keys=True).encode(), np.uint8),
        **arrays)
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

    Exact checks: the value schema must match field for field (name, dtype
    and shape); the densest group of keys sharing all of the target's
    aggregate hash bits (``shard_bits + dmax``) must fit one bucket — a
    larger group would
    OVERFLOW however the table splits; in schema mode the slab store must
    have a row per item; and the items must fit the pool's slots. Pool
    exhaustion depends on the split trajectory and is checked after the
    replay instead."""
    want = _schema_key(_schema_header(spec))
    have = _schema_key(image.schema)
    if want != have:
        raise ValueError(
            "value schema mismatch: image has "
            f"{have and [f[0] for f in have]}, restore spec has "
            f"{want and [f[0] for f in want]}; save and restore specs must "
            "declare the same fields (dtype and shape included)")
    if image.n_items == 0:
        return

    bits = _aggregate_bits(spec)
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
            f"hold {spec.bucket_size}; need dmax >= "
            f"{need - (bits - spec.dmax)} for placement="
            f"{spec.placement!r} (image has {image.n_items} items)")

    if spec.value_schema is not None and image.n_items > spec.slab_rows:
        raise ValueError(
            f"slab store too small: image has {image.n_items} items, "
            f"restore spec provides slab_rows={spec.slab_rows}; raise "
            "slab_capacity (or pool_size*bucket_size)")

    capacity = spec.n_shards * spec.pool_size * spec.bucket_size
    if image.n_items > capacity:
        raise ValueError(
            f"restore target too small: image has {image.n_items} items, "
            f"spec caps out at {capacity} "
            "(n_shards * pool_size * bucket_size)")


# ---------------------------------------------------------------------------
# restore (replay through the ordinary combining transaction)


def restore_from_image(image: TableImage, spec: TableSpec, device=None,
                       mesh=None):
    """Build a fresh ``Table`` for ``spec`` on ``device`` (default
    ``"cuda"``), or on ``mesh`` (every rank calls this with the same
    image), holding ``image``'s content: the items and their payloads
    go in as inserts through ``Table.apply``, one ``n_lanes``-wide
    transaction per chunk, with the elastic policy detached; then the
    policy is reattached with the image's counters (on shard 0 of a
    sharded target: ``policy_stats`` sums the shards)."""
    from repro_torch.core.dist import local_shards
    from repro_torch.table_api import Table  # table_api imports this module

    check_restorable(image, spec)
    load_spec = (dataclasses.replace(spec, resize_policy=None)
                 if spec.resize_policy is not None else spec)
    table = Table.create(load_spec, device, mesh)
    n = image.n_items
    if n:
        dev = table.device
        keys = torch.tensor(image.keys, dtype=torch.int32, device=dev)
        if isinstance(image.values, dict):
            dtypes = spec.field_dtypes()
            values = {name: _from_numpy(arr, dtypes[name]).to(dev)
                      for name, arr in image.values.items()}
        else:
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
    st = table.state
    if spec.placement == "sharded":
        st.policy_counts.zero_()
        if 0 in local_shards(spec.dist_config(), mesh):
            st.policy_counts[0] = counts
    else:
        st = st._replace(policy_counts=counts)
    spec.plan(table.device.type)
    return table._replace(spec=spec, state=st)


# ---------------------------------------------------------------------------
# facade entry points (Table.save / Table.restore delegate here)


def save_table(table, path: str, mesh=None) -> str:
    """Serialize ``table`` to a durable image file at ``path``. Every rank
    of a mesh table calls this, and so does every rank of ``mesh`` (the
    run's mesh) that holds a local ``table`` as a replica: global rank 0
    writes the file, alone, and no rank returns before it is written. If
    rank 0's write raises, every rank raises the same exception."""
    image = extract_image(table)
    mesh = table.mesh if table.mesh is not None else mesh
    if mesh is None:
        return save_image(image, path)
    import torch.distributed as dist
    failed = [None]
    if dist.get_rank() == 0:
        try:
            save_image(image, path)
        except Exception as e:  # noqa: BLE001 — every rank raises it below
            failed[0] = e
    # rank 0's outcome, broadcast once it is known: the other ranks wait
    # here for the file, and none is left at a barrier rank 0 skipped
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else None)
    dist.broadcast_object_list(failed, src=0, device=dev)
    if failed[0] is not None:
        raise failed[0]
    return path


def restore_table(path: str, spec: TableSpec, device=None, mesh=None):
    """Load the image at ``path`` into a fresh table built for ``spec`` (on
    ``mesh``, every rank reads the file)."""
    return restore_from_image(load_image(path), spec, device, mesh)
