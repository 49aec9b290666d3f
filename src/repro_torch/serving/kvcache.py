"""Paged KV cache whose page table IS the paper's wait-free hash table.

vLLM-style paging maps (sequence, block) → physical page through a table
that grows and shrinks as sequences join and leave the batch. Here that
table is the port's device-resident WF-Ext :class:`~repro_torch.table_api.
Table`: a decode step's page allocation is one combining transaction (an
upsert of every active slot's mapping), the attention's page ids are
rule-A lookups, and eviction is a batched delete per block. The
extendible directory deepens as the live set grows.

Key packing: key = (seq_id << BLOCK_BITS) | block_idx (int32; seq_id <
2^(31-BLOCK_BITS)). Each mapping carries the value schema

    {"page": i32   — physical page id,
     "length": i32 — tokens written into that page so far}

refreshed by the step's upsert, so the table alone describes the cache
(:func:`gather_kv` derives every slot's length from it).

The JAX package's ``serving/kvcache.py``, with the same state, the same
transactions in the same order (so ``applied_seq``, the table image and
the allocator equal the JAX package's) and the same image directory
(:func:`save_paged`). Two differences, both writes the JAX package makes
to a repeated index with an unspecified winner: :func:`append_token` and
the engine write only the active slots' K/V, and :func:`evict` pushes
only the freed pages (``masked_put``). Functions that take a
:class:`PagedState` write its tensors in place and consume it, as JAX's
donated buffers are; :func:`handover` builds a new state and leaves the
old one usable.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import snapshot
from repro_torch.core import table as T
from repro_torch.core.spec import TableSpec
from repro_torch.core.table import resolve_device
from repro_torch.table_api import Table

BLOCK_BITS = 12                      # ≤ 4096 blocks/sequence

# the page-metadata value schema (see module docstring)
PAGE_SCHEMA = (("page", "int32"), ("length", "int32"))

I32 = torch.int32


def _default_table_spec() -> TableSpec:
    return TableSpec(dmax=12, bucket_size=8, pool_size=1024, n_lanes=16,
                     value_schema=dict(PAGE_SCHEMA))


@dataclasses.dataclass(frozen=True)
class PagedConfig:
    n_layers: int
    n_kv_heads: int
    head_dim: int
    page_size: int = 16              # tokens per page
    n_pages: int = 256               # physical pages (per layer stacked)
    max_blocks: int = 32             # max pages gathered per sequence
    batch: int = 8
    table: TableSpec = dataclasses.field(default_factory=_default_table_spec)
    dtype: str = "bfloat16"

    def __post_init__(self):
        fields = {f.name for f in (self.table.value_schema or ())}
        if not fields >= {name for name, _ in PAGE_SCHEMA}:
            raise ValueError(
                "the page table needs the (page, length) value schema; got "
                f"{sorted(fields)}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


class PagedState(NamedTuple):
    table: Table                 # (seq, block) → {page, length}
    pages_k: torch.Tensor        # [L, n_pages, page, KV, hd]
    pages_v: torch.Tensor
    page_alloc: torch.Tensor     # i32[] watermark
    free_pages: torch.Tensor     # i32[n_pages] stack
    free_top: torch.Tensor       # i32[]
    lengths: torch.Tensor        # i32[batch] current length per slot
    seq_ids: torch.Tensor        # i32[batch] active sequence id (-1 = empty)


def _key(seq_ids, blocks):
    return (seq_ids << BLOCK_BITS) | blocks


def masked_put(dst, index, val, mask):
    """``dst[index[0][i], index[1][i], ...] = val[i]`` for the lanes where
    ``mask`` holds, in place and with no host read. Every other lane
    repeats the first masked lane's write (same index, same value), so a
    repeated index carries one value and the scatter's order cannot
    matter; with no masked lane every lane rewrites one entry with its own
    content."""
    n = mask.shape[0]
    lane = torch.where(mask, torch.arange(n, device=mask.device),
                       torch.argmax(mask.to(I32)))
    index = tuple(i[lane].long() for i in index)
    dst[index] = torch.where(mask.any(), val[lane], dst[index])


def init_paged(pc: PagedConfig, device=None) -> PagedState:
    """An empty paged cache on ``device`` (default ``"cuda"``)."""
    dev = resolve_device(device)
    shape = (pc.n_layers, pc.n_pages, pc.page_size, pc.n_kv_heads,
             pc.head_dim)

    def i32(*shape, fill=0):
        return torch.full(shape, fill, dtype=I32, device=dev)

    return PagedState(
        table=Table.create(pc.table, dev),
        pages_k=torch.zeros(shape, dtype=pc.torch_dtype, device=dev),
        pages_v=torch.zeros(shape, dtype=pc.torch_dtype, device=dev),
        page_alloc=i32(), free_pages=i32(pc.n_pages), free_top=i32(),
        lengths=i32(pc.batch), seq_ids=i32(pc.batch, fill=-1))


def _on(st: PagedState, x, dtype=I32):
    """A host array or a tensor as ``dtype`` on the state's device."""
    return _tensor(x, dtype, st.lengths.device)


def admit(pc: PagedConfig, st: PagedState, slot_mask, new_seq_ids):
    """Admit new sequences into empty slots (slot_mask bool[batch])."""
    slot_mask = _on(st, slot_mask, torch.bool)
    seq_ids = torch.where(slot_mask, _on(st, new_seq_ids), st.seq_ids)
    lengths = torch.where(slot_mask, 0, st.lengths)
    return st._replace(seq_ids=seq_ids, lengths=lengths)


def evict(pc: PagedConfig, st: PagedState, slot_mask):
    """Evict sequences: per block, a lookup of the slots' mappings (to free
    their pages), a batched DELETE of them (the paper's delete path) and a
    push of the freed pages onto the free stack."""
    slot_mask = _on(st, slot_mask, torch.bool)
    tbl, free_pages, free_top = st.table, st.free_pages, st.free_top
    seq = torch.where(slot_mask, st.seq_ids, 0)
    live_slot = slot_mask & (st.seq_ids >= 0)
    for b in range(pc.max_blocks):
        keys = _key(seq, torch.full_like(seq, b))
        live = live_slot & (b * pc.page_size < st.lengths)
        # look up the page first (to free it), then delete the mapping
        found, meta = tbl.lookup(keys)
        do = live & found
        kinds = torch.where(do, T.DEL, T.NOP).to(I32)
        tbl, _ = tbl.apply(kinds, keys)
        pos = free_top + torch.cumsum(do, 0) - 1
        masked_put(free_pages, (pos,), meta["page"], do)
        free_top = free_top + do.sum().to(I32)
    return st._replace(
        table=tbl, free_pages=free_pages, free_top=free_top,
        seq_ids=torch.where(slot_mask, -1, st.seq_ids),
        lengths=torch.where(slot_mask, 0, st.lengths))


def _step_transaction(pc: PagedConfig, st: PagedState):
    """The decode step's single table transaction.

    Allocates physical pages for slots crossing a block boundary and
    upserts every active slot's mapping with fresh {page, length} metadata
    (one combining transaction — the paper's n-thread announce). Returns
    (table', page [B], offset [B], page_alloc', free_top', lengths')."""
    active = st.seq_ids >= 0
    pos = st.lengths
    block = pos // pc.page_size
    offset = pos % pc.page_size
    need_page = active & (offset == 0)

    # physical page allocation: free stack first, then the watermark
    take_rank = torch.cumsum(need_page, 0).to(I32) - 1
    from_stack = take_rank < st.free_top
    sidx = (st.free_top - 1 - take_rank).clamp(0, pc.n_pages - 1)
    new_page = torch.where(from_stack, st.free_pages[sidx.long()],
                           st.page_alloc + take_rank - st.free_top)
    n_need = need_page.sum().to(I32)
    pop = torch.minimum(n_need, st.free_top)
    grow = n_need - pop

    # rule-A pre-read of the current mapping (mid-block slots keep their
    # page; boundary slots take the fresh allocation)
    keys = _key(st.seq_ids, block)
    _, meta = st.table.lookup(keys)
    page = torch.where(need_page, new_page, meta["page"])
    page = torch.where(active, page, 0).to(I32)

    kinds = torch.where(active, T.INS, T.NOP).to(I32)
    table, _res = st.table.apply(
        kinds, keys, {"page": page, "length": offset + 1})
    return (table, page, offset, st.page_alloc + grow, st.free_top - pop,
            torch.where(active, pos + 1, pos))


def allocate_slots(pc: PagedConfig, st: PagedState):
    """One combining transaction per decode step (see _step_transaction),
    resolving every slot's current (page, offset). Returns (st', page [B],
    offset [B])."""
    table, page, offset, page_alloc, free_top, lengths = \
        _step_transaction(pc, st)
    st = st._replace(table=table, page_alloc=page_alloc, free_top=free_top,
                     lengths=lengths)
    return st, page, offset


def append_token(pc: PagedConfig, st: PagedState, k_new, v_new):
    """Write one token's K/V (``[L, B, KV, hd]``) for every active slot,
    allocating pages at block boundaries through the step's transaction.
    Only the active slots' entries are written."""
    active = st.seq_ids >= 0
    table, page, offset, page_alloc, free_top, lengths = \
        _step_transaction(pc, st)
    for i in range(pc.n_layers):
        masked_put(st.pages_k[i], (page, offset), k_new[i], active)
        masked_put(st.pages_v[i], (page, offset), v_new[i], active)
    return st._replace(table=table, page_alloc=page_alloc,
                       free_top=free_top, lengths=lengths)


# ---------------------------------------------------------------------------
# durable images & drain-free handover (core/snapshot.py)


def _check_geometry(pc_old: PagedConfig, pc_new: PagedConfig,
                    page_alloc: int, max_len: int) -> None:
    """Reject handover targets the live cache cannot reseat into."""
    same = ("n_layers", "n_kv_heads", "head_dim", "page_size", "dtype")
    for f in same:
        if getattr(pc_old, f) != getattr(pc_new, f):
            raise ValueError(
                f"handover cannot change {f}: {getattr(pc_old, f)} -> "
                f"{getattr(pc_new, f)} (page contents would be "
                "reshaped/re-encoded)")
    if pc_new.n_pages < page_alloc:
        raise ValueError(
            f"handover target has n_pages={pc_new.n_pages} but "
            f"{page_alloc} pages are already allocated; grow n_pages")
    if pc_new.batch < pc_old.batch:
        raise ValueError(
            f"handover target batch={pc_new.batch} < current batch="
            f"{pc_old.batch}; slots are positional — shrink by evicting "
            "first")
    if pc_new.max_blocks * pc_new.page_size < max_len:
        raise ValueError(
            f"handover target max_blocks={pc_new.max_blocks} holds "
            f"{pc_new.max_blocks * pc_new.page_size} tokens but a live "
            f"sequence has {max_len}; grow max_blocks (truncation would "
            "silently drop attention context and leak page mappings)")


def _tensor(x, dtype, dev):
    """A host array or a tensor as ``dtype`` on ``dev``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x.to(device=dev, dtype=dtype)


def _reseat(pc_old: PagedConfig, pc_new: PagedConfig, table: Table,
            pages_k, pages_v, page_alloc, free_pages, free_top,
            lengths, seq_ids) -> PagedState:
    """Re-house a cache's content in ``pc_new``'s geometry on the table's
    device: page ids and slot positions are preserved verbatim (the
    page-table image carries the ids in its value schema), page and slot
    arrays grow."""
    dev = table.device
    rows = min(pc_old.n_pages, pc_new.n_pages)
    shape = (pc_new.n_layers, pc_new.n_pages, pc_new.page_size,
             pc_new.n_kv_heads, pc_new.head_dim)
    dt = pc_new.torch_dtype
    new_k = torch.zeros(shape, dtype=dt, device=dev)
    new_k[:, :rows] = _tensor(pages_k[:, :rows], dt, dev)
    new_v = torch.zeros(shape, dtype=dt, device=dev)
    new_v[:, :rows] = _tensor(pages_v[:, :rows], dt, dev)
    ft = int(free_top)
    new_free = torch.zeros(pc_new.n_pages, dtype=I32, device=dev)
    new_free[:ft] = _tensor(free_pages[:ft], I32, dev)
    pad = pc_new.batch - pc_old.batch
    new_len = torch.cat([_tensor(lengths, I32, dev),
                         torch.zeros(pad, dtype=I32, device=dev)])
    new_seq = torch.cat([_tensor(seq_ids, I32, dev),
                         torch.full((pad,), -1, dtype=I32, device=dev)])
    return PagedState(
        table=table, pages_k=new_k, pages_v=new_v,
        page_alloc=torch.tensor(int(page_alloc), dtype=I32, device=dev),
        free_pages=new_free, free_top=torch.tensor(ft, dtype=I32, device=dev),
        lengths=new_len, seq_ids=new_seq)


def handover(pc_old: PagedConfig, st: PagedState,
             pc_new: PagedConfig) -> PagedState:
    """Drain-free in-memory handover to a new (usually bigger) geometry.

    The page table goes through the canonical image (extract → replay into
    ``pc_new.table``, which may deepen the directory or resize pools); the
    K/V pages, allocator and slot registry reseat directly because page
    ids and slot positions survive the image round trip. No request is
    drained: the successor engine decodes the very next token."""
    _check_geometry(pc_old, pc_new, int(st.page_alloc),
                    int(st.lengths.max()))
    table = snapshot.restore_from_image(snapshot.extract_image(st.table),
                                        pc_new.table, st.table.device)
    return _reseat(pc_old, pc_new, table, st.pages_k, st.pages_v,
                   st.page_alloc, st.free_pages, st.free_top,
                   st.lengths, st.seq_ids)


# the PagedConfig geometry recorded in engine.npz so restore checks the
# SAVED geometry (not the target against itself); dtype rides separately
# as a string
_GEOMETRY_FIELDS = ("batch", "n_pages", "n_layers", "n_kv_heads",
                    "head_dim", "page_size", "max_blocks")


def _np(x):
    """A host array of ``x``; bf16 as its exact fp32 upcast."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    arr = np.asarray(x)
    return arr.astype(np.float32) if arr.dtype.name == "bfloat16" else arr


def save_paged(pc: PagedConfig, st: PagedState, path: str,
               extras: dict | None = None) -> str:
    """Durable image of the whole paged cache at directory ``path``, the
    JAX package's: ``table.npz`` (the canonical page-table image) +
    ``engine.npz`` (K/V pages, page allocator, slot registry, saved
    geometry, and ``extras`` as ``extra__<name>``). bf16 pages are stored
    as their exact fp32 upcast. The directory is written to ``path.tmp``
    and renamed, so a crash mid-save never leaves a mixed-generation
    image."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    st.table.save(os.path.join(tmp, "table.npz"))
    geometry = {f: np.int32(getattr(pc, f)) for f in _GEOMETRY_FIELDS}
    extras = {f"extra__{k}": _np(v) for k, v in (extras or {}).items()}
    with open(os.path.join(tmp, "engine.npz"), "wb") as f:
        np.savez(f, pages_k=_np(st.pages_k), pages_v=_np(st.pages_v),
                 page_alloc=_np(st.page_alloc), free_pages=_np(st.free_pages),
                 free_top=_np(st.free_top), lengths=_np(st.lengths),
                 seq_ids=_np(st.seq_ids), dtype=np.asarray(pc.dtype),
                 **geometry, **extras)
    # swap generations without ever deleting the only durable image: the
    # previous image survives at path.old until the new one is in place
    if os.path.exists(path):
        old = path + ".old"
        if os.path.exists(old):
            shutil.rmtree(old)
        os.rename(path, old)
        os.rename(tmp, path)  # atomicity point
        shutil.rmtree(old)
    else:
        os.rename(tmp, path)  # atomicity point
    return path


def load_extra(path: str, name: str):
    """Read one ``extras`` array back from a :func:`save_paged` image."""
    with np.load(os.path.join(path, "engine.npz")) as z:
        return np.asarray(z[f"extra__{name}"])


def restore_paged(pc_new: PagedConfig, path: str, device=None) -> PagedState:
    """Warm-start a paged cache from a :func:`save_paged` image (written by
    either package) on ``device`` (default ``"cuda"``). ``pc_new`` may
    differ from the saving config under the rules of :func:`handover`; the
    saved geometry is read from the image."""
    table = Table.restore(os.path.join(path, "table.npz"), pc_new.table,
                          device)
    with np.load(os.path.join(path, "engine.npz")) as z:
        saved = {f: int(z[f]) for f in _GEOMETRY_FIELDS}
        saved["dtype"] = str(z["dtype"])
        pc_old = dataclasses.replace(pc_new, **saved)
        _check_geometry(pc_old, pc_new, int(z["page_alloc"]),
                        int(np.asarray(z["lengths"]).max(initial=0)))
        return _reseat(pc_old, pc_new, table, z["pages_k"], z["pages_v"],
                       z["page_alloc"], z["free_pages"], z["free_top"],
                       z["lengths"], z["seq_ids"])


def gather_kv(pc: PagedConfig, st: PagedState):
    """Materialize each slot's K/V view [L, B, max_blocks*page, KV, hd]
    through rule-A lookups, with per-slot lengths derived from the
    mappings' ``length`` metadata (the max over a slot's blocks of
    ``block*page_size + length``), not from the engine's counters."""
    B = pc.batch
    blocks = torch.arange(pc.max_blocks, dtype=I32, device=st.lengths.device)
    keys = _key(st.seq_ids[:, None], blocks[None, :]).reshape(-1)
    found, meta = st.table.lookup(keys)
    page = torch.where(found, meta["page"], 0).reshape(B, pc.max_blocks)
    fnd = found.reshape(B, pc.max_blocks)
    filled = meta["length"].reshape(B, pc.max_blocks)
    lengths = torch.where(fnd, blocks[None, :] * pc.page_size + filled,
                          0).amax(dim=1).to(I32)
    Lx = pc.n_layers
    S = pc.max_blocks * pc.page_size
    k = st.pages_k[:, page.long()].reshape(Lx, B, S, pc.n_kv_heads,
                                           pc.head_dim)
    v = st.pages_v[:, page.long()].reshape(Lx, B, S, pc.n_kv_heads,
                                           pc.head_dim)
    return k, v, lengths
