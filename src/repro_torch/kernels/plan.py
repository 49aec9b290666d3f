"""Kernel execution plans: backend selection resolved once, up front.

A :class:`KernelPlan` is resolved once per ``TableSpec`` and device type,
when the first table on that device type is built, and never re-read on
the hot path:

  ``"plain"``  the plain transaction (``core/table.py::apply_batch``) and
               the plain probe (``core/table.py::lookup``);
  ``"cuda"``   the kernels (``kernels/ops.py``). Within the fused apply
               kernel's bound (one thread block of at most 1024 lanes,
               bucket rows of at most 32 slots in registers) a write
               transaction is one ``fused_apply`` launch and a lookup one
               ``fused_probe`` launch. Beyond it writes route in PyTorch and
               launch ``grouped_apply`` on the ops in lane order, and
               lookups route in PyTorch and launch ``probe``: a table whose
               writes leave the fused kernel routes its lookups the same
               way, as the JAX package does past its own fused bounds. Ops
               that meet a full bucket take the ``ST_FULL`` slow path
               (``kernels/resize.py``). On CPU tensors each kernel wrapper
               runs its plain version, so this path also runs on the CPU.

``backend="auto"`` resolves to ``"cuda"`` on a CUDA device and to
``"plain"`` on the CPU. Every geometry has a plan.

The plan also carries the kernels' launch shapes (``kernels/tuning.py``):
``lookup_tiles.block`` for both probes, ``apply_tiles.chunk`` for
``grouped_apply``. With ``spec.autotune == "off"`` they are the
registry's pin for the geometry or the defaults (block 64, chunk 4,096),
clamped to the nominal width ``max(n_lanes, 8)``. With ``"measured"`` and
the ``"cuda"`` backend the plan times every candidate on a scratch table
of the spec's geometry on that device type, once per card, kernel build
and geometry, and keeps the winners in the on-disk cache; on CPU tensors
the sweep runs through the plain versions, so it runs on the CPU too.
``source`` says where the tiles came from. No environment variable is
read.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.apply import fused_apply_supported
from repro_torch.kernels.tuning import (TileConfig, autotune, cached_tiles,
                                        default_candidates, device_tag,
                                        pick_tiles, tile_key)

PLAN_BACKENDS = ("plain", "cuda")
SPEC_BACKENDS = ("auto",) + PLAN_BACKENDS
DEVICE_TYPES = ("cpu", "cuda")
AUTOTUNE_POLICIES = ("off", "measured")
TILE_SOURCES = ("heuristic", "measured", "cache")

# timed calls per candidate after one warm-up call
_TUNE_ITERS = 20


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """One table's resolved dispatch, as hashable static metadata.
    ``backend`` is post-resolution ("auto" never survives);
    ``fused_lookup`` / ``fused_apply`` select the fused kernels under
    ``"cuda"``; ``lookup_tiles`` / ``apply_tiles`` are the launch shapes
    (the JAX plan's fields of the same names). ``source`` records the
    tiles' provenance ("heuristic" | "measured" | "cache") and is excluded
    from equality and hash: provenance does not make another plan."""

    backend: str
    fused_lookup: bool = True
    fused_apply: bool = True
    lookup_tiles: TileConfig = TileConfig()
    apply_tiles: TileConfig = TileConfig()
    autotune: str = "off"
    source: str = dataclasses.field(default="heuristic", compare=False)

    def __post_init__(self):
        assert self.backend in PLAN_BACKENDS, self.backend
        assert self.autotune in AUTOTUNE_POLICIES, self.autotune
        assert self.source in TILE_SOURCES, self.source


def spread_rows(n: int, rows: int, device):
    """``n`` bucket ids spread evenly over ``rows`` pool rows, i32[n]
    (computed in 64 bits: ``n * rows`` passes 2**31 at 4,096 lanes over a
    2**20-row pool)."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return (i * rows // n).to(torch.int32)


def _measured_tiles(kind: str, cfg, fused_lookup: bool, device_type: str,
                    tag: str, n: int) -> TileConfig:
    """Tiles for one kind by timing real launches at ``n`` lanes on a
    scratch table of ``cfg``'s geometry on ``device_type`` (the
    counterpart of the JAX plan's runner): the lookup through
    ``_kernel_lookup_impl`` as the plan routes it, the apply through
    ``grouped_apply`` on ``n`` inserts of spread bucket ids. The scratch
    table is built on the first runner call, so a cache hit builds
    nothing."""
    from repro_torch.core import table as T
    from repro_torch.kernels import apply as kapply
    from repro_torch.kernels import ops as kops

    key = tile_key(kind, dmax=cfg.dmax, pool_size=cfg.pool_size, n_lanes=n)
    scratch = {}

    def runner(tiles: TileConfig):
        if not scratch:
            st = T.init_table(cfg, device_type)
            i = torch.arange(n, dtype=torch.int32, device=st.keys.device)
            scratch.update(st=st, i=i, ones=torch.ones_like(i),
                           bids=spread_rows(n, cfg.pool_size, i.device))
        st, i = scratch["st"], scratch["i"]
        if kind == "lookup":
            kops._kernel_lookup_impl(cfg, st, i, fused_lookup,
                                     block=tiles.block)
        else:
            kapply.grouped_apply(scratch["ones"], i, i, scratch["bids"],
                                 st.keys, st.vals, chunk=tiles.chunk)

    return autotune(key, default_candidates(kind, n), runner,
                    iters=_TUNE_ITERS, backend_tag=tag, device=device_type)


def resolve_plan(spec, device_type: str) -> KernelPlan:
    """Resolve ``spec.backend`` and ``spec.autotune`` for tables on
    ``device_type``. Reads only the spec's geometry, ``backend`` and
    ``autotune``."""
    if spec.backend not in SPEC_BACKENDS:
        raise ValueError(f"backend {spec.backend!r} not in {SPEC_BACKENDS}")
    if device_type not in DEVICE_TYPES:
        raise ValueError(f"device type {device_type!r} not in "
                         f"{DEVICE_TYPES}")
    if spec.autotune not in AUTOTUNE_POLICIES:
        raise ValueError(f"autotune {spec.autotune!r} not in "
                         f"{AUTOTUNE_POLICIES}")
    backend = spec.backend
    if backend == "auto":
        backend = "cuda" if device_type == "cuda" else "plain"
    fused = (backend == "cuda"
             and fused_apply_supported(spec.n_lanes, spec.bucket_size))

    cfg = spec.table_config()
    n = max(spec.n_lanes, 8)
    lkey = tile_key("lookup", dmax=cfg.dmax, pool_size=cfg.pool_size,
                    n_lanes=n)
    akey = tile_key("apply", dmax=cfg.dmax, pool_size=cfg.pool_size,
                    n_lanes=n)
    if backend == "cuda" and spec.autotune == "measured":
        tag = device_tag(device_type)
        hit = (cached_tiles(lkey, tag) is not None
               and cached_tiles(akey, tag) is not None)
        lookup_tiles = _measured_tiles("lookup", cfg, fused, device_type,
                                       tag, n)
        apply_tiles = _measured_tiles("apply", cfg, fused, device_type, tag,
                                      n)
        source = "cache" if hit else "measured"
    else:
        lookup_tiles = pick_tiles(n, key=lkey)
        apply_tiles = pick_tiles(n, key=akey)
        source = "heuristic"
    return KernelPlan(backend=backend, fused_lookup=fused, fused_apply=fused,
                      lookup_tiles=lookup_tiles, apply_tiles=apply_tiles,
                      autotune=spec.autotune, source=source)


__all__ = ["KernelPlan", "resolve_plan", "PLAN_BACKENDS", "SPEC_BACKENDS",
           "AUTOTUNE_POLICIES", "TILE_SOURCES"]
