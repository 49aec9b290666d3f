"""Tile selection for the CUDA kernels: registry, heuristic and measured.

The counterpart of ``repro/kernels/tuning.py``. The Hopper kernels have
two launch shapes chosen at run time, one instantiation each, all built
together (``kernels/_build.py``):

  ``block``  threads of a probe block, one of :data:`BLOCKS`, shared by
             ``fused_probe`` and ``probe`` (``csrc/row_probe.cuh``);
  ``chunk``  lanes ``grouped_apply`` groups at once, one of
             :data:`CHUNKS` (``csrc/grouped_apply.cu``: 512 threads of 2,
             4 or 8 lanes each). A batch wider than its chunk is worked
             through chunk after chunk, in lane order.

``fused_apply`` takes no tile: its one 1,024-lane chunk is its lane bound.
The JAX fields ``tq`` / ``pc`` / ``dc`` tile VMEM and do not carry over.
Tiles never change a result, only the time. Resolution, strongest first:

  1. registry: in-process pins per plan key
     ``{kind}/d{dmax}/p{pool_size}/n{n_lanes}`` (the JAX schema, letter for
     letter), validated: unknown key forms raise, and re-registering
     *different* tiles for a key raises unless ``override=True``;
  2. heuristic: :class:`TileConfig`'s defaults, block 64 and chunk 4,096,
     clamped to the launch (:func:`clamp_tiles`).

No environment variable is read: the JAX module's ``REPRO_TILE_*`` and
``REPRO_TUNE_CACHE`` have no counterpart, and :func:`register_tiles` and
``TableSpec(autotune="measured")`` take their place.

:func:`autotune` is the measured sweep: it times candidate tiles with a
caller's runner (CUDA events on the card, the host clock on the CPU),
registers the fastest and persists it in an on-disk JSON cache keyed by
``(backend tag, plan key)``, so the sweep runs once per card, kernel build
and geometry. The cache is :func:`cache_path`,
``~/.cache/repro_torch/tile_cache.json`` unless the module attribute is
repointed; the backend tag (:func:`device_tag`) names the card, its
compute capability and the kernels' build directory, so that a changed
kernel source is measured again.
"""
from __future__ import annotations

import dataclasses
import json
import numbers
import os
import re
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

import torch

BLOCKS = (32, 64, 128, 256)
CHUNKS = (1024, 2048, 4096)


@dataclasses.dataclass(frozen=True)
class TileConfig:
    block: int = 64     # threads per probe block (fused_probe, probe)
    chunk: int = 4096   # lanes per grouped_apply chunk


def _one_of(v, allowed) -> bool:
    return (isinstance(v, numbers.Integral) and not isinstance(v, bool)
            and v in allowed)


def check_block(block: int) -> None:
    """Raise ``ValueError`` unless ``block`` is an integer in
    :data:`BLOCKS`."""
    if not _one_of(block, BLOCKS):
        raise ValueError(f"probe block {block!r} not in {BLOCKS}")


def check_chunk(chunk: int) -> None:
    """Raise ``ValueError`` unless ``chunk`` is an integer in
    :data:`CHUNKS`."""
    if not _one_of(chunk, CHUNKS):
        raise ValueError(f"grouped_apply chunk {chunk!r} not in {CHUNKS}")


# --------------------------------------------------------------------------
# key schema: one canonical spelling per (kernel kind, spec geometry)

TILE_KINDS = ("lookup", "apply")

_KEY_RE = re.compile(
    r"^(?P<kind>lookup|apply)/d(?P<dmax>\d+)/p(?P<pool>\d+)/n(?P<lanes>\d+)$")


def tile_key(kind: str, *, dmax: int, pool_size: int, n_lanes: int) -> str:
    """Canonical registry/cache key for one kernel-launch geometry."""
    if kind not in TILE_KINDS:
        raise ValueError(f"tile kind {kind!r} not in {TILE_KINDS}")
    return f"{kind}/d{dmax}/p{pool_size}/n{n_lanes}"


def validate_key(key: str) -> re.Match:
    """Check a key against the plan schema; raise ``ValueError`` otherwise.

    The schema is ``{kind}/d{dmax}/p{pool_size}/n{n_lanes}`` with ``kind``
    in :data:`TILE_KINDS`, the geometry the plan resolves tiles for."""
    m = _KEY_RE.match(key)
    if m is None:
        raise ValueError(
            f"tile key {key!r} does not match the plan schema "
            "'{kind}/d{dmax}/p{pool}/n{lanes}' with kind in "
            f"{TILE_KINDS} (see kernels.tuning.tile_key)")
    return m


_REGISTRY: Dict[str, TileConfig] = {}


def register_tiles(key: str, tiles: TileConfig, *,
                   override: bool = False) -> None:
    """Pin ``tiles`` for a plan-schema ``key`` (in-process).

    Raises ``ValueError`` for keys outside the plan schema and for
    collisions (an existing entry with *different* tiles) unless
    ``override=True``, and ``TypeError`` for anything but a
    :class:`TileConfig`."""
    validate_key(key)
    if not isinstance(tiles, TileConfig):
        raise TypeError(f"expected TileConfig, got {type(tiles).__name__}")
    prev = _REGISTRY.get(key)
    if prev is not None and prev != tiles and not override:
        raise ValueError(
            f"tile registry collision for {key!r}: {prev} is already "
            f"registered, refusing to overwrite with {tiles} "
            "(pass override=True to re-tune)")
    _REGISTRY[key] = tiles


def clear_registry() -> None:
    """Drop all in-process pins (tests / re-tuning)."""
    _REGISTRY.clear()


def _snap(v: int, allowed) -> int:
    """The largest allowed value at or below ``v``, else the smallest."""
    below = [a for a in allowed if a <= v]
    return max(below) if below else min(allowed)


def clamp_tiles(t: TileConfig, n_lanes: int) -> TileConfig:
    """Clamp a tile choice to one launch of ``n_lanes`` lanes: ``block``
    snapped into :data:`BLOCKS`; ``chunk`` snapped into :data:`CHUNKS` and
    at most the smallest chunk that holds the batch (a chunk sorts all of
    its lanes, padding included)."""
    fits = [c for c in CHUNKS if c >= n_lanes]
    cap = min(fits) if fits else max(CHUNKS)
    return TileConfig(block=_snap(t.block, BLOCKS),
                      chunk=min(_snap(t.chunk, CHUNKS), cap))


def pick_tiles(n_lanes: int, *, key: str = "") -> TileConfig:
    """Resolve tiles for launches of ``n_lanes`` lanes (registry >
    heuristic). ``key``, when given, must follow the plan schema."""
    if key:
        validate_key(key)
    return clamp_tiles(_REGISTRY.get(key, TileConfig()), n_lanes)


def default_candidates(kind: str, n_lanes: int) -> list[TileConfig]:
    """The measured sweep's candidates: every block for lookups, every
    chunk for applies, clamped to the launch and deduplicated (a narrow
    apply collapses to one chunk)."""
    if kind not in TILE_KINDS:
        raise ValueError(f"tile kind {kind!r} not in {TILE_KINDS}")
    grid = ([TileConfig(block=b) for b in BLOCKS] if kind == "lookup"
            else [TileConfig(chunk=c) for c in CHUNKS])
    out = []
    for t in grid:
        c = clamp_tiles(t, n_lanes)
        if c not in out:
            out.append(c)
    return out


# --------------------------------------------------------------------------
# on-disk measurement cache


def cache_path() -> Path:
    """The on-disk cache, ``~/.cache/repro_torch/tile_cache.json``. Tests
    and scripts repoint this module attribute."""
    return Path.home() / ".cache" / "repro_torch" / "tile_cache.json"


def device_tag(device) -> str:
    """What a measurement holds for: ``"cpu"`` on the CPU; on the card its
    name, ``sm_<major><minor>`` and the kernels' build directory (a hash of
    the sources and flags)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    from repro_torch.kernels import _build
    major, minor = torch.cuda.get_device_capability(dev)
    return (f"{torch.cuda.get_device_name(dev)}/sm_{major}{minor}/"
            f"{_build.build_dir().name}")


def _load_cache(path: Path) -> dict:
    try:
        with open(path) as f:
            data = json.load(f)
        return data if isinstance(data, dict) else {}
    except (OSError, ValueError):
        return {}


def _store_cache(path: Path, data: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def cached_tiles(key: str, backend_tag: str,
                 path: Optional[Path] = None) -> Optional[TileConfig]:
    """The persisted winner for ``(backend_tag, key)``, or None."""
    validate_key(key)
    entry = _load_cache(path or cache_path()).get(f"{backend_tag}::{key}")
    if not entry:
        return None
    try:
        return TileConfig(**entry["tiles"])
    except (KeyError, TypeError):
        return None


# device-side wait queued before a timed run, so that the CUDA events time
# the launches back to back and not the host's enqueueing (~10 ms)
_SLEEP_CYCLES = 20_000_000


def _mean_s(run: Callable[[TileConfig], None], tiles: TileConfig,
            iters: int, device: torch.device) -> float:
    """Mean seconds of ``run(tiles)`` over ``iters`` calls after one warm-up
    call: CUDA events around the calls on the card (``run`` must not
    synchronize), the host clock on the CPU."""
    run(tiles)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            run(tiles)
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize(device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(_SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        run(tiles)
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / 1e3 / iters


def autotune(key: str, candidates: Iterable[TileConfig],
             run: Callable[[TileConfig], None], iters: int = 5, *,
             backend_tag: str = "", use_cache: bool = True,
             path: Optional[Path] = None, device=None) -> TileConfig:
    """Measured tile sweep with an on-disk cache per ``(backend, key)``.

    On a cache hit the runner is never called: the persisted winner is
    registered and returned. On a miss each candidate is warmed by one
    ``run`` call and timed over ``iters`` more on ``device`` (default
    ``"cuda"``; see :func:`_mean_s`); the fastest is registered, persisted with
    ``{tiles, mean_s, iters, measured_at}`` and returned. A candidate that
    raises loses the sweep; if every candidate raises, so does
    ``autotune`` (a kernel that cannot launch is not hidden behind the
    default). ``backend_tag`` defaults to :func:`device_tag` of
    ``device``. Each runner call adds one to ``autotune.runner_calls``."""
    from repro_torch.core.table import resolve_device

    validate_key(key)
    device = resolve_device(device)
    tag = backend_tag or device_tag(device)
    path = path or cache_path()
    if use_cache:
        hit = cached_tiles(key, tag, path)
        if hit is not None:
            register_tiles(key, hit, override=True)
            return hit

    def counted(tiles):
        autotune.runner_calls += 1
        run(tiles)

    iters = max(1, iters)
    best, best_s, errors = None, float("inf"), []
    for tiles in candidates:
        try:
            dt = _mean_s(counted, tiles, iters, device)
        except Exception as e:  # noqa: BLE001 — a failing tile just loses
            errors.append((tiles, e))
            continue
        if dt < best_s:
            best, best_s = tiles, dt
    if best is None:
        raise RuntimeError(
            f"autotune {key!r}: every candidate raised: "
            + "; ".join(f"{t}: {e!r}" for t, e in errors)) from (
                errors[-1][1] if errors else None)
    register_tiles(key, best, override=True)
    if use_cache:
        data = _load_cache(path)
        data[f"{tag}::{key}"] = {"tiles": dataclasses.asdict(best),
                                 "mean_s": best_s, "iters": iters,
                                 "measured_at": time.time()}
        _store_cache(path, data)
    return best


autotune.runner_calls = 0


__all__ = [
    "TileConfig", "BLOCKS", "CHUNKS", "TILE_KINDS", "tile_key",
    "validate_key", "register_tiles", "clear_registry", "clamp_tiles",
    "pick_tiles", "default_candidates", "cache_path", "device_tag",
    "cached_tiles", "autotune", "check_block", "check_chunk",
]
