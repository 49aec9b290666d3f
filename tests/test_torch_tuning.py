"""The port's tile tuning (``repro_torch/kernels/tuning.py``) against the
JAX package's (``repro/kernels/tuning.py``).

Counterparts of ``tests/test_plan.py``'s autotune tests and
``tests/test_kernels.py::test_tile_tuning_env_and_registry``: the measured
sweep (a cold sweep, then a cache hit with the registry cleared and the
runner never called), the cache keyed by backend tag, raising candidates
skipped and, where the port diverges on purpose, every candidate raising
makes ``autotune`` raise; the key schema, the registry's collision and
override rules, and the heuristic. The key strings and the keys refused
are the JAX module's. The JAX module's environment overrides
(``REPRO_TILE_*``, ``REPRO_TUNE_CACHE``, ``REPRO_AUTOTUNE``) map to a test
that the port reads none. Every test here points the on-disk cache at its
own temporary file. A ``cuda``-marked test resolves a measured plan on the
card.
"""
import dataclasses
import json

import pytest
import torch

from repro_torch.kernels import tuning
from repro_torch.table_api import TableSpec

try:
    from repro.kernels import tuning as jtuning
except ModuleNotFoundError:
    # the GPU machine has no JAX: there only the cuda-marked test runs
    # (python -m pytest -m cuda tests/test_torch_tuning.py)
    jtuning = None

needs_jax = pytest.mark.skipif(jtuning is None, reason="needs JAX")


@pytest.fixture(autouse=True)
def cache(tmp_path, monkeypatch):
    """Each test gets an empty registry and its own cache file."""
    path = tmp_path / "tile_cache.json"
    monkeypatch.setattr(tuning, "cache_path", lambda: path)
    tuning.clear_registry()
    yield path
    tuning.clear_registry()


# ---------------------------------------------------------------------------
# the measured sweep


def test_autotune_cold_sweep_then_warm_hit(cache):
    key = tuning.tile_key("lookup", dmax=6, pool_size=64, n_lanes=8)
    cands = [tuning.TileConfig(block=32), tuning.TileConfig(block=128)]
    calls = []
    before = tuning.autotune.runner_calls

    win = tuning.autotune(key, cands, calls.append, iters=2,
                          backend_tag="cpu", device="cpu")
    assert win in cands
    # one warm-up and two timed calls a candidate
    assert len(calls) == 2 * 3
    assert tuning.autotune.runner_calls - before == len(calls)
    entry = json.loads(cache.read_text())[f"cpu::{key}"]
    assert tuning.TileConfig(**entry["tiles"]) == win
    assert entry["iters"] == 2 and entry["mean_s"] >= 0.0
    assert entry["measured_at"] > 0

    # warm: the persisted winner comes back WITHOUT running anything, even
    # with the in-process registry wiped (a fresh process)
    tuning.clear_registry()
    n_cold = tuning.autotune.runner_calls
    win2 = tuning.autotune(key, cands, calls.append, iters=2,
                           backend_tag="cpu", device="cpu")
    assert win2 == win and len(calls) == 6
    assert tuning.autotune.runner_calls == n_cold
    # and the hit re-pinned the registry for pick_tiles
    assert tuning.pick_tiles(8, key=key) == tuning.clamp_tiles(win, 8)


def test_autotune_cache_is_backend_keyed(cache):
    key = tuning.tile_key("apply", dmax=6, pool_size=64, n_lanes=8)
    cands = [tuning.TileConfig(chunk=1024)]
    calls = []
    tuning.autotune(key, cands, calls.append, iters=1, backend_tag="cpu",
                    device="cpu")
    n = len(calls)
    # another tag is another card or kernel build: a full re-measure
    tuning.autotune(key, cands, calls.append, iters=1,
                    backend_tag="NVIDIA H100 80GB HBM3/sm_90/0123abcd",
                    device="cpu")
    assert len(calls) > n
    assert tuning.cached_tiles(key, "cpu") is not None
    assert tuning.cached_tiles(
        key, "NVIDIA H100 80GB HBM3/sm_90/0123abcd") is not None
    assert tuning.cached_tiles(key, "NVIDIA H100 80GB HBM3/sm_90/"
                               "fedcba98") is None
    # the tag defaults to the device's: "cpu" on the CPU
    assert tuning.device_tag("cpu") == "cpu"
    tuning.clear_registry()
    assert tuning.autotune(key, cands, calls.append, iters=1,
                           device="cpu") == cands[0]
    assert len(calls) == n + 2          # "cpu" hit: nothing ran


def test_autotune_skips_raising_candidates():
    key = tuning.tile_key("lookup", dmax=4, pool_size=16, n_lanes=8)
    good = tuning.TileConfig(block=128)

    def run(t):
        if t != good:
            raise RuntimeError("launch failed")

    win = tuning.autotune(key, [tuning.TileConfig(block=32), good], run,
                          iters=1, backend_tag="x", device="cpu")
    assert win == good


def test_autotune_runs_on_the_card_by_default(cache, monkeypatch):
    """An entry point runs on the card unless the caller names another
    device: ``autotune`` with no ``device`` times its candidates on
    ``cuda``, and raises before running anything where there is no card."""
    key = tuning.tile_key("lookup", dmax=6, pool_size=64, n_lanes=8)
    cands = [tuning.TileConfig(block=32)]
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tuning.autotune(key, cands, calls.append, iters=1, backend_tag="x")
    assert calls == []
    seen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tuning, "_mean_s",
                        lambda run, tiles, iters, device: seen.append(
                            device) or 1.0)
    assert tuning.autotune(key, cands, calls.append, iters=1,
                           backend_tag="x") == cands[0]
    assert [d.type for d in seen] == ["cuda"]


@needs_jax
def test_autotune_raises_when_every_candidate_raises(cache):
    """The deliberate divergence: the JAX autotuner falls back to the
    default tiles; here a kernel that cannot launch is not hidden."""
    key = tuning.tile_key("apply", dmax=4, pool_size=16, n_lanes=8)

    def run(t):
        raise RuntimeError(f"cudaError_t 1 at {t}")

    with pytest.raises(RuntimeError, match="every candidate raised"):
        tuning.autotune(key, [tuning.TileConfig(chunk=1024),
                              tuning.TileConfig(chunk=2048)], run, iters=1,
                        backend_tag="x", device="cpu")
    assert not cache.exists() and tuning.cached_tiles(key, "x") is None
    assert tuning.pick_tiles(8, key=key) == tuning.clamp_tiles(
        tuning.TileConfig(), 8)
    # the JAX autotuner returns its default for the same sweep
    jkey = jtuning.tile_key("apply", dmax=4, pool_size=16, n_lanes=8)
    assert jtuning.autotune(jkey, [jtuning.TileConfig(8, 8, 8)], run,
                            iters=1, backend_tag="x", use_cache=False) == \
        jtuning.TileConfig()
    jtuning.clear_registry()


# ---------------------------------------------------------------------------
# keys, registry and heuristic


GEOMETRIES = [dict(dmax=6, pool_size=64, n_lanes=8),
              dict(dmax=20, pool_size=2**20, n_lanes=512),
              dict(dmax=20, pool_size=2**20, n_lanes=4096),
              dict(dmax=0, pool_size=1, n_lanes=1)]
BAD_KEYS = ["k1", "free-form", "", "lookup/d6/p64", "lookup/d6/p64/n8/x",
            "probe/d6/p64/n8", "Lookup/d6/p64/n8", "lookup/d-1/p64/n8",
            "lookup/d6/p64/n8 ", "apply/dx/p64/n8"]


@needs_jax
@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("kind", ["lookup", "apply"])
def test_keys_equal_the_jax_keys(kind, geom):
    key = tuning.tile_key(kind, **geom)
    assert key == jtuning.tile_key(kind, **geom)
    assert (tuning.validate_key(key).groupdict()
            == jtuning.validate_key(key).groupdict())
    assert tuning.TILE_KINDS == jtuning.TILE_KINDS


@needs_jax
@pytest.mark.parametrize("key", BAD_KEYS)
def test_bad_keys_refused_like_jax(key):
    for mod in (tuning, jtuning):
        with pytest.raises(ValueError, match="plan schema"):
            mod.validate_key(key)
        with pytest.raises(ValueError, match="plan schema"):
            mod.register_tiles(key, mod.TileConfig())
        with pytest.raises(ValueError, match="plan schema"):
            mod.cached_tiles(key, "x")
    if key:   # pick_tiles takes "" as "no key", in both packages
        with pytest.raises(ValueError, match="plan schema"):
            tuning.pick_tiles(64, key=key)
        with pytest.raises(ValueError, match="plan schema"):
            jtuning.pick_tiles(64, 64, key=key)
    with pytest.raises(ValueError, match="kind"):
        tuning.tile_key("probe", dmax=6, pool_size=64, n_lanes=8)


@needs_jax
def test_tile_registry_and_heuristic():
    # the heuristic: the CUDA kernels' defaults, clamped to the launch
    assert tuning.TileConfig() == tuning.TileConfig(block=64, chunk=4096)
    assert tuning.pick_tiles(4096) == tuning.TileConfig(64, 4096)
    assert tuning.pick_tiles(1100) == tuning.TileConfig(64, 2048)
    assert tuning.pick_tiles(512) == tuning.TileConfig(64, 1024)
    assert tuning.pick_tiles(10_000) == tuning.TileConfig(64, 4096)
    key = tuning.tile_key("lookup", dmax=6, pool_size=1000, n_lanes=64)
    tuning.register_tiles(key, tuning.TileConfig(block=32, chunk=2048),
                          override=True)
    assert tuning.pick_tiles(64, key=key) == tuning.TileConfig(32, 1024)
    assert tuning.pick_tiles(64).block == 64      # other keys: heuristic
    with pytest.raises(TypeError, match="TileConfig"):
        tuning.register_tiles(key, jtuning.TileConfig())
    # colliding re-registration (other tiles, same key) raises ...
    with pytest.raises(ValueError, match="collision"):
        tuning.register_tiles(key, tuning.TileConfig(block=256))
    # ... but idempotent and explicit-override writes are fine
    tuning.register_tiles(key, tuning.TileConfig(block=32, chunk=2048))
    tuning.register_tiles(key, tuning.TileConfig(block=256), override=True)
    assert tuning.pick_tiles(64, key=key).block == 256
    tuning.clear_registry()
    assert tuning.pick_tiles(64, key=key).block == 64


@pytest.mark.parametrize("t,n,want", [
    (tuning.TileConfig(), 8, (64, 1024)),
    (tuning.TileConfig(), 1025, (64, 2048)),
    (tuning.TileConfig(), 2049, (64, 4096)),
    (tuning.TileConfig(block=16, chunk=512), 8, (32, 1024)),
    (tuning.TileConfig(block=100, chunk=3000), 4096, (64, 2048)),
    (tuning.TileConfig(block=1024, chunk=8192), 9000, (256, 4096)),
])
def test_clamp_tiles(t, n, want):
    got = tuning.clamp_tiles(t, n)
    assert (got.block, got.chunk) == want
    assert got.block in tuning.BLOCKS and got.chunk in tuning.CHUNKS


def test_default_candidates():
    lk = tuning.default_candidates("lookup", 512)
    assert [c.block for c in lk] == [32, 64, 128, 256]
    assert {c.chunk for c in lk} == {1024}
    assert [c.chunk for c in tuning.default_candidates("apply", 512)] == \
        [1024]
    assert [c.chunk for c in tuning.default_candidates("apply", 1100)] == \
        [1024, 2048]
    assert [c.chunk for c in tuning.default_candidates("apply", 4096)] == \
        [1024, 2048, 4096]
    with pytest.raises(ValueError, match="kind"):
        tuning.default_candidates("probe", 8)


@needs_jax
def test_tiles_read_no_environment(monkeypatch, tmp_path):
    """The JAX module's overrides (``REPRO_TILE_TQ`` wins over the registry
    there, ``REPRO_TUNE_CACHE`` moves the cache, ``REPRO_AUTOTUNE`` forces
    a policy) change nothing here: ``register_tiles`` and
    ``TableSpec.autotune`` take their place."""
    spec = dict(dmax=6, bucket_size=4, pool_size=64, n_lanes=8,
                backend="cuda")
    key = tuning.tile_key("lookup", dmax=6, pool_size=64, n_lanes=8)
    tuning.register_tiles(key, tuning.TileConfig(block=32))
    want = (tuning.pick_tiles(8, key=key), tuning.cache_path(),
            TableSpec(**spec).plan("cpu"))
    for var, value in (("REPRO_TILE_TQ", "8"), ("REPRO_TILE_PC", "16"),
                       ("REPRO_TILE_DC", "16"), ("REPRO_AUTOTUNE", "measured"),
                       ("REPRO_TUNE_CACHE", str(tmp_path / "elsewhere.json")),
                       ("REPRO_FORCE_INTERPRET", "1")):
        monkeypatch.setenv(var, value)
    plan = TableSpec(**spec).plan("cpu")
    assert (tuning.pick_tiles(8, key=key), tuning.cache_path(), plan) == want
    assert plan.source == "heuristic" and plan.lookup_tiles.block == 32
    assert not (tmp_path / "elsewhere.json").exists()
    # while the JAX module follows REPRO_TILE_TQ
    assert jtuning.pick_tiles(8, 64).tq == 8


def test_tile_config_is_frozen_and_hashable():
    t = tuning.TileConfig(block=32, chunk=2048)
    with pytest.raises(dataclasses.FrozenInstanceError):
        t.block = 64
    assert {t: 1}[tuning.TileConfig(32, 2048)] == 1


# ---------------------------------------------------------------------------
# on the card


@pytest.mark.cuda
def test_measured_plan_on_the_card(cache):
    """The measured plan resolves on the card: the sweep runs (source
    ``measured``), then, with the registry cleared, the cache answers
    (source ``cache``, no runner call, the same tiles); the tag names the
    card, its compute capability and the kernels' build."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import _build
    tag = tuning.device_tag("cuda")
    assert tag.endswith("/" + _build.build_dir().name) and "/sm_" in tag
    # the second is the wide geometry: 4,096 lanes over 2**20 rows
    for geom in (dict(dmax=12, bucket_size=8, pool_size=4096, n_lanes=512),
                 dict(dmax=20, bucket_size=8, pool_size=2**20,
                      n_lanes=4096)):
        spec = dict(geom, backend="cuda", autotune="measured")
        calls = tuning.autotune.runner_calls
        first = TableSpec(**spec).plan("cuda")
        assert first.source == "measured"
        assert tuning.autotune.runner_calls > calls
        tuning.clear_registry()
        calls = tuning.autotune.runner_calls
        again = TableSpec(**spec).plan("cuda")
        assert again.source == "cache" and again == first
        assert tuning.autotune.runner_calls == calls
        assert first.lookup_tiles.block in tuning.BLOCKS
        assert first.apply_tiles.chunk in tuning.CHUNKS
    entries = json.loads(cache.read_text())
    assert all(k.startswith(tag + "::") for k in entries)
