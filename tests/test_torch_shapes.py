"""The PyTorch port's input-shape cells and per-architecture config modules
against the JAX package's.

* ``cells()`` lists the JAX package's 40 (arch, shape, supported, reason)
  cells, every reason word for word;
* every ``input_specs`` leaf (meta tensors) has the shape and dtype of the
  JAX ``ShapeDtypeStruct`` for all 40 cells at full width, and again with
  ``kv_quant="int8"``; the decode cache's keys are ``init_cache``'s;
* each of the ten per-architecture modules re-exports the config that
  ``archs.py`` holds under its name, field for field the JAX module's.
"""
import dataclasses
import importlib

import jax
import pytest
import torch

from repro.configs import archs as JA
from repro.configs import shapes as JS
from repro_torch.configs import archs as A
from repro_torch.configs import shapes as S
from repro_torch.models.model import init_cache
from repro_torch.training.checkpoint import _flat

jax.config.update("jax_platform_name", "cpu")

ARCH_MODULES = ["codeqwen1_5_7b", "deepseek_7b", "deepseek_moe_16b",
                "gemma_7b", "granite_moe_3b_a800m", "hymba_1_5b",
                "internvl2_2b", "mamba2_2_7b", "seamless_m4t_large_v2",
                "smollm_135m"]


def test_cells_match_jax():
    assert S.cells() == JS.cells()
    assert len(S.cells()) == 40
    assert sum(not ok for _, _, ok, _ in S.cells()) == 8
    assert {k: dataclasses.astuple(v) for k, v in S.SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in JS.SHAPES.items()}
    assert (S.LONG_CONTEXT_ARCHS, S.ENC_LEN) == (JS.LONG_CONTEXT_ARCHS,
                                                 JS.ENC_LEN)


def _jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in flat}


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("arch", sorted(A.ARCHS))
def test_input_specs_match_jax(arch, kv_quant):
    cfg = dataclasses.replace(A.get_config(arch), kv_quant=kv_quant)
    jcfg = dataclasses.replace(JA.get_config(arch), kv_quant=kv_quant)
    for shape in S.SHAPES:
        ours = _flat(S.input_specs(arch, shape, cfg))
        want = _jax_leaves(JS.input_specs(arch, shape, jcfg))
        assert sorted(ours) == sorted(want), (arch, shape)
        for k, leaf in ours.items():
            assert leaf.is_meta, (shape, k)
            assert tuple(leaf.shape) == tuple(want[k].shape), (shape, k)
            assert str(leaf.dtype).replace("torch.", "") == str(
                want[k].dtype), (shape, k)
        if S.SHAPES[shape].mode == "decode":
            assert set(ours) - {"tokens"} == {
                f"cache/{k}" for k in init_cache(cfg, 1, 1, 1, "meta")}
    # a Shape object stands for its name
    assert {k: tuple(v.shape) for k, v in _flat(S.input_specs(
        arch, S.SHAPES["decode_32k"], cfg)).items()} == {
        k: tuple(v.shape) for k, v in _flat(S.input_specs(
            arch, "decode_32k", cfg)).items()}


@pytest.mark.parametrize("module", ARCH_MODULES)
def test_arch_modules_match_jax(module):
    ours = importlib.import_module(f"repro_torch.configs.{module}").CONFIG
    want = importlib.import_module(f"repro.configs.{module}").CONFIG
    assert ours is A.get_config(ours.name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(want)
    assert isinstance(ours.torch_dtype, torch.dtype)
