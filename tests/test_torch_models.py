"""The PyTorch port's decode side of the model stack against the JAX
package's, on the CPU.

The JAX ``init_params`` tree crosses into the port through
``params_from_numpy``, so both packages hold the same weights; token
streams come from a numpy seed. Every ``smoke_config`` family runs
``decode_step`` for 4 steps in both packages (the counterpart of
``test_arch_smoke.py::test_decode_step_matches_cache_contract``): logits
and every cache leaf equal at rtol = atol = 1e-4 in float32 and 2e-2 in
bfloat16. The int8 KV cache and the segmented window-slice decode (the
counterparts of ``test_arch_smoke.py``'s last two tests) and the layers
(RMSNorm, RoPE, decode attention, the gated MLPs, MoE) are held the same
way.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import ARCHS as JARCHS
from repro.configs.archs import smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMoE
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as MoE

jax.config.update("jax_platform_name", "cpu")

B = 2
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
QUANT_STEPS = {"float32": 1, "bfloat16": 2}


def tree_np(t):
    if isinstance(t, dict):
        return {k: tree_np(v) for k, v in t.items()}
    return np.asarray(t)


def both(arch, seed, dtype="bfloat16", **kw):
    """(jax cfg, port cfg, jax params, port params): the same weights."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype=dtype, **kw)
    cfg = dataclasses.replace(smoke_config(arch), dtype=dtype, **kw)
    jp = JM.init_params(jcfg, jax.random.key(seed))
    return jcfg, cfg, jp, M.params_from_numpy(tree_np(jp), cfg, "cpu")


def close(got, want, tol, what):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


def run_decode(arch, dtype, steps, seed, max_len=32, **kw):
    """``steps`` decode steps through both packages on one token stream;
    logits and every cache leaf compared after each."""
    jcfg, cfg, jp, p = both(arch, seed, dtype, **kw)
    rng = np.random.default_rng(seed)
    enc = 64 if cfg.enc_layers else 0
    jc = JM.init_cache(jcfg, batch=B, max_len=max_len, enc_len=enc)
    c = M.init_cache(cfg, batch=B, max_len=max_len, enc_len=enc,
                     device="cpu")
    if cfg.enc_layers:
        mem = rng.standard_normal((B, enc, cfg.d_model)).astype(np.float32)
        jc["memory"] = jnp.asarray(mem, jcfg.jdtype)
        c["memory"] = torch.from_numpy(mem).to(cfg.torch_dtype)
    jstep = jax.jit(lambda p_, c_, t_: JM.decode_step(jcfg, p_, c_, t_))
    tol = TOL[dtype]
    tok = rng.integers(1, cfg.vocab_size, (B, 1)).astype(np.int32)
    for i in range(steps):
        jl, jc = jstep(jp, jc, jnp.asarray(tok))
        lg, c = M.decode_step(cfg, p, c, torch.from_numpy(tok))
        assert lg.shape == (B, 1, cfg.padded_vocab)
        assert lg.dtype == cfg.torch_dtype
        close(lg, jl, tol, f"{arch} step {i} logits")
        assert sorted(c) == sorted(jc)
        for k in jc:
            assert c[k].dtype == getattr(torch, str(jc[k].dtype)), k
            if c[k].dtype == torch.int8:
                # a quantized value moves with its input and its scale: one
                # step where float32 rounds a tie apart, two where bf16
                # inputs differ by an ulp (1/256 of up to 127 steps, twice)
                np.testing.assert_allclose(c[k].numpy(), np.asarray(jc[k]),
                                           atol=QUANT_STEPS[dtype],
                                           err_msg=k)
            else:
                close(c[k], jc[k], tol, f"{arch} step {i} cache {k}")
        tok = np.asarray(jl, np.float32).argmax(-1).astype(np.int32)
    assert c["length"].tolist() == [steps] * B
    return cfg, p, c


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_decode_step_matches_jax(arch, dtype):
    run_decode(arch, dtype, steps=4, seed=2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quant_int8_decode_matches_jax(dtype):
    """The int8 KV cache (quantized values within one step, scales and
    logits at the dtype's tolerance) through both packages, and the JAX
    test's own bound on the port: int8 logits track the bf16 cache's and
    the greedy token agrees."""
    run_decode("deepseek-7b", dtype, steps=8, seed=5, kv_quant="int8")
    cfg = smoke_config("deepseek-7b")
    qcfg = dataclasses.replace(cfg, kv_quant="int8")
    p = M.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    c_a = M.init_cache(cfg, batch=B, max_len=32, device="cpu")
    c_b = M.init_cache(qcfg, batch=B, max_len=32, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(5).integers(
        1, cfg.vocab_size, (B, 1)).astype(np.int32))
    for i in range(8):
        la, c_a = M.decode_step(cfg, p, c_a, tok)
        lb, c_b = M.decode_step(qcfg, p, c_b, tok)
        a, b = la.float(), lb.float()
        assert (a - b).abs().max() < 0.35 * max(a.abs().max().item(), 1.0), i
        assert torch.equal(a.argmax(-1), b.argmax(-1)), i
        tok = a.argmax(-1).to(torch.int32)


def test_segmented_window_slice_decode_matches_jax_and_uniform():
    """The segmented hybrid decode (windowed layers read a window slice)
    against the JAX package's, 40 steps past the 32-token window, and
    against the port's own uniform full-read stack."""
    cfg, p, c_seg = run_decode("hymba-1.5b", "bfloat16", steps=40, seed=6,
                               max_len=96, decode_window_slice=True)
    base = dataclasses.replace(cfg, decode_window_slice=False)
    c = M.init_cache(base, batch=B, max_len=96, device="cpu")
    c2 = M.init_cache(cfg, batch=B, max_len=96, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(6).integers(
        1, cfg.vocab_size, (B, 1)).astype(np.int32))
    for i in range(40):
        la, c = M.decode_step(base, p, c, tok)
        lb, c2 = M.decode_step(cfg, p, c2, tok)
        np.testing.assert_allclose(la.float().numpy(), lb.float().numpy(),
                                   rtol=2e-2, atol=2e-2, err_msg=f"step {i}")
        tok = la.argmax(-1).to(torch.int32)


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_init_params_tree_matches_jax(arch):
    """The port's tree has the JAX tree's keys, shapes and dtypes, and
    draws reproducibly from its generator."""
    jcfg = jax_smoke_config(arch)
    cfg = smoke_config(arch)
    want = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.key(0)))
    got = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def check(g, w, path=""):
        if isinstance(w, dict):
            assert isinstance(g, dict) and sorted(g) == sorted(w), path
            for k in w:
                check(g[k], w[k], f"{path}/{k}")
            return
        assert tuple(g.shape) == tuple(w.shape), path
        assert g.dtype == getattr(torch, str(w.dtype)), path
        assert torch.isfinite(g.float()).all(), path

    check(got, want)
    again = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(got["embed"], again["embed"])
    assert M.count_params(got) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(want))


def test_configs_are_the_jax_configs():
    """All ten configurations, field for field, and their smoke configs."""
    assert sorted(ARCHS) == sorted(JARCHS)
    for name in JARCHS:
        for port, ref in ((get_config(name), JARCHS[name]),
                          (smoke_config(name), jax_smoke_config(name))):
            assert dataclasses.asdict(port) == dataclasses.asdict(ref), name
            assert port.padded_vocab == ref.padded_vocab
            assert (port.e_pad, port.d_inner, port.ssm_heads) == (
                ref.e_pad, ref.d_inner, ref.ssm_heads)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("nope")


def test_params_from_numpy_checks_the_tree():
    jcfg, cfg, jp, _ = both("smollm-135m", 0)
    tree = tree_np(jp)
    tree["layers"]["mlp"]["w_up"] = tree["layers"]["mlp"]["w_up"][:, :1]
    with pytest.raises(ValueError, match="w_up has shape"):
        M.params_from_numpy(tree, cfg, "cpu")
    tree = tree_np(jp)
    tree["lm_head"] = tree["embed"]
    with pytest.raises(ValueError, match="parameter tree at /"):
        M.params_from_numpy(tree, cfg, "cpu")


def test_entry_points_run_on_cuda_unless_asked():
    """Without a card the default device raises; nothing falls back to the
    CPU unasked."""
    cfg = smoke_config("smollm-135m")
    if torch.cuda.is_available():
        assert M.init_cache(cfg, 1, 4)["length"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            M.init_cache(cfg, 1, 4)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            M.init_params(cfg, torch.Generator())
    with pytest.raises(NotImplementedError, match="training slice"):
        M.forward(cfg, {}, {})


# ---------------------------------------------------------------------------
# the layers, each against its JAX function


def arrays(rng, *shapes, dtype="bfloat16"):
    """(jax, torch) pairs of N(0, 1/n) arrays: n is the first axis of a 2-
    or 3-d weight (its contraction axis) where that exceeds 4, else 1, so
    that products stay O(1) and bf16 rounding stays relative."""
    out = []
    for s in shapes:
        fan_in = s[0] if len(s) in (2, 3) and s[0] > 4 else 1
        x = (rng.standard_normal(s) / fan_in ** 0.5).astype(np.float32)
        out.append((jnp.asarray(x, dtype),
                    torch.from_numpy(x).to(getattr(torch, dtype))))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope_match_jax(dtype):
    rng = np.random.default_rng(0)
    (jx, x), = arrays(rng, (3, 5, 4, 64), dtype=dtype)
    w = rng.standard_normal(64).astype(np.float32) * 0.1
    close(L.rms_norm(x, torch.from_numpy(w)),
          JL.rms_norm(jx, jnp.asarray(w)), TOL[dtype], "rms_norm")
    pos = rng.integers(0, 4096, (3, 5)).astype(np.int32)
    close(L.rope(x, torch.from_numpy(pos), 10000.0),
          JL.rope(jx, jnp.asarray(pos), 10000.0), TOL[dtype], "rope")


@pytest.mark.parametrize("window, partials", [(0, False), (5, False),
                                              (0, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_jax(dtype, window, partials):
    """GQA (8 heads over 2 KV heads), ragged lengths, a window, and bf16
    partial sums, dense and sliced."""
    rng = np.random.default_rng(1)
    (jq, q), (jk, k), (jv, v) = arrays(rng, (3, 1, 8, 16), (3, 24, 2, 16),
                                       (3, 24, 2, 16), dtype=dtype)
    length = np.array([1, 13, 24], np.int32)
    close(L.decode_attention(q, k, v, torch.from_numpy(length),
                             window=window, bf16_partials=partials),
          JL.decode_attention(jq, jk, jv, jnp.asarray(length), window=window,
                              bf16_partials=partials),
          TOL[dtype], "decode_attention")
    kpos = np.array([[0] * 8, [5 + i for i in range(8)],
                     [16 + i for i in range(8)]], np.int32)
    close(L.decode_attention_sliced(q, k[:, :8], v[:, :8],
                                    torch.from_numpy(kpos),
                                    torch.from_numpy(length),
                                    bf16_partials=partials),
          JL.decode_attention_sliced(jq, jk[:, :8], jv[:, :8],
                                     jnp.asarray(kpos), jnp.asarray(length),
                                     bf16_partials=partials),
          TOL[dtype], "decode_attention_sliced")


@pytest.mark.parametrize("activation", ["silu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_mlp_and_cross_attention_match_jax(dtype, activation):
    rng = np.random.default_rng(2)
    (jx, x), (jg, g), (ju, u), (jd, d), (jm, m) = arrays(
        rng, (2, 3, 32), (32, 48), (32, 48), (48, 32), (2, 7, 32),
        dtype=dtype)
    close(L.gated_mlp({"w_gate": g, "w_up": u, "w_down": d}, x,
                      activation=activation),
          JL.gated_mlp({"w_gate": jg, "w_up": ju, "w_down": jd}, jx,
                       activation=activation), TOL[dtype], "gated_mlp")
    ws = arrays(rng, (32, 4, 8), (32, 2, 8), (32, 2, 8), (4, 8, 32),
                dtype=dtype)
    names = ("wq", "wk", "wv", "wo")
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=8)
    close(L.cross_attention_block({n: w[1] for n, w in zip(names, ws)}, x,
                                  m, **kw),
          JL.cross_attention_block({n: w[0] for n, w in zip(names, ws)}, jx,
                                   jm, **kw), TOL[dtype], "cross attention")


@pytest.mark.parametrize("tied", [False, True])
def test_moe_block_matches_jax(tied):
    """The sort-based dispatch with capacity drops (2 shared + 8 routed
    experts padded to 16, top-2, 24 tokens) and, ``tied``, a zero router
    whose equal probabilities ``jax.lax.top_k`` breaks by the lower index:
    every token goes to experts 0 and 1 and most are dropped."""
    rng = np.random.default_rng(3)
    E, E_pad, D, Fd = 8, 16, 32, 16
    leaves = arrays(rng, (E_pad, D, Fd), (E_pad, D, Fd), (E_pad, Fd, D),
                    (D, 2 * Fd), (D, 2 * Fd), (2 * Fd, D), (4, 6, D),
                    dtype="float32")
    router = np.zeros((D, E_pad), np.float32) if tied else \
        rng.standard_normal((D, E_pad)).astype(np.float32)
    names = ("w_gate", "w_up", "w_down")
    jp = {n: w[0] for n, w in zip(names, leaves[:3])}
    p = {n: w[1] for n, w in zip(names, leaves[:3])}
    jp["shared"] = {n: w[0] for n, w in zip(names, leaves[3:6])}
    p["shared"] = {n: w[1] for n, w in zip(names, leaves[3:6])}
    jp["router"], p["router"] = jnp.asarray(router), torch.from_numpy(router)
    jx, x = leaves[6]
    kw = dict(n_experts=E, top_k=2, capacity_factor=1.25, n_shared=2)
    y, aux = MoE.moe_block(p, x, **kw)
    jy, jaux = JMoE.moe_block(jp, jx, **kw)
    close(y, jy, 1e-4, "moe y")
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    probs = torch.softmax(torch.zeros(3, E), -1)
    assert MoE.stable_top_k(probs, 2)[1].tolist() == [[0, 1]] * 3
