"""The PyTorch port's training forward against the JAX package's, on the
CPU: the counterpart of ``tests/test_arch_smoke.py``.

The JAX ``init_params`` tree crosses into the port through
``params_from_numpy``; inputs come from a numpy seed. Every
``smoke_config`` family's ``forward`` equals the JAX package's in logits
and MoE aux (rtol = atol = 1e-4 in float32, 2e-2 in bfloat16);
``flash_attention`` (causal, non-causal, sliding window, GQA, a length that
is not a chunk multiple, several chunks, both ``differentiable`` modes)
and ``ssd_chunked`` equal the JAX functions forward and under
``jax.grad``; the MoE block's aux loss and gradients equal ``jax.grad``'s;
the gradients of ``loss_fn`` equal ``jax.grad``'s for a dense, an MoE and a
hybrid family (float32, 1e-4 relative to the largest gradient); remat
changes nothing; and every family takes one train step with finite,
positive loss and moving parameters.
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
from repro.models import ssm as JS
from repro.training import train_step as JT
from repro_torch.configs import smoke_config
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as MoE
from repro_torch.models import ssm as S
from repro_torch.training import train_step as T
from repro_torch.training.optimizer import tree_leaves

jax.config.update("jax_platform_name", "cpu")

B, SEQ = 2, 64
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def tree_np(t):
    if isinstance(t, dict):
        return {k: tree_np(v) for k, v in t.items()}
    return np.asarray(t)


def both(arch, seed, dtype="bfloat16"):
    """(jax cfg, port cfg, jax params, port params): the same weights."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype=dtype)
    cfg = dataclasses.replace(smoke_config(arch), dtype=dtype)
    jp = JM.init_params(jcfg, jax.random.key(seed))
    return jcfg, cfg, jp, M.params_from_numpy(tree_np(jp), cfg, "cpu")


def make_batch(cfg, rng, seq=SEQ):
    """numpy batch: tokens, targets and the family's stub inputs."""
    batch = {
        "tokens": rng.integers(0, cfg.vocab_size, (B, seq)).astype(np.int32),
        "targets": rng.integers(0, cfg.vocab_size, (B, seq)).astype(np.int32),
    }
    if cfg.n_prefix_embeds:
        batch["prefix_embeds"] = rng.standard_normal(
            (B, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    if cfg.enc_layers:
        batch["enc_frames"] = rng.standard_normal(
            (B, seq, cfg.d_model)).astype(np.float32)
    return batch


def close(got, want, tol, what):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


def t_(x, grad=False):
    return torch.tensor(np.asarray(x, np.float32), requires_grad=grad)


# ---------------------------------------------------------------------------
# forward, every family


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_forward_matches_jax(arch, dtype):
    jcfg, cfg, jp, p = both(arch, 0, dtype)
    batch = make_batch(cfg, np.random.default_rng(0))
    jl, ja = jax.jit(lambda p_, b_: JM.forward(jcfg, p_, b_))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        lg, aux = M.forward(cfg, p, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    assert lg.shape == (B, SEQ, cfg.padded_vocab)
    assert lg.dtype == cfg.torch_dtype and aux.dtype == torch.float32
    close(lg, jl, TOL[dtype], f"{arch} logits")
    close(aux, ja, TOL[dtype], f"{arch} aux")
    if cfg.mlp_kind == "moe":
        assert float(aux) > 0


# ---------------------------------------------------------------------------
# flash attention and the SSD scan, forward and gradients


FLASH_CASES = {
    # name: (S, H, KV, chunk, causal, window)
    "causal": (96, 4, 4, 32, True, 0),
    "noncausal": (96, 4, 4, 32, False, 0),
    "window": (128, 4, 2, 32, True, 40),
    "gqa_ragged": (70, 6, 2, 32, True, 0),
    "window_ragged": (77, 4, 1, 16, True, 24),
    "noncausal_ragged": (50, 2, 1, 32, False, 0),
}


@pytest.mark.parametrize("differentiable", [False, True])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_matches_jax(case, differentiable):
    """Forward in float32 and bfloat16, and the gradient of a weighted sum
    of the output in float32: the port's skip-ahead loop against the JAX
    function in the same ``differentiable`` mode (the JAX gradient always
    through ``differentiable=True``, its only differentiable mode). A
    fully masked chunk adds nothing, so the two modes agree."""
    S_, H, KV, c, causal, window = FLASH_CASES[case]
    D = 16
    rng = np.random.default_rng(len(case) * 7 + S_)
    q, k, v = (rng.standard_normal((2, S_, h, D)).astype(np.float32)
               for h in (H, KV, KV))
    w = rng.standard_normal((2, S_, H, D)).astype(np.float32)
    kw = dict(causal=causal, window=window, chunk=c)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        want = JL.flash_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                  differentiable=differentiable, **kw)
        got = L.flash_attention(*(torch.from_numpy(x).to(dt)
                                  for x in (q, k, v)),
                                differentiable=differentiable, **kw)
        assert got.dtype == dt and got.shape == (2, S_, H, D)
        close(got, want, TOL[str(dt).split(".")[1]], f"{case} {dt}")

    def jloss(q_, k_, v_):
        return jnp.sum(JL.flash_attention(q_, k_, v_, differentiable=True,
                                          **kw) * w)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                               for x in (q, k, v)))
    qt, kt, vt = (t_(x, True) for x in (q, k, v))
    (L.flash_attention(qt, kt, vt, differentiable=differentiable, **kw)
     * torch.from_numpy(w)).sum().backward()
    for name, got, want in zip("qkv", (qt.grad, kt.grad, vt.grad), jg):
        assert torch.isfinite(got).all()
        close(got, want, 1e-4, f"{case} d{name}")


def test_flash_attention_fully_masked_rows_are_zero_not_nan():
    """A window shorter than the chunk leaves some rows of a visited
    chunk fully masked; the output stays finite and equals JAX's."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((1, 64, 2, 8)).astype(np.float32)
               for _ in range(3))
    kw = dict(causal=True, window=3, chunk=16)
    got = L.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), **kw)
    want = JL.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                              differentiable=True, **kw)
    assert torch.isfinite(got).all()
    close(got, want, 1e-5, "window 3")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_matches_jax(dtype):
    """Forward in both dtypes and ``jax.grad`` of a weighted sum in
    float32 (through x, dt, B, C and D), across 4 chunks: the mask before
    ``exp`` keeps the gradient finite. In bfloat16 the chunk's running sum
    of ``dt * A`` reaches tens, where a bf16 ulp is 0.25: JAX and PyTorch
    round that cumulative sum differently, so both bf16 outputs are held
    against the float32 JAX function at 2e-2 of its largest magnitude."""
    b, S_, H, Pd, N, c = 2, 64, 3, 8, 4, 16
    rng = np.random.default_rng(11)
    x = rng.standard_normal((b, S_, H, Pd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S_, H)))).astype(np.float32)
    A = -np.linspace(1.0, 4.0, H).astype(np.float32)
    Bm = rng.standard_normal((b, S_, N)).astype(np.float32)
    Cm = rng.standard_normal((b, S_, N)).astype(np.float32)
    Dv = np.ones(H, np.float32)
    w = rng.standard_normal((b, S_, H, Pd)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    args = (x, dt, A, Bm, Cm)
    want = JS.ssd_chunked(*(jnp.asarray(a, jdt) for a in args),
                          jnp.asarray(Dv), chunk=c)
    got = S.ssd_chunked(*(torch.from_numpy(a).to(tdt) for a in args),
                        torch.from_numpy(Dv), chunk=c)
    assert got.dtype == torch.float32      # D is float32: JAX promotes
    if dtype == "float32":
        close(got, want, TOL[dtype], f"ssd {dtype}")
    else:
        ref = np.asarray(JS.ssd_chunked(*(jnp.asarray(a) for a in args),
                                        jnp.asarray(Dv), chunk=c))
        bound = TOL[dtype] * np.abs(ref).max()
        assert np.abs(np.asarray(want, np.float32) - ref).max() < bound
        assert np.abs(got.numpy() - ref).max() < bound

    if dtype == "float32":
        jg = jax.grad(lambda *a: jnp.sum(JS.ssd_chunked(*a, chunk=c) * w),
                      argnums=(0, 1, 3, 4, 5))(
            *(jnp.asarray(a) for a in args + (Dv,)))
        ts = [t_(a, True) for a in args + (Dv,)]
        (S.ssd_chunked(*ts, chunk=c) * torch.from_numpy(w)).sum().backward()
        for i, want_g in zip((0, 1, 3, 4, 5), jg):
            assert torch.isfinite(ts[i].grad).all()
            scale = float(np.abs(np.asarray(want_g)).max())
            close(ts[i].grad / scale, np.asarray(want_g) / scale, 1e-4,
                  f"ssd grad {i}")


def test_moe_aux_and_grads_match_jax():
    """The MoE block's output, its aux loss (load balance + router z-loss)
    and the gradients of ``sum(y * w) + aux`` through x, the router and
    the expert weights equal ``jax.grad``'s (float32)."""
    cfg = smoke_config("deepseek-moe-16b")
    E = cfg.e_pad
    rng = np.random.default_rng(5)
    d, f = cfg.d_model, cfg.d_ff
    p = {"router": rng.standard_normal((d, E)) * 0.1,
         "w_gate": rng.standard_normal((E, d, f)) * 0.05,
         "w_up": rng.standard_normal((E, d, f)) * 0.05,
         "w_down": rng.standard_normal((E, f, d)) * 0.05,
         "shared": {"w_gate": rng.standard_normal((d, f)) * 0.05,
                    "w_up": rng.standard_normal((d, f)) * 0.05,
                    "w_down": rng.standard_normal((f, d)) * 0.05}}
    p = {k: ({kk: vv.astype(np.float32) for kk, vv in v.items()}
             if isinstance(v, dict) else v.astype(np.float32))
         for k, v in p.items()}
    x = rng.standard_normal((2, 16, d)).astype(np.float32)
    w = rng.standard_normal((2, 16, d)).astype(np.float32)
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k,
              capacity_factor=cfg.capacity_factor, n_shared=1)

    def jloss(p_, x_):
        y, aux = JMoE.moe_block(p_, x_, **kw)
        return jnp.sum(y * w) + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = {k: ({kk: t_(vv, True) for kk, vv in v.items()}
              if isinstance(v, dict) else t_(v, True)) for k, v in p.items()}
    tx = t_(x, True)
    y, aux = MoE.moe_block(tp, tx, **kw)
    close(y, jy, 1e-4, "moe y")
    close(aux, jaux, 1e-5, "moe aux")
    assert float(aux.detach()) > 1.0       # E * Σ density * mean prob ≈ k
    ((y * torch.from_numpy(w)).sum() + aux).backward()
    close(tx.grad, jgx, 1e-4, "moe dx")
    for k in ("router", "w_gate", "w_up", "w_down"):
        close(tp[k].grad, jgp[k], 1e-4, f"moe d{k}")
    for k in ("w_gate", "w_up", "w_down"):
        close(tp["shared"][k].grad, jgp["shared"][k], 1e-4, f"moe dshared {k}")


# ---------------------------------------------------------------------------
# loss gradients, three families


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-moe-16b",
                                  "hymba-1.5b"])
def test_loss_grads_match_jax(arch):
    """``loss_fn``'s value, parts and gradient for every parameter leaf
    against ``jax.grad`` in float32: each leaf within 1e-4 of the largest
    gradient of that leaf."""
    jcfg, cfg, jp, p = both(arch, 1, "float32")
    batch = make_batch(cfg, np.random.default_rng(1))
    tc, jtc = T.TrainConfig(), JT.TrainConfig()
    (jloss, jparts), jg = jax.jit(jax.value_and_grad(
        lambda p_, b_: JT.loss_fn(jcfg, jtc, p_, b_), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, parts, g = T._grads(cfg, tc, p, {k: torch.from_numpy(v)
                                           for k, v in batch.items()})
    close(loss, jloss, 1e-5, "loss")
    for k in ("ce", "z_loss", "moe_aux"):
        close(parts[k], jparts[k], 1e-5, k)
    jleaves = jax.tree_util.tree_leaves(jg)
    leaves = tree_leaves(g)
    assert len(leaves) == len(jleaves)
    for i, (got, want) in enumerate(zip(leaves, jleaves)):
        want = np.asarray(want)
        assert got.shape == want.shape
        scale = max(float(np.abs(want).max()), 1e-12)
        close(got / scale, want / scale, 1e-4, f"{arch} grad leaf {i}")


def test_remat_changes_nothing():
    """Layers under ``torch.utils.checkpoint`` (``cfg.remat``) give the
    same loss and gradients as the plain stack."""
    cfg = dataclasses.replace(smoke_config("hymba-1.5b"), dtype="float32")
    p = M.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in make_batch(cfg, np.random.default_rng(2)).items()}
    tc = T.TrainConfig()
    l0, _, g0 = T._grads(cfg, tc, p, batch)
    l1, _, g1 = T._grads(dataclasses.replace(cfg, remat=True), tc, p, batch)
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_one_train_step_no_nans(arch):
    """``test_arch_smoke.py``'s train-step check on the port: finite,
    positive loss, the step counter at 1, a positive gradient norm and
    moved parameters."""
    cfg = smoke_config(arch)
    state = T.init_train_state(cfg, torch.Generator().manual_seed(1), "cpu")
    before = state.params["embed"].clone()
    batch = {k: torch.from_numpy(v)
             for k, v in make_batch(cfg, np.random.default_rng(1)).items()}
    state, metrics = T.train_step(cfg, T.TrainConfig(), state, batch)
    loss = float(metrics["loss"])
    assert np.isfinite(loss) and loss > 0, (arch, metrics)
    assert int(state.opt.step) == 1
    assert float(metrics["grad_norm"]) > 0
    assert not torch.equal(state.params["embed"], before)
