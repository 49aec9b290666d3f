"""The PyTorch port's paged-KV serving engine against the JAX package's, on
the CPU.

Both engines run the same weights (the JAX ``init_params`` tree through
``params_from_numpy``) on the same request streams, step for step, driven
by the dense decode's argmax as ``tests/test_serving_paged.py`` drives
them: the counterparts of its four tests, plus the five dense-attention
families, ``append_token``, engine images crossing between the packages
both ways, and the two places where the JAX engine writes a repeated index
with an unspecified winner (the port writes only the lanes that carry
data). Integers are exact — the page table's canonical image, the page
watermark, the free stack up to its top, slot lengths, sequence ids and
next tokens; logits and K/V pages agree at rtol = atol = 2e-2 (bf16, the
JAX test's tolerance).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import smoke_config as jax_smoke_config
from repro.core import snapshot as JS
from repro.models import model as JM
from repro.serving import engine as JE
from repro.serving import kvcache as JKV
from repro_torch.configs import smoke_config
from repro_torch.core import snapshot as S
from repro_torch.core.invariants import check_invariants
from repro_torch.models import model as M
from repro_torch.serving import engine as E
from repro_torch.serving import kvcache as KV

jax.config.update("jax_platform_name", "cpu")

TOL = 2e-2
DENSE_FAMILIES = ["deepseek-7b", "codeqwen1.5-7b", "smollm-135m",
                  "internvl2-2b", "gemma-7b"]


def tree_np(t):
    if isinstance(t, dict):
        return {k: tree_np(v) for k, v in t.items()}
    return np.asarray(t)


def close(got, want, what):
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL, err_msg=what)


def with_backend(pc, backend):
    return dataclasses.replace(
        pc, table=dataclasses.replace(pc.table, backend=backend))


class Both:
    """One request stream through the port's engine and the JAX engine,
    with the port's dense decode as the oracle."""

    def __init__(self, arch="deepseek-7b", batch=4, max_len=40, page_size=8,
                 backend="auto", n_pages=None, seed=0):
        self.jcfg = dataclasses.replace(jax_smoke_config(arch), remat=False)
        self.cfg = smoke_config(arch)
        self.jp = JM.init_params(self.jcfg, jax.random.key(seed))
        self.p = M.params_from_numpy(tree_np(self.jp), self.cfg, "cpu")
        self.jpc = JE.make_paged_config(self.jcfg, batch, max_len, page_size)
        self.pc = with_backend(
            E.make_paged_config(self.cfg, batch, max_len, page_size), backend)
        if n_pages is not None:
            self.jpc = dataclasses.replace(self.jpc, n_pages=n_pages)
            self.pc = dataclasses.replace(self.pc, n_pages=n_pages)
        self.jest = JE.init_engine(self.jcfg, self.jpc)
        self.est = E.init_engine(self.cfg, self.pc, "cpu")
        self.dense = M.init_cache(self.cfg, batch, max_len, device="cpu")

    def admit(self, mask, ids):
        mask, ids = np.asarray(mask, bool), np.asarray(ids, np.int32)
        self.jest = self.jest._replace(paged=JKV.admit(
            self.jpc, self.jest.paged, jnp.asarray(mask), jnp.asarray(ids)))
        self.est = self.est._replace(paged=KV.admit(self.pc, self.est.paged,
                                                    mask, ids))
        length = self.dense["length"].clone()
        length[torch.from_numpy(mask)] = 0
        self.dense["length"] = length

    def evict(self, mask):
        mask = np.asarray(mask, bool)
        self.jest = self.jest._replace(paged=JKV.evict(
            self.jpc, self.jest.paged, jnp.asarray(mask)))
        self.est = self.est._replace(paged=KV.evict(self.pc, self.est.paged,
                                                    mask))

    def set_tokens(self, tokens):
        tokens = np.asarray(tokens, np.int32)
        self.jest = self.jest._replace(tokens=jnp.asarray(tokens))
        self.est = self.est._replace(tokens=torch.from_numpy(tokens.copy()))

    def step(self, what=""):
        """One step of both engines and the dense decode on the current
        tokens; logits compared on the active slots; all three go on with
        the dense argmax. Returns the port's logits."""
        tok = self.est.tokens.clone()
        ld, self.dense = M.decode_step(self.cfg, self.p, self.dense,
                                       tok[:, None])
        self.jest, jl = JE.serve_step(self.jcfg, self.jpc, self.jest,
                                      self.jp)
        self.est, lg = E.serve_step(self.cfg, self.pc, self.est, self.p)
        close(lg, jl, f"paged, port vs JAX {what}")
        active = (self.est.paged.seq_ids >= 0).numpy()
        close(lg[active], ld[active, 0], f"paged vs dense {what}")
        assert_same_tokens(jl, self.jest.tokens, self.est.tokens, what)
        self.set_tokens(torch.argmax(ld[:, 0], -1).numpy())
        return lg

    def check(self, what=""):
        """Every integer of the two states equal; pages close; the table's
        invariants; no error flag."""
        assert_same_paged(self.jest.paged, self.est.paged, what)


def assert_same_tokens(jax_logits, jax_tokens, tokens, what):
    """The two engines' next tokens are equal wherever the JAX logits'
    best two differ by more than twice the logits' tolerance: the two
    packages' bf16 logits differ by about an ulp, so a closer race may
    go either way."""
    top2 = np.sort(np.asarray(jax_logits, np.float32), axis=-1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 2 * (TOL + TOL * np.abs(top2[:, 1]))
    np.testing.assert_array_equal(tokens.numpy()[decided],
                                  np.asarray(jax_tokens)[decided],
                                  err_msg=what)


def assert_same_paged(js, st, what="", pages=True):
    ji, pi = JS.extract_image(js.table), S.extract_image(st.table)
    np.testing.assert_array_equal(pi.keys, ji.keys, err_msg=what)
    for k in ("page", "length"):
        np.testing.assert_array_equal(pi.values[k], np.asarray(ji.values[k]),
                                      err_msg=f"{what} {k}")
    top = int(js.free_top)
    assert int(st.free_top) == top, what
    assert int(st.page_alloc) == int(js.page_alloc), what
    np.testing.assert_array_equal(st.free_pages[:top].numpy(),
                                  np.asarray(js.free_pages)[:top])
    np.testing.assert_array_equal(st.lengths.numpy(), np.asarray(js.lengths))
    np.testing.assert_array_equal(st.seq_ids.numpy(), np.asarray(js.seq_ids))
    if pages:
        close(st.pages_k, js.pages_k, f"{what} pages_k")
        close(st.pages_v, js.pages_v, f"{what} pages_v")
    check_invariants(st.table.config, st.table.state)
    assert not bool(st.table.state.error)


@pytest.mark.parametrize("backend", ["auto", "cuda"])
def test_paged_decode_matches_dense_and_jax(backend):
    """20 steps across page boundaries (page 8) at batch 4: the port's paged
    logits equal its dense decode's and the JAX engine's, and the states
    equal the JAX engine's after every step. ``backend="cuda"`` takes the
    kernels' dispatch (their plain versions on CPU tensors)."""
    b = Both(backend=backend)
    assert b.est.paged.table.plan().backend == (
        "plain" if backend == "auto" else "cuda")
    b.admit(np.ones(4, bool), np.arange(1, 5))
    b.set_tokens(np.random.default_rng(0).integers(1, b.cfg.vocab_size, 4))
    for i in range(20):
        b.step(f"step {i}")
        b.check(f"step {i}")
    st = b.est.paged
    assert int(st.page_alloc) >= 4 * (20 // 8)
    assert int(st.table.size()) == int(np.ceil(20 / 8)) * 4


def test_eviction_frees_pages_and_mappings():
    b = Both(batch=4, max_len=32, page_size=4)
    b.admit(np.ones(4, bool), np.arange(1, 5))
    b.set_tokens(np.ones(4))
    for i in range(9):
        b.step(f"step {i}")
    assert int(b.est.paged.table.size()) == 3 * 4
    # the page table is self-describing: lengths derived from the mappings
    k, v, glens = KV.gather_kv(b.pc, b.est.paged)
    jk, jv, jlens = JKV.gather_kv(b.jpc, b.jest.paged)
    assert glens.tolist() == b.est.paged.lengths.tolist()
    assert glens.tolist() == np.asarray(jlens).tolist()
    close(k, jk, "gather_kv k")
    close(v, jv, "gather_kv v")

    mask = np.array([True, False, True, False])
    b.evict(mask)
    st = b.est.paged
    assert int(st.table.size()) == 3 * 2
    assert int(st.free_top) == 3 * 2                 # pages recycled
    b.check("after evict")
    # re-admit into the freed slots and keep decoding; freed pages reused
    b.admit(mask, [10, 0, 11, 0])
    b.set_tokens(np.ones(4))
    alloc = int(b.est.paged.page_alloc)
    for i in range(4):
        b.step(f"after admit {i}")
    assert int(b.est.paged.page_alloc) == alloc      # served from free list
    b.check("after re-admit")


def test_engine_handover_and_warm_start(tmp_path):
    """A successor engine under a bigger geometry continues every live
    request at its exact position, in memory and through an image; the
    state handed over equals the JAX engine's; infeasible targets raise
    the JAX package's errors."""
    b = Both(batch=4, max_len=40, page_size=8, seed=1)
    b.admit(np.ones(4, bool), np.arange(1, 5))
    b.set_tokens(np.random.default_rng(1).integers(1, b.cfg.vocab_size, 4))
    for i in range(10):                      # mid-page and past a boundary
        b.step(f"step {i}")
    pc, est = b.pc, b.est
    pc_big = E.make_paged_config(b.cfg, batch=8, max_len=40, page_size=8)
    jpc_big = JE.make_paged_config(b.jcfg, batch=8, max_len=40, page_size=8)
    est_big = E.handover_engine(pc, pc_big, est)
    jest_big = JE.handover_engine(b.jpc, jpc_big, b.jest)
    assert_same_paged(jest_big.paged, est_big.paged, "handover")
    assert int(est_big.paged.table.size()) == int(est.paged.table.size())
    assert est_big.paged.lengths[:4].tolist() == est.paged.lengths.tolist()
    assert (est_big.paged.seq_ids[4:] == -1).all()

    E.save_engine(str(tmp_path / "img"), pc_big, est_big)
    est_warm = E.warm_start_engine(pc_big, str(tmp_path / "img"), "cpu")
    assert_same_paged(jest_big.paged, est_warm.paged, "warm start")

    for i in range(4):
        est, l_ref = E.serve_step(b.cfg, pc, est, b.p)
        est_big, l_big = E.serve_step(b.cfg, pc_big, est_big, b.p)
        est_warm, l_warm = E.serve_step(b.cfg, pc_big, est_warm, b.p)
        jest_big, jl_big = JE.serve_step(b.jcfg, jpc_big, jest_big, b.jp)
        close(l_big[:4], l_ref, f"handover step {i}")
        close(l_warm, l_big, f"warm start step {i}")
        close(l_big, jl_big, f"handover vs JAX step {i}")
    assert_same_paged(jest_big.paged, est_big.paged, "after handover")

    rp = dataclasses.replace
    with pytest.raises(ValueError, match="cannot change page_size"):
        KV.handover(pc_big, est_big.paged, rp(pc_big, page_size=16))
    with pytest.raises(ValueError, match="slots are positional"):
        KV.handover(pc_big, est_big.paged, rp(pc_big, batch=2))
    with pytest.raises(ValueError, match="grow n_pages"):
        KV.handover(pc_big, est_big.paged, rp(pc_big, n_pages=1))
    # live sequences are 14 tokens deep: max_blocks=1 (8 tokens) truncates
    with pytest.raises(ValueError, match="grow max_blocks"):
        KV.handover(pc_big, est_big.paged, rp(pc_big, max_blocks=1))
    with pytest.raises(ValueError, match="cannot change dtype"):
        KV.handover(pc_big, est_big.paged, rp(pc_big, dtype="float32"))
    # ...and restore checks against the SAVED geometry, not the target
    with pytest.raises(ValueError, match="cannot change page_size"):
        KV.restore_paged(rp(pc_big, page_size=16), str(tmp_path / "img"),
                         "cpu")
    with pytest.raises(ValueError, match="value schema"):
        rp(pc_big, table=rp(pc_big.table, value_schema=None,
                            slab_capacity=0))


def test_page_table_directory_grows_with_live_set():
    """The extendible directory deepens as the live set grows, through the
    same depths as the JAX engine's page table."""
    b = Both(batch=8, max_len=64, page_size=4)
    b.admit(np.ones(8, bool), np.arange(1, 9))
    b.set_tokens(np.ones(8))
    d0 = int(b.est.paged.table.state.depth)
    for i in range(40):                      # 10 pages per sequence
        b.step(f"step {i}")
        assert int(b.est.paged.table.state.depth) == int(
            b.jest.paged.table.state.depth), i
    assert int(b.est.paged.table.state.depth) > d0
    b.check("end")


@pytest.mark.parametrize("arch", DENSE_FAMILIES)
def test_dense_attention_families_serve_like_jax(arch):
    """Each family the engine serves (GQA, ``qkv_bias``, GeGLU with
    ``head_dim`` 32 at smoke size): 10 steps across page boundaries, paged
    = dense = JAX. The other families raise."""
    b = Both(arch=arch, batch=3, max_len=16, page_size=4, seed=3)
    b.admit(np.ones(3, bool), np.arange(7, 10))
    b.set_tokens(np.random.default_rng(3).integers(1, b.cfg.vocab_size, 3))
    for i in range(10):
        b.step(f"{arch} step {i}")
    b.check(arch)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "granite-moe-3b-a800m",
                                  "hymba-1.5b", "mamba2-2.7b",
                                  "seamless-m4t-large-v2"])
def test_serve_step_refuses_other_families(arch):
    cfg = smoke_config(arch)
    pc = E.make_paged_config(cfg, batch=2, max_len=8, page_size=4)
    with pytest.raises(NotImplementedError, match="dense-attention"):
        E.serve_step(cfg, pc, None, None)


def test_engine_entry_points_run_on_cuda_unless_asked():
    """Without a card the default device raises; nothing falls back to the
    CPU unasked."""
    cfg = smoke_config("deepseek-7b")
    pc = E.make_paged_config(cfg, batch=2, max_len=8, page_size=4)
    if torch.cuda.is_available():
        assert E.init_engine(cfg, pc).tokens.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            E.init_engine(cfg, pc)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            KV.init_paged(pc)
    assert E.init_engine(cfg, pc, "cpu").tokens.device.type == "cpu"


def test_append_token_writes_only_the_active_slots():
    """``append_token`` makes the JAX package's transactions (the table
    image, allocator and slot registry equal its own after every step),
    and its pages hold exactly the K/V it was given. The JAX
    ``append_token`` scatters each inactive slot's stale value back into
    page 0 at that slot's offset, the index an active slot's first token
    takes there: on the CPU the stale value wins and the JAX package loses
    that token's K/V, so its pages are not the reference here."""
    b = Both(batch=3, max_len=16, page_size=4)
    b.admit([True, True, False], [1, 2, 0])
    pc, jpc = b.pc, b.jpc
    rng = np.random.default_rng(4)
    st, js = b.est.paged, b.jest.paged
    shape = (pc.n_layers, 3, pc.n_kv_heads, pc.head_dim)
    want = {n: np.zeros(tuple(st.pages_k.shape), np.float32) for n in "kv"}
    for i in range(9):
        kv = {n: torch.randn(shape, generator=torch.Generator().manual_seed(
            int(rng.integers(2**31)))).bfloat16() for n in "kv"}
        js = JKV.append_token(jpc, js, *(jnp.asarray(kv[n].float().numpy(),
                                                     jnp.bfloat16)
                                         for n in "kv"))
        st = KV.append_token(pc, st, kv["k"], kv["v"])
        assert_same_paged(js, st, f"append {i}", pages=False)
        for slot in (0, 1):
            page, off = 2 * (i // 4) + slot, i % 4
            for n in "kv":
                want[n][:, page, off] = kv[n][:, slot].float().numpy()
        np.testing.assert_array_equal(st.pages_k.float().numpy(), want["k"])
        np.testing.assert_array_equal(st.pages_v.float().numpy(), want["v"])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_engine_image_crosses_packages(tmp_path, direction):
    """An engine image saved by one package warm-starts in the other under
    a bigger geometry; the saver and the restored engine then decode with
    equal logits and equal states. Both packages write the same
    ``engine.npz`` keys and dtypes."""
    b = Both(batch=4, max_len=40, page_size=8, seed=2)
    b.admit(np.ones(4, bool), np.arange(1, 5))
    b.set_tokens(np.random.default_rng(2).integers(1, b.cfg.vocab_size, 4))
    for i in range(10):
        b.step(f"step {i}")
    pc_big = E.make_paged_config(b.cfg, batch=6, max_len=48, page_size=8)
    jpc_big = JE.make_paged_config(b.jcfg, batch=6, max_len=48, page_size=8)
    jpath, ppath = str(tmp_path / "jax"), str(tmp_path / "port")
    JE.save_engine(jpath, b.jpc, b.jest)
    E.save_engine(ppath, b.pc, b.est)
    with np.load(f"{jpath}/engine.npz") as zj, \
            np.load(f"{ppath}/engine.npz") as zp:
        assert sorted(zj.files) == sorted(zp.files)
        for k in zj.files:
            assert zj[k].dtype == zp[k].dtype and zj[k].shape == zp[k].shape, k
    if direction == "jax_to_port":
        est = E.warm_start_engine(pc_big, jpath, "cpu")
        jest = JE.warm_start_engine(jpc_big, jpath)
    else:
        jest = JE.warm_start_engine(jpc_big, ppath)
        est = E.warm_start_engine(pc_big, ppath, "cpu")
    assert_same_paged(jest.paged, est.paged, "warm start")
    for i in range(4):
        est, lp = E.serve_step(b.cfg, pc_big, est, b.p)
        jest, lj = JE.serve_step(b.jcfg, jpc_big, jest, b.jp)
        close(lp, lj, f"restored step {i}")
        close(lp[:4], b.step(f"saver {i}"), f"restored vs saver step {i}")
        assert_same_tokens(lj, jest.tokens, est.tokens, f"restored {i}")
    assert_same_paged(jest.paged, est.paged, "after warm start")
    assert b.est.paged.lengths.tolist() == est.paged.lengths[:4].tolist()


def test_inactive_slots_never_write_the_last_page():
    """The JAX engine writes every inactive slot's stale value back into
    page ``n_pages - 1`` at that slot's offset; when a live sequence takes
    that page at offset 0, the stale write and the new K/V hit one index
    and either may land. The port writes only the active slots: slot 0's
    cache, gathered through the page table, equals the dense cache exactly
    once it holds page ``n_pages - 1``."""
    b = Both(batch=2, max_len=24, page_size=4, n_pages=6)
    b.admit([True, False], [1, 0])
    b.set_tokens(np.ones(2))
    for i in range(24):
        tok = b.est.tokens.clone()
        ld, b.dense = M.decode_step(b.cfg, b.p, b.dense, tok[:, None])
        b.est, lg = E.serve_step(b.cfg, b.pc, b.est, b.p)
        close(lg[:1], ld[:1, 0], f"step {i}")
        b.set_tokens(torch.argmax(ld[:, 0], -1).numpy())
    st = b.est.paged
    assert int(st.page_alloc) == b.pc.n_pages
    k, v, lens = KV.gather_kv(b.pc, st)
    assert lens.tolist() == [24, 0]
    assert torch.equal(k[:, 0, :24], b.dense["k"][:, 0, :24])
    assert torch.equal(v[:, 0, :24], b.dense["v"][:, 0, :24])


def test_evict_pushes_only_freed_pages():
    """The JAX ``evict`` clips its idle lanes onto the last free-stack entry
    and writes the entry's old value back; when a freed page lands in that
    entry in the same batch, either may win (on the CPU the JAX package
    loses page 5 and pushes page 0 twice). The port pushes every freed page
    exactly once, in the JAX package's order: block by block, lane by
    lane."""
    b = Both(batch=3, max_len=12, page_size=4, n_pages=6)
    b.admit([True, True, False], [1, 2, 0])
    b.set_tokens(np.ones(3))
    for i in range(12):
        b.step(f"step {i}")
    st = KV.evict(b.pc, b.est.paged, np.array([True, True, False]))
    assert int(st.free_top) == 6
    # pages went out in lane order per block boundary: slot 0 holds 0, 2, 4
    assert st.free_pages.tolist() == [0, 1, 2, 3, 4, 5]
    assert int(st.table.size()) == 0
    assert st.seq_ids.tolist() == [-1, -1, -1]
