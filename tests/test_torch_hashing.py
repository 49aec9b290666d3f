"""The PyTorch port's hash and route helpers against the JAX package's.

Every helper of ``repro_torch.core.hashing`` must give the bits of its
``repro.core.hashing`` counterpart (and of the numpy ``hash_np``) exactly,
on the int32 edge keys and on 10**5 seeded random keys. The port computes
uint32 arithmetic in int64 masked to 32 bits, with the multiplications
split into 16-bit halves, so these tests pin that emulation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as JH
from repro_torch.core import hashing as TH

jax.config.update("jax_platform_name", "cpu")

EDGE = np.array([1, -5, 2**31 - 1, -2**31, 0, -1, 2**31 - 2, -2**31 + 1],
                np.int32)


def keys_under_test():
    rng = np.random.default_rng(2024)
    rand = rng.integers(-2**31, 2**31, size=100_000, dtype=np.int64)
    return np.concatenate([EDGE, rand.astype(np.int32)])


@pytest.mark.parametrize("hash_name", ["fmix32", "identity"])
@pytest.mark.parametrize("shift", [0, 1, 3])
def test_hash_matches_jax_and_numpy(hash_name, shift):
    keys = keys_under_test()
    want = np.asarray(JH.HASH_FNS[hash_name](jnp.asarray(keys))
                      << jnp.uint32(shift)).astype(np.int64)
    got = TH.hash_fn(hash_name, shift)(torch.from_numpy(keys)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        TH.hash_np(hash_name, keys, shift),
        JH.hash_np(hash_name, keys, shift))
    np.testing.assert_array_equal(TH.hash_np(hash_name, keys, shift), want)
    assert got.min() >= 0 and got.max() < 2**32


def test_edge_keys_fmix32_exact():
    got = TH.fmix32(torch.from_numpy(EDGE)).numpy()
    np.testing.assert_array_equal(got, JH.hash_np("fmix32", EDGE))


@pytest.mark.parametrize("dmax", [1, 6, 13, 20])
def test_dir_index_matches_jax(dmax):
    keys = keys_under_test()
    jh = JH.fmix32(jnp.asarray(keys))
    th = TH.fmix32(torch.from_numpy(keys))
    np.testing.assert_array_equal(TH.dir_index(th, dmax).numpy(),
                                  np.asarray(JH.dir_index(jh, dmax)))


def test_prefix_and_child_bit_match_jax():
    keys = keys_under_test()[:5000]
    jh = JH.fmix32(jnp.asarray(keys))
    th = TH.fmix32(torch.from_numpy(keys))
    for depth in list(range(0, 33)):
        np.testing.assert_array_equal(TH.prefix(th, depth).numpy(),
                                      np.asarray(JH.prefix(jh, depth)),
                                      err_msg=f"depth {depth}")
    for d in list(range(0, 32)) + [32, 40]:
        np.testing.assert_array_equal(TH.child_bit(th, d).numpy(),
                                      np.asarray(JH.child_bit(jh, d)),
                                      err_msg=f"parent depth {d}")
    # per-element depths, as the split pass uses them
    depths = np.random.default_rng(1).integers(0, 32, size=keys.shape[0])
    np.testing.assert_array_equal(
        TH.child_bit(th, torch.from_numpy(depths)).numpy(),
        np.asarray(JH.child_bit(jh, jnp.asarray(depths, jnp.uint32))))
