"""The PyTorch port's int8-compressed gradient all-reduce against the JAX
package's ``distributed/compression.py``.

* ``_quantize`` is bit-equal to the JAX ``_quantize`` (int8 values and the
  scale) on seeded float32 and bfloat16 inputs, exact ``.5`` ties (round
  half to even) and an all-zero input included;
* a 4-rank gloo rehearsal on the CPU — four processes of this file joined
  through a ``FileStore`` under ``tmp_path`` (no TCP port: the tests run
  in parallel), a (4, 1) ``("data", "model")`` mesh from
  ``make_local_mesh`` reduced over ``data``, and a (2, 2) one reduced over
  both axes — runs ``make_compressed_allreduce`` over a gradient
  tree (float32 and bfloat16 leaves) for 3 steps, carrying the feedback:
  every rank's reduced gradients equal the JAX per-rank arithmetic
  (``x = g + r``, ``_quantize``, ``q * scale``) summed over the ranks and
  divided by 4, to float32 rounding, and every rank's residual equals the
  JAX residual exactly.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.distributed import compression as JC
from repro_torch.distributed import compression as C
from repro_torch.launch.mesh import make_local_mesh

jax.config.update("jax_platform_name", "cpu")

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
HERE = os.path.abspath(__file__)
WORLD, STEPS = 4, 3
# leaf name → (shape, dtype) of the rehearsal's gradient tree
LEAVES = {"embed": ((64, 33), "float32"), "layers/w": ((3, 17, 8), "bfloat16"),
          "layers/norm": ((17,), "float32"), "zero": ((5,), "float32")}


def _inputs():
    rng = np.random.default_rng(21)
    ties = np.array([127.0, 63.5, -0.5, 0.5, 2.5, -1.5, 3.5, -126.5, 1.0,
                     -127.0], np.float32)
    return [rng.standard_normal(1000).astype(np.float32),
            (rng.standard_normal((7, 129)) * 1e-3).astype(np.float32),
            rng.uniform(-5, 5, 333).astype(np.float32), ties,
            np.zeros(9, np.float32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_bit_equal_to_jax(dtype):
    for x in _inputs():
        xt = torch.from_numpy(x).to(getattr(torch, dtype))
        xj = jnp.asarray(x, getattr(jnp, dtype))
        # both sides start from the same rounded values
        assert np.array_equal(xt.float().numpy(), np.asarray(xj, np.float32))
        q, s = C._quantize(xt)
        jq, js = JC._quantize(xj)
        assert q.dtype == torch.int8 and s.dtype == xt.dtype
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert np.array_equal(s.float().numpy().view(np.uint32),
                              np.asarray(js, np.float32).view(np.uint32))
    # the ties round half to even
    q, _ = C._quantize(torch.from_numpy(_inputs()[3]))
    assert q.tolist() == [127, 64, 0, 0, 2, -2, 4, -126, 1, -127]


def grads_at(rank: int, step: int):
    """Rank ``rank``'s gradient leaves at ``step`` as float32 numpy arrays
    (bfloat16 leaves already rounded)."""
    rng = np.random.default_rng([rank, step])
    out = {}
    for name, (shape, dtype) in LEAVES.items():
        g = (rng.standard_normal(shape) * (rank + 1)).astype(np.float32)
        if name == "zero":
            g[:] = 0
        if dtype == "bfloat16":
            g = torch.from_numpy(g).bfloat16().float().numpy()
        out[name] = g
    return out


def _tree(flat):
    out = {}
    for name, v in flat.items():
        *head, last = name.split("/")
        d = out
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


def _port_grads(rank, step):
    return _tree({k: torch.from_numpy(v).to(getattr(torch, LEAVES[k][1]))
                  for k, v in grads_at(rank, step).items()})


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        name = f"{prefix}{k}"
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], name + "/"))
        else:
            out[name] = tree[k]
    return out


def _rank_main(rank, store_path, out_dir):
    """One rank of the rehearsal: 3 steps of the compressed all-reduce,
    each step's reduced grads and residuals saved as .npy."""
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        struct = _port_grads(0, 0)
        # the same reduction over one data axis of 4 and over both axes of
        # a (2, 2) mesh (summed over each axis's group in turn)
        fns = {"data": C.make_compressed_allreduce(
            make_local_mesh(data=WORLD, device_type="cpu"), struct),
            "both": C.make_compressed_allreduce(
                make_local_mesh(data=2, model=2, device_type="cpu"), struct,
                axes=("data", "model"))}
        for name, fn in fns.items():
            fb = C.init_feedback(struct)
            for step in range(STEPS):
                red, fb = fn(_port_grads(rank, step), fb)
                for kind, tree in (("red", red), ("res", fb.residual)):
                    for k, v in _flat(tree).items():
                        assert v.dtype == torch.float32
                        np.save(os.path.join(
                            out_dir, f"{name}_{kind}_{rank}_{step}_"
                            f"{k.replace('/', '__')}.npy"), v.numpy())
    finally:
        dist.destroy_process_group()
    return 0


def test_gloo_rehearsal_matches_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, HERE, str(r), store,
                               str(tmp_path)], env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(WORLD)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, (out[-2000:], err[-3000:])

    res = {r: {k: np.zeros(shape, np.float32)
               for k, (shape, _) in LEAVES.items()} for r in range(WORLD)}
    for step in range(STEPS):
        for k in LEAVES:
            acc, scale_sum = 0.0, 0.0
            for r in range(WORLD):
                x = jnp.asarray(grads_at(r, step)[k]) + jnp.asarray(res[r][k])
                q, s = JC._quantize(x)
                part = np.asarray(q.astype(jnp.int32).astype(jnp.float32) * s)
                acc = acc + part.astype(np.float64)
                scale_sum += float(np.abs(part).max(initial=0.0))
                res[r][k] = np.asarray(x - q.astype(jnp.float32) * s)
            want = acc / WORLD
            tol = 2 * np.finfo(np.float32).eps * max(scale_sum, 1e-30)
            for r in range(WORLD):
                leaf = k.replace("/", "__")
                for axes in ("data", "both"):
                    got = np.load(tmp_path / f"{axes}_red_{r}_{step}_{leaf}.npy")
                    np.testing.assert_allclose(
                        got, want, rtol=0, atol=tol,
                        err_msg=f"{k} rank {r} step {step} over {axes}")
                    got_r = np.load(
                        tmp_path / f"{axes}_res_{r}_{step}_{leaf}.npy")
                    assert np.array_equal(got_r, res[r][k]), (k, r, step)
        assert all(np.abs(res[r]["embed"]).max() > 0 for r in range(WORLD))


if __name__ == "__main__":
    rank, store_path, out_dir = sys.argv[1:]
    sys.exit(_rank_main(int(rank), store_path, out_dir))
