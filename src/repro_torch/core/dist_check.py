"""Self-check of the sharded table, through the ``Table`` facade, and of
the int8 compressed gradient all-reduce.

    python -m repro_torch.core.dist_check [--device cpu|cuda]
    torchrun --nproc-per-node 4 -m repro_torch.core.dist_check \
        --data 2 --model 2

The port of ``repro/core/dist_check.py``. For 2 and 4 shards, a random
batched workload runs through a sharded ``Table``; every status must
equal, lane for lane, (a) a local ``Table`` over the same aggregate hash
bits and (b) the paper-literal sequential reference
(``core/reference.py::SeqExtHash``); every lookup must agree with both,
the invariants must hold per shard, and the final content (the union of
the shards' maps) must equal both.

``--data D --model M`` with D·M > 1 runs the sharded table on a ``(D,
M)`` ``("data", "model")`` mesh of D·M ranks, as the JAX check runs it on
its ``(4, 2)`` mesh: ranks started by ``torchrun`` (``env://``), or with
``RANK`` / ``WORLD_SIZE`` set and ``--dist-init file:///path`` (gloo
ranks joined through a shared file, as ``launch/train.py`` starts them);
NCCL ranks on ``cuda:LOCAL_RANK`` for ``--device cuda``. Of 2 and 4
shards, each count M divides runs (rank 0 prints); the local table and the
reference run on
every rank, and the mesh table's whole state, gathered over ``model``, is
checked.

Then :func:`check_compression`, the JAX check's counterpart on
``distributed/compression.py``: every rank's gradient is the same seeded
[64, 32] float32 base scaled by its rank + 1, reduced twice over the
whole mesh carrying the error feedback. The one-step mean must be within
5% of the largest exact value, and the two-step mean with feedback no
further off than the one step. ``--device cpu`` runs it on 4 gloo ranks (a
(2, 2) mesh, spawned processes joined through a ``FileStore`` in a
temporary directory: no TCP port); ``--device cuda`` on one NCCL rank.
Exit code 0 = pass.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from repro_torch.core import table as T
from repro_torch.core.invariants import check_invariants, full_view, to_dict
from repro_torch.core.reference import SeqExtHash
from repro_torch.core.spec import TableSpec

N_LANES = 16
STEPS = 12


def check_shards(shard_bits: int, device: str, seed: int = 0,
                 mesh=None) -> int:
    """Run the workload on a ``2**shard_bits``-shard table (on ``mesh``
    when one is given); returns the final item count (raises
    AssertionError on any disagreement)."""
    from repro_torch.table_api import Table

    # each shard a dmax=8 WF-Ext; the local table and the reference see
    # the same aggregate addressing, dmax + shard_bits hash bits
    sh_spec = TableSpec(dmax=8, bucket_size=4, pool_size=256,
                        n_lanes=N_LANES, placement="sharded",
                        shard_bits=shard_bits)
    bits = 8 + shard_bits
    lo_spec = TableSpec(dmax=bits, bucket_size=4, pool_size=256 << shard_bits,
                        n_lanes=N_LANES)
    t_sh = Table.create(sh_spec, device, mesh)
    t_lo = Table.create(lo_spec, device)
    ref = SeqExtHash(dmax=bits, bucket_size=4)
    rng = np.random.default_rng(seed)
    for step in range(STEPS):
        kinds = rng.integers(1, 3, size=N_LANES).astype(np.int32)
        # distinct keys per batch: shard-local linearization order can
        # differ from the reference's lane order for same-key conflicts
        keys = rng.choice(np.arange(1, 4000), size=N_LANES,
                          replace=False).astype(np.int32)
        vals = rng.integers(0, 999, size=N_LANES).astype(np.int32)
        t_sh, res_sh = t_sh.apply(kinds, keys, vals)
        t_lo, res_lo = t_lo.apply(kinds, keys, vals)
        want = [ref.insert(int(k), int(v)) if c == T.INS
                else ref.delete(int(k))
                for c, k, v in zip(kinds, keys, vals)]
        assert res_sh.status.tolist() == want, (step, res_sh.status, want)
        assert res_lo.status.tolist() == want, (step, res_lo.status, want)
        assert not bool(res_sh.error) and not bool(res_lo.error), step

        q = rng.choice(np.arange(1, 4000), size=N_LANES).astype(np.int32)
        f1, v1 = t_sh.lookup(q)
        f2, v2 = t_lo.lookup(q)
        want_fv = [ref.lookup(int(k)) for k in q]
        assert f1.tolist() == f2.tolist() == [f for f, _ in want_fv], step
        assert v1.tolist() == v2.tolist() == [v for _, v in want_fv], step

    full = full_view(t_sh)
    check_invariants(sh_spec.table_config(), full)
    got = to_dict(sh_spec.table_config(), full)
    lo_map = to_dict(lo_spec.table_config(), t_lo.state)
    ref_map = ref.as_dict()
    assert got == lo_map == ref_map, (len(got), len(lo_map), len(ref_map))
    assert int(t_sh.size()) == len(ref_map)
    return len(got)


COMPRESSION_RANKS_CPU = 4


def _compression_rank(rank, store_path, world, device_type):
    """One rank of :func:`check_compression` (rank 0 checks and prints)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh

    if world > 1:
        dist.init_process_group("gloo", store=dist.FileStore(store_path,
                                                             world),
                                rank=rank, world_size=world)
    data = 2 if world == 4 else world
    try:
        mesh = make_local_mesh(data=data, model=world // data,
                               device_type=device_type)
        _compression_on(mesh, device_type)
    finally:
        dist.destroy_process_group()


def _compression_on(mesh, device_type):
    """The compression check over every rank of ``mesh`` (rank 0 checks
    and prints)."""
    import torch.distributed as dist
    from repro_torch.distributed.compression import (
        init_feedback, make_compressed_allreduce)

    rank = dist.get_rank()
    dev = torch.device(device_type, torch.cuda.current_device()) \
        if device_type == "cuda" else torch.device("cpu")
    base = torch.tensor(np.random.default_rng(3).standard_normal(
        (64, 32)), dtype=torch.float32, device=dev)
    g = {"w": base * (dist.get_rank() + 1.0)}
    fn = make_compressed_allreduce(mesh, g, axes=("data", "model"))
    red, fb = fn(g, init_feedback(g))
    red2, fb = fn(g, fb)
    if rank == 0:
        world = mesh.size()
        exact = base.double().cpu().numpy() * (
            sum(range(1, world + 1)) / world)
        err1 = np.abs(red["w"].double().cpu().numpy() - exact).max()
        # the two-step mean with feedback is closer than one
        # uncorrected step
        two = (red["w"] + red2["w"]).double().cpu().numpy() / 2
        err2 = np.abs(two - exact).max()
        scale = np.abs(exact).max()
        assert err1 < 0.05 * scale, err1
        assert err2 <= err1 + 1e-6, (err1, err2)
        print(f"compression OK: one-step err {err1:.4f}, two-step "
              f"feedback err {err2:.4f} (scale {scale:.2f})", flush=True)


def check_compression(device_type: str) -> None:
    """The compression check on 4 spawned gloo ranks (``"cpu"``) or one
    NCCL rank (``"cuda"``); raises when a rank fails."""
    if device_type != "cpu":
        _compression_rank(0, None, 1, device_type)
        return
    import subprocess
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.core.dist_check",
             "--compression-rank", str(r), store], env=env)
            for r in range(COMPRESSION_RANKS_CPU)]
        codes = [p.wait(timeout=600) for p in procs]
    if any(codes):
        raise RuntimeError(f"compression check ranks exited {codes}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    ap.add_argument("--data", type=int, default=1, help="data-axis size")
    ap.add_argument("--model", type=int, default=1, help="model-axis size")
    ap.add_argument("--dist-init", default="env://",
                    help="process-group init method on a mesh: env:// "
                    "(torchrun) or file:///path")
    ap.add_argument("--compression-rank", nargs=2, default=None,
                    metavar=("RANK", "STORE"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.compression_rank:
        rank, store = args.compression_rank
        _compression_rank(int(rank), store, COMPRESSION_RANKS_CPU, "cpu")
        return 0
    if args.data * args.model > 1:
        return mesh_main(args)
    for shard_bits in (1, 2):
        n = check_shards(shard_bits, args.device)
        print(f"dist table OK: {n} items across {1 << shard_bits} shards, "
              f"{STEPS} transactions, statuses lane-exact", flush=True)
    device = args.device or "cuda"
    check_compression(torch.device(device).type)
    return 0


def mesh_main(args) -> int:
    """The table check on a ``(data, model)`` mesh of ranks for each shard
    count the mesh can hold, then the compression check over the same
    ranks."""
    import torch.distributed as dist
    from repro_torch.launch.train import start_mesh

    mesh, dev, started = start_mesh(args.data, args.model,
                                    args.device or "cuda", args.dist_init)
    try:
        lead = dist.get_rank() == 0
        ran = 0
        for shard_bits in (1, 2):
            if (1 << shard_bits) % args.model or N_LANES % args.data:
                continue
            n = check_shards(shard_bits, dev, mesh=mesh)
            ran += 1
            if lead:
                print(f"dist table OK: {n} items across {1 << shard_bits} "
                      f"shards on a ({args.data}, {args.model}) mesh, "
                      f"{STEPS} transactions, statuses lane-exact",
                      flush=True)
        if not ran:
            raise ValueError(f"a ({args.data}, {args.model}) mesh holds "
                             f"neither 2 nor 4 shards at {N_LANES} lanes")
        _compression_on(mesh, dev.type)
    finally:
        if started:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
