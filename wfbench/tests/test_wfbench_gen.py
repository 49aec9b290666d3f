"""The generator: the same ops for the same (seed, round), key maps that
are bijections, payload bytes equal to the reference's own definition."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from wfbench import gen
from wfbench.reference import record_bytes

REPO = Path(__file__).resolve().parents[2]


def _load(config, traffic):
    base = REPO / "wfbench"
    return (json.loads((base / "configs" / f"{config}.json").read_text()),
            json.loads((base / "traffic" / f"{traffic}.json").read_text()))


CELLS = [("paper-int", "mix90"), ("ycsb-1kb", "ycsb-b"),
         ("ycsb-1kb", "ycsb-d-retain"), ("ycsb-1kb", "ycsb-a")]


@pytest.mark.parametrize("config,traffic", CELLS)
def test_same_seed_and_round_same_ops(config, traffic):
    cfg, mix = _load(config, traffic)
    seed = 2**31 + 12345
    a = gen.Traffic(cfg, mix, seed, "cpu").round(7)
    b = gen.Traffic(cfg, mix, seed, "cpu").round(7)
    c = gen.Traffic(cfg, mix, seed, "cpu").round(8)
    d = gen.Traffic(cfg, mix, seed + 1, "cpu").round(7)
    for f in ("reads", "kinds", "keys", "values", "versions", "sample"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert not torch.equal(a.reads, c.reads)
    assert not torch.equal(a.reads, d.reads)
    assert a.reads.numel() == mix["reads"]["count"]
    assert a.keys.numel() == sum(o["count"] for o in mix["writes"]["ops"])


def test_key_maps_are_bijections_and_never_the_empty_key():
    cfg, mix = _load("paper-int", "mix90")
    t = gen.Traffic(cfg, mix, 99, "cpu")
    keys = t.key_of(torch.arange(cfg["keys"]["universe"]))
    assert torch.unique(keys).numel() == keys.numel()
    assert int(keys.min()) >= 1 and int(keys.max()) <= 2**30
    cfg, mix = _load("ycsb-1kb", "ycsb-b")
    t = gen.Traffic(cfg, mix, 99, "cpu")
    keys = t.key_of(torch.arange(1 << 20))
    assert torch.unique(keys).numel() == keys.numel()
    assert int(keys.min()) >= 0


def test_preload_is_a_seeded_half():
    cfg, mix = _load("paper-int", "mix90")
    a = gen.Traffic(cfg, mix, 3, "cpu").preload_idx()
    b = gen.Traffic(cfg, mix, 4, "cpu").preload_idx()
    assert a.numel() == cfg["keys"]["universe"] // 2
    assert torch.unique(a).numel() == a.numel()
    assert not torch.equal(a, b)


def test_zipfian_hottest_record_and_latest_window():
    cfg, mix = _load("ycsb-1kb", "ycsb-b")
    t = gen.Traffic(cfg, mix, 5, "cpu")
    idx = torch.cat([t.round(r).read_idx for r in range(4)])
    share = float((idx == 0).double().mean())
    assert 0.05 < share < 0.10           # 1 / H(2**18, 0.99), about 7.6%
    cfg, mix = _load("ycsb-1kb", "ycsb-d-retain")
    t = gen.Traffic(cfg, mix, 5, "cpu")
    n = cfg["keys"]["records"]
    for r in (0, 3):
        o = t.round(r)
        lo, hi = 2048 * r, n + 2048 * r
        ins = o.write_idx[o.kinds == gen.INS]
        dele = o.write_idx[o.kinds == gen.DEL]
        assert torch.equal(torch.sort(ins).values, torch.arange(hi, hi + 2048))
        assert torch.equal(torch.sort(dele).values,
                           torch.arange(lo, lo + 2048))
        assert int(o.read_idx.min()) >= lo and int(o.read_idx.max()) < hi
        assert float((o.read_idx == hi - 1).double().mean()) > 0.05


def test_payload_bytes_equal_the_reference_definition():
    keys = torch.tensor([0, 1, -7, 2**31 - 1, 424242], dtype=torch.int32)
    vers = torch.tensor([0, 1, 2**33, 5, 77])
    for seed in (0, 2**31 + 9, -3):
        got = gen.payload_bytes(seed, keys, vers, 1000).numpy()
        want = record_bytes(seed, keys.numpy(), vers.numpy(), 1000)
        assert got.shape == (5, 1000) and np.array_equal(got, want)
    fields = [("f0", (100,)), ("f1", (100,))]
    rows = gen.payload_bytes(1, keys, vers, 200)
    out = gen.split_fields(rows, fields)
    assert torch.equal(out["f1"], rows[:, 100:])


def test_a_skewed_mix_takes_one_theta_from_the_file_top():
    cfg, mix = _load("ycsb-1kb", "ycsb-a")
    mix = dict(mix)
    theta = mix.pop("theta")
    with pytest.raises(ValueError, match="theta"):
        gen.Traffic(cfg, mix, 1, "cpu")
    flat = gen.Traffic(cfg, dict(mix, theta=0.5), 1, "cpu")
    skew = gen.Traffic(cfg, dict(mix, theta=theta), 1, "cpu")
    assert float(flat._cdf[0]) < float(skew._cdf[0])


def test_settle_versions_lie_above_every_round():
    cfg, mix = _load("ycsb-1kb", "ycsb-b")
    t = gen.Traffic(cfg, mix, 7, "cpu")
    v = t.settle_versions(t.preload_idx())
    assert int(v.min()) > 10**5 * t.n_writes and int(v.max()) < 2**31
    assert torch.unique(v).numel() == v.numel()
