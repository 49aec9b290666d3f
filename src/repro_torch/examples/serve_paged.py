"""Batched serving over the WF-Ext paged KV cache: admit a request batch,
decode, evict finished sequences, admit new ones — the page table grows and
shrinks through wait-free transactions.

The port of ``examples/serve_paged.py``: the smoke ``deepseek-7b`` model
(random weights from seed 0) through the port's engine, the same batch,
pages, steps and prints.

Run: PYTHONPATH=src python -m repro_torch.examples.serve_paged [--device cpu]
"""
import dataclasses

import numpy as np
import torch

from repro_torch.configs.archs import smoke_config
from repro_torch.examples import device_args
from repro_torch.models.model import init_params
from repro_torch.serving import kvcache as KV
from repro_torch.serving.engine import (EngineState, init_engine,
                                        make_paged_config, serve_step)


def main(argv=None):
    dev = torch.device(device_args(__doc__, argv).device)
    cfg = dataclasses.replace(smoke_config("deepseek-7b"), remat=False)
    params = init_params(cfg, torch.Generator().manual_seed(0), dev)
    pc = make_paged_config(cfg, batch=4, max_len=64, page_size=8)
    est = init_engine(cfg, pc, dev)

    rng = np.random.default_rng(0)
    st = KV.admit(pc, est.paged, np.ones(4, bool),
                  np.asarray([1, 2, 3, 4], np.int32))
    est = EngineState(paged=st, tokens=torch.tensor(
        rng.integers(1, cfg.vocab_size, 4), dtype=torch.int32, device=dev))

    for step in range(24):
        est, logits = serve_step(cfg, pc, est, params)
        if step % 8 == 7:
            print(f"step {step + 1}: "
                  f"lengths={est.paged.lengths.cpu().numpy()} "
                  f"pages={int(est.paged.page_alloc)} "
                  f"mappings={int(est.paged.table.size())} "
                  f"dir_depth={int(est.paged.table.state.depth)}")
    assert bool(torch.isfinite(logits.float()).all())

    # sequence 2 finishes: evict (wait-free DELETEs) and admit a new request
    st = KV.evict(pc, est.paged, np.asarray([False, True, False, False]))
    st = KV.admit(pc, st, np.asarray([False, True, False, False]),
                  np.asarray([0, 9, 0, 0], np.int32))
    est = EngineState(paged=st, tokens=est.tokens)
    for _ in range(8):
        est, _ = serve_step(cfg, pc, est, params)
    print(f"after evict/admit: lengths={est.paged.lengths.cpu().numpy()} "
          f"free_pages={int(est.paged.free_top)} "
          f"mappings={int(est.paged.table.size())}")
    assert est.paged.lengths.tolist() == [32, 8, 32, 32]
    print("paged serving OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
