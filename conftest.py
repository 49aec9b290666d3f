"""Settings shared by every test directory.

Under pytest-xdist (``-n N``) each worker takes an equal share of the CPU
cores for PyTorch's intra-op threads, and so do the interpreters its tests
start (``OMP_NUM_THREADS``). Left at their defaults, N workers each run a
pool as wide as the machine, whose threads wait on each other: the port's
table tests then spend about twice the CPU time for the same work. A run
without xdist, or with ``OMP_NUM_THREADS`` set, keeps its threads.
"""
import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)

if _WORKERS > 1 and "OMP_NUM_THREADS" not in os.environ:
    _SHARE = max(1, (os.cpu_count() or 1) // _WORKERS)
    os.environ["OMP_NUM_THREADS"] = str(_SHARE)
    torch.set_num_threads(_SHARE)
