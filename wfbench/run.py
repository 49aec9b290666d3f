"""Run one cell of the benchmark of the PyTorch and CUDA port of WF-Ext.

    python3 wfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. The last line of standard output is the result (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit);
the last lines of standard error repeat the checks. Without a CUDA device,
with fewer cards than the cell asks for, or with JAX or the JAX package
loaded, it prints no result and exits with another code than 0.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    import torch
    torch.set_num_threads(1)        # one process, few threads: steadier
    from wfbench import harness
    try:
        result, lines, checks = harness.run(ROOT, a.workload, a.seed,
                                            a.seconds, bool(a.trace),
                                            T_START)
    except harness.CellError as e:
        print(f"wfbench: {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"wfbench: loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    for line in lines:
        print(json.dumps(line), flush=True)
    print("\n".join(checks), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
