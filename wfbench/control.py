"""Run the control of a cell: the plain reference in the program's place,
with reads one write call stale (``reference/control.py``), through the
same set-up, window and check as a run of the program. Every run has to
come out not correct; its mismatch counts are the upper readings the
limits sit below.

    python3 wfbench/control.py --workload <cell> --seeds 1,2,3 \\
        --seconds 5 [--device cuda]
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
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)

    from wfbench import harness
    from wfbench.reference import ControlTable
    worst = 0
    for seed in (int(s) for s in a.seeds.split(",")):
        result, _, _ = harness.run(
            ROOT, a.workload, seed, a.seconds, False, time.perf_counter(),
            device=a.device,
            table_factory=lambda c, d, f: ControlTable(d, f))
        print(json.dumps({"control": a.workload, "seed": seed,
                          "correct": result["correct"],
                          "attempted": result["attempted"],
                          "checks": result["checks"]}), flush=True)
        worst = max(worst, int(result["correct"]))
    return worst


if __name__ == "__main__":
    sys.exit(main())
