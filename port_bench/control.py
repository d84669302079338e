#!/usr/bin/env python3
"""The control of a cell's correctness check: one run of the program per
seed, judged twice, by the plain reference and by the control (the
reference with one guarantee broken: each queue window started from the
availability the window before it started from, as a solve dispatched
before the previous commit would be). The check is sound
only if the program reads 0 against the reference and the control reads
above 0 against the program on every seed.

    python3 port_bench/control.py --workload <cell> --seeds 1,2,3 --seconds 5

Prints one JSON line per seed with both readings. The benchmark's own
runs never run it; `port_bench/tests/test_bench_control.py` runs it at a small
size on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench import run  # noqa: E402


def readings(cell: str, seed: int, seconds: float, device=None) -> dict:
    """One program run of `cell`; the numbers its check compares, against
    the reference and against the control."""
    result = run.run_cell(cell, seed, seconds, False, device=device,
                          t_start=time.perf_counter())
    driver = run.run_cell.last_driver
    control = {c.name: c.value for c in driver.check(control=True)}
    return {"cell": cell, "seed": seed, "correct": result["correct"],
            "reference": {k: v["value"] for k, v in result["checks"].items()},
            "control": control}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, args.seconds)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
