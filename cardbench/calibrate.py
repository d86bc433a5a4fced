#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from (PERF.md, section 2).

    python3 cardbench/calibrate.py --workload starcoder2.decode --seeds 1,2,3 --seconds 30

Runs the cell's timed path once a seed, all seeds in one process (or one
spawn of ranks), each with the window of a run, and prints a JSON line a
seed: each compared number of the program and, beside it, the control's
(the reference with TF32 on, put in the program's place). Not run by the
benchmark's own runs.
"""
import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def readings(root: Path, cell: str, seeds: list[int], seconds: float, t0: float,
             device: str = "cuda") -> list[dict]:
    """A reading a seed: the program's compared numbers and the control's."""
    from cardbench import harness

    bench = harness.Bench(root)
    c = bench.cell(cell)
    spec = harness.run_spec(c, seeds, seconds, False, t0, device, control=True)
    records = harness.driver(c["traffic_spec"]["driver"]).run(spec)
    return [{"seed": seed, "program": {k: v["value"] for k, v in r["checks"].items()},
             "control": r["control"], "setup_s": r["setup_s"], "window_s": r["window_s"],
             "attempted": r["attempted"]} for seed, r in zip(seeds, records)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    seeds = [int(s) for s in args.seeds.split(",")]
    for line in readings(ROOT, args.workload, seeds, args.seconds, T0):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
