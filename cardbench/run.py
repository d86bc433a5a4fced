#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result line.

    python3 cardbench/run.py --workload starcoder2.decode --seed 7 --seconds 30 --trace 0

Run from the root of a checkout. It loads and warms up, measures for
``--seconds``, checks the outputs against the plain reference, and prints,
as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device`` and,
traced, ``breakdown``; the numbers compared come last, under ``checks``, and
again as the last lines of standard error. Without the cards the cell asks
for it exits non-zero and prints no result.
"""
import time

T0 = time.monotonic()  # set-up is timed from the process's first line

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from cardbench import harness

    return harness.main(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), T0)


if __name__ == "__main__":
    sys.exit(main())
