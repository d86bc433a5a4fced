"""Benchmark harness of the port, the twin of the JAX package's
``benchmarks/run.py``: one module per paper table/figure plus the kernel and
roofline reports and the H100-pool DSE. Prints ``name,us_per_call,derived``
CSV lines; a module that fails to import or to run prints its ``ERROR`` row
(as the reference does), the others still run, and the exit code is 1.

Usage:
    PYTHONPATH=src python -m repro_torch.benchmarks.run             # everything
    PYTHONPATH=src python -m repro_torch.benchmarks.run --only fig6 # substring filter

``kernel_bench`` builds the kernels with nvcc and reads them with cuobjdump,
so the whole harness runs where the CUDA toolkit is; the other modules are
host code.
"""
from __future__ import annotations

import argparse
import importlib
import sys
import time
import traceback

MODULES = tuple(f"{__package__}.{name}" for name in
                ("paper_repro", "kernel_bench", "roofline_report", "gpu_dse"))


def main(argv=None, modules=MODULES) -> int:
    """Run ``modules`` (importable names, each with a ``run()`` returning
    rows); returns 0 when every module imported and ran, else 1."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="", help="substring filter on row names")
    args = ap.parse_args(argv)

    failed = 0
    print("name,us_per_call,derived")
    for name in modules:
        # imported one at a time so a failure in one bench doesn't kill the others
        try:
            mod = importlib.import_module(name)
        except Exception:
            print(f"{name},ERROR,import_failed")
            traceback.print_exc()
            failed += 1
            continue
        t0 = time.perf_counter()
        try:
            rows = mod.run()
        except Exception:
            print(f"{name},ERROR,run_failed")
            traceback.print_exc()
            failed += 1
            continue
        for row in rows:
            if args.only and args.only not in row:
                continue
            print(row)
        dt = time.perf_counter() - t0
        print(f"{name}.total,{dt*1e6:.0f},ok")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
