"""Roofline rows from the port's dry run, the twin of
``benchmarks/roofline_report.py``.

Reads the JSON that ``python -m repro_torch.launch.dryrun --out PATH``
writes and returns, per (mesh x arch x shape), the three per-device
roofline terms on H100 constants, the dominant one, and the
MODEL_FLOPS / counted FLOPs "useful compute" ratio; a hint row where the
file is absent:

    PYTHONPATH=src python -m repro_torch.benchmarks.roofline_report [PATH]
"""
from __future__ import annotations

import json
import os
import sys
from collections import Counter

DEFAULT = "dryrun.json"


def run(path: str = DEFAULT) -> list[str]:
    if not os.path.exists(path):
        return [f"roofline.missing,,run `python -m repro_torch.launch.dryrun --arch all "
                f"--both-meshes --out {path}` first"]
    with open(path) as f:
        cells = json.load(f)
    rows = []
    for c in cells:
        key = f"roofline.{c['mesh']}.{c['arch']}.{c['shape']}"
        if c["status"] == "skipped":
            rows.append(f"{key},,SKIPPED({c['reason'][:60]})")
            continue
        if c["status"] == "error":
            rows.append(f"{key},,ERROR({c['reason'][:80]})")
            continue
        rows.append(
            f"{key},{c['compile_s']*1e6:.0f},"
            f"t_compute_ms={c['t_compute']*1e3:.2f};"
            f"t_memory_ms={c['t_memory']*1e3:.2f};"
            f"t_collective_ms={c['t_collective']*1e3:.2f};"
            f"bottleneck={c['bottleneck']};useful={c['useful_ratio']:.2f};"
            f"args_gib={c['arg_bytes']/2**30:.2f};temp_gib={c['temp_bytes']/2**30:.2f};"
            f"out_gib={c['output_bytes']/2**30:.2f}"
        )
    ok = [c for c in cells if c["status"] == "ok"]
    if ok:
        bn = Counter(c["bottleneck"] for c in ok)
        rows.append(f"roofline.summary,,cells_ok={len(ok)};bottlenecks={dict(bn)}")
    return rows


if __name__ == "__main__":
    print("\n".join(run(sys.argv[1] if len(sys.argv) > 1 else DEFAULT)))
