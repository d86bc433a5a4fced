"""Render the dry-run tables from the port's dry-run JSON, the twin of
``repro.launch.report``:

    PYTHONPATH=src python -m repro_torch.launch.report dryrun.json

``compile_s`` is the host's seconds to trace the step here (JAX's: to
compile it); ``temp/chip`` is the step's peak of live bytes a device
(``flop_analysis``: a lower bound on the allocator's peak).
"""
from __future__ import annotations

import json
import sys
from collections import Counter


def fmt_bytes(b: float) -> str:
    if b >= 2**30:
        return f"{b/2**30:.1f}G"
    if b >= 2**20:
        return f"{b/2**20:.1f}M"
    return f"{b:.0f}"


def render(cells: list[dict], mesh: str) -> str:
    rows = [c for c in cells if c["mesh"] == mesh]
    out = [
        f"### Mesh {mesh}",
        "",
        "| arch | shape | status | compile_s | args/chip | temp/chip | "
        "t_comp (ms) | t_mem (ms) | t_coll (ms) | bound | useful |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for c in rows:
        if c["status"] != "ok":
            out.append(
                f"| {c['arch']} | {c['shape']} | {c['status']}: "
                f"{c['reason'][:48]} | | | | | | | | |"
            )
            continue
        out.append(
            f"| {c['arch']} | {c['shape']} | ok | {c['compile_s']:.0f} | "
            f"{fmt_bytes(c['arg_bytes'])} | {fmt_bytes(c['temp_bytes'])} | "
            f"{c['t_compute']*1e3:.1f} | {c['t_memory']*1e3:.1f} | "
            f"{c['t_collective']*1e3:.1f} | {c['bottleneck'][:4]} | "
            f"{c['useful_ratio']:.2f} |"
        )
    ok = [c for c in rows if c["status"] == "ok"]
    bn = Counter(c["bottleneck"] for c in ok)
    out += ["", f"{len(ok)} cells ok; bottleneck split: {dict(bn)}", ""]
    return "\n".join(out)


def main() -> None:
    path = sys.argv[1] if len(sys.argv) > 1 else "dryrun.json"
    with open(path) as f:
        cells = json.load(f)
    for mesh in sorted({c["mesh"] for c in cells}):
        print(render(cells, mesh))


if __name__ == "__main__":
    main()
