"""The harness: a cell's pieces found by name, its driver run, its metrics
read, the result line printed.

A driver (``drivers/<name>.py``) has ``run(spec) -> list[record]``, one
record a seed of ``spec["seeds"]``. A record is a dict of what the run
measured and counted (the readers' input), plus ``setup_s``, ``attempted``,
``failed``, ``device``, ``checks`` (each compared number beside its limit)
and ``forbidden_modules`` (what its other processes found loaded). A metric
reader (``metrics/<metric>.py``) has ``read(record) -> float | None``, None
where the record holds nothing for it to read.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Callable, Optional

# no process of a run may hold these, compared by whole top-level name: the
# JAX stack and the JAX package (the port's own name begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded() -> list[str]:
    """The forbidden top-level modules this process has loaded."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


class Bench:
    """``BENCHMARK.json`` and the files under ``cardbench/`` of one checkout."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.dir = self.root / "cardbench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def _json(self, kind: str, name: str) -> dict:
        return json.loads((self.dir / kind / f"{name}.json").read_text())

    def cell(self, name: str) -> dict:
        """The cell's file, its configuration and its traffic."""
        cell = self._json("workloads", name)
        return {**cell, "name": name, "config_spec": self._json("configs", cell["config"]),
                "traffic_spec": self._json("traffic", cell["traffic"])}

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The metrics a run of ``cell`` reports: its end-to-end metrics
        untraced, its per-layer metrics traced (a metric without
        ``workloads`` belongs to every cell)."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.spec[kind] if cell in m.get("workloads", [cell])]

    def reader(self, metric: str) -> Callable[[dict], Optional[float]]:
        path = self.dir / "metrics" / f"{metric}.py"
        mod_spec = importlib.util.spec_from_file_location(f"cardbench_metric_{metric}", path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        return mod.read


def driver(name: str):
    return importlib.import_module(f"cardbench.drivers.{name}")


def run_spec(cell: dict, seeds: list[int], seconds: float, trace: bool, t0: float,
             device: str, control: bool = False) -> dict:
    """What a driver is handed: the seeds and the cell's parameters."""
    return {"cell": cell["name"], "config": cell["config_spec"],
            "traffic": cell["traffic_spec"], "chips": cell["chips"],
            "limits": cell["limits"], "seeds": list(seeds), "seconds": float(seconds),
            "trace": bool(trace), "t0": t0, "device": device, "control": control}


def checks_pass(checks: dict) -> bool:
    """Every compared number is a number and within its limit."""
    return bool(checks) and all(
        isinstance(c["value"], (int, float)) and math.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in checks.values())


def result(bench: Bench, cell: str, record: dict, trace: bool) -> dict:
    """The result line's object for one record."""
    metrics = {}
    for m in bench.metrics(cell, trace):
        value = bench.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {"correct": checks_pass(record["checks"]), "attempted": record["attempted"],
           "failed": record["failed"], "metrics": metrics, "device": dict(record["device"])}
    if trace and "trace" in record:
        tr = record["trace"]
        out["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    out["checks"] = record["checks"]  # last: the numbers compared, each beside its limit
    return out


def run_cell(bench: Bench, cell: str, seed: int, seconds: float, trace: bool, t0: float,
             device: str = "cuda") -> dict:
    """One run of ``cell``: its driver's record for ``seed``."""
    c = bench.cell(cell)
    spec = run_spec(c, [seed], seconds, trace, t0, device)
    return driver(c["traffic_spec"]["driver"]).run(spec)[0]


def main(root: Path, cell: str, seed: int, seconds: float, trace: bool, t0: float) -> int:
    bench = Bench(root)
    chips = bench.cell(cell)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cardbench: {cell} needs {chips} CUDA card(s), this machine has {have}",
              file=sys.stderr)
        return 2
    record = run_cell(bench, cell, seed, seconds, trace, t0)
    found = sorted(set(forbidden_loaded()) | set(record.get("forbidden_modules", [])))
    if found:
        print(f"cardbench: the run loaded {found} (the JAX stack or the JAX package)",
              file=sys.stderr)
        return 3
    out = result(bench, cell, record, trace)
    print(f"cardbench: set-up {record['setup_s']:.3f} s, window {record['window_s']:.3f} s, "
          f"reference {record['reference_s']:.3f} s", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
