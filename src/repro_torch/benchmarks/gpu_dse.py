"""H100-pool DSE (the paper's Fig. 5 recipe over card deployments), the twin
of the JAX package's ``benchmarks/tpu_dse.py``: enumerate (stages x replicas
x tensor) factorizations of an 8-card NVLink pool per architecture,
Pareto-filter, and report the paper's three canonical points (pure pipeline
/ best hybrid / pure batch). Analytic only: it runs no kernel and needs no
card.

    python -m repro_torch.benchmarks.gpu_dse
"""
from __future__ import annotations

from ..configs import get_config
from ..dse.gpu_deploy import explore_gpu

ARCHS = ["qwen3-0.6b", "h2o-danube-3-4b", "starcoder2-15b", "internvl2-76b"]
CARDS = 8


def run() -> list[str]:
    rows = []
    for arch in ARCHS:
        cfg = get_config(arch)
        points, frontier = explore_gpu(cfg, cards=CARDS)
        best = max(points, key=lambda p: p.throughput)
        pure_pipe = max((p for p in points if p.replicas == 1),
                        key=lambda p: p.throughput)
        pure_batch = max((p for p in points if p.stages == 1),
                         key=lambda p: p.throughput)
        rows.append(
            f"gpu_dse.{arch},,deployments={len(points)};frontier={len(frontier)};"
            f"best={best.label}:{best.throughput:.0f}seq_s;"
            f"pure_pipeline={pure_pipe.label}:{pure_pipe.throughput:.0f};"
            f"pure_batch={pure_batch.label}:{pure_batch.throughput:.0f};"
            f"hybrid_gain_vs_pipeline={best.throughput/pure_pipe.throughput:.2f}x"
        )
    return rows


if __name__ == "__main__":
    for row in run():
        print(row)
