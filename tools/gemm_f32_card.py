#!/usr/bin/env python3
"""The 3xTF32 fp32 GEMM (``kernels/gemm_f32``) on one NVIDIA card: checked
and timed, the route's threshold swept, and the host's cost of the route
where it declines.

    python3 tools/gemm_f32_card.py [--phases check,time,sweep,decline] [--out F]

check and time: ``chip_smoke.check_gemm_f32`` and ``time_gemm_f32`` at
``chip_smoke.F32_CHECKED`` and ``F32_TIMED``; fails beyond 4x torch's fp32
error. sweep: the kernel against torch's fp32 product (TF32 off) over the
rows of x at the models' widths, device time from CUDA graphs, which sets
``ops.MIN_ROWS``. decline: the host's time a call of ``x @ w``,
``gemm_f32.ops.matmul`` and ``pspec.product`` on products the route
declines (starcoder2-15b's decode step: 16 rows at d_model 6144), each
call enqueued from Python and the card left to drain between rounds, in
rounds of plain, routed, routed, plain. Every number goes to the JSON file
``--out`` names.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.gemm_f32 import kernel as gk  # noqa: E402

# (K, N) of the sweep: h2o-danube-3-4b's q / up / down, starcoder2-15b's q and up
SWEEP_KN = [(3840, 3840), (3840, 10240), (10240, 3840), (6144, 6144), (6144, 24576)]
SWEEP_ROWS = [16, 32, 64, 128, 192, 256, 384, 512, 768, 1024, 2048, 4608]


def sweep(report) -> list:
    rows = []
    for K, N in SWEEP_KN:
        w = smoke.f32_operands(1, K, N, 3000 + K + N)[1]
        for M in SWEEP_ROWS:
            x = smoke.f32_operands(M, K, 1, 4000 + M)[0]
            kern = smoke.graph_ms(lambda: gk.gemm_f32_cuda(x, w), 10, 3)
            plain = smoke.graph_ms(lambda: x @ w, 10, 3)
            rows.append({"M": M, "K": K, "N": N, "kernel_ms": kern, "torch_fp32_ms": plain})
            report(f"sweep ({M}, {K}) x ({K}, {N}): kernel {kern:.4f} ms, torch fp32 "
                   f"{plain:.4f} ms, ratio {plain / kern:.3f}")
        del w, x
    return rows


# starcoder2-15b's decode products, (rows, K, N): q, k/v (4 heads of 128),
# up, down and the head; and a product whose card time is negligible
DECLINE_SHAPES = [(16, 6144, 6144), (16, 6144, 512), (16, 6144, 24576), (16, 24576, 6144),
                  (16, 6144, 49152), (16, 64, 64)]
DECLINE_CALLS, DECLINE_ROUNDS = 200, 8


def decline(report) -> list:
    """Host microseconds a call, the median over rounds: a round enqueues
    DECLINE_CALLS products and is timed to the last call's return, before
    the card has finished, after a synchronize."""
    from statistics import median

    from repro_torch.kernels.gemm_f32 import ops
    from repro_torch.runtime.pspec import product

    fns = {"plain": lambda x, w: x @ w, "ops.matmul": ops.matmul, "pspec.product": product}
    rows = []
    for M, K, N in DECLINE_SHAPES:
        x, w = smoke.f32_operands(M, K, N, 5000 + K + N)
        x = x.view(M, 1, K)  # a decode step's (lanes, 1, d_model)
        us = {name: [] for name in fns}
        order = ["plain", "ops.matmul", "pspec.product", "pspec.product", "ops.matmul", "plain"]
        with torch.no_grad():
            for name in fns:
                fns[name](x, w)  # warm
            for _ in range(DECLINE_ROUNDS):
                for name in order:
                    fn = fns[name]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(DECLINE_CALLS):
                        fn(x, w)
                    us[name].append((time.perf_counter() - t0) / DECLINE_CALLS * 1e6)
        torch.cuda.synchronize()
        row = {"M": M, "K": K, "N": N, **{f"{k}_us": median(v) for k, v in us.items()}}
        rows.append(row)
        report(f"decline ({M}, 1, {K}) x ({K}, {N}): host us a call, median of "
               f"{2 * DECLINE_ROUNDS} rounds of {DECLINE_CALLS}: " + ", ".join(
                   f"{k} {row[k + '_us']:.2f}" for k in fns)
               + f"; ops.matmul - plain {row['ops.matmul_us'] - row['plain_us']:+.2f}")
        del x, w
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="check,time,sweep,decline")
    ap.add_argument("--out", help="write every number here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gemm_f32_card: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smoke.card_line()
    print(f"card: {card}; torch {torch.__version__}, cuda {torch.version.cuda}")

    def report(msg):
        print(f"{msg}  [{card}]", flush=True)

    t0 = time.time()
    built = _build.build({"gemm_f32": gk.SOURCE})["gemm_f32"]
    print(f"built {built.path.name} in {time.time() - t0:.1f} s\n{built.log}")
    out = {"card": card}
    phases = args.phases.split(",")
    if "check" in phases:
        out["check"] = smoke.check_gemm_f32(gk, report)
    if "time" in phases:
        out["time"] = smoke.time_gemm_f32(gk, report)
    if "sweep" in phases:
        out["sweep"] = sweep(report)
    if "decline" in phases:
        out["decline"] = decline(report)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
