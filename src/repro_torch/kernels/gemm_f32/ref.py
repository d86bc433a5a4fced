"""Plain PyTorch versions of the 3xTF32 GEMM, for the tests and
``chip_smoke.py``; the main path does not use them.

``gemm_tf32`` emulates the kernel's arithmetic on fp32 inputs: each operand
split as the flash kernel splits (``split_tf32``: big rounded to TF32, small
the remainder truncated as the tensor cores read it); a k step of 8 at a
time, the three products small.big, big.small and big.big each summed
exactly and added to a partial sum in fp32 rounded toward zero, as the
tensor cores add to their accumulators; every ``promote`` steps (a 32-k
stage) the partial added to the fp32 sum, rounded to nearest, and a new
partial begun. ``promote=None`` keeps one partial for the whole of K, as
one long wgmma accumulator would; ``split=False`` is one product of the
rounded operands, plain TF32. ``gemm_float64`` is the yardstick.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..flash_attention.ref import K_STEP, split_tf32, tf32_round, toward_zero

PROMOTE = 4  # k steps a stage: the kernel's partial sums cover 32 k


def gemm_float64(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x.double() @ w.double()


def gemm_tf32(x: torch.Tensor, w: torch.Tensor, *, split: bool = True,
              promote: Optional[int] = PROMOTE) -> torch.Tensor:
    """(M, K) @ (K, N) as the kernel computes it, on the CPU; fp32 out."""
    if split:
        xb, xs = (p.double() for p in split_tf32(x))
        wb, ws = (p.double() for p in split_tf32(w))
        terms = [(xs, wb), (xb, ws), (xb, wb)]  # the kernel's order: y^T = w^T x^T
    else:
        terms = [(tf32_round(x).double(), tf32_round(w).double())]
    out = torch.zeros(x.shape[0], w.shape[1], dtype=torch.float32)
    part = torch.zeros_like(out)
    steps = -(-x.shape[1] // K_STEP)
    for i in range(steps):
        sl = slice(i * K_STEP, (i + 1) * K_STEP)
        for a, b in terms:
            part = toward_zero(part.double() + a[:, sl] @ b[sl])
        if promote is not None and ((i + 1) % promote == 0 or i == steps - 1):
            out, part = out + part, torch.zeros_like(out)
    return out if promote is not None else part


def rms_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """RMS of ``got - want`` over the RMS of ``want``, in float64."""
    want = want.double()
    return float((got.double() - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())
