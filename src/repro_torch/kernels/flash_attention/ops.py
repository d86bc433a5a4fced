"""Dispatch of attention by the device of its inputs.

A CUDA tensor goes to the hand-written kernel, which runs or raises. A CPU
tensor goes to the plain PyTorch version (the same math as the JAX package's
CPU dispatch at the shapes the tests use). There is no switch and no fallback.
"""
from __future__ import annotations

from typing import Optional

from . import kernel
from .ref import mha_reference


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None):
    if q.is_cuda:
        return kernel.flash_attention_cuda(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type == "cpu":
        return mha_reference(q, k, v, causal=causal, window=window, scale=scale)
    raise ValueError(f"no attention path for device {q.device}")
