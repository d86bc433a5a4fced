"""Dispatch of the SSD scan by the device of its inputs.

A CUDA tensor goes to the hand-written kernel at every sequence length; it
runs or raises. The kernel has no gradient yet, so where autograd would need
one the CUDA branch raises rather than return an output that autograd cannot
trace back. A CPU tensor takes ``ssd_chunked`` (chunk 128), the path the
JAX model's forward takes on the CPU (``repro.models.ssm.mamba_forward``).
There is no switch and no fallback.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import ssd_chunked


def ssd_scan(xh, dt, A, B, C):
    """xh: (b, s, H, P); dt: (b, s, H); A: (H,); B, C: (b, s, N). Returns y
    only, as the JAX package's ``ssd_scan`` does."""
    if xh.is_cuda:
        if torch.is_grad_enabled() and any(x.requires_grad for x in (xh, dt, A, B, C)):
            raise RuntimeError(
                "ssd_scan has no gradient on CUDA yet (ROADMAP queue 1 item 15); train "
                "mamba models on the CPU, or run the kernel under torch.no_grad()")
        return kernel.ssd_scan_cuda(xh, dt, A, B, C)[0]
    if xh.device.type != "cpu":
        raise ValueError(f"no ssd_scan path for device {xh.device}")
    return ssd_chunked(xh, dt, A, B, C)
