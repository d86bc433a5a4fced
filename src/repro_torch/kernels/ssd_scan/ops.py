"""Dispatch of the SSD scan by the device of its inputs.

A CUDA tensor goes to the hand-written kernel at every sequence length; it
runs or raises. Where autograd needs a gradient, the launch goes through
``SSDScan``: its forward is the kernel, its backward recomputes
``ssd_chunked`` (the CPU path below, within about 1e-6 of the recurrence
the kernel runs) and differentiates that (no JAX kernel has a backward
kernel to port). A CPU tensor takes ``ssd_chunked`` (chunk 128), the path
the JAX model's forward takes on the CPU (``repro.models.ssm.mamba_forward``).
There is no switch and no fallback.
"""
from __future__ import annotations

import torch

from . import kernel
from .._recompute import plain_gradients
from .ref import ssd_chunked


class SSDScan(torch.autograd.Function):
    """The CUDA kernel as an autograd node: the kernel's y forward (its final
    state dropped, as ``ssd_scan`` returns y only); backward, the gradient of
    ``ssd_chunked`` recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, xh, dt, A, B, C):
        ctx.save_for_backward(xh, dt, A, B, C)
        return kernel.ssd_scan_cuda(xh, dt, A, B, C)[0]

    @staticmethod
    def backward(ctx, grad_y):
        return plain_gradients(ssd_chunked, ctx.saved_tensors, ctx.needs_input_grad, grad_y)


def ssd_scan(xh, dt, A, B, C):
    """xh: (b, s, H, P); dt: (b, s, H); A: (H,); B, C: (b, s, N). Returns y
    only, as the JAX package's ``ssd_scan`` does."""
    if xh.is_cuda:
        if torch.is_grad_enabled() and any(x.requires_grad for x in (xh, dt, A, B, C)):
            return SSDScan.apply(xh, dt, A, B, C)
        return kernel.ssd_scan_cuda(xh, dt, A, B, C)[0]
    if xh.device.type != "cpu":
        raise ValueError(f"no ssd_scan path for device {xh.device}")
    return ssd_chunked(xh, dt, A, B, C)
