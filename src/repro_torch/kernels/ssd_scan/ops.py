"""Dispatch of the SSD scan by the device of its inputs.

A CUDA tensor goes to the hand-written kernel at every sequence length; it
runs or raises. Where autograd needs a gradient, the launch goes through
``SSDScan``: its forward is the kernel, its backward recomputes
``ssd_chunked`` (the CPU path below, within about 1e-6 of the recurrence
the kernel runs) and differentiates that (no JAX kernel has a backward
kernel to port). A CPU tensor takes ``ssd_chunked`` (chunk 128), the path
the JAX model's forward takes on the CPU (``repro.models.ssm.mamba_forward``).
There is no switch and no fallback.

A DTensor (zamba2 under the ``ssm_x`` spec) runs through ``local_map``:
each rank runs the scan on its own heads, with B and C whole. A shape-only
tensor (a dry run) computes nothing and records the kernel's work
(``kernels/_sharded.py``).
"""
from __future__ import annotations

import torch

from . import kernel
from .. import _sharded
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
    """xh: (b, s, H, P); dt: (b, s, H); A: (H,); B, C: (b, s, N), or (b, s,
    G, N) for G groups of heads. Returns y only, as the JAX package's
    ``ssd_scan`` does."""
    if _sharded.is_dtensor(xh):
        return _sharded_ssd_scan(xh, dt, A, B, C)
    if _sharded.is_shape_only(xh):
        flops, n_bytes = kernel.work(*xh.shape, B.shape[-1], *B.shape[2:-1])
        return _sharded.shape_only("ssd_scan", flops, n_bytes, (xh,), xh, dt, A, B, C)
    if xh.is_cuda:
        if torch.is_grad_enabled() and any(x.requires_grad for x in (xh, dt, A, B, C)):
            return SSDScan.apply(xh, dt, A, B, C)
        return kernel.ssd_scan_cuda(xh, dt, A, B, C)[0]
    if xh.device.type != "cpu":
        raise ValueError(f"no ssd_scan path for device {xh.device}")
    return ssd_chunked(xh, dt, A, B, C)


def _sharded_ssd_scan(xh, dt, A, B, C):
    """The scan of sharded inputs: the kernel on each rank's heads."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = xh.device_mesh
    x_pl, heads_on = _sharded.head_split(xh, 2, (0,), "ssd_scan xh")
    a_pl = tuple(Shard(0) if i == heads_on else Replicate() for i in range(mesh.ndim))
    bc_pl = tuple(Replicate() if i == heads_on else p for i, p in enumerate(x_pl))

    def local(*xs):
        return ssd_scan(*(x.contiguous() for x in xs))

    # every rank reads B and C whole for its own heads, and A whole for its
    # own batch: their gradients are each rank's share, pending sums
    bc_grad = _sharded.partial_on(bc_pl, heads_on)
    a_grad = _sharded.partial_on(a_pl, _sharded.batch_dims(x_pl, heads_on))
    return _sharded.local_call(local, (xh, dt, A, B, C), (x_pl, x_pl, a_pl, bc_pl, bc_pl),
                               x_pl, mesh, grad_pl=(x_pl, x_pl, a_grad, bc_grad, bc_grad))
