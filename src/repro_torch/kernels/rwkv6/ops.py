"""Dispatch of the wkv6 recurrence by the device of its inputs.

A CUDA tensor goes to the hand-written kernel at every sequence length,
decode steps included, as the TPU branch of ``repro.kernels.rwkv6.ops``
does; it runs or raises. Where autograd needs a gradient, the launch goes
through ``WKV6``: its forward is the kernel, its backward recomputes the
sequential ``wkv6_reference`` (the recurrence the kernel computes, which the
chunked form is not where a chunk's log decay passes -CLAMP) and
differentiates that (no JAX kernel has a backward kernel to port). A CPU
tensor takes the JAX package's CPU dispatch: the chunked form for ``s > 1``
and the sequential recurrence for ``s == 1``. There is no switch and no
fallback.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import kernel
from .._recompute import plain_gradients
from .ref import wkv6_chunked, wkv6_reference


class WKV6(torch.autograd.Function):
    """The CUDA kernel as an autograd node: the kernel's (y, final state)
    forward; backward, the gradient of ``wkv6_reference`` recomputed from the
    saved inputs, for all six of them (``u`` and the initial state too)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        ctx.save_for_backward(r, k, v, w, u, state)
        return kernel.wkv6_cuda(r, k, v, w, u, state)

    @staticmethod
    def backward(ctx, grad_y, grad_state):
        return plain_gradients(wkv6_reference, ctx.saved_tensors, ctx.needs_input_grad,
                               (grad_y, grad_state))


def wkv6(r, k, v, w, u, state, *, state_out: Optional[torch.Tensor] = None):
    """Returns (y, final state); the final state is written into
    ``state_out`` when given, which may be ``state`` itself."""
    if r.is_cuda:
        if torch.is_grad_enabled() and any(
                x.requires_grad for x in (r, k, v, w, u, state)):
            if state_out is not None:
                raise ValueError("state_out (an in-place cache write) takes no gradient; "
                                 "serve under torch.inference_mode()")
            return WKV6.apply(r, k, v, w, u, state)
        return kernel.wkv6_cuda(r, k, v, w, u, state, state_out=state_out)
    if r.device.type != "cpu":
        raise ValueError(f"no wkv6 path for device {r.device}")
    plain = wkv6_chunked if r.shape[1] > 1 else wkv6_reference
    y, final = plain(r, k, v, w, u, state)
    if state_out is None:
        return y, final
    return y, state_out.copy_(final)
