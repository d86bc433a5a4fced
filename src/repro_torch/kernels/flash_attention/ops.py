"""Dispatch of attention by the device of its inputs.

A CUDA tensor goes to the hand-written kernel, which runs or raises. Where
autograd needs a gradient of the result, the launch goes through
``FlashAttention``: its forward is the kernel, its backward recomputes the
attention with the plain version and differentiates that (no JAX kernel has
a backward kernel to port). A CPU tensor takes ``plain_attention``, the JAX
package's CPU dispatch. There is no switch and no fallback.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import kernel
from .._recompute import plain_gradients
from .ref import banded_attention, chunked_attention, mha_reference

# above this many kv positions the plain path takes the chunked online
# softmax (O(S * block) memory) instead of the dense version, as in JAX
CHUNKED_THRESHOLD = 2048


def plain_path(s: int, t: int, causal: bool, window: Optional[int]) -> str:
    """Which plain version ``plain_attention`` takes at these shapes:
    ``banded``, ``chunked`` or ``dense`` (``repro.kernels.flash_attention.ops``)."""
    if causal and window is not None and s == t and t >= 2 * window:
        return "banded"
    if t > CHUNKED_THRESHOLD:
        return "chunked"
    return "dense"


def plain_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None):
    """The plain version the JAX package's CPU dispatch picks."""
    path = plain_path(q.shape[1], k.shape[1], causal, window)
    if path == "banded":
        return banded_attention(q, k, v, window=window, scale=scale)
    if path == "chunked":
        return chunked_attention(q, k, v, causal=causal, window=window, scale=scale)
    return mha_reference(q, k, v, causal=causal, window=window, scale=scale)


class FlashAttention(torch.autograd.Function):
    """The CUDA kernel as an autograd node: the kernel's output forward, the
    plain version's gradient (recomputed from the saved q, k, v) backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, scale=scale)
        return kernel.flash_attention_cuda(q, k, v, causal=causal, window=window, scale=scale)

    @staticmethod
    def backward(ctx, grad_out):
        return (*plain_gradients(plain_attention, ctx.saved_tensors, ctx.needs_input_grad[:3],
                                 grad_out, **ctx.opts), None, None, None)


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None):
    if q.is_cuda:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return FlashAttention.apply(q, k, v, causal, window, scale)
        return kernel.flash_attention_cuda(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type == "cpu":
        return plain_attention(q, k, v, causal=causal, window=window, scale=scale)
    raise ValueError(f"no attention path for device {q.device}")
