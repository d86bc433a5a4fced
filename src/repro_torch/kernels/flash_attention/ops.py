"""Dispatch of attention by the device of its inputs.

A CUDA tensor goes to the hand-written kernel, which runs or raises. Where
autograd needs a gradient of the result, the launch goes through
``FlashAttention``: its forward is the kernel, its backward recomputes the
attention with the plain version and differentiates that (no JAX kernel has
a backward kernel to port). A CPU tensor takes ``plain_attention``, the JAX
package's CPU dispatch. There is no switch and no fallback.

A DTensor (a model sharded under a ``ShardingPolicy``) runs through
``local_map``: each rank launches the kernel on its own heads (or, on the
CPU, the plain version on them), k/v narrowed to the groups those heads
read where the policy leaves k/v whole. A shape-only tensor (a dry run)
computes nothing and records the kernel's work (``kernels/_sharded.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import kernel
from .. import _sharded
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


def _sharded_attention(q, k, v, causal, window, scale):
    """Attention of a sharded q, k, v: the kernel on each rank's heads."""
    mesh = q.device_mesh
    q_pl, heads_on = _sharded.head_split(q, 2, (0,), "flash_attention q")
    kv_pl, pick = _sharded.group_placements(q_pl, heads_on, mesh, q.shape[2], k.shape[2], 2)

    def local(ql, kl, vl):
        if pick is not None:
            kl, vl = pick(kl), pick(vl)
        return flash_attention(ql.contiguous(), kl.contiguous(), vl.contiguous(),
                               causal=causal, window=window, scale=scale)

    # a rank that narrows k/v to its groups gives them a share of their
    # gradient: a pending sum over the heads' mesh dimension
    kv_grad = kv_pl if pick is None else _sharded.partial_on(kv_pl, heads_on)
    return _sharded.local_call(local, (q, k, v), (q_pl, kv_pl, kv_pl), q_pl, mesh,
                               grad_pl=(q_pl, kv_grad, kv_grad))


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None):
    if _sharded.is_dtensor(q):
        return _sharded_attention(q, k, v, causal, window, scale)
    if _sharded.is_shape_only(q):
        flops, n_bytes = kernel.work(q.shape, k.shape, causal, window, q.element_size())
        return _sharded.shape_only("flash_attention", flops, n_bytes, (q,), q, k, v)
    if q.is_cuda:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return FlashAttention.apply(q, k, v, causal, window, scale)
        return kernel.flash_attention_cuda(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type == "cpu":
        return plain_attention(q, k, v, causal=causal, window=window, scale=scale)
    raise ValueError(f"no attention path for device {q.device}")
