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

A DTensor (rwkv6 under the ``ssm_x`` / ``wkv_state`` specs) runs through
``local_map``: each rank runs the recurrence on its own heads, and a state
output given in place must already have the state's placements. A
shape-only tensor (a dry run) computes nothing and records the kernel's
work (``kernels/_sharded.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import kernel
from .. import _sharded
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
    if _sharded.is_dtensor(r):
        return _sharded_wkv6(r, k, v, w, u, state, state_out)
    if _sharded.is_shape_only(r):
        flops, n_bytes = kernel.work(*r.shape)
        y, final = _sharded.shape_only("wkv6", flops, n_bytes, (r, state), r, k, v, w, u, state)
        # the kernel writes the final state over state_out: the same write here
        return y, final if state_out is None else state_out.copy_(final)
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


def _sharded_wkv6(r, k, v, w, u, state, state_out):
    """The recurrence of sharded inputs: the kernel on each rank's heads."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = r.device_mesh
    x_pl, heads_on = _sharded.head_split(r, 2, (0,), "wkv6 r")
    u_pl = tuple(Shard(0) if i == heads_on else Replicate() for i in range(mesh.ndim))
    s_pl = tuple(Shard(1) if i == heads_on else p for i, p in enumerate(x_pl))
    args, in_pl = [r, k, v, w, u, state], [x_pl] * 4 + [u_pl, s_pl]
    if state_out is not None:
        if tuple(state_out.placements) != s_pl:
            raise ValueError(f"wkv6: the in-place state {state_out.placements} is not in the "
                             f"state's placements {s_pl}")
        args.append(state_out)
        in_pl.append(s_pl)

    def local(*xs):
        xs = [x.contiguous() for x in xs[:6]] + list(xs[6:])
        return wkv6(*xs[:6], state_out=xs[6] if len(xs) > 6 else None)

    # every batch shard reads u whole: its gradient is each rank's share
    u_grad = _sharded.partial_on(u_pl, _sharded.batch_dims(x_pl, heads_on))
    grad_pl = [x_pl] * 4 + [u_grad] + in_pl[5:]
    return _sharded.local_call(local, args, in_pl, (x_pl, s_pl), mesh, grad_pl=grad_pl)
