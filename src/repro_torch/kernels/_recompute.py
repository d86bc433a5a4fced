"""The backward every kernel's autograd Function shares: no JAX kernel has a
backward kernel to port, so each differentiates a plain version of what its
kernel computes, recomputed from the saved inputs."""
from __future__ import annotations

import torch


def plain_gradients(plain, saved, need, grad_out, **kw) -> tuple:
    """Gradients of ``plain(*saved, **kw)`` for the inputs ``need`` marks
    (None for the others), given the cotangents ``grad_out`` of its
    outputs."""
    with torch.enable_grad():
        inputs = [x.detach().requires_grad_(n) for x, n in zip(saved, need)]
        out = plain(*inputs, **kw)
        wrt = [x for x in inputs if x.requires_grad]
        grads = iter(torch.autograd.grad(out, wrt, grad_out))
    return tuple(next(grads) if n else None for n in need)
