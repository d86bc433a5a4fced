"""Dispatch of the wkv6 recurrence by the device of its inputs.

A CUDA tensor goes to the hand-written kernel at every sequence length,
decode steps included, as the TPU branch of ``repro.kernels.rwkv6.ops``
does; it runs or raises. The kernel has no gradient yet, so where autograd
would need one the CUDA branch raises rather than return an output that
autograd cannot trace back. A CPU tensor takes the JAX package's CPU dispatch:
the chunked form for ``s > 1`` and the sequential recurrence for ``s == 1``.
There is no switch and no fallback.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import kernel
from .ref import wkv6_chunked, wkv6_reference


def wkv6(r, k, v, w, u, state, *, state_out: Optional[torch.Tensor] = None):
    """Returns (y, final state); the final state is written into
    ``state_out`` when given, which may be ``state`` itself."""
    if r.is_cuda:
        if torch.is_grad_enabled() and any(
                x.requires_grad for x in (r, k, v, w, u, state)):
            raise RuntimeError(
                "wkv6 has no gradient on CUDA yet (ROADMAP queue 1 item 15); train rwkv "
                "models on the CPU, or run the kernel under torch.no_grad()")
        return kernel.wkv6_cuda(r, k, v, w, u, state, state_out=state_out)
    if r.device.type != "cpu":
        raise ValueError(f"no wkv6 path for device {r.device}")
    plain = wkv6_chunked if r.shape[1] > 1 else wkv6_reference
    y, final = plain(r, k, v, w, u, state)
    if state_out is None:
        return y, final
    return y, state_out.copy_(final)
