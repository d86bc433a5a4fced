"""The route of the models' dense products (``runtime/pspec.product``).

A product goes to the 3xTF32 kernel when it can observe that the kernel
takes it and gains: at least ``MIN_ROWS`` rows of ``x``, both operands plain
fp32 tensors on the card (not DTensors), ``w`` 2-D, no gradient to record,
rows 16-byte aligned. Below that the product is bound by reading ``w`` (a
decode step's 16 rows), which cuBLAS does once in fp32 and 3xTF32 cannot
beat. Everything else stays ``x @ w``: the CPU, bf16, training, sharded
tensors and small batches. On the route the kernel runs or raises; there is
no switch and no fallback.

``declined`` counts the calls on a CUDA tensor that the route sent to
``x @ w`` (set it to 0 to start a count); ``kernel.launches`` counts the
others.
"""
from __future__ import annotations

import torch

from . import kernel

# rows of x from which the kernel beats cuBLAS's fp32 product on the H100
# (PERF.md section 3: the sweep over rows at the models' widths)
MIN_ROWS = 256
_PLAIN = (torch.Tensor, torch.nn.Parameter)

declined = 0


def _aligned(x: torch.Tensor, w: torch.Tensor) -> bool:
    x2 = kernel.rows_view(x)
    return (x2 is not None and x2.stride(0) % 4 == 0 and w.stride(1) == 1
            and w.stride(0) % 4 == 0 and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


def route(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether ``x @ w`` on the card goes to the kernel, from what the call
    can observe: the rows of ``x`` (first, so that a decode step's products
    leave at the first test), the operands' types (a DTensor or any other
    subclass is sharded), ``w``'s dimensions, both dtypes, whether autograd
    would record the product, and the rows' strides and alignment."""
    n = x.numel()  # numel and shape[-1]: the cheapest reads of the rows
    if n < MIN_ROWS * x.shape[-1] or not n:
        return False
    if type(x) not in _PLAIN or type(w) not in _PLAIN or w.dim() != 2:
        return False
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        return False
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return False
    return _aligned(x, w)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``, on the kernel where ``route`` takes it."""
    global declined
    if x.is_cuda:
        if route(x, w):
            return kernel.gemm_f32_cuda(x, w)
        declined += 1
    return x @ w
