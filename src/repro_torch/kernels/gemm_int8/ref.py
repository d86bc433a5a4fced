"""Plain PyTorch version of the paper's PU compute op, as in
``repro.kernels.gemm_int8.ref``: INT8 GEMM with INT32 accumulation, + bias,
power-of-two requantisation (round-half-up arithmetic shift), optional
residual add after the shift, optional ReLU, saturation to INT8 (the
FusedConvAdd(ReLU) dataflow of the PU post-processing block).

Bit-exact on both devices. On the CPU the product is an int32 matmul. CUDA
has no integer matmul (cuBLAS has none, and PyTorch's CUDA ``matmul``
refuses int32 and int64: checked on an H100 with torch 2.11 + CUDA 12.8 by
``chip_smoke.py``), so on the card the product is taken in float64
(``_float64_product``): each term is an integer of magnitude at most 2^14,
so the float64 sum (at most 2^14 K in magnitude) is exact while
2^14 K < 2^53. That bounds the float64 sum, not the int32 result: the sum
is taken through int64 to int32, which wraps modulo 2^32 as JAX's int32
``jnp.dot`` and the kernel do (a float-to-int32 cast would saturate on the
card and give -2^31 on the CPU). The epilogue is int32 on both devices, so
it wraps where JAX's int32 arithmetic wraps.
"""
from __future__ import annotations

from typing import Optional

import torch


def _float64_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The int32 product of int8 a and w, wrapped modulo 2^32, taken in
    float64 (exact while 2^14 K < 2^53) on any device."""
    return (a.double() @ w.double()).to(torch.int64).to(torch.int32)


def _int32_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if a.is_cuda:
        return _float64_product(a, w)
    return a.to(torch.int32) @ w.to(torch.int32)


def requantize(acc: torch.Tensor, bias: Optional[torch.Tensor] = None, *, shift: int = 7,
               relu: bool = False, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The PU post-processing of an int32 (M, N) accumulator: + bias, the
    round-half-up arithmetic shift, + residual, ReLU, saturation to int8."""
    if bias is not None:
        acc = acc + bias.to(torch.int32)[None, :]
    if shift > 0:  # round half up; >> on int32 is arithmetic
        acc = (acc + (1 << (shift - 1))) >> shift
    if residual is not None:
        acc = acc + residual.to(torch.int32)
    if relu:
        acc = torch.clamp_min(acc, 0)
    return acc.clamp(-128, 127).to(torch.int8)


def gemm_int8_reference(
    a: torch.Tensor,  # (M, K) int8 activations
    w: torch.Tensor,  # (K, N) int8 weights
    bias: Optional[torch.Tensor] = None,  # (N,) int32
    *,
    shift: int = 7,  # power-of-two scale: out = acc >> shift
    relu: bool = False,
    residual: Optional[torch.Tensor] = None,  # (M, N) int8, added after the shift
) -> torch.Tensor:
    return requantize(_int32_product(a, w), bias, shift=shift, relu=relu, residual=residual)
