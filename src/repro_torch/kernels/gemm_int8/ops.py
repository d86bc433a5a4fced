"""Dispatch of the INT8 PU GEMM by the device of its inputs.

A CUDA tensor goes to the hand-written kernel, with ``bias=None`` taken as
int32 zeros as the TPU branch of ``repro.kernels.gemm_int8.ops`` does; it
runs or raises. A CPU tensor takes the plain version. There is no switch
(no counterpart of ``REPRO_FORCE_REF``) and no fallback.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import gemm_int8_reference


def gemm_int8(a, w, bias=None, *, shift: int = 7, relu: bool = False, residual=None):
    """int8 (M, K) @ int8 (K, N) -> int8 (M, N) with the PU epilogue."""
    if a.is_cuda:
        b = bias if bias is not None else torch.zeros((w.shape[1],), dtype=torch.int32,
                                                      device=a.device)
        return kernel.gemm_int8_cuda(a, w, b, residual, shift=shift, relu=relu)
    if a.device.type != "cpu":
        raise ValueError(f"no gemm_int8 path for device {a.device}")
    return gemm_int8_reference(a, w, bias, shift=shift, relu=relu, residual=residual)
