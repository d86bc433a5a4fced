"""Wrapper of the hand-written CUDA fp32 GEMM (``csrc/gemm_f32.cu``): y = x @ w
with 3xTF32 products on wgmma. It replaces no TPU kernel (the JAX package
leaves its dense products to XLA); ``ops.matmul`` routes the models'
prefill-sized products here.

It checks what the kernel takes, allocates the output, launches on PyTorch's
current stream and raises if the launch was refused. ``launches`` counts the
launches of the kernel (set it to 0 to start a count).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from .. import _build
from .._sharded import refuse_wrapped

SOURCE = Path(__file__).resolve().parent / "csrc" / "gemm_f32.cu"

launches = 0


@functools.cache
def _fwd():
    """The C entry point, built and loaded on first use; argtypes set once."""
    fn = _build.load("gemm_f32", SOURCE).gemm_f32_fwd
    # every pointer and the stream as c_void_p, or ctypes cuts them to 32 bits
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, i, i, i, ll, ll, p]
    fn.restype = ctypes.c_int
    return fn


def rows_view(x: torch.Tensor) -> Optional[torch.Tensor]:
    """``x`` as a 2-D (rows, K) view with unit column stride, or None where
    its leading dimensions do not collapse into one stride."""
    if x.dim() < 1 or x.stride(-1) != 1:
        return None
    if x.dim() == 1:
        return x.view(1, -1)
    try:
        return x.view(-1, x.shape[-1])
    except RuntimeError:
        return None


def gemm_f32_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for fp32 ``x`` (..., K) and ``w`` (K, N) on one card, in
    3xTF32 on the tensor cores; the result is contiguous, (..., N)."""
    global launches
    refuse_wrapped("gemm_f32_cuda", x, w)
    if w.dim() != 2 or x.dim() < 1 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"want x (..., K) and w (K, N); got {tuple(x.shape)}, {tuple(w.shape)}")
    for name, t in (("x", x), ("w", w)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must lie on x's CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes fp32")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    x2 = rows_view(x)
    if x2 is None or x2.stride(0) % 4 or w.stride(1) != 1 or w.stride(0) % 4:
        raise ValueError(f"x's rows and w's must be unit-stride with 16-byte row strides; got "
                         f"x {tuple(x.stride())}, w {tuple(w.stride())}")
    M, K = x2.shape
    N = w.shape[1]
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M and N:
        if K == 0:
            y.zero_()
        else:
            with torch.cuda.device(x.device):  # x's card for the launch; the caller's after it
                err = _fwd()(x2.data_ptr(), w.data_ptr(), y.data_ptr(), M, N, K, x2.stride(0),
                             w.stride(0), torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"gemm_f32_fwd launch failed: error {err}")
            launches += 1
    return y.view(*x.shape[:-1], N)

