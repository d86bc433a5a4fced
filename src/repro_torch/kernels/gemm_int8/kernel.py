"""Wrapper of the hand-written CUDA INT8 PU GEMM (``csrc/gemm_int8.cu``), the
port of ``gemm_int8_tpu``.

It checks what the kernel takes before it builds anything, allocates the
output, launches on PyTorch's current stream and raises if the launch was
refused. ``launches`` counts the launches of the kernel (set it to 0 to
start a count).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from .. import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "gemm_int8.cu"
MAX_SHIFT = 31  # the ISA's 5-bit Compute.SCALE field (repro/core/isa.py:484)

launches = 0


@functools.cache
def _fwd():
    """The C entry point, built and loaded on first use; argtypes set once."""
    fn = _build.load("gemm_int8", SOURCE).gemm_int8_fwd
    # every pointer and the stream as c_void_p, or ctypes cuts them to 32 bits
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def gemm_int8_cuda(
    a: torch.Tensor,  # (M, K) int8
    w: torch.Tensor,  # (K, N) int8, row-major: N contiguous, as in JAX
    bias: torch.Tensor,  # (N,) int32
    residual: Optional[torch.Tensor] = None,  # (M, N) int8
    *,
    shift: int,
    relu: bool,
) -> torch.Tensor:
    """Returns the (M, N) int8 output of the fused GEMM."""
    global launches
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"want a (M,K) and w (K,N); got {tuple(a.shape)}, {tuple(w.shape)}")
    (M, K), N = a.shape, w.shape[1]
    if min(M, N, K) == 0:
        raise ValueError(f"empty product (M, N, K) = {(M, N, K)}")
    if bias.shape != (N,):
        raise ValueError(f"want bias (N,) = {(N,)}; got {tuple(bias.shape)}")
    if residual is not None and residual.shape != (M, N):
        raise ValueError(f"want residual (M,N) = {(M, N)}; got {tuple(residual.shape)}")
    if isinstance(shift, bool) or not isinstance(shift, int) or not 0 <= shift <= MAX_SHIFT:
        raise ValueError(f"shift {shift!r} outside 0..{MAX_SHIFT}")
    named = (("a", a, torch.int8), ("w", w, torch.int8), ("bias", bias, torch.int32))
    if residual is not None:
        named += (("residual", residual, torch.int8),)
    for name, x, dtype in named:
        if x.dtype != dtype:
            raise TypeError(f"{name} is {x.dtype}; the kernel takes {dtype}")
    for name, x, _ in named:
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x, _ in named:
        if not x.is_cuda or x.device != a.device:
            raise ValueError(f"{name} must lie on a's CUDA device")
    out = torch.empty((M, N), dtype=torch.int8, device=a.device)
    with torch.cuda.device(a.device):  # a's card for the launch; the caller's after it
        err = _fwd()(
            a.data_ptr(), w.data_ptr(), bias.data_ptr(),
            None if residual is None else residual.data_ptr(), out.data_ptr(),
            M, N, K, shift, int(bool(relu)), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"gemm_int8_fwd launch failed: error {err}")
    launches += 1
    return out
