"""Wrapper of the hand-written CUDA flash-attention kernel
(``csrc/flash_attention.cu``), the port of ``flash_attention_tpu``.

It checks what the kernel takes, allocates the output, launches on
PyTorch's current stream and raises if the launch was refused. ``launches``
counts the launches of the kernel (set it to 0 to start a count).
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Optional

import torch

from .. import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 112, 120, 128, 256)  # 112: zamba2-7b, 120: h2o-danube-3-4b
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


@functools.cache
def _fwd():
    """The C entry point, built and loaded on first use; argtypes set once."""
    fn = _build.load("flash_attention", SOURCE).flash_attention_fwd
    # every pointer and the stream as c_void_p, or ctypes cuts them to 32 bits
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, i, p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(
    q: torch.Tensor,  # (b, s, H, hd)
    k: torch.Tensor,  # (b, t, G, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    global launches
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (b,s,H,hd) and k, v (b,t,G,hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, H, hd = q.shape
    t, G = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or G == 0 or H % G:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do not fit GQA")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not built; the kernel takes {HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device")
        if x.dtype != q.dtype or x.dtype not in _DTYPES:
            raise TypeError(f"{name} is {x.dtype}; the kernel takes one of fp32 / bf16 for all")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    sc = scale if scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):  # q's card for the launch; the caller's after it
        err = _fwd()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, t, H, G, hd, int(causal), window or 0, sc, _DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: error {err}")
    launches += 1
    return out
