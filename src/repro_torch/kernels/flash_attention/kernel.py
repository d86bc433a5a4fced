"""Wrapper of the hand-written CUDA flash-attention kernels, the port of
``flash_attention_tpu``: ``csrc/flash_attention_wgmma.cu`` (wgmma, TMA,
warp roles) for fp32 inputs at the head sizes in ``WGMMA_HEAD_DIMS``, and
``csrc/flash_attention.cu`` (mma.sync) for bf16 and every other head size
(``route``).

It checks what the kernel takes, allocates the output, launches on
PyTorch's current stream and raises if the launch was refused. ``launches``
counts the launches of either kernel and ``launches_wgmma`` those of the
wgmma one (set them to 0 to start a count).
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .. import _build
from .._sharded import refuse_wrapped

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
SOURCE_WGMMA = Path(__file__).resolve().parent / "csrc" / "flash_attention_wgmma.cu"
# 112: zamba2-7b, 120: h2o-danube-3-4b, 224: Zamba2-7B as published (HybridConfig)
HEAD_DIMS = (16, 32, 64, 112, 120, 128, 224, 256)
# fp32 head sizes that take the wgmma kernel: those where it timed faster
# than the mma.sync one at the main path's shape (PERF.md section 6)
WGMMA_HEAD_DIMS = (64, 112, 120, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
launches_wgmma = 0


def route(dtype: torch.dtype, hd: int) -> str:
    """The kernel a call of this dtype and head size launches: ``"wgmma"``
    (fp32 at a head size in ``WGMMA_HEAD_DIMS``) or ``"mma.sync"``."""
    return "wgmma" if dtype == torch.float32 and hd in WGMMA_HEAD_DIMS else "mma.sync"


@functools.cache
def _fwd():
    """The C entry point, built and loaded on first use; argtypes set once."""
    fn = _build.load("flash_attention", SOURCE).flash_attention_fwd
    # every pointer and the stream as c_void_p, or ctypes cuts them to 32 bits
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _fwd_wgmma():
    """The wgmma kernel's C entry point, built and loaded on first use."""
    fn = _build.load("flash_attention_wgmma", SOURCE_WGMMA).flash_attention_wgmma_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


def plan(hd: int, dtype: torch.dtype) -> dict:
    """The launch ``flash_attention_cuda`` makes at head size ``hd``, as the
    built source of its route reports it (``flash_attention_wgmma_plan`` or
    ``flash_attention_plan``): threads a block, dynamic shared memory, q rows
    a block, kv rows a tile."""
    out = (ctypes.c_int * 4)()
    if route(dtype, hd) == "wgmma":
        err = _build.load("flash_attention_wgmma", SOURCE_WGMMA).flash_attention_wgmma_plan(
            hd, out)
    else:
        err = _build.load("flash_attention", SOURCE).flash_attention_plan(hd, _DTYPES[dtype], out)
    if err != 0:
        raise ValueError(f"flash_attention: no launch at head size {hd}, {dtype}")
    return dict(zip(("threads", "smem_bytes", "bq", "bk"), out))


def flash_attention_cuda(
    q: torch.Tensor,  # (b, s, H, hd)
    k: torch.Tensor,  # (b, t, G, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    global launches, launches_wgmma
    refuse_wrapped("flash_attention_cuda", q, k, v)
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
    wgmma = route(q.dtype, hd) == "wgmma"
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, t, H, G, hd,
            int(causal), window or 0, sc)
    with torch.cuda.device(q.device):  # q's card for the launch; the caller's after it
        stream = torch.cuda.current_stream().cuda_stream
        err = _fwd_wgmma()(*args, stream) if wgmma else _fwd()(*args, _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_{'wgmma_' if wgmma else ''}fwd launch failed: "
                           f"error {err}")
    launches += 1
    launches_wgmma += wgmma
    return out


def kept_pairs(s: int, t: int, causal: bool = True, window: Optional[int] = None) -> int:
    """The (row, column) pairs of an s x t score matrix that the mask keeps
    (col < t, col <= row if causal, col > row - window if a window is
    given), counted row by row without the matrix."""
    rows = np.arange(s, dtype=np.int64)  # numpy: the count never meets a fake mode
    hi = np.minimum(rows + 1, t) if causal else np.full_like(rows, t)
    lo = np.maximum(rows - window + 1, 0) if window is not None else np.zeros_like(rows)
    return int(np.maximum(hi - lo, 0).sum())


def work(q_shape, k_shape, causal: bool, window: Optional[int], itemsize: int):
    """(operations, bytes) of one call, as the kernel's bound counts them:
    two products of hd a kept (row, column) pair and head, q, k, v read and
    the output written once."""
    b, s, H, hd = q_shape
    t, G = k_shape[1], k_shape[2]
    flops = 4 * hd * b * H * kept_pairs(s, t, causal, window)
    n_bytes = itemsize * (2 * b * s * H * hd + 2 * b * t * G * hd)
    return flops, n_bytes
