"""Wrapper of the hand-written CUDA wkv6 kernel (``csrc/wkv6.cu``), the port
of ``wkv6_tpu``.

It checks what the kernel takes before it builds anything, allocates the
outputs, launches on PyTorch's current stream and raises if the launch was
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

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6.cu"
HEAD_SIZES = (8, 16, 32, 64)
DEFAULT_CHUNK = 32
TILE_FLOATS = 2048  # chunk * P: four such tiles fill 32 KB of shared memory, below 48 KB

launches = 0


@functools.cache
def _fwd():
    """The C entry point, built and loaded on first use; argtypes set once."""
    fn = _build.load("wkv6", SOURCE).wkv6_fwd
    # every pointer and the stream as c_void_p, or ctypes cuts them to 32 bits
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def wkv6_cuda(
    r: torch.Tensor,  # (b, s, H, P)
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,  # (H, P)
    state: torch.Tensor,  # (b, H, P, P)
    *,
    state_out: Optional[torch.Tensor] = None,
    chunk: int = DEFAULT_CHUNK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y, final state). The final state is written into ``state_out``
    when given, which may be ``state`` itself (an in-place update)."""
    global launches
    if r.dim() != 4 or any(x.shape != r.shape for x in (k, v, w)):
        raise ValueError(f"want r, k, v, w of one shape (b,s,H,P); got {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, {tuple(w.shape)}")
    b, s, H, P = r.shape
    if min(b, s, H) == 0:
        raise ValueError(f"empty input {tuple(r.shape)}")
    if P not in HEAD_SIZES:
        raise ValueError(f"head size {P} not built; the kernel takes {HEAD_SIZES}")
    if u.shape != (H, P) or state.shape != (b, H, P, P):
        raise ValueError(f"want u (H,P) = {(H, P)} and state (b,H,P,P) = {(b, H, P, P)}; "
                         f"got {tuple(u.shape)}, {tuple(state.shape)}")
    if state_out is not None and state_out.shape != state.shape:
        raise ValueError(f"state_out {tuple(state_out.shape)} is not state's shape")
    if not 1 <= chunk <= TILE_FLOATS // P:
        raise ValueError(f"chunk {chunk} outside 1..{TILE_FLOATS // P} for head size {P}")
    named = (("r", r), ("k", k), ("v", v), ("w", w), ("u", u), ("state", state))
    if state_out is not None:
        named += (("state_out", state_out),)
    for name, x in named:
        if x.dtype != torch.float32:
            raise TypeError(f"{name} is {x.dtype}; the kernel takes fp32")
    for name, x in named:
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x in named:
        if not x.is_cuda or x.device != r.device:
            raise ValueError(f"{name} must lie on r's CUDA device")
    y = torch.empty_like(r)
    out = torch.empty_like(state) if state_out is None else state_out
    with torch.cuda.device(r.device):  # r's card for the launch; the caller's after it
        err = _fwd()(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            state.data_ptr(), y.data_ptr(), out.data_ptr(), b, s, H, P, chunk,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"wkv6_fwd launch failed: error {err}")
    launches += 1
    return y, out
