"""Wrapper of the hand-written CUDA SSD-scan kernel (``csrc/ssd_scan.cu``),
the port of ``ssd_scan_tpu``.

It checks what the kernel takes before it builds anything, allocates the
outputs, launches on PyTorch's current stream and raises if the launch was
refused. ``launches`` counts the launches of the kernel (set it to 0 to
start a count).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .. import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
# (head size P, state size N) pairs the source instantiates: zamba2-7b,
# its reduced config, and the TestSSDScan shapes
SHAPES = ((64, 64), (32, 16), (8, 4), (8, 8), (16, 4), (16, 8))
DEFAULT_CHUNK = 32
TILE_FLOATS = 8192  # chunk * (P + 2N + 1): the staged tiles take at most 32 KB, below 48 KB

launches = 0


@functools.cache
def _fwd():
    """The C entry point, built and loaded on first use; argtypes set once."""
    fn = _build.load("ssd_scan", SOURCE).ssd_scan_fwd
    # every pointer and the stream as c_void_p, or ctypes cuts them to 32 bits
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def ssd_scan_cuda(
    xh: torch.Tensor,  # (b, s, H, P)
    dt: torch.Tensor,  # (b, s, H)
    A: torch.Tensor,  # (H,)
    B: torch.Tensor,  # (b, s, N)
    C: torch.Tensor,  # (b, s, N)
    *,
    chunk: int = DEFAULT_CHUNK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (b, s, H, P), h_final (b, H, N, P)), both fp32. ``chunk``
    is the number of steps staged at a time; it does not change the result."""
    global launches
    if xh.dim() != 4 or B.dim() != 3:
        raise ValueError(f"want xh (b,s,H,P) and B, C (b,s,N); got {tuple(xh.shape)}, "
                         f"{tuple(B.shape)}")
    b, s, H, P = xh.shape
    N = B.shape[-1]
    if dt.shape != (b, s, H) or A.shape != (H,) or B.shape != (b, s, N) or C.shape != B.shape:
        raise ValueError(f"want dt (b,s,H) = {(b, s, H)}, A (H,) = {(H,)} and B, C (b,s,N) = "
                         f"{(b, s, N)}; got {tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    if min(b, s, H) == 0:
        raise ValueError(f"empty input {tuple(xh.shape)}")
    if (P, N) not in SHAPES:
        raise ValueError(f"(P, N) = {(P, N)} not built; the kernel takes {SHAPES}")
    if not 1 <= chunk <= TILE_FLOATS // (P + 2 * N + 1):
        raise ValueError(f"chunk {chunk} outside 1..{TILE_FLOATS // (P + 2 * N + 1)} for "
                         f"(P, N) = {(P, N)}")
    named = (("xh", xh), ("dt", dt), ("A", A), ("B", B), ("C", C))
    for name, x in named:
        if x.dtype != torch.float32:
            raise TypeError(f"{name} is {x.dtype}; the kernel takes fp32")
    for name, x in named:
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x in named:
        if not x.is_cuda or x.device != xh.device:
            raise ValueError(f"{name} must lie on xh's CUDA device")
    y = torch.empty_like(xh)
    h_final = torch.empty((b, H, N, P), dtype=torch.float32, device=xh.device)
    with torch.cuda.device(xh.device):  # xh's card for the launch; the caller's after it
        err = _fwd()(
            xh.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), h_final.data_ptr(), b, s, H, P, N, chunk,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ssd_scan_fwd launch failed: error {err}")
    launches += 1
    return y, h_final
