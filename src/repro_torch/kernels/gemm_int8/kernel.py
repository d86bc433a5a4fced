"""Wrapper of the hand-written CUDA INT8 PU GEMM (``csrc/gemm_int8.cu``), the
port of ``gemm_int8_tpu``.

``w`` is the (K, N) matrix of JAX's signature in one of two layouts, told
apart by its strides (``w_layout``): row-major (N contiguous, as in JAX)
goes to ``gemm_int8_fwd``; column-major (K contiguous, ``w.t().contiguous()
.t()``, the layout in which a PU's weights are loaded once) goes to
``gemm_int8_kmajor_fwd``, which splits K (``split_k``) where its tile grid
would leave SMs empty, the slices of a tile one thread-block cluster that
sums their int32 partials in shared memory. The function computed is the
same.

It checks what the kernel takes before it builds anything, allocates the
output, launches on PyTorch's current stream and raises if the launch was
refused. ``launches`` counts the launches, one a GEMM whatever its layout
or split (set it to 0 to start a count).
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
BM, BK = 128, 64  # the column-major kernel's block rows and K tile (csrc, namespace kmajor)
MAX_SPLITS = 8  # K slices a tile: the portable thread-block cluster size

launches = 0


def _cdiv(x: int, y: int) -> int:
    return -(-x // y)


def block_n(M: int, N: int, sms: int) -> int:
    """The column-major kernel's block columns: 128 where 128 x 128 tiles
    give at least 7/8 of the SMs a block (fewer bytes a product, and no
    split), else 64 (twice the blocks, and no half-empty tile at N = 64)."""
    return 128 if N > 64 and 8 * _cdiv(M, BM) * _cdiv(N, 128) >= 7 * sms else 64


def split_k(M: int, N: int, K: int, sms: int) -> int:
    """The number S of K slices for the column-major kernel on a card of
    ``sms`` SMs. S > 1 only where the tile grid has fewer blocks than SMs;
    then blocks x S stays within the card, S is at most MAX_SPLITS, and
    every slice gets a whole number of K tiles, at least two
    (``k_slices``)."""
    blocks = _cdiv(M, BM) * _cdiv(N, block_n(M, N, sms))
    if blocks >= sms:
        return 1
    return max(1, min(sms // blocks, _cdiv(K, BK) // 2, MAX_SPLITS))


def k_slices(K: int, splits: int) -> list[tuple[int, int]]:
    """The K bytes [lo, hi) of each slice, as the kernel cuts them: slice z
    of S takes tiles [T z // S, T (z + 1) // S) of the T = ceil(K / BK)."""
    T = _cdiv(K, BK)
    return [(T * z // splits * BK, min(T * (z + 1) // splits * BK, K)) for z in range(splits)]


def w_layout(w: torch.Tensor) -> str:
    """"row" (N contiguous) or "col" (K contiguous) for a (K, N) ``w``; raises
    for any other strides. Where both describe the same bytes (N == 1 or
    K == 1), exact strides decide, and then row-major."""
    K, N = w.shape
    if w.stride() == (N, 1):
        return "row"
    if w.stride() == (1, K):
        return "col"
    if w.is_contiguous():
        return "row"
    if w.t().is_contiguous():
        return "col"
    raise ValueError(f"w must be contiguous row-major (N contiguous) or column-major (K "
                     f"contiguous); got strides {w.stride()} for shape {tuple(w.shape)}")


@functools.cache
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _fwd():
    """The C entry point, built and loaded on first use; argtypes set once."""
    fn = _build.load("gemm_int8", SOURCE).gemm_int8_fwd
    # every pointer and the stream as c_void_p, or ctypes cuts them to 32 bits
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kmajor_fwd():
    """The column-major entry point, from the same library."""
    fn = _build.load("gemm_int8", SOURCE).gemm_int8_kmajor_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def gemm_int8_cuda(
    a: torch.Tensor,  # (M, K) int8
    w: torch.Tensor,  # (K, N) int8, row-major (as in JAX) or column-major
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
        if name != "w" and not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    layout = w_layout(w)
    for name, x, _ in named:
        if not x.is_cuda or x.device != a.device:
            raise ValueError(f"{name} must lie on a's CUDA device")
    out = torch.empty((M, N), dtype=torch.int8, device=a.device)
    res = None if residual is None else residual.data_ptr()
    with torch.cuda.device(a.device):  # a's card for the launch; the caller's after it
        stream = torch.cuda.current_stream().cuda_stream
        if layout == "row":
            entry = "gemm_int8_fwd"
            err = _fwd()(a.data_ptr(), w.data_ptr(), bias.data_ptr(), res, out.data_ptr(),
                         M, N, K, shift, int(bool(relu)), stream)
        else:
            entry = "gemm_int8_kmajor_fwd"
            sms = sm_count(a.device.index)
            err = _kmajor_fwd()(a.data_ptr(), w.data_ptr(), bias.data_ptr(), res,
                                out.data_ptr(), M, N, K, block_n(M, N, sms),
                                split_k(M, N, K, sms), shift, int(bool(relu)), stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: error {err}")
    launches += 1
    return out
