"""Wrapper of the hand-written CUDA SSD-scan kernel (``csrc/ssd_scan.cu``),
the port of ``ssd_scan_tpu``.

It checks what the kernel takes before it builds anything, picks the plan
of the launch (``plan``: columns a block, threads a column, tile steps,
shared memory), allocates the outputs, launches on PyTorch's current
stream and raises if the launch was refused. ``launches`` counts the
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

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
# (head size P, state size N) -> (columns a block PC, threads a column R,
# columns a thread CPT), each an instantiation of the source: zamba2-7b, its
# reduced config, and the TestSSDScan shapes. PC = P / 2, so every (batch,
# head) has two blocks; R splits the N rows of a column into float4 groups.
PLANS = {(64, 64): (32, 2, 2), (32, 16): (16, 4, 1), (8, 4): (4, 1, 1), (8, 8): (4, 2, 1),
         (16, 4): (8, 1, 1), (16, 8): (8, 2, 1)}
SHAPES = tuple(PLANS)
STAGES = 2  # tiles in the ring, the source's constant: the next in flight while one runs
# steps a tile: at the zamba2-7b shape 2 x 24 steps take 31 KB of shared
# memory a block, so seven blocks fit an SM's 228 KB and the 896 blocks are
# one wave on 132 SMs (3 x 16 steps fit too, and ran 3-4 % slower)
DEFAULT_CHUNK = 24
MAX_SMEM = 232448  # bytes of shared memory a block can have on sm_90 (after the opt-in)

launches = 0


def smem_bytes(N: int, pc: int, threads: int, chunk: int) -> int:
    """Dynamic shared memory of a launch, as the source computes it: the
    ring's STAGES slots (x's pc columns, B, C and dt of ``chunk`` steps, dt
    rounded up to whole float4s) and each warp's decays."""
    tpad = -(-chunk // 4) * 4
    warps = -(-threads // 32)
    return 4 * (STAGES * (chunk * (pc + 2 * N) + tpad) + warps * tpad)


@functools.cache
def max_chunk(P: int, N: int) -> int:
    """The largest ``chunk`` whose ring fits a block's shared memory."""
    pc, r, cpt = PLANS[(P, N)]
    lo, hi = 1, 1 << 16
    while lo < hi:
        mid = (lo + hi + 1) // 2
        fits = smem_bytes(N, pc, pc // cpt * r, mid) <= MAX_SMEM
        lo, hi = (mid, hi) if fits else (lo, mid - 1)
    return lo


def plan(P: int, N: int, s: int, chunk: Optional[int] = None) -> dict:
    """The launch of one call: ``pc`` columns a block (grid (H, b, P / pc)),
    ``r`` threads a column, ``cpt`` columns a thread, ring slots of
    ``chunk`` steps (the requested tile, or DEFAULT_CHUNK, cut to the
    sequence), its threads and shared memory. Raises for a ``chunk`` outside
    1..max_chunk(P, N)."""
    pc, r, cpt = PLANS[(P, N)]
    chunk = DEFAULT_CHUNK if chunk is None else chunk
    if not 1 <= chunk <= max_chunk(P, N):
        raise ValueError(f"chunk {chunk} outside 1..{max_chunk(P, N)} for (P, N) = {(P, N)}")
    tile = min(chunk, s)
    threads = pc // cpt * r
    return {"pc": pc, "r": r, "cpt": cpt, "chunk": tile, "threads": threads,
            "blocks_per_head": P // pc, "smem_bytes": smem_bytes(N, pc, threads, tile)}


@functools.cache
def _fwd():
    """The C entry point, built and loaded on first use; argtypes set once."""
    fn = _build.load("ssd_scan", SOURCE).ssd_scan_fwd
    # every pointer and the stream as c_void_p, or ctypes cuts them to 32 bits
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def ssd_scan_cuda(
    xh: torch.Tensor,  # (b, s, H, P)
    dt: torch.Tensor,  # (b, s, H)
    A: torch.Tensor,  # (H,)
    B: torch.Tensor,  # (b, s, N), or (b, s, G, N): head h reads group h // (H / G)
    C: torch.Tensor,  # as B
    *,
    chunk: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (b, s, H, P), h_final (b, H, N, P)), both fp32. ``chunk``
    is the number of steps a tile stages (``plan``); it does not change the
    result."""
    global launches
    refuse_wrapped("ssd_scan_cuda", xh, dt, A, B, C)
    if xh.dim() != 4 or B.dim() not in (3, 4):
        raise ValueError(f"want xh (b,s,H,P) and B, C (b,s,N) or (b,s,G,N); got "
                         f"{tuple(xh.shape)}, {tuple(B.shape)}")
    b, s, H, P = xh.shape
    N = B.shape[-1]
    G = B.shape[2] if B.dim() == 4 else 1
    bc = (b, s, G, N) if B.dim() == 4 else (b, s, N)
    if dt.shape != (b, s, H) or A.shape != (H,) or B.shape != bc or C.shape != B.shape:
        raise ValueError(f"want dt (b,s,H) = {(b, s, H)}, A (H,) = {(H,)} and B, C = "
                         f"{bc}; got {tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    if G == 0 or H % G:
        raise ValueError(f"{H} heads do not split into {G} groups")
    if min(b, s, H) == 0:
        raise ValueError(f"empty input {tuple(xh.shape)}")
    if (P, N) not in SHAPES:
        raise ValueError(f"(P, N) = {(P, N)} not built; the kernel takes {SHAPES}")
    pl = plan(P, N, s, chunk)
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
            y.data_ptr(), h_final.data_ptr(), b, s, H, P, N, G, pl["pc"], pl["r"], pl["cpt"],
            pl["chunk"], torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ssd_scan_fwd launch failed: error {err}")
    launches += 1
    return y, h_final


def work(b: int, s: int, H: int, P: int, N: int, G: int = 1):
    """(operations, bytes) of one fp32 call, as the kernel's bound counts
    them: decay*h + (dt x) B and C.h, 4 N P a step and head; xh, dt, A, B
    and C (G groups) read, y and the final state written once."""
    n_in = b * s * H * P + b * s * H + H + 2 * b * s * G * N
    return 4 * b * s * H * P * N, 4 * (n_in + b * s * H * P + b * H * N * P)
