"""Wrapper of the hand-written CUDA wkv6 kernel (``csrc/wkv6.cu``), the port
of ``wkv6_tpu``.

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

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6.cu"
# head size P -> (columns a block PC, threads a column R, columns a thread
# CPT) where b H blocks of P columns reach WIDE_GRID, and where they do not:
# then a block owns fewer columns, and the rwkv6-7b decode step (b 1, H 64)
# has 256 blocks, not 64; its prefill (b 4) has 256 of P columns each, and
# each block stages the head's r, k and w once.
PLANS = {64: ((64, 4, 4), (16, 2, 1)), 32: ((16, 2, 1), (16, 2, 1)),
         16: ((8, 2, 1), (8, 2, 1)), 8: ((4, 2, 1), (4, 2, 1))}
HEAD_SIZES = tuple(PLANS)
WIDE_GRID = 256
STAGES = 2  # tiles in the ring, the source's constant: the next in flight while one runs
# steps a tile: at the rwkv6-7b prefill plan 2 x 48 steps take 96 KB of
# shared memory a block (two blocks an SM, the 256 blocks one wave; 3 x 32
# steps ran 2-3 % slower)
DEFAULT_CHUNK = 48
MAX_SMEM = 232448  # bytes of shared memory a block can have on sm_90 (after the opt-in)

launches = 0


def smem_bytes(P: int, pc: int, chunk: int) -> int:
    """Dynamic shared memory of a launch, as the source computes it: the
    ring's STAGES slots (r, k, w of ``chunk`` steps, v's pc columns), u, and
    the tile's sums r.u.k (rounded up to whole float4s)."""
    return 4 * (STAGES * chunk * (3 * P + pc) + P + -(-chunk // 4) * 4)


@functools.cache
def max_chunk(P: int) -> int:
    """The largest ``chunk`` whose ring fits a block's shared memory under
    either plan of head size P."""
    pc = max(plan[0] for plan in PLANS[P])
    lo, hi = 1, 1 << 16
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if smem_bytes(P, pc, mid) <= MAX_SMEM else (lo, mid - 1)
    return lo


def plan(b: int, s: int, H: int, P: int, chunk: Optional[int] = None) -> dict:
    """The launch of one call: ``pc`` columns a block (grid (H, b, P / pc)),
    ``r`` threads a column, ``cpt`` columns a thread, ring slots of
    ``chunk`` steps (the requested tile, or DEFAULT_CHUNK, cut to the
    sequence), whether it runs the ring (a decode step, s = 1, does not),
    its threads, blocks a (batch, head) and shared memory. Raises for a
    ``chunk`` outside 1..max_chunk(P)."""
    chunk = DEFAULT_CHUNK if chunk is None else chunk
    if not 1 <= chunk <= max_chunk(P):
        raise ValueError(f"chunk {chunk} outside 1..{max_chunk(P)} for head size {P}")
    wide, narrow = PLANS[P]
    pc, r, cpt = wide if b * H >= WIDE_GRID else narrow
    tile = min(chunk, s)
    ring = s > 1  # the decode step runs the ring-free kernel of the source
    return {"pc": pc, "r": r, "cpt": cpt, "chunk": tile, "ring": ring,
            "threads": pc // cpt * r, "blocks_per_head": P // pc,
            "smem_bytes": smem_bytes(P, pc, tile) if ring else 0}


@functools.cache
def _fwd():
    """The C entry point, built and loaded on first use; argtypes set once."""
    fn = _build.load("wkv6", SOURCE).wkv6_fwd
    # every pointer and the stream as c_void_p, or ctypes cuts them to 32 bits
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
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
    chunk: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y, final state). The final state is written into ``state_out``
    when given, which may be ``state`` itself (an in-place update). ``chunk``
    is the number of steps a tile stages (``plan``); it does not change the
    result."""
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
    pl = plan(b, s, H, P, chunk)
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
            state.data_ptr(), y.data_ptr(), out.data_ptr(), b, s, H, P, pl["pc"], pl["r"],
            pl["cpt"], pl["chunk"], torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"wkv6_fwd launch failed: error {err}")
    launches += 1
    return y, out
