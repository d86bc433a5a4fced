"""Plain PyTorch version of blockwise GQA attention (causal / sliding window).

``mha_reference`` is the dense O(S^2)-memory version of
``repro.kernels.flash_attention.ref.mha_reference``: the CPU path of the port
and, on the card, the yardstick the CUDA kernel is checked against.

``mha_tf32`` emulates the CUDA kernel's numerical route on fp32 inputs (its
products as 3xTF32 on the tensor cores, or as plain TF32 with
``split=False``), and ``kept_pairs`` counts the (row, column) pairs a mask
keeps, for a kernel's bound. The tests and ``chip_smoke.py`` use them; the
main path does not.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def repeat_kv(k: torch.Tensor, rep: int) -> torch.Tensor:
    """(b, t, G, hd) -> (b, t, G*rep, hd); kv head ``g`` serves q heads
    ``g*rep .. g*rep+rep-1``."""
    if rep == 1:
        return k
    b, t, G, hd = k.shape
    return k[:, :, :, None, :].expand(b, t, G, rep, hd).reshape(b, t, G * rep, hd)


def _mask(s: int, t: int, causal: bool, window: Optional[int], device=None) -> torch.Tensor:
    """(s, t) bool, True where query row i may see key column j."""
    qi = torch.arange(s, device=device)[:, None]
    kj = torch.arange(t, device=device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= kj > qi - window
    return mask


def mha_reference(
    q: torch.Tensor,  # (b, s, H, hd)
    k: torch.Tensor,  # (b, t, G, hd)
    v: torch.Tensor,  # (b, t, G, hd)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    b, s, H, hd = q.shape
    t, G = k.shape[1], k.shape[2]
    rep = H // G
    sc = scale if scale is not None else 1.0 / math.sqrt(hd)
    qh = q.reshape(b, s, G, rep, hd)
    scores = torch.einsum("bsgrq,btgq->bgrst", qh, k).float() * sc
    scores = scores.masked_fill(~_mask(s, t, causal, window, q.device), -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bgrst,btgq->bsgrq", probs, v)
    return out.reshape(b, s, H, hd)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds (finite inputs)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x = big + small`` to fp32 accuracy, as the kernel splits: ``big`` is
    ``x`` rounded to TF32, ``small = x - big`` truncated to TF32 (the kernel
    passes it whole, and the tensor cores read its top 19 bits)."""
    big = tf32_round(x)
    small = (x.float() - big).contiguous().view(torch.int32) & -0x2000
    return big, small.view(torch.float32)


def _tf32_product(eq: str, a: torch.Tensor, b: torch.Tensor, split: bool) -> torch.Tensor:
    """``einsum(eq, a, b)`` with TF32 operands and fp32 sums: with ``split``
    the 3xTF32 sum a_small.b_big + a_big.b_small + a_big.b_big, else one
    product of the rounded operands."""
    a_big, a_small = split_tf32(a)
    b_big, b_small = split_tf32(b)
    out = torch.einsum(eq, a_big, b_big)
    if split:
        out = torch.einsum(eq, a_small, b_big) + torch.einsum(eq, a_big, b_small) + out
    return out


def mha_tf32(q, k, v, *, causal: bool = True, window: Optional[int] = None,
             scale: Optional[float] = None, split: bool = True) -> torch.Tensor:
    """``mha_reference`` on fp32 inputs with the kernel's products: S = Q K^T
    and O = P V on TF32 operands (3xTF32 with ``split``, else plain TF32),
    P = exp(S - max) unnormalised, O divided by the row sum at the end."""
    b, s, H, hd = q.shape
    t, G = k.shape[1], k.shape[2]
    rep = H // G
    sc = scale if scale is not None else 1.0 / math.sqrt(hd)
    qh = q.float().reshape(b, s, G, rep, hd)
    scores = _tf32_product("bsgrq,btgq->bgrst", qh, k.float(), split) * sc
    mask = _mask(s, t, causal, window, q.device)
    scores = scores.masked_fill(~mask, -1e30)
    p = torch.exp(scores - scores.amax(-1, keepdim=True)).masked_fill(~mask, 0.0)
    out = _tf32_product("bgrst,btgq->bsgrq", p, v.float(), split)
    den = p.sum(-1).clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
    return (out / den).reshape(b, s, H, hd)


def kept_pairs(s: int, t: int, causal: bool = True, window: Optional[int] = None) -> int:
    """The (row, column) pairs of an s x t score matrix that the mask keeps:
    col < t, col <= row if causal, col > row - window if a window is given."""
    return int(_mask(s, t, causal, window).sum())
