"""Plain PyTorch version of blockwise GQA attention (causal / sliding window).

``mha_reference`` is the dense O(S^2)-memory version of
``repro.kernels.flash_attention.ref.mha_reference``: the CPU path of the port
and, on the card, the yardstick the CUDA kernel is checked against.
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

    qi = torch.arange(s, device=q.device)[:, None]
    kj = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= kj > qi - window
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bgrst,btgq->bsgrq", probs, v)
    return out.reshape(b, s, H, hd)
