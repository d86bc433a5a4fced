"""Plain PyTorch versions of blockwise GQA attention (causal / sliding window).

``mha_reference`` is the dense O(S^2)-memory version of
``repro.kernels.flash_attention.ref.mha_reference``: on the card, the
yardstick the CUDA kernel is checked against. ``chunked_attention`` (an
online softmax over (block_q, block_k) tiles, O(S * block) memory in the
forward) and ``banded_attention`` (sliding-window causal attention on the
band only) are the twins of the JAX package's long-sequence versions; the
CPU dispatch (``ops.plain_attention``) picks among the three as JAX's does.
All three are differentiable. Scores and softmax statistics are fp32 for
fp32 and bf16 inputs, as in JAX, and float64 for float64 inputs (gradcheck).

``mha_tf32`` emulates the CUDA kernels' numerical route on fp32 inputs (its
products as 3xTF32 on the tensor cores, or as plain TF32 with
``split=False``; with ``kv_tile``, the wgmma kernel's accumulation tile by
tile), and ``kept_pairs`` counts the (row, column) pairs a mask keeps, for a
kernel's bound. The tests and ``chip_smoke.py`` use them; the main path does
not.
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


def _stat_dtype(x: torch.Tensor) -> torch.dtype:
    """fp32, or the input's dtype where it is wider (float64)."""
    return torch.promote_types(x.dtype, torch.float32)


def _blocks(x: torch.Tensor, n: int, blk: int, pad_front: int = 0) -> torch.Tensor:
    """(b, t, H, hd) zero-padded along t (``pad_front`` rows before, the rest
    after) to ``n * blk`` + ``pad_front`` rows, then (b, H, rows, hd)."""
    pad_back = n * blk - x.shape[1]
    x = torch.nn.functional.pad(x, (0, 0, 0, 0, pad_front, pad_back))
    return x.transpose(1, 2)


def chunked_attention(
    q: torch.Tensor,  # (b, s, H, hd)
    k: torch.Tensor,  # (b, t, G, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    block_q: int = 512,
    block_k: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention over (block_q, block_k) tiles, the twin of
    ``repro.kernels.flash_attention.ref.chunked_attention`` (the same blocks,
    padding, mask and fp32 statistics). A kv tile the mask hides entirely is
    skipped: its update would leave (m, l, acc) as they are, bit for bit."""
    b, s, H, hd = q.shape
    t, G = k.shape[1], k.shape[2]
    sc = scale if scale is not None else 1.0 / math.sqrt(hd)
    k, v = repeat_kv(k, H // G), repeat_kv(v, H // G)
    bq, bk = min(block_q, s), min(block_k, t)
    nq, nk = -(-s // bq), -(-t // bk)
    qs = _blocks(q, nq, bq) * sc  # (b, H, nq * bq, hd)
    ks, vs = _blocks(k, nk, bk), _blocks(v, nk, bk)
    f32 = dict(dtype=_stat_dtype(q), device=q.device)
    outs = []
    for qi in range(nq):
        qb = qs[:, :, qi * bq:(qi + 1) * bq]
        rows = qi * bq + torch.arange(bq, device=q.device)[:, None]
        m = torch.full((b, H, bq, 1), -1e30, **f32)
        l = torch.zeros((b, H, bq, 1), **f32)
        acc = torch.zeros((b, H, bq, hd), **f32)
        for ki in range(nk):
            lo, hi = ki * bk, (ki + 1) * bk - 1  # the tile's first and last column
            if (causal and lo > qi * bq + bq - 1) or (
                    window is not None and hi <= qi * bq - window):
                continue
            cols = lo + torch.arange(bk, device=q.device)[None, :]
            mask = (cols < t) & (rows < s)
            if causal:
                mask &= cols <= rows
            if window is not None:
                mask &= cols > rows - window
            sqk = (qb @ ks[:, :, lo:hi + 1].transpose(-1, -2)).to(acc.dtype)
            sqk = sqk.masked_fill(~mask, -1e30)
            m_new = torch.maximum(m, sqk.amax(-1, keepdim=True))
            p = torch.exp(sqk - m_new).masked_fill(~mask, 0.0)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = acc * alpha + p @ vs[:, :, lo:hi + 1].to(acc.dtype)
            m = m_new
        outs.append((acc / l.clamp_min(1e-30)).to(q.dtype))
    return torch.cat(outs, 2)[:, :, :s].transpose(1, 2)


def banded_attention(
    q: torch.Tensor,  # (b, s, H, hd)
    k: torch.Tensor,  # (b, s, G, hd)  (self-attention: t == s)
    v: torch.Tensor,
    *,
    window: int,
    scale: Optional[float] = None,
    block_q: int = 512,
) -> torch.Tensor:
    """Sliding-window causal attention on the band only, the twin of
    ``repro.kernels.flash_attention.ref.banded_attention``: q chunk ``i``
    attends the (window + block) kv rows from ``i * block - window`` on,
    O(S * window) work instead of the masked O(S^2)."""
    b, s, H, hd = q.shape
    G = k.shape[2]
    sc = scale if scale is not None else 1.0 / math.sqrt(hd)
    k, v = repeat_kv(k, H // G), repeat_kv(v, H // G)
    bq = min(block_q, s)
    nq = -(-s // bq)
    band = window + bq
    qs = _blocks(q, nq, bq) * sc  # (b, H, nq * bq, hd)
    # kv left-padded by ``window``: chunk i's band starts at padded row i * bq
    kp, vp = _blocks(k, nq, bq, pad_front=window), _blocks(v, nq, bq, pad_front=window)
    outs = []
    for qi in range(nq):
        rows = qi * bq + torch.arange(bq, device=q.device)[:, None]
        cols = qi * bq - window + torch.arange(band, device=q.device)[None, :]
        mask = (cols >= 0) & (cols <= rows) & (cols > rows - window) & (rows < s)
        kb = kp[:, :, qi * bq:qi * bq + band]
        vb = vp[:, :, qi * bq:qi * bq + band]
        sqk = (qs[:, :, qi * bq:(qi + 1) * bq] @ kb.transpose(-1, -2)).to(_stat_dtype(q))
        p = torch.softmax(sqk.masked_fill(~mask, -1e30), dim=-1)
        outs.append((p @ vb.to(p.dtype)).to(q.dtype))
    return torch.cat(outs, 2)[:, :, :s].transpose(1, 2)


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
    scores = torch.einsum("bsgrq,btgq->bgrst", qh, k).to(_stat_dtype(q)) * sc
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


def toward_zero(v: torch.Tensor) -> torch.Tensor:
    """float64 ``v`` to fp32, rounded toward zero, as the tensor cores add to
    their fp32 accumulators."""
    t = v.float()
    return torch.where(t.double().abs() > v.abs(), torch.nextafter(t, torch.zeros_like(t)), t)


K_STEP = 8  # wgmma's k for TF32


def _wgmma_sum(acc: Optional[torch.Tensor], a: tuple, b: tuple) -> torch.Tensor:
    """``acc + a @ b`` as one wgmma accumulator takes it: k steps of 8, each
    step's three products (a_small b_big, a_big b_small, a_big b_big) summed
    exactly and added to the fp32 accumulator rounded toward zero. ``a`` and
    ``b`` are the (big, small) splits of (..., m, k) and (..., k, n); ``acc``
    None starts afresh."""
    (ab, as_), (bb, bs) = a, b
    out = acc
    for k0 in range(0, ab.shape[-1], K_STEP):
        sl = slice(k0, k0 + K_STEP)
        for x, y in ((as_, bb), (ab, bs), (ab, bb)):
            prod = x[..., sl].double() @ y[..., sl, :].double()
            out = toward_zero(prod if out is None else out.double() + prod)
    return out


def _mha_wgmma(q, k, v, causal, window, sc, kv_tile, fresh_partials):
    """``mha_tf32`` as the wgmma kernel accumulates, kv tile by kv tile:
    S = Q K^T in one accumulator over hd, the online softmax in base 2, and
    each tile's P V in a fresh partial added, rounded to nearest, to the
    rescaled output (one FFMA); ``fresh_partials=False`` keeps P V in one
    accumulator over every tile instead, rescaled in place."""
    b, s, H, hd = q.shape
    t, G = k.shape[1], k.shape[2]
    rep = H // G
    qs = split_tf32(q.float().reshape(b, s, G, rep, hd).permute(0, 2, 3, 1, 4))
    ks = split_tf32(k.float().permute(0, 2, 3, 1)[:, :, None])  # (b, G, 1, hd, t)
    vs = split_tf32(v.float().permute(0, 2, 1, 3)[:, :, None])  # (b, G, 1, t, hd)
    mask = _mask(s, t, causal, window, q.device)
    scale_log2 = torch.tensor(sc * math.log2(math.e), dtype=torch.float32)
    m = torch.full((b, G, rep, s, 1), -1e30)
    l = torch.zeros((b, G, rep, s, 1))
    o = torch.zeros((b, G, rep, s, hd))
    for k0 in range(0, t, kv_tile):
        cols = slice(k0, k0 + kv_tile)
        x = _wgmma_sum(None, qs, tuple(p[..., cols] for p in ks)) * scale_log2
        x = x.masked_fill(~mask[:, cols], -1e30)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        base = torch.where(m_new == -1e30, 0.0, m_new)  # a row masked so far: exp2 gives 0
        alpha = torch.exp2(m - base)
        p = torch.exp2(x - base)
        l = l * alpha + p.sum(-1, keepdim=True)
        pv = (split_tf32(p), tuple(y[..., cols, :] for y in vs))
        if fresh_partials:
            o = (o.double() * alpha.double() + _wgmma_sum(None, *pv).double()).float()
        else:
            o = _wgmma_sum(o * alpha, *pv)
        m = m_new
    out = o / l.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, H, hd)


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
             scale: Optional[float] = None, split: bool = True,
             kv_tile: Optional[int] = None, fresh_partials: bool = True) -> torch.Tensor:
    """``mha_reference`` on fp32 inputs with the kernel's products: S = Q K^T
    and O = P V on TF32 operands (3xTF32 with ``split``, else plain TF32),
    P = exp(S - max) unnormalised, O divided by the row sum at the end, each
    product's sum exact. With ``kv_tile`` (3xTF32 only) the wgmma kernel's
    accumulation instead (``_mha_wgmma``): tiles of ``kv_tile`` kv rows,
    truncating adds, and ``fresh_partials`` as there."""
    b, s, H, hd = q.shape
    t, G = k.shape[1], k.shape[2]
    rep = H // G
    sc = scale if scale is not None else 1.0 / math.sqrt(hd)
    if kv_tile is not None:
        return _mha_wgmma(q, k, v, causal, window, sc, kv_tile, fresh_partials)
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
