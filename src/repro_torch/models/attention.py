"""Grouped-query attention: full / sliding-window, optional qk-norm, RoPE;
prefill (full-sequence) and single-token decode paths.

The full-sequence path goes through ``repro_torch.kernels.flash_attention.ops``:
the CUDA kernel on the card, the plain version on the CPU. Decode attention
is plain tensor code, as in the JAX package.

Unlike the JAX package, ``decode_attention`` writes the new k/v into the
cache in place (every batch lane at one slot) instead of returning a copy.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..configs.base import ArchConfig
from ..kernels.flash_attention import ops as flash
from .layers import apply_rope, normal, rmsnorm


def init_attn(gen: torch.Generator, lead: tuple, cfg: ArchConfig, dtype, device) -> dict:
    """Attention params with leading axes ``lead`` (the layer stack)."""
    d, H, G, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    s = 1.0 / math.sqrt(d)
    p = {
        "wq": normal(gen, (*lead, d, H, hd), s, dtype, device),
        "wk": normal(gen, (*lead, d, G, hd), s, dtype, device),
        "wv": normal(gen, (*lead, d, G, hd), s, dtype, device),
        "wo": normal(gen, (*lead, H, hd, d), 1.0 / math.sqrt(H * hd), dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((*lead, hd), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros((*lead, hd), dtype=dtype, device=device)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhq->bshq") as one matmul on the flattened heads."""
    d, h, q = w.shape
    return (x @ w.reshape(d, h * q)).view(*x.shape[:-1], h, q)


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshq,hqd->bsd")."""
    h, q, d = wo.shape
    return o.reshape(*o.shape[:-2], h * q) @ wo.reshape(h * q, d)


def _project_qkv(p: dict, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if cfg.qk_norm:  # per head over hd, before RoPE
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def full_attention(p: dict, cfg: ArchConfig, x: torch.Tensor, *, local: bool,
                   window: Optional[int] = None) -> torch.Tensor:
    """Causal (optionally windowed) self-attention over the full sequence."""
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    w = (window or cfg.window) if local else None
    out = flash.flash_attention(q, k, v, causal=True, window=w)
    return _out_proj(out, p["wo"])


# ------------------------------------------------------------- decode path --
def init_kv_cache(cfg: ArchConfig, n_layers: int, batch: int, length: int, dtype,
                  device) -> dict:
    G, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (n_layers, batch, length, G, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_slot(pos: int, cache_len: int, local: bool) -> int:
    """The cache slot a decode step at ``pos`` writes: the ring-buffer slot
    for windowed layers, the plain one (the last, past the end) otherwise."""
    return pos % cache_len if local else min(pos, cache_len - 1)


def decode_attention(
    p: dict,
    cfg: ArchConfig,
    x: torch.Tensor,  # (b, 1, d)
    layer_cache: dict,  # {"k": (b, S, g, q), "v": ...} single layer slice, written in place
    pos: int,  # current position
    *,
    local: bool,
) -> torch.Tensor:
    b = x.shape[0]
    H, G, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    ck, cv = layer_cache["k"], layer_cache["v"]
    cache_len = ck.shape[1]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, positions)  # q:(b,1,H,hd) k/v:(b,1,G,hd)

    slot = cache_slot(pos, cache_len, local)
    ck[:, slot] = k[:, 0]
    cv[:, slot] = v[:, 0]

    # grouped einsums: the same sums as repeat_kv + einsum, without the copy.
    # Scores come out in fp32 as with JAX's preferred_element_type (for a
    # bf16 cache this costs an fp32 copy of the cache; fp32 is a no-op).
    qg = q.view(b, 1, G, H // G, hd)
    scores = torch.einsum("bugrq,btgq->bgrut", qg.float(), ck.float())
    scores = scores * (1.0 / math.sqrt(hd))
    valid = torch.arange(cache_len, device=x.device) <= min(pos, cache_len - 1)
    scores = scores.masked_fill(~valid, -1e30)
    probs = torch.softmax(scores, dim=-1).to(cv.dtype)
    out = torch.einsum("bgrut,btgq->bugrq", probs, cv).reshape(b, 1, H, hd)
    return _out_proj(out, p["wo"])
