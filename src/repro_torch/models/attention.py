"""Grouped-query attention: full / sliding-window, optional qk-norm, RoPE;
prefill (full-sequence) and single-token decode paths.

The full-sequence path goes through ``repro_torch.kernels.flash_attention.ops``:
the CUDA kernel on the card, the plain version on the CPU. Decode attention
is plain tensor code, as in the JAX package.

Unlike the JAX package, ``decode_attention`` writes the new k/v into the
cache in place (every batch lane at one slot) instead of returning a copy.
A sharded cache (a DTensor, its sequence split over "model" by the policy)
is written on the rank that owns the slot, and decode attention over it
takes the flash-decoding layout: the tiny q is gathered, each rank scores
its own positions, and only the softmax's row statistics and the output
are summed across ranks.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..configs.base import ArchConfig
from ..kernels.flash_attention import ops as flash
from ..runtime.pspec import constrain, fit_grad, fit_split, is_sharded, product
from .layers import apply_rope, normal, rmsnorm


def init_attn(gen: torch.Generator, lead: tuple, cfg: ArchConfig, dtype, device,
              d_in: Optional[int] = None) -> dict:
    """Attention params with leading axes ``lead`` (the layer stack); q, k and
    v read ``d_in`` channels (d_model by default), the output has d_model."""
    d, H, G, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    d_in = d_in or d
    s = 1.0 / math.sqrt(d_in)
    p = {
        "wq": normal(gen, (*lead, d_in, H, hd), s, dtype, device),
        "wk": normal(gen, (*lead, d_in, G, hd), s, dtype, device),
        "wv": normal(gen, (*lead, d_in, G, hd), s, dtype, device),
        "wo": normal(gen, (*lead, H, hd, d), 1.0 / math.sqrt(H * hd), dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((*lead, hd), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros((*lead, hd), dtype=dtype, device=device)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhq->bshq") as one matmul on the flattened heads."""
    d, h, q = w.shape
    w2 = fit_grad(w.reshape(d, h * q), 1, h)
    return fit_split(product(x, w2), -1, h).reshape(*x.shape[:-1], h, q)


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshq,hqd->bsd")."""
    h, q, d = wo.shape
    o2 = fit_grad(o.reshape(*o.shape[:-2], h * q), -1, h)
    return product(o2, fit_grad(wo.reshape(h * q, d), 0, h))


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
                   window: Optional[int] = None, scale: Optional[float] = None) -> torch.Tensor:
    """Causal (optionally windowed) self-attention over the full sequence;
    scores scaled by ``scale`` (1 / sqrt(head_dim) by default)."""
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    q = constrain(q, "attn_q")
    w = (window or cfg.window) if local else None
    out = flash.flash_attention(q, k, v, causal=True, window=w, scale=scale)
    out = constrain(out, "attn_out")
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
    scale: Optional[float] = None,  # of the scores; 1 / sqrt(head_dim) by default
) -> torch.Tensor:
    b = x.shape[0]
    H, G, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    ck, cv = layer_cache["k"], layer_cache["v"]
    cache_len = ck.shape[1]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, positions)  # q:(b,1,H,hd) k/v:(b,1,G,hd)

    slot = cache_slot(pos, cache_len, local)
    if is_sharded(ck):
        _write_owned_slot(ck, slot, k)
        _write_owned_slot(cv, slot, v)
        out = _sharded_decode(q, ck, cv, min(pos, cache_len - 1), G, scale)
        return _out_proj(out, p["wo"])
    ck[:, slot] = k[:, 0]
    cv[:, slot] = v[:, 0]

    # grouped einsums: the same sums as repeat_kv + einsum, without the copy.
    # Scores come out in fp32 as with JAX's preferred_element_type (for a
    # bf16 cache this costs an fp32 copy of the cache; fp32 is a no-op).
    qg = q.view(b, 1, G, H // G, hd)
    scores = torch.einsum("bugrq,btgq->bgrut", qg.float(), ck.float())
    scores = scores * (1.0 / math.sqrt(hd) if scale is None else scale)
    valid = torch.arange(cache_len, device=x.device) <= min(pos, cache_len - 1)
    scores = scores.masked_fill(~valid, -1e30)
    probs = torch.softmax(scores, dim=-1).to(cv.dtype)
    out = torch.einsum("bgrut,btgq->bugrq", probs, cv).reshape(b, 1, H, hd)
    return _out_proj(out, p["wo"])


# ------------------------------------------------------- sharded decode path --
def _write_owned_slot(c, slot: int, new) -> None:
    """``c[:, slot] = new[:, 0]`` for a DTensor cache (b, t, g, q): the new
    k/v is brought to the cache's placements (gathered where the cache splits
    the sequence) and written in place through ``local_map`` by the rank
    whose shard holds the slot. Every other rank rewrites one slot of its own
    with its old value, as XLA's SPMD partitioner lowers a dynamic-update-slice
    (a clamped index and a select): each rank then writes one slot a step,
    which is what the dry run counts (``launch/flop_analysis.py``)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = c.device_mesh
    seq_on = [i for i, p in enumerate(c.placements) if isinstance(p, Shard) and p.dim == 1]
    if len(seq_on) > 1:
        raise ValueError(f"cache sequence split over {len(seq_on)} mesh dimensions "
                         f"({c.placements}); the write takes one split")
    new_pl = tuple(Replicate() if i in seq_on else p for i, p in enumerate(c.placements))
    rank = mesh.get_local_rank(seq_on[0]) if seq_on else 0

    def write(cl, nl):
        lo = rank * cl.shape[1] if seq_on else 0
        j = min(max(slot - lo, 0), cl.shape[1] - 1)
        cl[:, j] = nl[:, 0] if lo <= slot < lo + cl.shape[1] else cl[:, j].clone()
        return cl

    local_map(write, out_placements=list(c.placements), in_placements=(c.placements, new_pl),
              device_mesh=mesh, redistribute_inputs=True)(c, new)


def _sharded_decode(q, ck, cv, last: int, G: int, scale: Optional[float] = None):
    """One token's attention over a DTensor cache in the flash-decoding
    layout: q gathered to every rank of a sequence shard, scores of the local
    positions, the row max and sum reduced across ranks, the probabilities
    times the local values summed across ranks. The same sums as the plain
    path's ``torch.softmax``, in another order."""
    from torch.distributed.tensor import Replicate, Shard

    b, _, H, hd = q.shape
    cache_len = ck.shape[1]
    keep = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in q.placements)
    q = q.redistribute(q.device_mesh, keep)
    qg = q.view(b, 1, G, H // G, hd)
    scores = torch.einsum("bugrq,btgq->bgrut", qg.float(), ck.float())
    scores = constrain(scores.reshape(b, H, 1, cache_len), "decode_scores")
    scores = scores * (1.0 / math.sqrt(hd) if scale is None else scale)
    valid = torch.arange(cache_len, device=scores.device) <= last
    scores = scores.masked_fill(~valid, -1e30)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = (e / e.sum(dim=-1, keepdim=True)).to(cv.dtype)
    probs = fit_split(probs, 1, G).reshape(b, G, H // G, 1, cache_len)
    return torch.einsum("bgrut,btgq->bugrq", probs, cv).reshape(b, 1, H, hd)
