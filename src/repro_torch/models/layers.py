"""Shared layer primitives: norms, RoPE, MLPs, initializers.

Conventions (those of ``repro.models.layers``):
  * params are nested dicts of tensors; per-layer stacks carry a leading
    layer axis;
  * norm and softmax statistics are fp32 whatever the compute dtype;
  * weight layouts are the JAX package's: ``w_in (d, f)``, ``w_out (f, d)``,
    embedding ``(vocab, d)``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def normal(gen: torch.Generator, shape, scale: float, dtype, device) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(scale).to(dtype)  # in place: a stacked leaf is drawn once, not twice


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def act_fn(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
        "sqrelu": lambda x: F.relu(x).square(),
    }[name]


# ----------------------------------------------------------------- RoPE ----
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half RoPE. x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    ang = positions[..., :, None].float() * freqs  # (..., s, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ MLPs ----
def init_mlp(gen: torch.Generator, lead: tuple, d: int, f: int, kind: str, dtype,
             device) -> dict:
    """MLP params with leading axes ``lead`` (the layer stack)."""
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {"w_in": normal(gen, (*lead, d, f), s_in, dtype, device),
         "w_out": normal(gen, (*lead, f, d), s_out, dtype, device)}
    if kind in ("swiglu", "geglu"):
        p["w_gate"] = normal(gen, (*lead, d, f), s_in, dtype, device)
    return p


def mlp(p: dict, x: torch.Tensor, kind: str, act: str) -> torch.Tensor:
    a = act_fn("silu" if kind == "swiglu" else act)
    h = x @ p["w_in"]
    if kind in ("swiglu", "geglu"):
        h = a(x @ p["w_gate"]) * h
    else:
        h = a(h)
    return h @ p["w_out"]


# ------------------------------------------------------------- embedding ----
def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype, device) -> torch.Tensor:
    return normal(gen, (vocab, d), 1.0, dtype, device)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, table)


def unembed(table_or_head: torch.Tensor, x: torch.Tensor, tied: bool) -> torch.Tensor:
    if tied:
        return x @ table_or_head.T
    return x @ table_or_head
