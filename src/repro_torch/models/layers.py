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

from ..runtime.pspec import constrain, is_sharded, product


def normal(gen, shape, scale: float, dtype, device) -> torch.Tensor:
    """N(0, scale^2) values from ``gen``; with ``gen`` None (a shape-only
    init on the meta device) an empty tensor of the same shape and dtype."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
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
        "gelu_erf": F.gelu,  # exact: Hugging Face's "gelu" (Zamba2's shared MLP)
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
    h = product(x, p["w_in"])
    if kind in ("swiglu", "geglu"):
        h = a(product(x, p["w_gate"])) * h
    else:
        h = a(h)
    h = constrain(h, "ffn_hidden")
    return product(h, p["w_out"])


# ------------------------------------------------------------- embedding ----
def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype, device) -> torch.Tensor:
    return normal(gen, (vocab, d), 1.0, dtype, device)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    if is_sharded(table):
        # FSDP's gather of the d_model shards before the lookup; the vocab
        # split stays (DTensor's masked lookup takes a table split on vocab
        # alone)
        from torch.distributed.tensor import Replicate, Shard

        keep = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                for p in table.placements]
        table = table.redistribute(table.device_mesh, keep)
    return F.embedding(tokens, table)


def unembed(table_or_head: torch.Tensor, x: torch.Tensor, tied: bool) -> torch.Tensor:
    logits = product(x, table_or_head.T if tied else table_or_head)
    return constrain(logits, "logits")
