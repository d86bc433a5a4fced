"""Optimizers on trees of tensors, the twins of ``repro.runtime.optimizer``:
AdamW with a configurable moment dtype, and Adafactor-style factored second
moments.

Plain functions, as in JAX: ``*_init`` builds the state, ``*_update``
returns new params and state and leaves its inputs as they were. The state
is the JAX package's tree (``{"step": int32 0-d tensor, "m": tree, "v":
tree}`` for AdamW), so a checkpoint of either package restores in the
other. Scalars (the step, the learning rate, the bias corrections, the
clip factor) are fp32 tensors, computed as JAX computes them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from ..tree import tree_leaves, tree_map
from .pspec import settled


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: torch.dtype = torch.float32  # bf16 halves optimizer memory
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_schedule(c: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay, in fp32."""
    step = step.float()
    warm = torch.clamp(step / max(c.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - c.warmup_steps) / max(c.total_steps - c.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return c.lr * warm * (c.min_lr_ratio + (1 - c.min_lr_ratio) * cos)


def adamw_init(c: AdamWConfig, params: Any) -> dict:
    def zeros(p):  # a DTensor's moments take its placements
        return torch.zeros_like(p, dtype=c.moment_dtype, memory_format=torch.contiguous_format)

    step = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
    return {"step": step, "m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def global_norm(tree: Any) -> torch.Tensor:
    # a sharded leaf's sum is reduced before the stack (``settled``)
    return torch.sqrt(torch.stack([settled(g.float().square().sum())
                                   for g in tree_leaves(tree)]).sum())


@torch.no_grad()
def adamw_update(c: AdamWConfig, grads: Any, opt_state: dict, params: Any):
    """Returns (params, opt_state, {"lr", "grad_norm"}): clipping by the
    global norm, bias correction, decoupled weight decay on every leaf."""
    step = opt_state["step"] + 1
    lr = lr_schedule(c, step)
    gnorm = global_norm(grads)
    clip = torch.clamp(c.grad_clip / (gnorm + 1e-9), max=1.0)
    stepf = step.float()
    corr1 = 1 - torch.pow(torch.tensor(c.b1, device=stepf.device), stepf)
    corr2 = 1 - torch.pow(torch.tensor(c.b2, device=stepf.device), stepf)

    def upd(g, m, v, p):
        g = g.float() * clip
        m_new = c.b1 * m.float() + (1 - c.b1) * g
        v_new = c.b2 * v.float() + (1 - c.b2) * g.square()
        delta = (m_new / corr1) / (torch.sqrt(v_new / corr2) + c.eps) \
            + c.weight_decay * p.float()
        p_new = p.float() - lr * delta
        return p_new.to(p.dtype), m_new.to(c.moment_dtype), v_new.to(c.moment_dtype)

    out = tree_map(upd, grads, opt_state["m"], opt_state["v"], params)
    return (_pick(out, 0), {"step": step, "m": _pick(out, 1), "v": _pick(out, 2)},
            {"lr": lr, "grad_norm": gnorm})


def _pick(tree: Any, i: int) -> Any:
    """Item ``i`` of each tuple that an update left at the leaves of a tree
    of dicts and lists."""
    if isinstance(tree, tuple):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return [_pick(v, i) for v in tree]


# ------------------------------------------------- Adafactor (factored v) --
@dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-3
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0


def adafactor_init(c: AdafactorConfig, params: Any) -> dict:
    """Row and column second moments (``vr``, ``vc``) for a leaf of two or
    more dimensions, the full ``v`` for the others; fp32."""
    def zeros(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if p.dim() >= 2:
            return {"vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return {"v": torch.zeros(p.shape, **f32)}

    step = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
    return {"step": step, "v": tree_map(zeros, params)}


@torch.no_grad()
def adafactor_update(c: AdafactorConfig, grads: Any, opt_state: dict, params: Any):
    step = opt_state["step"] + 1
    beta = 1.0 - (step.float() + 1.0) ** (-c.decay)

    def upd(g, v, p):
        g = g.float()
        g2 = g.square() + c.eps
        if p.dim() >= 2:
            vr = beta * v["vr"] + (1 - beta) * g2.mean(-1)
            vc = beta * v["vc"] + (1 - beta) * g2.mean(-2)
            r = vr / vr.mean(-1, keepdim=True)  # normalised rows
            u = g * torch.rsqrt(r[..., None] * vc[..., None, :] + c.eps)  # rank-1 estimate
            v_new = {"vr": vr, "vc": vc}
        else:
            v_full = beta * v["v"] + (1 - beta) * g2
            u = g * torch.rsqrt(v_full)
            v_new = {"v": v_full}
        rms = torch.sqrt(u.square().mean() + 1e-12)
        u = u / torch.clamp(rms / c.clip_threshold, min=1.0)
        p_new = p.float() - c.lr * (u + c.weight_decay * p.float())
        return p_new.to(p.dtype), v_new

    # the state's leaves are dicts: walk the params' structure, not the state's
    out = tree_map(lambda p, g, v: upd(g, v, p), params, grads, opt_state["v"])
    return _pick(out, 0), {"step": step, "v": _pick(out, 1)}, {}

