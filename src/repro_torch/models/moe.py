"""Mixture-of-Experts FFN: top-k routing with capacity-factor dispatch, the
twin of ``repro.models.moe`` (GShard/Switch-style one-hot dispatch and
combine tensors, the same grouping, capacity, drops and aux loss).

Tokens (batch and sequence flattened) are cut into ``n_groups`` dispatch
groups of ``gl`` tokens; each (token, k) pair takes a place in its expert's
queue in token-major, k-minor order, and pairs past the capacity ``C`` are
dropped (their gate is zeroed). As in the JAX package, tokens past
``n_groups * gl`` (a ragged tail) are not routed: the layer passes them to
its output unchanged.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .layers import act_fn, normal


def init_moe(gen: torch.Generator, lead: tuple, cfg: ArchConfig, dtype, device) -> dict:
    """MoE params with leading axes ``lead`` (the layer stack); the router is
    fp32 whatever ``dtype`` is."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {"router": normal(gen, (*lead, d, E), s_in, torch.float32, device),
         "w_in": normal(gen, (*lead, E, d, f), s_in, dtype, device),
         "w_out": normal(gen, (*lead, E, f, d), s_out, dtype, device)}
    if cfg.mlp in ("swiglu", "geglu"):
        p["w_gate"] = normal(gen, (*lead, E, d, f), s_in, dtype, device)
    return p


def _capacity(cfg: ArchConfig, group_len: int) -> int:
    c = int(math.ceil(group_len * cfg.top_k * cfg.capacity_factor / cfg.n_experts))
    return max(4, min(group_len, c))


def moe_mlp(p: dict, cfg: ArchConfig, x: torch.Tensor):
    """x: (b, s, d) -> (y, aux, keep). ``y`` and the fp32 load-balancing loss
    ``aux`` are JAX's ``(y, aux)``; ``keep`` (n_groups, gl, K) says which
    (token, k) pairs found a place in their expert's queue."""
    b, s, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    tokens = x.reshape(b * s, d)
    n = tokens.shape[0]
    gl = min(cfg.moe_group, n)
    n_groups = max(1, n // gl)
    gl = n // n_groups
    xt = tokens[:n_groups * gl].reshape(n_groups, gl, d)

    probs = torch.softmax(xt.float() @ p["router"], dim=-1)  # (g, t, E)
    # top-k gates (sorted, as jax.lax.top_k), normalised over the chosen experts
    gate_vals, gate_idx = torch.topk(probs, K, dim=-1)  # (g, t, K)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    C = _capacity(cfg, gl)
    # place of each (token, k) in its expert's queue, token-major then k-minor
    onehot = F.one_hot(gate_idx, E).float()  # (g, t, K, E)
    flatoh = onehot.reshape(n_groups, gl * K, E)
    pos = ((flatoh.cumsum(1) - flatoh).reshape(n_groups, gl, K, E) * onehot).sum(-1)
    keep = pos < C
    gate_vals = gate_vals * keep

    # combine[g, t, e, c] = gate of the pair of token t queued at place c of
    # expert e (a token takes an expert once, so one pair at most): contracted
    # over k in two steps, never a (g, t, K, E, C) tensor. JAX's one_hot gives
    # zeros past C, where torch's raises: clamp, the zeroed gates drop them.
    pos_oh = F.one_hot(pos.long().clamp(max=C - 1), C).float() * keep[..., None]
    gated = (gate_vals[..., None] * onehot).reshape(n_groups * gl, K, E)
    combine = (gated.transpose(1, 2) @ pos_oh.reshape(n_groups * gl, K, C))
    combine = combine.reshape(n_groups, gl, E, C).to(x.dtype)
    dispatch = (combine > 0).to(x.dtype)

    # the expert GEMMs in the promoted dtype of x and the weights, as JAX's
    # einsums promote (a bf16 x with fp32 weights runs them in fp32); each
    # .to is a no-op where the dtypes agree
    wdt = torch.promote_types(x.dtype, p["w_in"].dtype)
    xe = torch.einsum("gtec,gtd->gecd", dispatch, xt).to(wdt)  # (g, E, C, d)
    h = torch.einsum("gecd,edf->gecf", xe, p["w_in"].to(wdt))
    if "w_gate" in p:
        gt = torch.einsum("gecd,edf->gecf", xe, p["w_gate"].to(wdt))
        h = act_fn("silu" if cfg.mlp == "swiglu" else cfg.act)(gt) * h
    else:
        h = act_fn(cfg.act)(h)
    ye = torch.einsum("gecf,efd->gecd", h, p["w_out"].to(wdt))
    y = torch.einsum("gtec,gecd->gtd", combine.to(ye.dtype), ye)

    # load-balancing loss (Switch): E * sum_e f_e * P_e, f from the top-1 choice
    me = onehot[:, :, 0, :].mean(1)
    pe = probs.mean(1)
    aux = E * (me * pe).sum(-1).mean()

    y = y.reshape(n_groups * gl, d)
    if n_groups * gl < n:  # the ragged tail passes through, as in JAX
        y = torch.cat([y, tokens[n_groups * gl:]], dim=0)
    return y.reshape(b, s, d), aux, keep
