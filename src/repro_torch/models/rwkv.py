"""RWKV-6 "Finch" block [arXiv:2404.05892], as in ``repro.models.rwkv``:
attention-free time-mix with data-dependent decay (low-rank dynamic lerp +
decay LoRA) and squared-ReLU channel-mix.

The wkv recurrence goes through ``repro_torch.kernels.rwkv6.ops``: the CUDA
kernel on the card at every length, the JAX package's CPU dispatch on the
CPU. State per layer: the token-shift registers (last hidden) of time and
channel mix and the (H, P, P) fp32 wkv state.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.rwkv6 import ops as wkv_ops
from ..runtime.pspec import constrain, fit_split, product
from .layers import normal

LORA_R = 32  # low-rank dim for the dynamic mix / decay projections


def init_rwkv(gen: torch.Generator, lead: tuple, cfg: ArchConfig, dtype, device) -> dict:
    """Time-mix and channel-mix params with leading axes ``lead`` (the layer
    stack). ``w0``, ``u`` and ``ln_x`` are fp32 whatever ``dtype`` is."""
    d, f = cfg.d_model, cfg.d_ff
    s = 1.0 / math.sqrt(d)

    def full(value, shape, dt=dtype):
        return torch.full((*lead, *shape), value, dtype=dt, device=device)

    def rand(shape, scale, dt=dtype):
        return normal(gen, (*lead, *shape), scale, dt, device)

    return {
        # time-mix
        "mu_x": full(0.5, (d,)),
        "mu": rand((5, d), 0.1),  # r, k, v, w, g static mix
        "A_mix": rand((d, 5 * LORA_R), s),
        "B_mix": rand((5, LORA_R, d), 0.05),
        "w0": rand((d,), 0.5, torch.float32),
        "A_w": rand((d, LORA_R), s),
        "B_w": rand((LORA_R, d), 0.05),
        "u": rand((d,), 0.5, torch.float32),  # bonus for the current token
        "Wr": rand((d, d), s),
        "Wk": rand((d, d), s),
        "Wv": rand((d, d), s),
        "Wg": rand((d, d), s),
        "Wo": rand((d, d), s),
        "ln_x": full(1.0, (d,), torch.float32),  # per-head group norm scale
        # channel-mix
        "cm_mu_r": full(0.5, (d,)),
        "cm_mu_k": full(0.5, (d,)),
        "cm_Wr": rand((d, d), s),
        "cm_Wk": rand((d, f), s),
        "cm_Wv": rand((f, d), 1.0 / math.sqrt(f)),
    }


def _ddlerp(p: dict, x: torch.Tensor, xx: torch.Tensor) -> list:
    """Data-dependent token-shift mixing -> r, k, v, w, g inputs (RWKV6)."""
    dx = xx - x
    xxx = x + dx * p["mu_x"]
    lora = torch.tanh(product(xxx, p["A_mix"]))
    lora = fit_split(lora, -1, 5).reshape(*lora.shape[:-1], 5, LORA_R)
    dyn = torch.einsum("...er,erd->...ed", lora, p["B_mix"])  # (..., 5, d)
    mixed = x[..., None, :] + dx[..., None, :] * (p["mu"] + dyn)
    return list(mixed.unbind(-2))


def _decay(p: dict, xw: torch.Tensor) -> torch.Tensor:
    lw = product(xw, p["A_w"])
    w = p["w0"] + product(torch.tanh(lw), p["B_w"]).float()
    return torch.exp(-torch.exp(w))  # in (0, 1), data-dependent per channel


def _group_norm(y: torch.Tensor, scale: torch.Tensor, H: int, eps: float = 64e-5):
    """Head-wise normalization of the wkv output (population variance, as
    ``jnp.var``)."""
    yh = fit_split(y, -1, H).reshape(*y.shape[:-1], H, -1).float()
    mu = yh.mean(dim=-1, keepdim=True)
    var = yh.var(dim=-1, keepdim=True, correction=0)
    yh = (yh - mu) * torch.rsqrt(var + eps)
    return (yh.reshape(y.shape) * scale).to(y.dtype)


def _shifted(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """x moved one token later, with ``shift`` (b, d) as the token before it."""
    return torch.cat([shift[:, None, :], x[:, :-1, :]], dim=1)


def rwkv_time_mix(p: dict, cfg: ArchConfig, x: torch.Tensor, shift: torch.Tensor,
                  state: torch.Tensor, *, state_out=None):
    """x: (b, s, d); shift: (b, d) last token of the previous call; state:
    (b, H, P, P) fp32. Returns (y, new_shift, new_state); the new state is
    written into ``state_out`` when given, which may be ``state`` itself."""
    b, s, d = x.shape
    P = cfg.ssm_head_dim
    H = d // P
    xr, xk, xv, xw, xg = _ddlerp(p, x, _shifted(x, shift))
    r = fit_split(product(xr, p["Wr"]), -1, H).reshape(b, s, H, P)
    k = fit_split(product(xk, p["Wk"]), -1, H).reshape(b, s, H, P)
    v = fit_split(product(xv, p["Wv"]), -1, H).reshape(b, s, H, P)
    g = F.silu(product(xg, p["Wg"]))
    w = fit_split(_decay(p, xw), -1, H).reshape(b, s, H, P)
    u = p["u"].reshape(H, P)
    r32, k32, v32 = (constrain(a.float(), "ssm_x") for a in (r, k, v))
    y, new_state = wkv_ops.wkv6(r32, k32, v32, w, u, state, state_out=state_out)
    y = constrain(y, "ssm_x")
    y = _group_norm(y.reshape(b, s, d), p["ln_x"], H).to(x.dtype)
    return product(y * g, p["Wo"]), x[:, -1, :], new_state


def rwkv_channel_mix(p: dict, cfg: ArchConfig, x: torch.Tensor, shift: torch.Tensor):
    xx = _shifted(x, shift)
    xr = x + (xx - x) * p["cm_mu_r"]
    xk = x + (xx - x) * p["cm_mu_k"]
    kk = constrain(F.relu(product(xk, p["cm_Wk"])).square(), "ffn_hidden")
    vv = product(kk, p["cm_Wv"])
    rr = torch.sigmoid(product(xr, p["cm_Wr"]))
    return rr * vv, x[:, -1, :]


def init_rwkv_cache(cfg: ArchConfig, n_layers: int, batch: int, dtype, device) -> dict:
    """Token-shift registers in ``dtype`` and the wkv state in fp32."""
    d = cfg.d_model
    P = cfg.ssm_head_dim
    H = d // P
    return {
        "shift_tm": torch.zeros((n_layers, batch, d), dtype=dtype, device=device),
        "shift_cm": torch.zeros((n_layers, batch, d), dtype=dtype, device=device),
        "wkv": torch.zeros((n_layers, batch, H, P, P), dtype=torch.float32, device=device),
    }
