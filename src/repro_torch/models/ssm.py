"""Mamba2 (SSD) block [arXiv:2405.21060], as in ``repro.models.ssm``: per-head
scalar decay A, input-dependent dt (softplus), B and C of size ``ssm_state``
shared by the heads, a depthwise causal conv on (x, B, C), and a gated
RMSNorm on the output.

The full-sequence scan goes through ``repro_torch.kernels.ssd_scan.ops``:
the CUDA kernel on the card at every length, ``ssd_chunked`` (the JAX
model's own path) on the CPU. Decode is plain tensor code, as in the JAX
package, and unlike it writes the new ``conv`` history and ``ssm`` state into
the cache it is given instead of returning new ones.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.ssd_scan import ops as ssd_ops
from .layers import normal, rmsnorm


def init_mamba(gen: torch.Generator, lead: tuple, cfg: ArchConfig, dtype, device) -> dict:
    """Mamba params with leading axes ``lead`` (the layer stack). ``A_log``,
    ``dt_bias`` and ``D`` are fp32 whatever ``dtype`` is."""
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * N

    def zeros(shape, dt=dtype):
        return torch.zeros((*lead, *shape), dtype=dt, device=device)

    return {
        # in_proj -> [z (di), x (di), B (N), C (N), dt (H)]
        "w_in": normal(gen, (*lead, d, 2 * di + 2 * N + H), 1.0 / math.sqrt(d), dtype, device),
        "conv_w": normal(gen, (*lead, cfg.ssm_conv, conv_dim), 0.5, dtype, device),
        "conv_b": zeros((conv_dim,)),
        "A_log": normal(gen, (*lead, H), 0.5, torch.float32, device),  # A = -exp(A_log)
        "dt_bias": zeros((H,), torch.float32),
        "D": torch.ones((*lead, H), dtype=torch.float32, device=device),
        "gate_norm": zeros((di,)),
        "w_out": normal(gen, (*lead, di, d), 1.0 / math.sqrt(di), dtype, device),
    }


def _split_proj(cfg: ArchConfig, proj: torch.Tensor):
    di, N = cfg.d_inner, cfg.ssm_state
    return proj[..., :di], proj[..., di:2 * di + 2 * N], proj[..., 2 * di + 2 * N:]


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along seq, then SiLU: xbc (b, s, c), w (k, c)."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + s, :] * w[i] for i in range(k))
    return F.silu(out + b)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, which is logaddexp(x, 0) at every x (torch's
    ``softplus`` turns linear above 20)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _gated_out(p: dict, cfg: ArchConfig, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    y = rmsnorm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return y @ p["w_out"]


def mamba_forward(p: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence Mamba2 block. x: (b, s, d)."""
    b, s, _ = x.shape
    H, P, N, di = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.d_inner
    z, xbc, dtr = _split_proj(cfg, x @ p["w_in"])
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xh = xbc[..., :di].reshape(b, s, H, P)
    B, C = xbc[..., di:di + N], xbc[..., di + N:]
    dt = _softplus(dtr.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    # the kernel takes contiguous fp32; the slices of xbc are neither in general
    y = ssd_ops.ssd_scan(xh.float().contiguous(), dt, A, B.float().contiguous(),
                         C.float().contiguous())
    y = y + p["D"][None, None, :, None] * xh.float()
    return _gated_out(p, cfg, y.reshape(b, s, di).to(x.dtype), z)


# ------------------------------------------------------------- decode path --
def init_mamba_cache(cfg: ArchConfig, n_layers: int, batch: int, dtype, device) -> dict:
    """The conv history in ``dtype`` and the SSM state in fp32."""
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = cfg.d_inner + 2 * N
    return {
        "conv": torch.zeros((n_layers, batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((n_layers, batch, H, N, P), dtype=torch.float32, device=device),
    }


def mamba_decode_step(p: dict, cfg: ArchConfig, x: torch.Tensor, cache: dict) -> torch.Tensor:
    """x: (b, 1, d); cache: one layer's {"conv": (b, k-1, c), "ssm": (b, H, N, P)},
    both overwritten with their new values. Returns the block's output."""
    b = x.shape[0]
    H, P, N, di = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.d_inner
    z, xbc, dtr = _split_proj(cfg, x @ p["w_in"])

    hist = torch.cat([cache["conv"], xbc[:, :1]], dim=1)  # (b, k, c), a new tensor
    conv_out = F.silu(torch.einsum("bkc,kc->bc", hist, p["conv_w"]) + p["conv_b"])
    cache["conv"].copy_(hist[:, 1:])

    xh = conv_out[..., :di].reshape(b, H, P).float()
    B, C = conv_out[..., di:di + N].float(), conv_out[..., di + N:].float()
    dt = _softplus(dtr[:, 0].float() + p["dt_bias"])  # (b, H)
    decay = torch.exp(dt * -torch.exp(p["A_log"])[None, :])
    upd = torch.einsum("bh,bn,bhp->bhnp", dt, B, xh)
    h = cache["ssm"]
    h.copy_(h * decay[:, :, None, None] + upd)
    y = torch.einsum("bn,bhnp->bhp", C, h)
    y = y + p["D"][None, :, None] * xh
    return _gated_out(p, cfg, y.reshape(b, 1, di).to(x.dtype), z)
