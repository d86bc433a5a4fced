"""Plain PyTorch forward of the dense decoder that the port runs for both
configurations, from the published description as the configuration file
states it:

    x = embed[tokens]
    each layer:  h = rms(x) * (1 + norm1);  q, k, v = h Wq, h Wk, h Wv (heads)
                 q, k = RoPE(q), RoPE(k)  (split-half, theta from the file)
                 x += attention(q, k, v) Wo   (GQA: q head i reads kv head
                                               i // (H / G); causal, and
                                               windowed where the file has a
                                               sliding window)
                 h = rms(x) * (1 + norm2)
                 x += (silu(h Wgate) * h Win) Wout     (swiglu)
                   or gelu_tanh(h Win) Wout             (dense)
    logits = (rms(x) * (1 + final_norm)) Whead

It computes in the dtype of its inputs (float32 on the card, float64 in the
tests), attention in blocks of query rows, and runs one or more precisions
of the same forward side by side (``"fp32"``: TF32 off; ``"tf32"``: the
control, TF32 on), drawing each layer's weights once for all of them.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Iterable, Optional

import torch
import torch.nn.functional as F

from ..model_config import Dims


@contextlib.contextmanager
def precision(name: str):
    """Matmuls in float32 with TF32 off (``"fp32"``) or on (``"tf32"``)."""
    keep = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    on = {"fp32": False, "tf32": True}[name]
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = keep


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotary embedding of x (b, s, heads, hd) at positions 0 .. s-1."""
    s, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=x.dtype, device=x.device) / hd)
    ang = torch.arange(s, dtype=x.dtype, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(q, k, v, window: Optional[int], block: int = 1024) -> torch.Tensor:
    """Causal GQA attention, q (b, s, H, hd), k and v (b, s, G, hd), in
    blocks of ``block`` query rows; a key j is seen by row i where j <= i
    and, with a window, i - j < window."""
    b, s, H, hd = q.shape
    rep = H // k.shape[2]
    qh = q.transpose(1, 2)
    kh = k.repeat_interleave(rep, dim=2).transpose(1, 2)
    vh = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    out = torch.empty_like(qh)
    for i0 in range(0, s, block):
        i1 = min(s, i0 + block)
        lo = 0 if window is None else max(0, i0 - window + 1)
        scores = (qh[:, :, i0:i1] @ kh[:, :, lo:i1].transpose(-1, -2)) / math.sqrt(hd)
        qi = torch.arange(i0, i1, device=q.device)[:, None]
        kj = torch.arange(lo, i1, device=q.device)[None, :]
        seen = kj <= qi
        if window is not None:
            seen &= kj > qi - window
        scores = scores.masked_fill(~seen, float("-inf"))
        out[:, :, i0:i1] = torch.softmax(scores, -1) @ vh[:, :, lo:i1]
    return out.transpose(1, 2)


def layer_forward(d: Dims, p: dict, x: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    H, G, hd = d.heads, d.kv_heads, d.head_dim
    h = rmsnorm(x, p["norm1"], d.eps)
    q = (h @ p["wq"].reshape(d.d, H * hd)).view(b, s, H, hd)
    k = (h @ p["wk"].reshape(d.d, G * hd)).view(b, s, G, hd)
    v = (h @ p["wv"].reshape(d.d, G * hd)).view(b, s, G, hd)
    o = attention(rope(q, d.rope_theta), rope(k, d.rope_theta), v, d.window)
    x = x + o.reshape(b, s, H * hd) @ p["wo"].reshape(H * hd, d.d)
    h = rmsnorm(x, p["norm2"], d.eps)
    if d.mlp == "swiglu":
        m = F.silu(h @ p["w_gate"]) * (h @ p["w_in"])
    elif d.act == "gelu":
        m = F.gelu(h @ p["w_in"], approximate="tanh")
    else:
        raise ValueError(f"{d.name}: mlp {d.mlp!r} with act {d.act!r}")
    return x + m @ p["w_out"]


def logits(d: Dims, layer_weights: Callable[[int], dict], glob: dict, tokens: torch.Tensor,
           rows: Optional[torch.Tensor] = None,
           precisions: Iterable[str] = ("fp32",)) -> dict[str, torch.Tensor]:
    """Logits (b, len(rows), V) of tokens (b, s) at positions ``rows`` (all
    by default), one tensor a precision. ``layer_weights(i)`` gives layer
    i's leaves by name (``wq`` ... ``w_out``, ``norm1``, ``norm2``);
    ``glob`` holds ``embed``, ``final_norm`` and ``lm_head``."""
    xs = {name: glob["embed"][tokens] for name in precisions}
    for i in range(d.layers):
        p = layer_weights(i)
        for name in xs:
            with precision(name):
                xs[name] = layer_forward(d, p, xs[name])
        del p
    out = {}
    for name, x in xs.items():
        if rows is not None:
            x = x[:, rows]
        with precision(name):
            out[name] = rmsnorm(x, glob["final_norm"], d.eps) @ glob["lm_head"]
    return out
