"""Plain PyTorch forward of Zamba2 as published (Zyphra/Zamba2-7B-Instruct,
``modeling_zamba2``; arXiv:2411.15242), from the configuration file's sizes
(``hybrid.HybridDims``), with every norm weighted by 1 + scale as the port
stores it:

    x0 = E[tokens];  x = x0
    for l in 0 .. layers - 1:
      if l is the j-th entry of hybrid_ids (block b = j % blocks):
        u = rms(concat(x, x0)) * (1 + n_in[b])                      # 2 d wide
        q, k, v = u Wq[b], u Wk[b], u Wv[b]                         # heads x hd
        q, k = RoPE(q), RoPE(k)                                     # split-half over hd
        a = causal_softmax(q k^T * (hd / 2)^-1/2) v  ->  Wo[b]      # no residual
        g = rms(a) * (1 + n_ff[b])
        gate | up = g Wgu[b] + (g A_j) B_j                          # the call's LoRA
        t = ((gelu_erf(gate) * up) Wdown[b]) L_j                    # the call's projection
      else t = 0
      h = rms(x + t) * (1 + n[l])
      z | xBC | dt = h Win[l]
      xBC = silu(causal_depthwise_conv(xBC) + conv_b[l])
      xs, B, C = xBC split d_inner | G N | G N                      # B, C: (G, N)
      D = softplus(dt + dt_bias[l]);  A = -exp(A_log[l])            # no time-step clamp
      head h, group g = h // (H / G):
        S_t = exp(D_t A) S_{t-1} + D_t B_t,g (x) xs_t,h;  y_t,h = C_t,g . S_t + Dskip_h xs_t,h
      x = x + (group_rms(y * silu(z), groups of d_inner / G) * (1 + n_gate[l])) Wout[l]
    logits = (rms(x) * (1 + n_final)) E^T                           # tied head

The scan runs in its chunked matrix form (chunks of 256, the config's
``chunk_size``): within a chunk (C B^T . L . dt) X with the decay matrix L
masked before its exp, across chunks the recurrence of the chunk-boundary
states. Attention runs in blocks of 1024 query rows. It computes in the
dtype of its inputs (float32 on the card, float64 in the tests) and runs one
or more precisions of the same forward side by side (``"fp32"``: TF32 off;
``"tf32"``: the control, TF32 on), drawing each layer's weights once for
all of them. It imports nothing of the port.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch
import torch.nn.functional as F

from ..hybrid import HybridDims
from .dense import precision, rmsnorm, rope

CHUNK = 256
BLOCK = 1024


def attention(q, k, v, scale: float, block: int = BLOCK) -> torch.Tensor:
    """Causal attention, q (b, s, H, hd), k and v (b, s, G, hd), G dividing
    H, scores scaled by ``scale``, in blocks of ``block`` query rows."""
    b, s, H, hd = q.shape
    rep = H // k.shape[2]
    qh = q.transpose(1, 2)
    kh = k.repeat_interleave(rep, dim=2).transpose(1, 2)
    vh = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    out = torch.empty_like(qh)
    for i0 in range(0, s, block):
        i1 = min(s, i0 + block)
        scores = (qh[:, :, i0:i1] @ kh[:, :, :i1].transpose(-1, -2)) * scale
        seen = torch.arange(i1, device=q.device)[None, :] <= torch.arange(
            i0, i1, device=q.device)[:, None]
        scores = scores.masked_fill(~seen, float("-inf"))
        out[:, :, i0:i1] = torch.softmax(scores, -1) @ vh[:, :, :i1]
    return out.transpose(1, 2)


def ssd(xs, dt, A, B, C, chunk: int = CHUNK) -> torch.Tensor:
    """y of the scan: xs (b, s, H, P), dt (b, s, H) > 0, A (H,) < 0, B and C
    (b, s, G, N); head h reads group h // (H / G). Chunked matrix form; the
    sequence is padded to whole chunks with dt = 0 (the state unchanged)."""
    b, s, H, P = xs.shape
    G, N = B.shape[2], B.shape[3]
    B = B.repeat_interleave(H // G, dim=2)  # (b, s, H, N)
    C = C.repeat_interleave(H // G, dim=2)
    pad = -s % chunk
    if pad:
        xs, B, C = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xs, B, C))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc = xs.shape[1] // chunk
    x = xs.reshape(b, nc, chunk, H, P)
    Bc, Cc = B.reshape(b, nc, chunk, H, N), C.reshape(b, nc, chunk, H, N)
    dtc = dt.reshape(b, nc, chunk, H)
    cums = torch.cumsum(dtc * A, dim=2)  # (b, nc, l, H): log-decay from the chunk's start
    # within a chunk: y_l = sum_{m <= l} C_l . B_m exp(cums_l - cums_m) dt_m x_m
    diff = cums.permute(0, 1, 3, 2)[..., :, None] - cums.permute(0, 1, 3, 2)[..., None, :]
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=xs.device).tril()
    L = torch.exp(diff.masked_fill(~causal, float("-inf")))  # (b, nc, H, l, m)
    W = torch.einsum("bclhn,bcmhn->bchlm", Cc, Bc) * L * dtc.permute(0, 1, 3, 2)[..., None, :]
    y = torch.einsum("bchlm,bcmhp->bclhp", W, x)
    # chunk-boundary states, then the state entering each chunk
    to_end = torch.exp(cums[:, :, -1:] - cums) * dtc  # (b, nc, l, H)
    states = torch.einsum("bclhn,bclh,bclhp->bchnp", Bc, to_end, x)
    decay = torch.exp(cums[:, :, -1])  # (b, nc, H)
    h = torch.zeros_like(states[:, 0])
    entering = []
    for c in range(nc):
        entering.append(h)
        h = h * decay[:, c, :, None, None] + states[:, c]
    h_in = torch.stack(entering, 1)  # (b, nc, H, N, P)
    y = y + torch.einsum("bclhn,bchnp->bclhp", Cc, h_in) * torch.exp(cums)[..., None]
    return y.reshape(b, nc * chunk, H, P)[:, :s]


def mamba(h: HybridDims, p: dict, x: torch.Tensor, t: Optional[torch.Tensor]) -> torch.Tensor:
    """x after mamba layer ``p``, the call's output ``t`` (or None) added to
    its input before the norm."""
    b, s, _ = x.shape
    di, G, N, H, P = h.d_inner, h.groups, h.d_state, h.ssm_heads, h.ssm_head_dim
    u = rmsnorm(x if t is None else x + t, p["norm"], h.eps)
    proj = u @ p["w_in"]
    z, xbc, dtr = proj[..., :di], proj[..., di:di + h.conv_dim], proj[..., di + h.conv_dim:]
    padded = F.pad(xbc, (0, 0, h.d_conv - 1, 0))
    conv = sum(padded[:, k:k + s] * p["conv_w"][k] for k in range(h.d_conv))
    xbc = F.silu(conv + p["conv_b"])
    xs = xbc[..., :di].reshape(b, s, H, P)
    B = xbc[..., di:di + G * N].reshape(b, s, G, N)
    C = xbc[..., di + G * N:].reshape(b, s, G, N)
    dt = F.softplus(dtr + p["dt_bias"], threshold=float("inf"))  # no linear branch
    y = ssd(xs, dt, -torch.exp(p["A_log"]), B, C) + p["D"][:, None] * xs
    gated = (y.reshape(b, s, di) * F.silu(z)).reshape(b, s, G, di // G)
    normed = rmsnorm(gated, p["gate_norm"].reshape(G, di // G), h.eps).reshape(b, s, di)
    return x + normed @ p["w_out"]


def shared_call(h: HybridDims, p: dict, c: dict, x: torch.Tensor, x0: torch.Tensor):
    """The output t of a call into shared block ``p`` with the call's own
    LoRA and projection ``c``."""
    b, s, _ = x.shape
    u = rmsnorm(torch.cat([x, x0], -1), p["norm1"], h.eps)
    q, k, v = ((u @ p[w].reshape(h.d_attn, -1)).view(b, s, -1, h.head_dim)
               for w in ("wq", "wk", "wv"))
    o = attention(rope(q, h.rope_theta), rope(k, h.rope_theta), v, (h.head_dim / 2) ** -0.5)
    a = o.reshape(b, s, -1) @ p["wo"].reshape(-1, h.d)
    g = rmsnorm(a, p["norm2"], h.eps)
    gate, up = (g @ p["w_gate_up"] + (g @ c["adapter_a"]) @ c["adapter_b"]).chunk(2, -1)
    return ((F.gelu(gate) * up) @ p["w_out"]) @ c["linear"]


def logits(h: HybridDims, mamba_weights: Callable[[int], dict],
           shared_weights: Callable[[int], dict], call_weights: Callable[[int], dict],
           glob: dict, tokens: torch.Tensor, rows: Optional[torch.Tensor] = None,
           precisions: Iterable[str] = ("fp32",)) -> dict[str, torch.Tensor]:
    """Logits (b, len(rows), V) of tokens (b, s) at positions ``rows`` (all
    by default), one tensor a precision. ``mamba_weights(l)``,
    ``shared_weights(b)`` and ``call_weights(j)`` give the leaves by last
    name (``hybrid_weights``); ``glob`` holds ``embed`` and ``final_norm``."""
    x0 = glob["embed"][tokens]
    xs = {name: x0 for name in precisions}
    calls = {i: j for j, i in enumerate(h.hybrid_ids)}
    for layer in range(h.layers):
        ts = dict.fromkeys(xs)
        if layer in calls:
            j = calls[layer]
            p, c = shared_weights(j % h.blocks), call_weights(j)
            for name in xs:
                with precision(name):
                    ts[name] = shared_call(h, p, c, xs[name], x0)
            del p, c
        p = mamba_weights(layer)
        for name in xs:
            with precision(name):
                xs[name] = mamba(h, p, xs[name], ts[name])
        del p, ts
    out = {}
    for name, x in xs.items():
        if rows is not None:
            x = x[:, rows]
        with precision(name):
            out[name] = rmsnorm(x, glob["final_norm"], h.eps) @ glob["embed"].T
    return out
