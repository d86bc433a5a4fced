"""Plain PyTorch versions of the RWKV6 wkv recurrence, as in
``repro.kernels.rwkv6.ref``:

    y_t = r_t . (S + u * k_t v_t^T)
    S   = diag(w_t) S + k_t v_t^T

``wkv6_reference`` is the sequential recurrence (a loop over time): the
oracle, and on the card the yardstick of the CUDA kernel. ``wkv6_chunked``
is the GLA-style chunked form, the CPU path for ``s > 1``: with prefix decays
P_t = prod_{tau<=t} w_tau inside a chunk,

    y_t = (r_t*P_{t-1}) . S_in + sum_{s<t} ((r_t*P_{t-1}).(k_s/P_s)) v_s
        + ((r_t*u).k_t) v_t
    S_out = D(P_L) (S_in + (k/P)^T V)

It is exact while the per-chunk cumulative log-decay stays within +/-CLAMP
(=60); beyond that the clamped terms mis-weight contributions, so outside
that regime it is not the recurrence (the sequential version is).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

CLAMP = 60.0


def wkv6_chunked(r, k, v, w, u, state, chunk: int = 16):
    """Same contract as ``wkv6_reference``; r/k/v/w: (b, s, h, p) fp32, w in
    (0, 1); u: (h, p); state: (b, h, p, p). Returns (y, final_state)."""
    b, s, h, p = r.shape
    ch = min(chunk, s)
    nc = -(-s // ch)
    pad = nc * ch - s
    if pad:
        r, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)

    rc, kc, vc, wc = (a.reshape(b, nc, ch, h, p) for a in (r, k, v, w))
    logw = torch.log(torch.clamp(wc, min=1e-38))
    cum = torch.cumsum(logw, dim=2)  # log P_t (within the chunk)
    excl = cum - logw  # log P_{t-1}
    r_dec = rc * torch.exp(torch.clamp(excl, -CLAMP, CLAMP))
    k_dec = kc * torch.exp(torch.clamp(-cum, -CLAMP, CLAMP))

    # intra-chunk: A[t, s] = r_dec_t . k_dec_s, strictly causal
    A = torch.einsum("bclhp,bcmhp->bchlm", r_dec, k_dec)
    mask = torch.tril(torch.ones((ch, ch), dtype=torch.bool, device=r.device), diagonal=-1)
    A = A.masked_fill(~mask, 0.0)
    y = torch.einsum("bchlm,bcmhq->bclhq", A, vc)
    # bonus diagonal
    d = (rc * u * kc).sum(-1)
    y = y + d[..., None] * vc

    # inter-chunk state recurrence: the state entering each chunk
    s_local = torch.einsum("bclhp,bclhq->bchpq", k_dec, vc)  # (k/P)^T V
    chunk_decay = torch.exp(torch.clamp(cum[:, :, -1], -CLAMP, CLAMP))  # (b, nc, h, p)
    S = state
    s_in = []
    for c in range(nc):
        s_in.append(S)
        S = chunk_decay[:, c, :, :, None] * (S + s_local[:, c])
    y = y + torch.einsum("bclhp,bchpq->bclhq", r_dec, torch.stack(s_in, 1))

    y = y.reshape(b, nc * ch, h, p)[:, :s]
    return y, S


def wkv6_reference(r, k, v, w, u, state):
    """r/k/v/w: (b, s, h, p) fp32 (w in (0, 1)); u: (h, p); state: (b, h, p, p).
    Returns (y: (b, s, h, p), final_state). The steps come from ``unbind``,
    whose backward stacks the steps' gradients once; indexing step t instead
    would make its backward fill and add a zero tensor of the whole input
    each step (the card's wkv6 gradient differentiates this loop)."""
    S = state
    ys = []
    for rt, kt, vt, wt in zip(*(x.unbind(1) for x in (r, k, v, w))):  # (b, h, p) each
        kv = kt[..., :, None] * vt[..., None, :]
        ys.append(torch.einsum("bhp,bhpq->bhq", rt, S + u[None, :, :, None] * kv))
        S = S * wt[..., None] + kv
    return torch.stack(ys, 1), S
