"""Plain PyTorch versions of the Mamba2 SSD scan, per head with a scalar
decay rate A < 0 and step sizes dt > 0:

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T      (h: (N, P))
    y_t = C_t . h_t

``ssd_reference`` is the sequential recurrence of ``repro.kernels.ssd_scan.ref``
(a loop over time): the oracle, and on the card the yardstick of the CUDA
kernel. It also returns the final state, the kernel's second output.
``ssd_chunked`` is the chunked form of ``repro.models.ssm.ssd_chunked``, the
JAX model's own path and here the CPU path: an intra-chunk causal term
``(C B^T . L . dt) X`` with the decay matrix L masked before the exp, and an
inter-chunk recurrence over chunk-boundary states.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_reference(xh, dt, A, B, C):
    """xh: (b, s, H, P); dt: (b, s, H) > 0; A: (H,) < 0; B, C: (b, s, N).
    Returns (y: (b, s, H, P), h_final: (b, H, N, P)), both fp32."""
    b, s, H, P = xh.shape
    N = B.shape[-1]
    xh, dt, A, B, C = (a.float() for a in (xh, dt, A, B, C))
    h = torch.zeros((b, H, N, P), dtype=torch.float32, device=xh.device)
    ys = []
    for t in range(s):
        dt_t = dt[:, t]  # (b, H)
        decay = torch.exp(dt_t * A[None, :])
        upd = torch.einsum("bh,bn,bhp->bhnp", dt_t, B[:, t], xh[:, t])
        h = h * decay[:, :, None, None] + upd
        ys.append(torch.einsum("bn,bhnp->bhp", C[:, t], h))
    return torch.stack(ys, 1), h


def ssd_chunked(xh, dt, A, B, C, chunk: int = 128):
    """Same inputs as ``ssd_reference``; returns y: (b, s, H, P). The sequence
    is padded to a whole number of chunks (zero dt: the state is unchanged)."""
    b, s, H, P = xh.shape
    N = B.shape[-1]
    if s % chunk:
        pad = chunk - s % chunk
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    S = xh.shape[1]
    nc = S // chunk
    xc = xh.reshape(b, nc, chunk, H, P)
    dtc = dt.reshape(b, nc, chunk, H)
    Bc = B.reshape(b, nc, chunk, N)
    Cc = C.reshape(b, nc, chunk, N)

    dA = dtc * A[None, None, None, :]  # (b, nc, l, H) negative increments
    cums = torch.cumsum(dA, dim=2)  # within-chunk cumulative log-decay

    # intra-chunk (diagonal) term: causal decay matrix L, masked *before* the
    # exp (above the diagonal the difference is positive and overflows; the
    # JAX package masks first so that the backward pass stays finite too)
    Ldiff = cums[:, :, :, None, :] - cums[:, :, None, :, :]  # (b, nc, l, l, H)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device))
    L = torch.exp(Ldiff.masked_fill(~causal[None, None, :, :, None], float("-inf")))
    CB = torch.einsum("bcln,bcmn->bclm", Cc, Bc)  # (b, nc, l, l)
    W = CB[..., None] * L * dtc[:, :, None, :, :]  # (b, nc, l, m, H)
    y_diag = torch.einsum("bclmh,bcmhp->bclhp", W, xc)

    # chunk-boundary states: h_c = sum_m exp(cums_last - cums_m) dt_m B_m x_m
    decay_to_end = torch.exp(cums[:, :, -1:, :] - cums)  # (b, nc, l, H)
    states = torch.einsum("bcln,bclhp->bchnp", Bc, (decay_to_end * dtc)[..., None] * xc)

    # inter-chunk recurrence: the state entering each chunk, in fp32 as JAX
    # carries it (float64 for float64 inputs, so that gradcheck runs)
    acc = torch.promote_types(states.dtype, torch.float32)
    chunk_decay = torch.exp(cums[:, :, -1, :])  # (b, nc, H)
    h = torch.zeros((b, H, N, P), dtype=acc, device=xh.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c].to(acc)
    h_in = torch.stack(h_prev, 1).to(Cc.dtype)  # (b, nc, H, N, P)

    # off-diagonal contribution: y_off = C_l . (exp(cums_l) h_in)
    y_off = torch.einsum("bcln,bchnp->bclhp", Cc, h_in) * torch.exp(cums)[..., None]
    return (y_diag + y_off).reshape(b, S, H, P)[:, :s]
