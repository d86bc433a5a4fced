"""The yardstick's counts for a hybrid configuration (``hybrid.HybridDims``):
the operations of a prefill and the least times of the SSD scan and of the
shared attention, at the data-sheet peaks of ``roofline.py``.

The scan is counted as its recurrence needs it, whatever implements it: per
token, head and layer the state update exp(dt a) h + (dt x) B^T and the
read-out C h, 4 N P operations, and the bytes of xh, dt, B and C read once
and y written once. A chunked form on the tensor cores does more operations
than that and moves no fewer bytes, so no implementation reads above 100 %.
"""
from __future__ import annotations

from .hybrid import HybridDims
from .roofline import kept_pairs, least_s


def mamba_matmul_params(h: HybridDims) -> int:
    """Weights a token multiplies in one mamba layer: in and out projections."""
    return h.d * (h.d_inner + h.conv_dim + h.ssm_heads) + h.d_inner * h.d


def call_matmul_params(h: HybridDims) -> int:
    """Weights a token multiplies in one shared call: q, k, v over the
    concat, o, the MLP's gate|up and down, the LoRA and the projection."""
    attn = h.d_attn * h.head_dim * (h.heads + 2 * h.kv_heads) + h.heads * h.head_dim * h.d
    mlp = h.d * 2 * h.d_ff + h.d_ff * h.d
    return attn + mlp + h.adapter_rank * (h.d + 2 * h.d_ff) + h.d * h.d


def scan_flops(h: HybridDims, b: int, s: int) -> int:
    """One layer's scan over b x s tokens: 4 N P a token and head."""
    return 4 * h.d_state * h.ssm_head_dim * h.ssm_heads * b * s


def scan_bytes(h: HybridDims, b: int, s: int, itemsize: int = 4) -> int:
    """xh, dt, B and C read once, y written once."""
    return itemsize * b * s * (2 * h.ssm_heads * h.ssm_head_dim + h.ssm_heads
                               + 2 * h.groups * h.d_state)


def ssd_least_s(h: HybridDims, b: int, s: int) -> float:
    return least_s(scan_flops(h, b, s), scan_bytes(h, b, s))


def attention_flops(h: HybridDims, b: int, s: int) -> int:
    """One call's causal attention over b x s: q k and p v, two operations a
    kept pair, head and head dimension (no window)."""
    return 4 * h.head_dim * h.heads * b * kept_pairs(s, None)


def flash_least_s(h: HybridDims, b: int, s: int, itemsize: int = 4) -> float:
    """One launch of the attention kernel on b x s: q, k, v read and the
    output written once."""
    n_bytes = itemsize * 2 * b * s * h.head_dim * (h.heads + h.kv_heads)
    return least_s(attention_flops(h, b, s), n_bytes)


def prefill_flops(h: HybridDims, b: int, s: int) -> int:
    """A forward of b x s tokens with logits at every position: the products,
    the tied head, the calls' attention and the layers' scans."""
    matmul = 2 * b * s * (h.layers * mamba_matmul_params(h) + h.calls * call_matmul_params(h)
                          + h.d * h.vocab)
    return matmul + h.calls * attention_flops(h, b, s) + h.layers * scan_flops(h, b, s)
