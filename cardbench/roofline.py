"""The yardstick's counts: the operations and bytes of the work the cells
do, and the data-sheet peaks they are held to.

Peaks are NVIDIA's H100 SXM data sheet, dense, at the 700 W limit. The
configurations run fp32; their peak is the dense TF32 rate, 495 TFLOP/s,
not the 67 TFLOP/s of fp32 outside the tensor cores: the flash kernel
already runs 3xTF32 on the tensor cores, and a later GEMM on such a route
would read above 100 % of the lower rate. A least time is the larger of
the operations the algorithm needs over the peak (attention counted only
where the mask keeps a pair) and each input byte read once and each output
byte written once over the HBM rate.
"""
from __future__ import annotations

from typing import Optional

from .model_config import Dims

PEAK_FLOPS = 495e12  # TF32 tensor cores, dense
HBM_BYTES_PER_S = 3.35e12


def least_s(flops: float, n_bytes: float) -> float:
    return max(flops / PEAK_FLOPS, n_bytes / HBM_BYTES_PER_S)


def kept_pairs(s: int, window: Optional[int]) -> int:
    """(query, key) pairs of causal self-attention over s positions that the
    mask keeps: row i sees min(i + 1, window) keys."""
    w = s if window is None else min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def layer_matmul_params(d: Dims) -> int:
    """Weights a token multiplies in one layer: q, k, v, o and the MLP."""
    attn = d.d * d.head_dim * (d.heads + 2 * d.kv_heads) + d.heads * d.head_dim * d.d
    return attn + d.d * d.d_ff * (3 if d.mlp == "swiglu" else 2)


def attention_flops(d: Dims, b: int, s: int) -> int:
    """One layer's attention over b sequences of s positions: q k and p v,
    two operations a kept pair, head and head dimension."""
    return 4 * d.head_dim * d.heads * b * kept_pairs(s, d.window)


def prefill_flops(d: Dims, b: int, s: int) -> int:
    """A forward of b x s tokens with logits at every position."""
    matmul = 2 * b * s * (d.layers * layer_matmul_params(d) + d.d * d.vocab)
    return matmul + d.layers * attention_flops(d, b, s)


def flash_least_s(d: Dims, b: int, s: int, itemsize: int = 4) -> float:
    """The least time of one launch of the attention kernel on b x s:
    q, k, v read and the output written once."""
    n_bytes = itemsize * (2 * b * s * d.heads * d.head_dim + 2 * b * s * d.kv_heads * d.head_dim)
    return least_s(attention_flops(d, b, s), n_bytes)


def decode_keys(d: Dims, pos: int) -> int:
    """Keys a decode step at ``pos`` attends to, its own included."""
    return pos + 1 if d.window is None else min(pos + 1, d.window)


def decode_step_flops(d: Dims, b: int, pos: int) -> int:
    matmul = 2 * b * (d.layers * layer_matmul_params(d) + d.d * d.vocab)
    return matmul + d.layers * 4 * d.head_dim * d.heads * b * decode_keys(d, pos)


def decode_step_bytes(d: Dims, b: int, pos: int, itemsize: int = 4) -> int:
    """Read once: every weight (norms, layers, final norm, head) and b rows
    of the embedding, the cache up to ``pos`` and the token ids; written
    once: the step's k and v, and the logits."""
    weights = d.layers * (layer_matmul_params(d) + 2 * d.d) + d.d + d.d * d.vocab + b * d.d
    cache = d.layers * 2 * b * decode_keys(d, pos) * d.kv_heads * d.head_dim
    return itemsize * (weights + cache + b * d.vocab) + 8 * b


def decode_step_least_s(d: Dims, b: int, pos: int) -> float:
    return least_s(decode_step_flops(d, b, pos), decode_step_bytes(d, b, pos))
