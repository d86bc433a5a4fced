"""NVIDIA H100 SXM data-sheet constants: the one home for them in the port.

Used only to compute a kernel's bound (the least time the card could take
for a piece of work). Dense rates, no sparsity, at the 700 W power limit;
a card set below that limit runs slower under load.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # HBM3, 80 GB
BF16_TENSOR_FLOPS = 989e12  # bf16/fp16 tensor cores, dense
TF32_TENSOR_FLOPS = 495e12  # TF32 tensor cores, dense
FP32_FLOPS = 67e12  # fp32 on CUDA cores (outside the tensor cores)
INT8_TENSOR_OPS = 1979e12  # int8 tensor cores, dense


def bound_seconds(n_bytes: float, n_flops: float, peak_flops: float) -> tuple[float, str]:
    """The larger of bytes / HBM rate and operations / ``peak_flops``, and
    which of the two sets it ("bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_flops / peak_flops
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
