"""NVIDIA H100 SXM data-sheet constants: the one home for them in the port.

Used to compute a kernel's bound (the least time the card could take for a
piece of work) and to cost deployments over a pool of cards
(``dse/gpu_deploy.py``). Dense rates, no sparsity, at the 700 W power
limit; a card set below that limit runs slower under load.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # HBM3, 80 GB
BF16_TENSOR_FLOPS = 989e12  # bf16/fp16 tensor cores, dense
TF32_TENSOR_FLOPS = 495e12  # TF32 tensor cores, dense
FP32_FLOPS = 67e12  # fp32 on CUDA cores (outside the tensor cores)
INT8_TENSOR_OPS = 1979e12  # int8 tensor cores, dense

HBM_CAPACITY_BYTES = 80e9
# NVLink 4 (18 links): 900 GB/s a card in total, 450 GB/s in each direction.
# Every card of one HGX board (8 cards) reaches every other at this rate
# through the NVSwitches, so one rate holds within those 8 cards.
NVLINK_BYTES_PER_S = 450e9
BOARD_CARDS = 8  # cards of one NVLink board (an HGX H100 8-GPU board, a DGX H100)
# Off its board a card reaches the others over the cluster network: in a DGX
# H100 (NVIDIA DGX H100 data sheet and user guide) each card has one
# ConnectX-7 port of 400 Gb/s NDR InfiniBand, 50 GB/s in each direction.
NETWORK_BYTES_PER_S = 50e9
# Usable bytes a card for a deployment's weights and activations: 80 GB less
# 2 GB (the same margin as the v5e's 14 GB of 16): a CUDA context holds
# ~0.5 GB (PERF.md: the pipeline run across four ranks), and the rest is left to NCCL's
# buffers, cuBLAS workspaces and the caching allocator's slack.
DEPLOY_BUDGET_BYTES = HBM_CAPACITY_BYTES - 2e9


def bound_seconds(n_bytes: float, n_flops: float, peak_flops: float) -> tuple[float, str]:
    """The larger of bytes / HBM rate and operations / ``peak_flops``, and
    which of the two sets it ("bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_flops / peak_flops
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
