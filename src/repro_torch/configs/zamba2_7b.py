"""zamba2-7b [hybrid]: Mamba2 backbone + 2 alternating shared attention
blocks applied every 6 layers [arXiv:2411.15242; unverified]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,  # MHA in the shared blocks
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,  # 3584 / 32
    ssm_state=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_head_dim=64,
    attn_every=6,
    n_shared_attn=2,
    mlp="swiglu",
    citation="arXiv:2411.15242",
))
