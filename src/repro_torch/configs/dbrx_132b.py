"""dbrx-132b [moe]: 16 fine-grained experts top-4, GQA kv=8
[hf:databricks/dbrx-base; unverified]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    head_dim=128,
    attn="full",
    mlp="swiglu",
    n_experts=16,
    top_k=4,
    citation="hf:databricks/dbrx-base",
))
