"""grok-1-314b [moe]: 8 experts top-2, GQA kv=8 [hf:xai-org/grok-1;
unverified]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    head_dim=128,
    attn="full",
    mlp="geglu",
    act="gelu",
    n_experts=8,
    top_k=2,
    citation="hf:xai-org/grok-1",
))
