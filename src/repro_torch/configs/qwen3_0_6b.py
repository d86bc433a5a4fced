"""qwen3-0.6b [dense]: qk_norm, GQA kv=8, tied embeddings
[hf:Qwen/Qwen3-8B; hf]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=3072,
    vocab_size=151936,
    head_dim=128,  # qwen3 uses explicit 128 (> d_model/heads)
    attn="full",
    qk_norm=True,
    rope_theta=1_000_000.0,
    mlp="swiglu",
    tie_embeddings=True,
    citation="hf:Qwen/Qwen3-8B",
))
