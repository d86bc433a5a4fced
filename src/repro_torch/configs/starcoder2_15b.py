"""starcoder2-15b [dense]: GQA kv=4, RoPE, non-gated GELU MLP
[arXiv:2402.19173; hf]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    attn="full",
    mlp="dense",
    act="gelu",
    citation="arXiv:2402.19173",
))
