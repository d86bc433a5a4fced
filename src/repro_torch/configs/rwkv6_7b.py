"""rwkv6-7b [ssm] "Finch": attention-free, data-dependent decay
[arXiv:2404.05892; hf]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,  # wkv heads: d_model / ssm_head_dim
    num_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    head_dim=64,
    attn="none",
    ssm_head_dim=64,
    mlp="dense",  # rwkv channel-mix (squared relu)
    act="sqrelu",
    citation="arXiv:2404.05892",
))
