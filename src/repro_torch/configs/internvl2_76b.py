"""internvl2-76b [vlm]: InternViT frontend (STUB: input_specs supplies
precomputed patch embeddings) + LLaMA-70B-class decoder backbone
[arXiv:2404.16821; unverified]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    attn="full",
    mlp="swiglu",
    frontend="patch_embed",
    n_prefix_embeds=256,
    citation="arXiv:2404.16821",
))
