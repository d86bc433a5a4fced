"""musicgen-large [audio]: decoder-only transformer over EnCodec tokens
(frontend STUB: input_specs supplies precomputed frame embeddings)
[arXiv:2306.05284; hf]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,  # MHA
    d_ff=8192,
    vocab_size=2048,
    head_dim=64,
    attn="full",
    mlp="dense",
    act="gelu",
    frontend="frame_embed",
    citation="arXiv:2306.05284",
))
