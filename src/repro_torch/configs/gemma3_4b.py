"""gemma3-4b [dense]: 5:1 local:global attention, 128k context, GeGLU,
huge vocab [hf:google/gemma-3-1b-pt; unverified]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    d_ff=10240,
    vocab_size=262144,
    head_dim=256,
    attn="local_global",
    window=1024,
    global_every=6,  # 5 local : 1 global
    qk_norm=True,
    rope_theta=1_000_000.0,
    mlp="geglu",
    act="gelu",
    tie_embeddings=True,
    citation="hf:google/gemma-3-1b-pt",
))
