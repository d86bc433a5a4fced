"""Traffic drivers, one module a kind, named by a traffic file's ``driver``:
each has ``run(spec) -> list[record]`` (``harness.py``)."""
from ..model_config import dims


def arch_config(cfg: dict):
    """The port's ``ArchConfig`` for a configuration file: what the drivers
    hand the program."""
    from repro_torch.configs.base import ArchConfig

    d = dims(cfg)
    return ArchConfig(name=d.name, family="dense", num_layers=d.layers, d_model=d.d,
                      num_heads=d.heads, num_kv_heads=d.kv_heads, d_ff=d.d_ff,
                      vocab_size=d.vocab, head_dim=d.head_dim,
                      attn="full" if d.window is None else "swa",
                      window=d.window or 4096, mlp=d.mlp, act=d.act, rope_theta=d.rope_theta,
                      norm_eps=d.eps, tie_embeddings=False)
