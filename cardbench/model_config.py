"""A configuration file as the benchmark reads it.

The file's top-level keys are those of the model's published ``config.json``
with the values as run (``BENCHMARK.json`` lists under ``reduced`` every key
whose value differs from the published one); its ``port`` group says how the
port's dense stack is set to run it. ``dims`` gives the sizes the yardstick
uses (weights, counts, the reference); ``drivers.arch_config`` turns them
into the port's ``ArchConfig``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class Dims:
    name: str
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    window: Optional[int]  # None: full causal attention
    mlp: str  # "swiglu" (gated SiLU) or "dense" (one projection, then the activation)
    act: str  # "silu" or "gelu" (tanh form)
    rope_theta: float
    eps: float


def dims(cfg: dict) -> Dims:
    port = cfg["port"]
    if port["norm"] != "rms_one_plus_scale" or cfg.get("use_bias", False):
        raise ValueError(f"{cfg['name']}: the benchmark's dense stack has RMS norms weighted "
                         "by 1 + scale and no biases")
    eps = cfg["rms_norm_eps"] if "rms_norm_eps" in cfg else cfg["norm_epsilon"]
    return Dims(name=cfg["name"], layers=cfg["num_hidden_layers"], d=cfg["hidden_size"],
                heads=cfg["num_attention_heads"], kv_heads=cfg["num_key_value_heads"],
                head_dim=cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"],
                d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
                window=cfg.get("sliding_window"), mlp=port["mlp"], act=port["act"],
                rope_theta=float(cfg["rope_theta"]), eps=float(eps))

