"""Architecture configuration system.

Every assigned architecture is a frozen :class:`ArchConfig` registered under
its pool id (``--arch <id>``). Shapes follow the assignment: every LM arch
carries the four canonical input shapes; ``long_500k`` only applies to
sub-quadratic architectures (``supports_long``).

``reduced()`` returns a tiny same-family config for CPU smoke tests; the full
configs are exercised exclusively through the dry-run (ShapeDtypeStruct, no
allocation).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


LM_SHAPES: tuple[ShapeCfg, ...] = (
    ShapeCfg("train_4k", 4_096, 256, "train"),
    ShapeCfg("prefill_32k", 32_768, 32, "prefill"),
    ShapeCfg("decode_32k", 32_768, 128, "decode"),
    ShapeCfg("long_500k", 524_288, 1, "decode"),
)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default: d_model // num_heads

    # attention flavor
    attn: str = "full"  # full | swa | local_global | none
    window: int = 4_096  # SWA / local window
    global_every: int = 0  # local_global: every Nth layer is global (gemma3: 6)
    qk_norm: bool = False
    rope_theta: float = 10_000.0

    # MLP
    mlp: str = "swiglu"  # swiglu | geglu | dense
    act: str = "silu"

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_group: int = 1024  # dispatch group size (tokens)

    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    attn_every: int = 0  # hybrid (zamba2): shared attn block after every N
    n_shared_attn: int = 2  # alternating shared blocks

    # io frontend (vlm/audio: stubbed embeddings per the assignment)
    frontend: str = "tokens"  # tokens | patch_embed | frame_embed
    n_prefix_embeds: int = 256  # vlm: image tokens folded into the sequence

    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    citation: str = ""

    # ------------------------------------------------------------------ api --
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def supports_long(self) -> bool:
        """long_500k runs only for sub-quadratic attention state (SSM /
        hybrid / windowed); pure full-attention archs skip it (DESIGN.md)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.attn in ("swa", "local_global")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def shapes(self) -> list[ShapeCfg]:
        out = []
        for s in LM_SHAPES:
            if s.name == "long_500k" and not self.supports_long:
                continue
            out.append(s)
        return out

    def all_shapes_with_skips(self) -> list[tuple[ShapeCfg, bool]]:
        return [
            (s, s.name == "long_500k" and not self.supports_long)
            for s in LM_SHAPES
        ]

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + layers)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
        gate = 2 if self.mlp in ("swiglu", "geglu") else 1
        per_mlp = d * f * (gate + 1)
        if self.family == "moe":
            per_mlp = per_mlp * self.n_experts + d * self.n_experts
        if self.family == "ssm":  # rwkv6: time-mix ~ 4*d^2 + channel-mix
            per_layer = 4 * d * d + d * f * 2
            return emb + self.num_layers * per_layer
        if self.family == "hybrid":
            di, N = self.d_inner, self.ssm_state
            per_mamba = d * (2 * di + 2 * N * 1 + self.ssm_heads) + di * d + di * (self.ssm_conv)
            shared = self.n_shared_attn * (per_attn + per_mlp)
            return emb + self.num_layers * per_mamba + shared
        return emb + self.num_layers * (per_attn + per_mlp)

    def active_param_count(self) -> int:
        if self.family != "moe":
            return self.param_count()
        dense_like = replace(self, n_experts=0, top_k=0, family="dense")
        d, f = self.d_model, self.d_ff
        gate = 2 if self.mlp in ("swiglu", "geglu") else 1
        per_mlp = d * f * (gate + 1)
        return dense_like.param_count() - self.num_layers * per_mlp + self.num_layers * self.top_k * per_mlp

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        return replace(
            self,
            num_layers=max(2, min(4, self.num_layers)),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(4, max(1, self.num_kv_heads * 4 // self.num_heads or 1)),
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            window=64,
            global_every=self.global_every and 2,
            attn_every=self.attn_every and 2,
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=32 if self.ssm_state else self.ssm_head_dim,
            moe_group=64,
            n_prefix_embeds=8,
        )


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    from . import _ensure_loaded

    _ensure_loaded()
    return _REGISTRY[name]


def all_configs() -> dict[str, ArchConfig]:
    from . import _ensure_loaded

    _ensure_loaded()
    return dict(_REGISTRY)
