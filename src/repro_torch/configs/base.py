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
from typing import ClassVar, Optional


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
    # Zamba2's published layout (``HybridConfig``, whose fields these are):
    # B/C groups of the SSD scan, the mamba layers a shared call precedes and
    # the rank of each call's LoRA. The registered presets, whose fields are
    # the JAX package's, read these defaults: one group, the ``attn_every`` plan.
    ssm_groups: ClassVar[int] = 1
    hybrid_layer_ids: ClassVar[tuple[int, ...]] = ()
    adapter_rank: ClassVar[int] = 0

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


@dataclass(frozen=True)
class HybridConfig(ArchConfig):
    """A hybrid stack in Zamba2's published layout (Zyphra/Zamba2-7B-Instruct,
    ``modeling_zamba2``; arXiv:2411.15242), which the ``zamba2-7b`` preset
    simplifies. Mamba2 layers whose B and C form ``ssm_groups`` groups (head
    h reads group h // (H / G); the gated norm is per group of d_inner / G
    channels); before each layer of ``hybrid_layer_ids`` a call into shared
    block j % ``n_shared_attn`` (j: the call's index): RMS norm of
    concat(x, the token embedding), attention with ``num_heads`` heads of
    ``head_dim`` read from that 2 d_model width and scaled by
    (head_dim / 2)^-1/2, then an RMS norm and a gated exact-GELU MLP (``act``
    ``gelu_erf``) whose gate|up product adds the call's own rank
    ``adapter_rank`` LoRA, and the call's own d_model x d_model projection.
    No residual inside the call: its output is added to the next mamba
    layer's input before that layer's norm."""
    ssm_groups: int = 1
    hybrid_layer_ids: tuple[int, ...] = ()
    adapter_rank: int = 0

    def __post_init__(self):
        ids = self.hybrid_layer_ids
        if list(ids) != sorted(set(ids)) or not all(0 <= i < self.num_layers for i in ids):
            raise ValueError(f"hybrid_layer_ids {ids}: increasing mamba layer indices below "
                             f"{self.num_layers}")
        if self.ssm_heads % self.ssm_groups or self.d_inner % self.ssm_groups:
            raise ValueError(f"{self.ssm_heads} heads and d_inner {self.d_inner} do not split "
                             f"into {self.ssm_groups} groups")

    def param_count(self) -> int:
        d, f, r, v = self.d_model, self.d_ff, self.adapter_rank, self.vocab_size
        di, GN, H, hd = self.d_inner, self.ssm_groups * self.ssm_state, self.ssm_heads, \
            self.resolved_head_dim
        conv = di + 2 * GN
        mamba = d * (di + conv + H) + self.ssm_conv * conv + conv + 3 * H + di + di * d + d
        attn = 2 * d * 3 * self.num_heads * hd + self.num_heads * hd * d
        shared = 2 * d + attn + d + d * 2 * f + f * d
        call = d * r + r * 2 * f + d * d
        emb = v * d * (1 if self.tie_embeddings else 2)
        return (emb + d + self.num_layers * mamba + self.n_shared_attn * shared
                + len(self.hybrid_layer_ids) * call)


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
