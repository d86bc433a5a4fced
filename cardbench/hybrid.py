"""A hybrid configuration file (``port.family`` ``hybrid``: Zamba2's published
``config.json`` keys) as the benchmark reads it.

``model_config.dims`` loads such a file too, for the keys a dense stack
shares, but its head size would read hidden / heads = 112; the yardstick of
a hybrid cell (weights, counts, the reference) takes its sizes from
``hybrid_dims`` instead, and ``port_fields`` names them as the port's
``HybridConfig`` does (``drivers/prefill.py`` builds that config from them;
this module imports nothing of the port).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HybridDims:
    name: str
    layers: int  # mamba layers (num_hidden_layers)
    d: int  # hidden_size
    vocab: int
    hybrid_ids: tuple[int, ...]  # a shared call before each of these mamba layers
    blocks: int  # shared blocks (num_mem_blocks); call j runs block j % blocks
    heads: int  # the shared attention's heads, of head_dim, reading d_attn channels
    kv_heads: int
    head_dim: int
    d_attn: int  # concat(x, embedding): 2 d
    d_ff: int  # the shared MLP's width (gate and up each)
    adapter_rank: int  # each call's LoRA on the MLP's gate|up
    ssm_heads: int
    ssm_head_dim: int  # P
    d_state: int  # N
    groups: int  # G: B/C groups, head h reads group h // (H / G)
    d_conv: int
    d_inner: int
    rope_theta: float
    eps: float

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.groups * self.d_state

    @property
    def calls(self) -> int:
        return len(self.hybrid_ids)


def is_hybrid(cfg: dict) -> bool:
    return cfg["port"]["family"] == "hybrid"


def hybrid_dims(cfg: dict) -> HybridDims:
    """The sizes of a hybrid file; raises where the file asks for what the
    published layout does not have (biases, an attention adapter, no RoPE)."""
    port = cfg["port"]
    want = {"use_shared_mlp_adapter": True, "use_shared_attention_adapter": False,
            "use_mem_rope": True, "add_bias_linear": False, "use_conv_bias": True,
            "time_step_limit": None}
    wrong = {k: cfg.get(k) for k, v in want.items() if cfg.get(k) != v}
    if port["norm"] != "rms_one_plus_scale" or port["act"] != "gelu_erf" or wrong:
        raise ValueError(f"{cfg['name']}: the benchmark's hybrid stack is Zamba2's published "
                         f"layout with RMS norms weighted by 1 + scale; got {port}, {wrong}")
    d, layers = cfg["hidden_size"], cfg["num_hidden_layers"]
    kinds = ["hybrid" if i in cfg["hybrid_layer_ids"] else "mamba" for i in range(layers)]
    if kinds != cfg["layers_block_type"] or cfg["attention_hidden_size"] != 2 * d:
        raise ValueError(f"{cfg['name']}: layers_block_type or attention_hidden_size disagree "
                         "with hybrid_layer_ids and hidden_size")
    d_inner = cfg["mamba_expand"] * d
    if cfg["n_mamba_heads"] * cfg["mamba_headdim"] != d_inner:
        raise ValueError(f"{cfg['name']}: n_mamba_heads x mamba_headdim != mamba_expand x hidden")
    return HybridDims(
        name=cfg["name"], layers=layers, d=d, vocab=cfg["vocab_size"],
        hybrid_ids=tuple(cfg["hybrid_layer_ids"]), blocks=cfg["num_mem_blocks"],
        heads=cfg["num_attention_heads"], kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg["attention_head_dim"], d_attn=cfg["attention_hidden_size"],
        d_ff=cfg["ffn_hidden_size"], adapter_rank=cfg["adapter_rank"],
        ssm_heads=cfg["n_mamba_heads"], ssm_head_dim=cfg["mamba_headdim"],
        d_state=cfg["mamba_d_state"], groups=cfg["mamba_ngroups"], d_conv=cfg["mamba_d_conv"],
        d_inner=d_inner, rope_theta=float(cfg["rope_theta"]), eps=float(cfg["rms_norm_eps"]))


def port_fields(h: HybridDims) -> dict:
    """The keyword arguments of the port's ``HybridConfig`` for these sizes:
    a gated exact-GELU MLP, the head tied to the embedding."""
    return dict(
        name=h.name, family="hybrid", num_layers=h.layers, d_model=h.d, num_heads=h.heads,
        num_kv_heads=h.kv_heads, d_ff=h.d_ff, vocab_size=h.vocab, head_dim=h.head_dim,
        rope_theta=h.rope_theta, mlp="geglu", act="gelu_erf", ssm_state=h.d_state,
        ssm_expand=h.d_inner // h.d, ssm_conv=h.d_conv, ssm_head_dim=h.ssm_head_dim,
        n_shared_attn=h.blocks, tie_embeddings=True, norm_eps=h.eps, ssm_groups=h.groups,
        hybrid_layer_ids=h.hybrid_ids, adapter_rank=h.adapter_rank)

