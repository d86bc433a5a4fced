"""LM assembly for the port: builds the ``dense``, ``rwkv``, ``mamba`` and
``shared_attn`` block kinds from an ArchConfig, in the JAX package's
parameter layout.

A model is a sequence of blocks; each block stacks ``n`` layers of one kind
along a leading layer axis (``params["blocks"][i]``), as in
``repro.models.transformer``. The port has the ``dense`` kind (pre-norm GQA
attention + pre-norm MLP, full or windowed attention), the ``rwkv`` kind
(RWKV6 time-mix + channel-mix), the ``mamba`` kind (Mamba2 SSD) and the
``shared_attn`` kind of zamba2 (a dense layer whose params, unstacked, live
in ``params["shared"]`` and are shared by its occurrences, each of which has
its own KV cache; its ``params["blocks"]`` entry is ``{}``). The ``moe`` kind
and the other frontends raise ``NotImplementedError`` naming their ROADMAP
item.

API:
  init_params(cfg, seed, dtype, device)          -> params
  forward(cfg, params, batch)                    -> (logits, aux)
  init_cache(cfg, batch, max_len, dtype, device) -> cache
  decode_step(cfg, params, cache, batch, pos)    -> (logits, cache)  [cache updated in place]
  forward_layers(cfg, stack, lo, hi, x)          -> x  [a pipeline stage's layers]
  final_logits(cfg, params, x)                   -> logits
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from .._device import resolve_device
from ..configs.base import ArchConfig
from . import attention as attn
from . import rwkv, ssm
from .layers import embed, init_embedding, init_mlp, mlp, normal, rmsnorm, unembed

_PORTED_KINDS = ("dense", "rwkv", "mamba", "shared_attn")
_ROADMAP_ITEM = {"moe": "ROADMAP queue 1 item 8 (models/moe.py)"}


@dataclass(frozen=True)
class BlockSpec:
    kind: str  # dense | moe | mamba | rwkv | shared_attn
    n: int  # stacked layers in this block (1 for shared_attn)
    local: bool = False  # windowed attention
    shared_idx: int = -1  # which shared param set (zamba2 alternates 2)


def layer_plan(cfg: ArchConfig) -> list[BlockSpec]:
    L = cfg.num_layers
    if cfg.family == "hybrid":
        plan: list[BlockSpec] = []
        done = 0
        grp = 0
        while done < L:
            n = min(cfg.attn_every, L - done)
            plan.append(BlockSpec("mamba", n))
            done += n
            if done < L or n == cfg.attn_every:
                plan.append(BlockSpec("shared_attn", 1, shared_idx=grp % cfg.n_shared_attn))
                grp += 1
        return plan
    if cfg.family == "ssm":
        return [BlockSpec("rwkv", L)]
    kind = "moe" if cfg.family == "moe" else "dense"
    if cfg.attn == "local_global":
        plan = []
        done = 0
        while done < L:
            n_local = min(cfg.global_every - 1, L - done)
            if n_local:
                plan.append(BlockSpec(kind, n_local, local=True))
                done += n_local
            if done < L:
                plan.append(BlockSpec(kind, 1, local=False))
                done += 1
        return plan
    return [BlockSpec(kind, L, local=(cfg.attn == "swa"))]


def _check_ported(cfg: ArchConfig) -> list[BlockSpec]:
    if cfg.frontend != "tokens":
        raise NotImplementedError(
            f"{cfg.name}: frontend {cfg.frontend!r} is ROADMAP queue 1 item 10 (frontends)")
    plan = layer_plan(cfg)
    for blk in plan:
        if blk.kind not in _PORTED_KINDS:
            raise NotImplementedError(f"{cfg.name}: block kind {blk.kind!r} is "
                                      f"{_ROADMAP_ITEM[blk.kind]}")
    return plan


# ------------------------------------------------------------------- init --
def _init_stack(gen: torch.Generator, cfg: ArchConfig, kind: str, lead: tuple, dtype,
                device) -> dict:
    """Params of one block kind with leading axes ``lead``: ``(n,)`` for a
    stack of n layers, ``()`` for a shared layer."""
    d = cfg.d_model

    def norm():
        return torch.zeros((*lead, d), dtype=dtype, device=device)

    if kind == "rwkv":
        return {"norm1": norm(), "tm": rwkv.init_rwkv(gen, lead, cfg, dtype, device),
                "norm2": norm()}  # tm includes the channel-mix params
    if kind == "mamba":
        return {"norm": norm(), "mamba": ssm.init_mamba(gen, lead, cfg, dtype, device)}
    return {
        "norm1": norm(),
        "attn": attn.init_attn(gen, lead, cfg, dtype, device),
        "norm2": norm(),
        "mlp": init_mlp(gen, lead, d, cfg.d_ff, cfg.mlp, dtype, device),
    }


def init_params(cfg: ArchConfig, seed: int = 0, dtype=torch.bfloat16, device=None) -> dict:
    """Random params from ``seed`` with the JAX package's shapes (not its
    values: torch cannot replay ``jax.random``; ``bridge`` copies those)."""
    plan = _check_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params: dict[str, Any] = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype, dev),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
        "blocks": [],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(gen, (cfg.d_model, cfg.vocab_size), cfg.d_model ** -0.5,
                                   dtype, dev)
    shared: dict[int, dict] = {}
    for blk in plan:
        if blk.kind == "shared_attn":
            if blk.shared_idx not in shared:
                shared[blk.shared_idx] = _init_stack(gen, cfg, blk.kind, (), dtype, dev)
            params["blocks"].append({})  # params live in params["shared"]
        else:
            params["blocks"].append(_init_stack(gen, cfg, blk.kind, (blk.n,), dtype, dev))
    if shared:
        params["shared"] = [shared[i] for i in sorted(shared)]
    return params


def _layer(stack: Any, i: int) -> Any:
    """Layer ``i`` of a stacked param tree (views, no copies)."""
    if isinstance(stack, dict):
        return {k: _layer(v, i) for k, v in stack.items()}
    return stack[i]


def _block_layer(params: dict, blk: BlockSpec, bparams: dict, i: int) -> dict:
    """The params of layer ``i`` of a block: a shared_attn block's one layer
    is its shared param set."""
    if blk.kind == "shared_attn":
        return params["shared"][blk.shared_idx]
    return _layer(bparams, i)


# ---------------------------------------------------------------- forward --
def _layer_forward(cfg: ArchConfig, kind: str, local: bool, p: dict,
                   x: torch.Tensor) -> torch.Tensor:
    if kind == "rwkv":  # zero shift and zero state; the new ones are dropped
        b, _, d = x.shape
        P = cfg.ssm_head_dim
        shift0 = torch.zeros((b, d), dtype=x.dtype, device=x.device)
        state0 = torch.zeros((b, d // P, P, P), dtype=torch.float32, device=x.device)
        h = rmsnorm(x, p["norm1"], cfg.norm_eps)
        x = x + rwkv.rwkv_time_mix(p["tm"], cfg, h, shift0, state0)[0]
        h = rmsnorm(x, p["norm2"], cfg.norm_eps)
        return x + rwkv.rwkv_channel_mix(p["tm"], cfg, h, shift0)[0]
    if kind == "mamba":
        return x + ssm.mamba_forward(p["mamba"], cfg, rmsnorm(x, p["norm"], cfg.norm_eps))
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    x = x + attn.full_attention(p["attn"], cfg, h, local=local)
    h = rmsnorm(x, p["norm2"], cfg.norm_eps)
    return x + mlp(p["mlp"], h, cfg.mlp, cfg.act)


def forward_layers(cfg: ArchConfig, stack: dict, lo: int, hi: int,
                   x: torch.Tensor) -> torch.Tensor:
    """Layers ``lo`` to ``hi`` of a uniform dense stack (params with a leading
    layer axis) on ``x``: the body of a pipeline stage."""
    local = cfg.attn == "swa"
    for i in range(lo, hi):
        x = _layer_forward(cfg, "dense", local, _layer(stack, i), x)
    return x


def final_logits(cfg: ArchConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """The final norm and the head: hidden states -> logits."""
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return unembed(head, x, tied=cfg.tie_embeddings)


def forward(cfg: ArchConfig, params: dict, batch: dict):
    """Full-sequence forward (prefill). batch: {"tokens": (b, s)}.

    Returns (logits, aux); aux carries the MoE loss, 0 for dense stacks."""
    plan = _check_ported(cfg)
    x = embed(params["embed"], batch["tokens"])
    for blk, bparams in zip(plan, params["blocks"]):
        for i in range(blk.n):
            x = _layer_forward(cfg, blk.kind, blk.local, _block_layer(params, blk, bparams, i),
                               x)
    logits = final_logits(cfg, params, x)
    return logits, {"moe_aux": torch.zeros((), dtype=torch.float32, device=x.device)}


# ------------------------------------------------------------------ cache --
def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> list:
    """Per-block decode caches. Windowed attention blocks get ring buffers
    of ``window`` slots; full attention gets ``max_len``; rwkv and mamba
    O(1). Each ``shared_attn`` occurrence has its own cache (leading axis 1)."""
    dev = resolve_device(device)
    caches = []
    for blk in _check_ported(cfg):
        if blk.kind == "rwkv":
            caches.append(rwkv.init_rwkv_cache(cfg, blk.n, batch, dtype, dev))
            continue
        if blk.kind == "mamba":
            caches.append(ssm.init_mamba_cache(cfg, blk.n, batch, dtype, dev))
            continue
        length = min(cfg.window, max_len) if blk.local else max_len
        caches.append(attn.init_kv_cache(cfg, blk.n, batch, length, dtype, dev))
    return caches


def decode_step(cfg: ArchConfig, params: dict, caches: list, batch: dict, pos: int):
    """One-token decode. batch: {"tokens": (b, 1)}; ``pos`` is the current
    sequence position. ``caches`` is updated in place and the same list is
    returned: attention blocks write this token's k/v (every lane of the
    batch at one slot); rwkv blocks overwrite ``shift_tm``, ``shift_cm`` and
    ``wkv`` with their new values (the wkv kernel writes the new state over
    the old one); mamba blocks overwrite ``conv`` and ``ssm``."""
    plan = _check_ported(cfg)
    pos = int(pos)
    x = embed(params["embed"], batch["tokens"])
    for blk, bparams, cache in zip(plan, params["blocks"], caches):
        for i in range(blk.n):
            x = _layer_decode(cfg, blk.kind, blk.local, _block_layer(params, blk, bparams, i),
                              x, _layer(cache, i), pos)
    return final_logits(cfg, params, x), caches


def _layer_decode(cfg: ArchConfig, kind: str, local: bool, p: dict, x: torch.Tensor,
                  lc: dict, pos: int) -> torch.Tensor:
    if kind == "mamba":
        return x + ssm.mamba_decode_step(p["mamba"], cfg, rmsnorm(x, p["norm"], cfg.norm_eps),
                                         lc)
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    if kind == "rwkv":
        y, new_tm, _ = rwkv.rwkv_time_mix(p["tm"], cfg, h, lc["shift_tm"], lc["wkv"],
                                          state_out=lc["wkv"])
        lc["shift_tm"].copy_(new_tm)
        x = x + y
        h = rmsnorm(x, p["norm2"], cfg.norm_eps)
        y, new_cm = rwkv.rwkv_channel_mix(p["tm"], cfg, h, lc["shift_cm"])
        lc["shift_cm"].copy_(new_cm)
        return x + y
    x = x + attn.decode_attention(p["attn"], cfg, h, lc, pos, local=local)
    h = rmsnorm(x, p["norm2"], cfg.norm_eps)
    return x + mlp(p["mlp"], h, cfg.mlp, cfg.act)
