"""LM assembly for the port: builds every architecture of the zoo from its
ArchConfig, in the JAX package's parameter layout.

A model is a sequence of blocks; each block stacks ``n`` layers of one kind
along a leading layer axis (``params["blocks"][i]``), as in
``repro.models.transformer``:

  dense        pre-norm GQA attention + pre-norm MLP (full or windowed)
  moe          pre-norm GQA attention + pre-norm MoE FFN
  rwkv         RWKV6 time-mix + channel-mix
  mamba        Mamba2 (SSD) block
  shared_attn  zamba2's shared dense layer: its params, unstacked, live in
               ``params["shared"]`` and are shared by its occurrences, each
               with its own KV cache; its ``params["blocks"]`` entry is ``{}``,
               or, in Zamba2's published layout (``HybridConfig``), the
               call's own LoRA and output projection (leading axis 1):
               the call reads concat(x, the token embedding) and its output
               joins the next mamba layer's input, not the residual

The input frontend is the config's: ``tokens``; ``patch_embed`` (tokens, with
``batch["patch_embeds"]`` projected by ``params["patch_proj"]`` over the
first positions at prefill); ``frame_embed`` (``batch["frame_embeds"]`` is
the input).

API:
  init_params(cfg, seed, dtype, device)          -> params
  forward(cfg, params, batch, remat=False)       -> (logits, aux)
  init_cache(cfg, batch, max_len, dtype, device) -> cache
  decode_step(cfg, params, cache, batch, pos)    -> (logits, cache)  [cache updated in place]
  forward_layers(cfg, stack, lo, hi, x)          -> x  [a pipeline stage's layers]
  final_logits(cfg, params, x)                   -> logits
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..configs.base import ArchConfig
from ..runtime.pspec import constrain, product, reduced_grad, unbind_layers
from ..runtime.spans import span
from . import attention as attn
from . import moe, rwkv, ssm
from .layers import (act_fn, embed, init_embedding, init_mlp, mlp, normal, rmsnorm,
                     unembed)


@dataclass(frozen=True)
class BlockSpec:
    kind: str  # dense | moe | mamba | rwkv | shared_attn
    n: int  # stacked layers in this block (1 for shared_attn)
    local: bool = False  # windowed attention
    shared_idx: int = -1  # which shared param set (zamba2 alternates 2)


def layer_plan(cfg: ArchConfig) -> list[BlockSpec]:
    L = cfg.num_layers
    if cfg.hybrid_layer_ids:  # a shared call before each of these mamba layers
        plan, done = [], 0
        for j, i in enumerate(cfg.hybrid_layer_ids):
            if i > done:
                plan.append(BlockSpec("mamba", i - done))
            plan.append(BlockSpec("shared_attn", 1, shared_idx=j % cfg.n_shared_attn))
            done = i
        return plan + [BlockSpec("mamba", L - done)]
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
    if kind == "shared_attn" and cfg.hybrid_layer_ids:  # reads concat(x, embedding)
        f = cfg.d_ff
        return {"norm1": torch.zeros((*lead, 2 * d), dtype=dtype, device=device),
                "attn": attn.init_attn(gen, lead, cfg, dtype, device, d_in=2 * d),
                "norm2": norm(),
                "mlp": {"w_gate_up": normal(gen, (*lead, d, 2 * f), d ** -0.5, dtype, device),
                        "w_out": normal(gen, (*lead, f, d), f ** -0.5, dtype, device)}}
    layer = {"norm1": norm(), "attn": attn.init_attn(gen, lead, cfg, dtype, device),
             "norm2": norm()}
    if kind == "moe":
        layer["moe"] = moe.init_moe(gen, lead, cfg, dtype, device)
    else:
        layer["mlp"] = init_mlp(gen, lead, d, cfg.d_ff, cfg.mlp, dtype, device)
    return layer


def _init_call(gen: torch.Generator, cfg: ArchConfig, dtype, device) -> dict:
    """One shared call's own params in the published layout (leading axis 1):
    the LoRA on the shared MLP's gate|up (``adapter_a`` (d, r), ``adapter_b``
    (r, 2 d_ff)) and the output projection ``linear`` (d, d)."""
    d, r = cfg.d_model, cfg.adapter_rank
    return {"adapter_a": normal(gen, (1, d, r), d ** -0.5, dtype, device),
            "adapter_b": normal(gen, (1, r, 2 * cfg.d_ff), r ** -0.5, dtype, device),
            "linear": normal(gen, (1, d, d), d ** -0.5, dtype, device)}


def init_params(cfg: ArchConfig, seed: int = 0, dtype=torch.bfloat16, device=None) -> dict:
    """Random params from ``seed`` with the JAX package's shapes (not its
    values: torch cannot replay ``jax.random``; ``bridge`` copies those). On
    the meta device (which has no generator) the same tree, shapes only."""
    plan = layer_plan(cfg)
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    params: dict[str, Any] = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype, dev),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
        "blocks": [],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(gen, (cfg.d_model, cfg.vocab_size), cfg.d_model ** -0.5,
                                   dtype, dev)
    if cfg.frontend == "patch_embed":
        params["patch_proj"] = normal(gen, (cfg.d_model, cfg.d_model), cfg.d_model ** -0.5,
                                      dtype, dev)
    shared: dict[int, dict] = {}
    for blk in plan:
        if blk.kind == "shared_attn":
            if blk.shared_idx not in shared:
                shared[blk.shared_idx] = _init_stack(gen, cfg, blk.kind, (), dtype, dev)
            # params live in params["shared"]; a published call has its own too
            params["blocks"].append(_init_call(gen, cfg, dtype, dev) if cfg.hybrid_layer_ids
                                    else {})
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


def _unbind(stack: Any, n: int) -> list:
    """The ``n`` layers of a stacked param tree, each leaf unbound once
    (views): the backward then stacks each leaf's layer gradients once,
    where ``_layer`` a layer would make a zero stack for every layer."""
    if isinstance(stack, dict):
        parts = {k: _unbind(v, n) for k, v in stack.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(unbind_layers(stack))


def _map(fn, tree: Any) -> Any:
    return {k: _map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _block_layer(params: dict, blk: BlockSpec, bparams: dict, i: int) -> dict:
    """The params of layer ``i`` of a block: a shared_attn block's one layer
    is its shared param set."""
    if blk.kind == "shared_attn":
        return params["shared"][blk.shared_idx]
    return _layer(bparams, i)


# ---------------------------------------------------------------- forward --
def _ffn(cfg: ArchConfig, kind: str, p: dict, h: torch.Tensor):
    """The dense MLP or the MoE FFN of a layer: (y, aux, keep mask or None)."""
    if kind == "moe":
        return moe.moe_mlp(p["moe"], cfg, h)
    return mlp(p["mlp"], h, cfg.mlp, cfg.act), 0.0, None


def _layer_forward(cfg: ArchConfig, kind: str, local: bool, p: dict, x: torch.Tensor,
                   t: Optional[torch.Tensor] = None):
    """One full-sequence layer: (x, MoE aux loss, dropped (token, k) pairs),
    the new x under the ``residual`` constraint. ``t``, a published shared
    call's output, joins a mamba layer's input before its norm."""
    x, aux, dropped = _layer_body(cfg, kind, local, p, x, t)
    return constrain(x, "residual"), aux, dropped


def _mamba_input(x: torch.Tensor, t: Optional[torch.Tensor]) -> torch.Tensor:
    """What a mamba layer normalises: x, plus a preceding call's output."""
    return x if t is None else x + t


def _shared_call(cfg: ArchConfig, p: dict, call: dict, x: torch.Tensor, x0: torch.Tensor,
                 lc: Optional[dict] = None, pos: int = 0) -> torch.Tensor:
    """One call into shared block ``p`` in the published layout
    (``HybridConfig``), with the call's own ``call`` params: the output t
    that the next mamba layer adds to its input. Attention over the full
    sequence, or, given one call's KV cache ``lc``, a decode step at ``pos``.
    No residual inside: t is the projection of the MLP's output."""
    u = rmsnorm(torch.cat([x, x0], dim=-1), p["norm1"], cfg.norm_eps)
    scale = (cfg.resolved_head_dim / 2) ** -0.5  # q and k read twice d_model
    if lc is None:
        a = attn.full_attention(p["attn"], cfg, u, local=False, scale=scale)
    else:
        a = attn.decode_attention(p["attn"], cfg, u, lc, pos, local=False, scale=scale)
    g = rmsnorm(a, p["norm2"], cfg.norm_eps)
    gu = (product(g, p["mlp"]["w_gate_up"])
          + product(product(g, call["adapter_a"]), call["adapter_b"]))
    gate, up = gu.chunk(2, dim=-1)
    y = product(act_fn(cfg.act)(gate) * up, p["mlp"]["w_out"])
    return product(y, call["linear"])


def _layer_body(cfg: ArchConfig, kind: str, local: bool, p: dict, x: torch.Tensor,
                t: Optional[torch.Tensor] = None):
    if kind == "rwkv":  # zero shift and zero state; the new ones are dropped
        b, _, d = x.shape
        P = cfg.ssm_head_dim
        shift0 = torch.zeros((b, d), dtype=x.dtype, device=x.device)
        state0 = torch.zeros((b, d // P, P, P), dtype=torch.float32, device=x.device)
        h = rmsnorm(x, p["norm1"], cfg.norm_eps)
        x = x + rwkv.rwkv_time_mix(p["tm"], cfg, h, shift0, state0)[0]
        h = rmsnorm(x, p["norm2"], cfg.norm_eps)
        return x + rwkv.rwkv_channel_mix(p["tm"], cfg, h, shift0)[0], 0.0, 0
    if kind == "mamba":
        h = rmsnorm(_mamba_input(x, t), p["norm"], cfg.norm_eps)
        return x + ssm.mamba_forward(p["mamba"], cfg, h), 0.0, 0
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    x = x + attn.full_attention(p["attn"], cfg, h, local=local)
    y, aux, keep = _ffn(cfg, kind, p, rmsnorm(x, p["norm2"], cfg.norm_eps))
    return x + y, aux, 0 if keep is None else keep.numel() - keep.sum()


def forward_layers(cfg: ArchConfig, stack: dict, lo: int, hi: int,
                   x: torch.Tensor) -> torch.Tensor:
    """Layers ``lo`` to ``hi`` of a uniform dense stack (params with a leading
    layer axis) on ``x``: the body of a pipeline stage."""
    local = cfg.attn == "swa"
    for i in range(lo, hi):
        x = _layer_forward(cfg, "dense", local, _layer(stack, i), x)[0]
    return x


def final_logits(cfg: ArchConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """The final norm and the head: hidden states -> logits."""
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return unembed(head, x, tied=cfg.tie_embeddings)


def _embed_input(cfg: ArchConfig, params: dict, batch: dict) -> torch.Tensor:
    """The layers' input: frame embeddings as given; or token embeddings, with
    a patch prefix projected over the first P positions where the batch has
    one that fits (P <= s: at prefill, never at decode)."""
    if cfg.frontend == "frame_embed":
        return batch["frame_embeds"]
    x = embed(params["embed"], batch["tokens"])
    pe = batch.get("patch_embeds") if cfg.frontend == "patch_embed" else None
    if pe is not None and pe.shape[1] <= x.shape[1]:
        proj = (pe @ params["patch_proj"]).to(x.dtype)
        # out of place: a slice write into a sharded or pending-sum DTensor
        # could land in a copy
        x = torch.cat([proj, x[:, pe.shape[1]:]], dim=1)
    return constrain(x, "emb")


def forward(cfg: ArchConfig, params: dict, batch: dict, *, remat: bool = False):
    """Full-sequence forward (training teacher-forcing, prefill). batch:
    {"tokens": (b, s)}, plus {"patch_embeds": (b, P, d)} for ``patch_embed``;
    {"frame_embeds": (b, s, d)} for ``frame_embed``. With ``remat`` each
    layer keeps only its input for the backward and runs again there
    (``torch.utils.checkpoint``, as ``jax.checkpoint`` in JAX).

    Returns (logits, aux): ``aux["moe_aux"]`` is the sum of the layers'
    load-balancing losses (fp32, 0 without MoE layers), as in JAX;
    ``aux["moe_dropped"]`` counts the (token, k) pairs the layers dropped
    at capacity.

    Each mamba layer runs in the span ``hybrid.mamba`` and each shared call
    in ``hybrid.shared``. In the published layout the token embedding x0
    goes to every shared call, and a call's output to the next mamba layer."""
    x = _embed_input(cfg, params, batch)
    x0 = x if cfg.hybrid_layer_ids else None
    t = None  # the last published call's output, for the next mamba layer
    aux, dropped = 0.0, 0  # tensors from the first MoE layer on
    for blk, bparams in zip(layer_plan(cfg), params["blocks"]):
        if x0 is not None and blk.kind == "shared_attn":
            args = (cfg, _map(reduced_grad, params["shared"][blk.shared_idx]),
                    _map(reduced_grad, _layer(bparams, 0)), x, x0)
            with span("hybrid.shared"):
                t = (checkpoint(_shared_call, *args, use_reentrant=False) if remat
                     else _shared_call(*args))
            continue
        layers = (_unbind(bparams, blk.n) if blk.kind != "shared_attn"
                  else [params["shared"][blk.shared_idx]])
        for p in layers:
            args = (cfg, blk.kind, blk.local, _map(reduced_grad, p), x, t)
            with _kind_span(blk.kind):
                if remat:
                    x, a, n = checkpoint(_layer_forward, *args, use_reentrant=False)
                else:
                    x, a, n = _layer_forward(*args)
            aux, dropped, t = aux + a, dropped + n, None
    return final_logits(cfg, params, x), {
        "moe_aux": torch.as_tensor(aux, dtype=torch.float32, device=x.device),
        "moe_dropped": torch.as_tensor(dropped, dtype=torch.int64, device=x.device)}


_SPANS = {"mamba": "hybrid.mamba", "shared_attn": "hybrid.shared"}


def _kind_span(kind: str):
    """The span of one layer of ``kind`` in ``forward``: a hybrid's mamba
    layers and shared calls have theirs, the other kinds none."""
    return span(_SPANS[kind]) if kind in _SPANS else contextlib.nullcontext()


# ------------------------------------------------------------------ cache --
def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> list:
    """Per-block decode caches. Windowed attention blocks get ring buffers
    of ``window`` slots; full attention gets ``max_len``; rwkv and mamba
    O(1). Each ``shared_attn`` occurrence has its own cache (leading axis 1)."""
    dev = resolve_device(device)
    caches = []
    for blk in layer_plan(cfg):
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
    """One-token decode. batch: {"tokens": (b, 1)}, or {"frame_embeds":
    (b, 1, d)} for ``frame_embed``; ``pos`` is the current sequence
    position. ``caches`` is updated in place and the same list is
    returned: attention blocks write this token's k/v (every lane of the
    batch at one slot); rwkv blocks overwrite ``shift_tm``, ``shift_cm`` and
    ``wkv`` with their new values (the wkv kernel writes the new state over
    the old one); mamba blocks overwrite ``conv`` and ``ssm``. In the
    published hybrid layout x0 is the step token's embedding, and each
    shared call writes its own cache."""
    pos = int(pos)
    x = _embed_input(cfg, params, batch)
    x0 = x if cfg.hybrid_layer_ids else None
    t = None
    for blk, bparams, cache in zip(layer_plan(cfg), params["blocks"], caches):
        if x0 is not None and blk.kind == "shared_attn":
            with span("hybrid.shared"):
                t = _shared_call(cfg, params["shared"][blk.shared_idx], _layer(bparams, 0), x,
                                 x0, _layer(cache, 0), pos)
            continue
        for i in range(blk.n):
            x = _layer_decode(cfg, blk.kind, blk.local, _block_layer(params, blk, bparams, i),
                              x, _layer(cache, i), pos, t)
            t = None
    return final_logits(cfg, params, x), caches


def _layer_decode(cfg: ArchConfig, kind: str, local: bool, p: dict, x: torch.Tensor,
                  lc: dict, pos: int, t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One layer of a decode step, its halves in the spans ``decode.attention``
    (the token mixer: attention, rwkv's time mix, or a mamba layer whole) and
    ``decode.ffn``; a shared layer whole also in ``hybrid.shared``. ``t``, a
    published call's output, joins a mamba layer's input before its norm."""
    if kind == "shared_attn":
        with span("hybrid.shared"):
            return _layer_decode(cfg, "dense", local, p, x, lc, pos)
    with span("decode.attention"):
        if kind == "mamba":
            h = rmsnorm(_mamba_input(x, t), p["norm"], cfg.norm_eps)
            return x + ssm.mamba_decode_step(p["mamba"], cfg, h, lc)
        h = rmsnorm(x, p["norm1"], cfg.norm_eps)
        if kind == "rwkv":
            y, new_tm, _ = rwkv.rwkv_time_mix(p["tm"], cfg, h, lc["shift_tm"], lc["wkv"],
                                              state_out=lc["wkv"])
            lc["shift_tm"].copy_(new_tm)
            x = x + y
        else:
            x = x + attn.decode_attention(p["attn"], cfg, h, lc, pos, local=local)
    with span("decode.ffn"):
        h = rmsnorm(x, p["norm2"], cfg.norm_eps)
        if kind == "rwkv":
            y, new_cm = rwkv.rwkv_channel_mix(p["tm"], cfg, h, lc["shift_cm"])
            lc["shift_cm"].copy_(new_cm)
            return x + y
        return x + _ffn(cfg, kind, p, h)[0]
