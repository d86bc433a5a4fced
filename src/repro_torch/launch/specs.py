"""Meta-device stand-ins for every model input and state, the twin of
``repro.launch.specs``: the JAX shapes and dtypes, nothing allocated.

``device`` may name another device for a caller that builds the same
stand-ins under a ``FakeTensorMode`` (the dry run), where nothing is
allocated either.
"""
from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ArchConfig, ShapeCfg
from ..models import transformer as tf


def _empty(shape, dtype, device):
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype, device=device)


def input_specs(cfg: ArchConfig, shape: ShapeCfg, *, act_dtype=torch.bfloat16,
                device="meta") -> dict:
    """Inputs for train_step (train_*) or prefill (prefill_*)."""
    B, S = shape.global_batch, shape.seq_len
    batch: dict[str, Any] = {}
    if cfg.frontend == "frame_embed":
        batch["frame_embeds"] = _empty((B, S, cfg.d_model), act_dtype, device)
    else:
        batch["tokens"] = _empty((B, S), torch.int32, device)
        if cfg.frontend == "patch_embed":
            batch["patch_embeds"] = _empty((B, cfg.n_prefix_embeds, cfg.d_model), act_dtype,
                                           device)
    if shape.kind == "train":
        batch["labels"] = _empty((B, S), torch.int32, device)
    return batch


def decode_input_specs(cfg: ArchConfig, shape: ShapeCfg, *, act_dtype=torch.bfloat16,
                       device="meta") -> dict:
    """One-new-token inputs for serve_step at a KV/state cache of seq_len."""
    B = shape.global_batch
    if cfg.frontend == "frame_embed":
        return {"frame_embeds": _empty((B, 1, cfg.d_model), act_dtype, device)}
    return {"tokens": _empty((B, 1), torch.int32, device)}


def params_specs(cfg: ArchConfig, *, dtype=torch.bfloat16, device="meta") -> Any:
    """The parameter tree of ``init_params`` (its shape-only init on meta)."""
    return tf.init_params(cfg, 0, dtype, device=device)


def cache_specs(cfg: ArchConfig, batch: int, max_len: int, *, dtype=torch.bfloat16,
                device="meta") -> Any:
    return tf.init_cache(cfg, batch, max_len, dtype, device=device)


def opt_state_specs(cfg: ArchConfig, opt_cfg, *, dtype=torch.bfloat16, device="meta") -> Any:
    from ..runtime.optimizer import adamw_init

    return adamw_init(opt_cfg, params_specs(cfg, dtype=dtype, device=device))
