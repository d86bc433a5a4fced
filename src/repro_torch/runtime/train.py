"""Training step factory, the twin of ``repro.runtime.train``: loss, grads,
optimizer update; optional remat (``torch.utils.checkpoint`` per layer) and
microbatch gradient accumulation. Sharding (JAX's ``policy``) is not ported
yet.

On the card each recurrence and attention layer runs its kernel forward and
differentiates a plain version backward: attention through
``kernels.flash_attention.ops.FlashAttention``, the rwkv wkv6 recurrence
through ``kernels.rwkv6.ops.WKV6`` (the sequential ``wkv6_reference``) and
the mamba SSD scan through ``kernels.ssd_scan.ops.SSDScan`` (``ssd_chunked``,
the CPU path). So every block kind trains on the card as on the CPU.
"""
from __future__ import annotations

from typing import Any

import torch

from .._device import batch_on_device, resolve_device
from ..configs.base import ArchConfig
from ..models import transformer as tf
from ..tree import tree_leaves, tree_map
from .optimizer import AdamWConfig, adamw_init, adamw_update

Z_LOSS = 1e-4
MOE_AUX_WEIGHT = 1e-2


def loss_fn(cfg: ArchConfig, params: Any, batch: dict, *, remat: bool = True):
    """NLL over the labels (masked by ``loss_mask`` where the batch has one)
    + ``Z_LOSS`` x mean(logsumexp^2) + ``MOE_AUX_WEIGHT`` x the MoE aux
    loss. Returns (total, {"nll", "z_loss", "moe_aux"})."""
    logits, aux = tf.forward(cfg, params, batch, remat=remat)
    logits = logits.float()
    # -log_softmax at the label as lse - logit: no second (b, s, vocab) tensor
    lse = torch.logsumexp(logits, dim=-1)
    nll = lse - logits.gather(-1, batch["labels"][..., None])[..., 0]
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = mask.to(nll.dtype)
        nll = nll * mask
        denom = torch.clamp(mask.sum(), min=1.0)
    else:
        denom = nll.numel()
    loss = nll.sum() / denom
    # z-loss stabilizes the softmax normalizer at scale
    zl = Z_LOSS * lse.square().mean()
    total = loss + zl + MOE_AUX_WEIGHT * aux["moe_aux"]
    return total, {"nll": loss, "z_loss": zl, "moe_aux": aux["moe_aux"]}


def _rebuild(tree: Any, leaves) -> Any:
    """``tree``'s structure with the next of ``leaves`` at each leaf."""
    return tree_map(lambda _: next(leaves), tree)


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, *, remat: bool = True,
                    microbatch: int = 1, device=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), metrics ``nll``, ``z_loss``, ``moe_aux``, ``lr`` and
    ``grad_norm``. ``microbatch > 1`` splits the batch into that many
    chunks along its first axis, sums their gradients in fp32 and divides
    by the count (the metrics are the last chunk's), as JAX's scan does. A
    batch whose first axis does not divide by ``microbatch`` raises
    ``ValueError`` before any work (JAX's reshape raises there too)."""
    dev = resolve_device(device)

    def grads_of(params: Any, batch: dict):
        live = [p.detach().requires_grad_() for p in tree_leaves(params)]
        total, met = loss_fn(cfg, _rebuild(params, iter(live)), batch, remat=remat)
        grads = torch.autograd.grad(total, live, allow_unused=True)
        # a leaf the loss does not reach (a patch projection without patches)
        # gets zeros, as jax.grad gives
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, live)]
        return grads, {k: v.detach() for k, v in met.items()}

    def compute_grads(params: Any, batch: dict):
        if microbatch <= 1:
            grads, met = grads_of(params, batch)
            return _rebuild(params, iter(grads)), met
        n = next(iter(batch.values())).shape[0] // microbatch
        gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in tree_leaves(params)]
        for i in range(microbatch):
            chunk = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            grads, met = grads_of(params, chunk)
            for acc, g in zip(gsum, grads):
                acc.add_(g)
        return _rebuild(params, (g / microbatch for g in gsum)), met

    def train_step(params: Any, opt_state: dict, batch: dict):
        rows = {k: len(v) for k, v in batch.items()}
        if microbatch > 1 and any(n % microbatch for n in rows.values()):
            raise ValueError(f"microbatch={microbatch} does not divide the batch's first axis "
                             f"{rows}: every row must fall in one chunk")
        grads, met = compute_grads(params, batch_on_device(batch, dev))
        params_new, opt_new, stats = adamw_update(opt_cfg, grads, opt_state, params)
        return params_new, opt_new, {**met, **stats}

    return train_step


def init_train_state(cfg: ArchConfig, opt_cfg: AdamWConfig, seed: int = 0,
                     dtype=torch.bfloat16, device=None):
    params = tf.init_params(cfg, seed, dtype, device)
    return params, adamw_init(opt_cfg, params)
