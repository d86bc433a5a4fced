"""Training step factory, the twin of ``repro.runtime.train``: loss, grads,
optimizer update; optional remat (``torch.utils.checkpoint`` per layer) and
microbatch gradient accumulation. Given a ``ShardingPolicy``, the step runs
under its activation specs, as JAX's does: params and optimizer state are
then DTensors on the policy's mesh and a host batch is placed under
``inputs_sharding``.

On the card each recurrence and attention layer runs its kernel forward and
differentiates a plain version backward: attention through
``kernels.flash_attention.ops.FlashAttention``, the rwkv wkv6 recurrence
through ``kernels.rwkv6.ops.WKV6`` (the sequential ``wkv6_reference``) and
the mamba SSD scan through ``kernels.ssd_scan.ops.SSDScan`` (``ssd_chunked``,
the CPU path). So every block kind trains on the card as on the CPU.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from ..configs.base import ArchConfig
from ..kernels._sharded import is_dtensor as is_sharded, local_call
from ..models import transformer as tf
from ..tree import tree_leaves, tree_map
from .optimizer import AdamWConfig, adamw_init, adamw_update
from .pspec import settled
from .serve import place_batch, policy_context, policy_device
from .sharding import ShardingPolicy

Z_LOSS = 1e-4
MOE_AUX_WEIGHT = 1e-2


def loss_fn(cfg: ArchConfig, params: Any, batch: dict, *, remat: bool = True):
    """NLL over the labels (masked by ``loss_mask`` where the batch has one)
    + ``Z_LOSS`` x mean(logsumexp^2) + ``MOE_AUX_WEIGHT`` x the MoE aux
    loss. Returns (total, {"nll", "z_loss", "moe_aux"})."""
    logits, aux = tf.forward(cfg, params, batch, remat=remat)
    logits = logits.float()
    # -log_softmax at the label as lse - logit: no second (b, s, vocab) tensor
    lse, picked = lse_and_label_logits(logits, batch["labels"])
    nll = lse - picked
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = mask.to(nll.dtype)
        nll = nll * mask
        denom = torch.clamp(mask.sum(), min=1.0)
    else:
        denom = nll.numel()
    loss = settled(nll.sum() / denom)
    # z-loss stabilizes the softmax normalizer at scale
    zl = settled(Z_LOSS * lse.square().mean())
    total = loss + zl + MOE_AUX_WEIGHT * settled(aux["moe_aux"])
    return total, {"nll": loss, "z_loss": zl, "moe_aux": aux["moe_aux"]}


def lse_and_label_logits(logits: torch.Tensor, labels: torch.Tensor):
    """(logsumexp of ``logits`` over the vocab, ``logits[..., labels]``):
    (b, s, V), (b, s) -> (b, s), (b, s). A plain tensor takes
    ``torch.logsumexp`` and ``gather``. A DTensor whose vocab is split works
    on each rank's own shard (``local_map``), as Megatron's vocab-parallel
    cross-entropy does: the max over the vocab (a pending max, reduced), the
    sum of exp(logit - max) (a pending sum, reduced), and the label's logit
    picked where the label less the shard's vocab offset falls in the shard,
    0 elsewhere (a pending sum with one non-zero term a row: the gather's
    value exactly). No rank then holds more of the logits than its shard,
    and the backward writes that shard only, where DTensor's ``logsumexp``
    would gather the vocab and its ``gather``'s backward would make zeros of
    the global logits on every rank."""
    if not is_sharded(logits):
        return (torch.logsumexp(logits, dim=-1),
                logits.gather(-1, labels[..., None])[..., 0])
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, last = logits.device_mesh, logits.dim() - 1
    V = logits.shape[last]
    lg_pl, row_pl, vocab_on, off = [], [], None, 0
    for i, p in enumerate(logits.placements):
        if isinstance(p, Shard) and p.dim == last and vocab_on is None:
            vocab_on = i
            n = mesh.size(i)
            off = min(mesh.get_local_rank(i) * -(-V // n), V)  # DTensor's shards: torch.chunk's
            lg_pl.append(p)
            row_pl.append(Replicate())
        elif isinstance(p, Shard) and p.dim < last:
            lg_pl.append(p)
            row_pl.append(p)
        else:  # a pending sum, or a second split of the vocab: whole
            lg_pl.append(Replicate())
            row_pl.append(Replicate())
    lg_pl, row_pl = tuple(lg_pl), tuple(row_pl)

    def pending(op):
        return tuple(Partial(op) if i == vocab_on else p for i, p in enumerate(row_pl))

    def pick(lg, lab):
        idx = lab.long() - off
        inside = (idx >= 0) & (idx < lg.shape[-1])
        got = lg.gather(-1, idx.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0]
        return torch.where(inside, got, torch.zeros((), dtype=got.dtype, device=got.device))

    m = settled(local_call(lambda lg: lg.amax(-1), [logits.detach()], [lg_pl], pending("max"),
                           mesh))
    sum_exp = local_call(lambda lg, mx: torch.exp(lg - mx[..., None]).sum(-1), [logits, m],
                         [lg_pl, row_pl], pending("sum"), mesh)
    picked = local_call(pick, [logits, labels], [lg_pl, row_pl], pending("sum"), mesh)
    return settled(sum_exp).log() + m, settled(picked)


def _rebuild(tree: Any, leaves) -> Any:
    """``tree``'s structure with the next of ``leaves`` at each leaf."""
    return tree_map(lambda _: next(leaves), tree)


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, *, remat: bool = True,
                    microbatch: int = 1, device=None,
                    policy: Optional[ShardingPolicy] = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), metrics ``nll``, ``z_loss``, ``moe_aux``, ``lr`` and
    ``grad_norm``. ``microbatch > 1`` splits the batch into that many
    chunks along its first axis, sums their gradients in fp32 and divides
    by the count (the metrics are the last chunk's), as JAX's scan does. A
    batch whose first axis does not divide by ``microbatch`` raises
    ``ValueError`` before any work (JAX's reshape raises there too)."""
    dev = policy_device(policy, device)

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
        gsum = [torch.zeros_like(p, dtype=torch.float32, memory_format=torch.contiguous_format)
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
        with policy_context(policy):
            grads, met = compute_grads(params, place_batch(batch, dev, policy))
            params_new, opt_new, stats = adamw_update(opt_cfg, grads, opt_state, params)
        return params_new, opt_new, {**met, **stats}

    return train_step


def init_train_state(cfg: ArchConfig, opt_cfg: AdamWConfig, seed: int = 0,
                     dtype=torch.bfloat16, device=None):
    params = tf.init_params(cfg, seed, dtype, device)
    return params, adamw_init(opt_cfg, params)
