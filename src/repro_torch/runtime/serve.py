"""Serving runtime: prefill and decode-step factories and a
continuous-batching engine, as in ``repro.runtime.serve``.

``make_prefill`` runs the full-sequence forward (through the flash-attention,
wkv6 and SSD-scan kernels on the card); ``make_serve_step`` builds the one-new-token
step (params, caches, batch, pos) -> (next_token_logits, caches), which
updates ``caches`` in place.

Given a ``ShardingPolicy`` (``runtime/sharding.py``), both run under its
activation specs, as JAX's do: params and caches are then DTensors on the
policy's mesh (``shard_params``, ``shard_cache``), a host batch is placed
under ``inputs_sharding`` (``data.shard_for_host``), and the device is the
mesh's. ``ServingEngine`` takes no policy, as in JAX.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from .._device import batch_on_device, resolve_device
from ..configs.base import ArchConfig
from ..models import attention as attn
from ..models import transformer as tf
from .data import shard_for_host
from .pspec import activation_policy, is_sharded
from .sharding import ShardingPolicy, mesh_device
from .spans import span


def policy_context(policy: Optional[ShardingPolicy]):
    """The policy's activation specs installed (JAX's ``_ctx``), or nothing."""
    if policy is None:
        return contextlib.nullcontext()
    return activation_policy(policy.mesh, policy.activation_specs())


def policy_device(policy: Optional[ShardingPolicy], device) -> torch.device:
    """The device an entry point runs on: ``device`` without a policy, the
    mesh's under one (a ``device`` that names another kind raises)."""
    if policy is None:
        return resolve_device(device)
    dev = mesh_device(policy.mesh)
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"device {device} disagrees with the policy's mesh on {dev.type}")
    return dev


def place_batch(batch: dict, dev: torch.device, policy: Optional[ShardingPolicy]) -> dict:
    """A batch on ``dev``, or, under a policy, under its input placements
    (DTensors already placed stay as they are)."""
    if policy is None:
        return batch_on_device(batch, dev)
    if all(is_sharded(v) for v in batch.values()):
        return batch
    return shard_for_host(batch, policy.mesh, policy)


def grad_off(policy: Optional[ShardingPolicy]):
    """``inference_mode`` for plain tensors; ``no_grad`` under a policy, since
    a DTensor view (a layer of a stacked param) cannot be made in inference
    mode from a tensor made outside it."""
    return torch.inference_mode() if policy is None else torch.no_grad()


def make_prefill(cfg: ArchConfig, device=None, *, policy: Optional[ShardingPolicy] = None):
    dev = policy_device(policy, device)

    def prefill(params, batch):
        with grad_off(policy), policy_context(policy):
            logits, _ = tf.forward(cfg, params, place_batch(batch, dev, policy))
        return logits

    return prefill


def make_serve_step(cfg: ArchConfig, device=None, *,
                    policy: Optional[ShardingPolicy] = None):
    dev = policy_device(policy, device)

    def serve_step(params, caches, batch, pos):
        with span("serve.step"), grad_off(policy), policy_context(policy):
            return tf.decode_step(cfg, params, caches, place_batch(batch, dev, policy), pos)

    return serve_step


# ---------------------------------------------------------- batching engine --
@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int
    generated: list[int] = field(default_factory=list)
    done: bool = False
    submitted_at: float = 0.0
    finished_at: float = 0.0


class ServingEngine:
    """Slot-based continuous batching over a fixed decode batch.

    Requests are queued, assigned to free slots, prefilled one token at a
    time into the shared KV cache at their slot index, and decoded greedily
    (argmax); slots recycle as requests finish. The slot semantics are those
    of the JAX engine, including its feeding the last prompt token twice
    (once while admitting, once as the first decode input).

    Cache lanes: the JAX engine decodes all lanes (each fed the stepped
    lane's token at its position) and copies lane ``i`` back. Here decode
    writes the cache in place, so ``_step_slot`` decodes on a view of lane
    ``i`` alone (batch 1): it writes lane ``i`` and no other, and computes
    the same values for it where lanes are independent. At an MoE layer they
    are not: the lanes' tokens share one dispatch group and compete for its
    capacity, so an MoE model decodes every lane, as JAX does, and puts the
    other lanes' k/v at the written slot back. As in the JAX engine,
    admitting a request resets its slot's position but not its cache lane:
    attention masks stale k/v by position, while the rwkv state
    (token shifts and wkv) and the mamba state (``conv`` history and
    ``ssm``), which have no position, carry over from the slot's previous
    request.
    """

    def __init__(self, cfg: ArchConfig, params, *, batch_slots: int = 4,
                 max_len: int = 512, eos_token: Optional[int] = None,
                 dtype=torch.float32, device=None):
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.slots: list[Optional[Request]] = [None] * batch_slots
        self.max_len = max_len
        self.eos = eos_token
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self.caches = tf.init_cache(cfg, batch_slots, max_len, dtype, self.device)
        self.pos = [0] * batch_slots
        self._next_rid = 0
        self._decode = make_serve_step(cfg, self.device)
        self._plan = tf.layer_plan(cfg)
        self._lanes_share_routing = any(blk.kind == "moe" for blk in self._plan)

    def submit(self, prompt: list[int], max_new_tokens: int = 32) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, list(prompt), max_new_tokens,
                                  submitted_at=time.time()))
        return rid

    # -- internals ------------------------------------------------------------
    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot is None and self.queue:
                req = self.queue.pop(0)
                self.slots[i] = req
                self.pos[i] = 0
                for t in req.prompt:
                    self._step_slot(i, t)

    def _step_slot(self, i: int, token: int) -> int:
        if self._lanes_share_routing:
            logits = self._step_all_lanes(i, token)
        else:
            lane = [{name: c[:, i:i + 1] for name, c in cache.items()} for cache in self.caches]
            logits = self._decode(self.params, lane, {"tokens": [[token]]}, self.pos[i])[0][0]
        self.pos[i] += 1
        return int(torch.argmax(logits[-1]))

    def _step_all_lanes(self, i: int, token: int) -> torch.Tensor:
        """Lane ``i``'s logits from a decode of every lane, each fed ``token``
        at ``pos[i]``, as the JAX engine runs it; only lane ``i`` keeps what
        the step wrote into the (attention-only) caches."""
        pos = self.pos[i]
        slots = [attn.cache_slot(pos, cache["k"].shape[2], blk.local)
                 for blk, cache in zip(self._plan, self.caches)]
        saved = [{name: c[:, :, slot].clone() for name, c in cache.items()}
                 for slot, cache in zip(slots, self.caches)]
        tokens = [[token]] * len(self.slots)
        logits, _ = self._decode(self.params, self.caches, {"tokens": tokens}, pos)
        for slot, cache, old in zip(slots, self.caches, saved):
            for name, c in cache.items():
                old[name][:, i] = c[:, i, slot]
                c[:, :, slot] = old[name]
        return logits[i]

    def step(self) -> None:
        """One engine tick: admit + one decode step for every active slot."""
        self._admit()
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            last = req.generated[-1] if req.generated else req.prompt[-1]
            nxt = self._step_slot(i, last)
            req.generated.append(nxt)
            if len(req.generated) >= req.max_new_tokens or (
                self.eos is not None and nxt == self.eos
            ):
                req.done = True
                req.finished_at = time.time()
                self.finished.append(req)
                self.slots[i] = None

    def run_until_drained(self, max_ticks: int = 10_000) -> list[Request]:
        ticks = 0
        while (self.queue or any(self.slots)) and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.finished
