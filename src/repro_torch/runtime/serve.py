"""Serving runtime: prefill and decode-step factories and a
continuous-batching engine, as in ``repro.runtime.serve``.

``make_prefill`` runs the full-sequence forward (through the flash-attention,
wkv6 and SSD-scan kernels on the card); ``make_serve_step`` builds the one-new-token
step (params, caches, batch, pos) -> (next_token_logits, caches), which
updates ``caches`` in place.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from .._device import resolve_device
from ..configs.base import ArchConfig
from ..models import transformer as tf


def _tokens(tokens, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(tokens, device=device).long()


def make_prefill(cfg: ArchConfig, device=None):
    dev = resolve_device(device)

    @torch.inference_mode()
    def prefill(params, batch):
        logits, _ = tf.forward(cfg, params, {"tokens": _tokens(batch["tokens"], dev)})
        return logits

    return prefill


def make_serve_step(cfg: ArchConfig, device=None):
    dev = resolve_device(device)

    @torch.inference_mode()
    def serve_step(params, caches, batch, pos):
        return tf.decode_step(cfg, params, caches,
                              {"tokens": _tokens(batch["tokens"], dev)}, pos)

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

    Cache lanes: the JAX engine decodes all lanes and copies lane ``i`` back.
    Here decode writes the cache in place, so ``_step_slot`` decodes on a
    view of lane ``i`` alone (batch 1): it writes lane ``i`` and no other,
    and computes the same values for it, lanes being independent. As in the
    JAX engine, admitting a request resets its slot's position but not its
    cache lane: attention masks stale k/v by position, while the rwkv state
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
        lane = [{name: c[:, i:i + 1] for name, c in cache.items()} for cache in self.caches]
        logits, _ = self._decode(self.params, lane, {"tokens": [[token]]}, self.pos[i])
        self.pos[i] += 1
        return int(torch.argmax(logits[0, -1]))

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
