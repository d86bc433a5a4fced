"""Deterministic synthetic token stream with checkpointable state, the twin of
``repro.runtime.data`` (numpy only, so its batches are bit-equal to JAX's).

Next-token-prediction batches come from a seeded PRNG "document stream"
(zipfian token distribution with structured repetition so models can reduce
loss). State = (seed, step); capturing it in checkpoints makes restarts
bit-exact. ``shard_for_host`` (placement on a device mesh) is not ported
yet: it waits for the port's sharding.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    structure: int = 8  # repetition period that makes the stream learnable


@dataclass
class DataState:
    step: int = 0

    def as_dict(self) -> dict:
        return {"step": self.step}

    @classmethod
    def from_dict(cls, d: dict) -> "DataState":
        return cls(step=int(d["step"]))


class TokenStream:
    """Stateless-per-step generator: batch(step) is a pure function of
    (config, step) — restart-safe and elastic (host count can change)."""

    def __init__(self, cfg: DataConfig, state: Optional[DataState] = None):
        self.cfg = cfg
        self.state = state or DataState()
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must divide across hosts")

    @property
    def host_batch(self) -> int:
        return self.cfg.global_batch // self.cfg.n_hosts

    def _batch_at(self, step: int) -> dict:
        c = self.cfg
        rng = np.random.default_rng(np.uint64(c.seed * 1_000_003 + step))
        # zipfian-ish marginals + periodic structure
        base = rng.zipf(1.3, size=(c.global_batch, c.seq_len + 1)).astype(np.int64)
        base = base % (c.vocab_size - 2) + 1
        pos = np.arange(c.seq_len + 1)
        mask = (pos % c.structure) < (c.structure // 2)
        base[:, mask[: c.seq_len + 1]] = (
            np.arange(c.global_batch)[:, None] % 97 + 2
        )
        lo = self.cfg.host_id * self.host_batch
        hi = lo + self.host_batch
        toks = base[lo:hi]
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def next(self) -> dict:
        batch = self._batch_at(self.state.step)
        self.state.step += 1
        return batch

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next()

