"""The paper's DSE methodology over a pool of H100s: enumerate deployments of
an architecture over a fixed card pool (pipeline stages x data replicas x
tensor shards), cost each from the analytic roofline, Pareto-filter — the
Fig. 5 three-step recipe with cards standing in for PUs. The twin of the JAX
package's TPU deployment DSE (``repro/dse/tpu_deploy.py``): the same formula,
term for term, with NVLink in place of the ICI link and the H100's rates
and budget in place of the v5e's.

A deployment = (S stages, R replicas, T tensor shards), S*R*T = cards.
Each replica pipelines microbatches through S stages of L/S layers computed
on T cards; batch-level parallelism across the R replicas = the paper's
hybrid parallelism.

The default pool is 8 cards: one HGX board, whose NVSwitches give every
pair of cards the same NVLink rate, so the one ``link_bw`` of the formula
holds. Like the TPU recipe, it counts 2 bytes a weight and an activation
value (bf16), and so it defaults to the bf16 tensor-core rate. The rates
and the budget are keyword arguments: the tests pass the JAX package's v5e
values and get its deployments back, field for field.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from .. import hw
from ..configs.base import ArchConfig
from ..runtime.pipeline import layer_cost_seconds
from .pareto import pareto_front


@dataclass(frozen=True)
class Deployment:
    stages: int
    replicas: int
    tensor: int
    throughput: float  # sequences/s aggregate
    latency: float  # end-to-end per batch
    batch: int  # concurrent sequences in flight

    @property
    def label(self) -> str:
        return f"S{self.stages}xR{self.replicas}xT{self.tensor}"


def _divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def enumerate_deployments(
    cfg: ArchConfig,
    *,
    cards: int = 8,
    seq_len: int = 4096,
    microbatch: int = 4,
    microbatches: int = 8,
    link_bw: float = hw.NVLINK_BYTES_PER_S,
    budget: float = hw.DEPLOY_BUDGET_BYTES,
    peak_flops: float = hw.BF16_TENSOR_FLOPS,
    hbm_bw: float = hw.HBM_BYTES_PER_S,
) -> list[Deployment]:
    """Every (S, R, T) factorization of ``cards`` whose weights and
    in-flight activations fit ``budget`` bytes a card, costed in seconds:
    ``link_bw`` is bytes/s a card and direction, ``peak_flops`` and
    ``hbm_bw`` are the rates of ``layer_cost_seconds``."""
    out = []
    L = cfg.num_layers
    for S in _divisors(cards):
        if S > L:
            continue
        for T in _divisors(cards // S):
            R = cards // (S * T)
            # weights replicate across replicas: must fit S x T cards
            w_per_card = 2.0 * cfg.param_count() / (S * T)
            kv_per_card = (  # in-flight microbatch activations (rough)
                2.0 * microbatch * microbatches * seq_len * cfg.d_model / T
            )
            if w_per_card + kv_per_card > budget:
                continue
            per_layer = layer_cost_seconds(cfg, seq_len, microbatch, T,
                                           peak_flops=peak_flops, hbm_bw=hbm_bw)
            # TP collectives: ~2 all-reduces of the (mb, s, d) activation per
            # layer, ring cost 2(T-1)/T on the link
            if T > 1:
                ar = 2 * (2 * (T - 1) / T) * microbatch * seq_len * cfg.d_model * 2 / link_bw
                per_layer += ar
            lps = math.ceil(L / S)
            stage_t = lps * per_layer
            # boundary transfer per microbatch between stages
            boundary = 2 * microbatch * seq_len * cfg.d_model / T / link_bw
            stage_t = max(stage_t, boundary)
            thr = R * microbatch / stage_t
            lat = (S + microbatches - 1) * stage_t
            out.append(
                Deployment(
                    stages=S,
                    replicas=R,
                    tensor=T,
                    throughput=thr,
                    latency=lat,
                    batch=R * microbatches * microbatch,
                )
            )
    return out


def explore_gpu(cfg: ArchConfig, **kw):
    """All deployments of ``enumerate_deployments(cfg, **kw)`` and their
    (throughput, latency) Pareto frontier."""
    points = enumerate_deployments(cfg, **kw)
    frontier = pareto_front(
        points, [lambda p: p.throughput, lambda p: -p.latency]
    )
    return points, frontier
