"""Multi-pod dry run of the port: run every (architecture x input shape) step
on the production mesh (16x16 single-pod / 2x16x16 multi-pod) with no card
and no allocation, and derive its per-device roofline terms. The twin of
``repro.launch.dryrun``.

JAX lowers and compiles each cell for 512 forced host devices and reads the
optimized HLO. Here a fake process group of 256 (512) ranks stands in for
the cards in one process (``mesh.fake_world``), the parameters, optimizer
state, cache and batch are DTensors of ``FakeTensor`` shards under the
cell's ``ShardingPolicy``, and the step runs as a user runs it
(``make_train_step`` / ``make_prefill`` / ``make_serve_step`` with
``policy=``), counted by ``flop_analysis``: rank 0's shard of every op, the
kernels' shape-only work, and every collective DTensor issues.

The roofline denominators are the H100's (``repro_torch/hw.py``): bf16
tensor cores 989 TFLOP/s, HBM3 3.35 TB/s, NVLink 450 GB/s a direction
within an 8-card board and the network's 50 GB/s a direction off it. The
memory term reads the step's arguments once plus every op's output
(``flop_analysis``); the collective term times each collective at its
group's tier (``LINK_NOTE``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --both-meshes --out results.json
"""
from __future__ import annotations

import argparse
import json
import logging
import time
import traceback
from dataclasses import asdict, dataclass, field

import torch

from .. import hw
from ..configs import LM_SHAPES, all_configs, get_config
from ..configs.base import ArchConfig, ShapeCfg
from ..runtime.data import shard_for_host
from ..runtime.optimizer import AdamWConfig, adamw_init
from ..runtime.serve import make_prefill, make_serve_step
from ..runtime.sharding import make_policy, shard_cache, shard_params
from ..runtime.train import make_train_step
from . import flop_analysis, specs
from .mesh import fake_world, make_production_mesh, production_shape

PEAK_FLOPS = hw.BF16_TENSOR_FLOPS  # bf16 a card
HBM_BW = hw.HBM_BYTES_PER_S  # bytes/s a card
LINK_BW = hw.NVLINK_BYTES_PER_S  # bytes/s a card, one direction, within a board
NET_BW = hw.NETWORK_BYTES_PER_S  # bytes/s a card, one direction, off the board
LINK_NOTE = ("collective term: each collective as a flat ring paced by its slowest hop, at "
             "NVLink 450 GB/s where its group lies on one 8-card board and at the network's "
             "50 GB/s where it spans boards; no credit for NCCL's hierarchical or NVLS "
             "algorithms, so an estimate, not a bound")

SHAPES = {s.name: s for s in LM_SHAPES}


@dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    status: str  # ok | skipped | error
    reason: str = ""
    compile_s: float = 0.0  # host seconds to trace the step (JAX: to compile it)
    # per device, bytes: the step's arguments (local shards) and what it
    # writes into its outputs (an argument written in place: the bytes written)
    arg_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0  # peak live bytes of the storages the step made
    op_output_bytes: float = 0.0  # every op's output once (hbm_bytes less arg_bytes)
    # JAX's cost_analysis numbers: no counterpart, left 0
    xla_flops: float = 0.0
    xla_bytes: float = 0.0
    # flop_analysis (per device)
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_wire_bytes: float = 0.0
    collective_wire_bytes_nvlink: float = 0.0
    collective_wire_bytes_network: float = 0.0
    collective_by_type: dict = field(default_factory=dict)
    n_collectives: int = 0
    n_collectives_comm_debug: int = 0  # CommDebugMode's count of the same run
    unknown_trip_loops: int = 0  # no loops to trip: every op is counted as it runs
    # roofline terms (seconds, per device)
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    bottleneck: str = ""
    model_flops_per_chip: float = 0.0
    useful_ratio: float = 0.0
    kernels: dict = field(default_factory=dict)
    flops_by_op: dict = field(default_factory=dict)
    flops_by_phase: dict = field(default_factory=dict)  # forward | backward | recompute
    top_hbm_ops: list = field(default_factory=list)
    top_live_ops: list = field(default_factory=list)  # what is live at the temp_bytes peak
    top_flop_ops: list = field(default_factory=list)
    top_collectives: list = field(default_factory=list)
    link: str = LINK_NOTE


def model_flops_per_chip(cfg: ArchConfig, shape: ShapeCfg, n_chips: int) -> float:
    """6*N_active*D for training, 2*N_active*D for inference forward; decode
    counts one token per sequence."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens / n_chips
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens / n_chips
    tokens = shape.global_batch  # one new token per sequence
    # decode also re-reads the KV cache: attention flops ~ 2*2*L*kv*hd*S per tok
    attn = 4.0 * cfg.num_layers * cfg.num_kv_heads * cfg.resolved_head_dim * shape.seq_len
    return (2.0 * n_active + attn) * tokens / n_chips


def _build_step(cfg: ArchConfig, shape: ShapeCfg, policy):
    """(fn, args) of the cell's step, its arguments DTensors of shape-only
    shards on the policy's mesh. Call under a ``FakeTensorMode``."""
    params = shard_params(specs.params_specs(cfg, device="cpu"), policy)
    if shape.kind == "train":
        opt_big = cfg.param_count() * 2 / 256 > (2 << 30)
        opt_cfg = AdamWConfig(moment_dtype=torch.bfloat16 if opt_big else torch.float32)
        opt = adamw_init(opt_cfg, params)
        batch = shard_for_host(specs.input_specs(cfg, shape, device="cpu"), policy.mesh, policy)
        step = make_train_step(cfg, opt_cfg, remat=True, microbatch=1, policy=policy)
        return step, (params, opt, batch)
    if shape.kind == "prefill":
        batch = shard_for_host(specs.input_specs(cfg, shape, device="cpu"), policy.mesh, policy)
        return make_prefill(cfg, policy=policy), (params, batch)
    cache = shard_cache(specs.cache_specs(cfg, shape.global_batch, shape.seq_len,
                                          device="cpu"), policy)
    batch = shard_for_host(specs.decode_input_specs(cfg, shape, device="cpu"), policy.mesh,
                           policy)
    return make_serve_step(cfg, policy=policy), (params, cache, batch, shape.seq_len - 1)


def _trace(cfg, shape, policy):
    """Run the cell's step once: (counts, argument bytes, output bytes).
    ``counts`` holds the bytes of every op's output and the step's peak live
    bytes (``flop_analysis.analyze``).
    An output the step wrote in place into an argument (a decode step's
    cache) counts the bytes written (``flop_analysis.output_bytes``).

    The arguments are made under a ``FakeTensorMode``; the step runs with the
    mode off the stack, its shards FakeTensors that carry it: DTensor's own
    host-side index arithmetic (its placement and redistribution planning)
    then computes on real tensors, as it must. A small tensor the model
    makes (positions, masks, zero states) is real and joins the shards as a
    constant (``allow_non_fake_inputs``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        fn, args = _build_step(cfg, shape, policy)
    with flop_analysis.analyze() as counts:
        out = fn(*args)
    return (counts, flop_analysis.local_bytes(args),
            flop_analysis.output_bytes(out, args, counts.writes))


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False, verbose: bool = True,
             cfg: ArchConfig | None = None) -> CellResult:
    """One cell; ``cfg`` runs in place of ``arch``'s config (a reduced one,
    in the tests)."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    res = CellResult(arch=arch, shape=shape_name, mesh=mesh_name, status="ok")

    if shape.name == "long_500k" and not cfg.supports_long:
        res.status = "skipped"
        res.reason = "pure full attention: 500k decode KV is unbounded (DESIGN.md)"
        return res

    dims, _ = production_shape(multi_pod=multi_pod)
    n_chips = 1
    for d in dims:
        n_chips *= d
    quiet = logging.getLogger("torch.distributed.tensor._redistribute")
    level = quiet.level
    quiet.setLevel(logging.ERROR)  # DTensor's advice on sequential all-reduces
    t0 = time.time()
    try:
        with fake_world(n_chips):
            mesh = make_production_mesh(multi_pod=multi_pod)  # real tensors: outside the mode
            policy = make_policy(cfg, mesh)
            counts, res.arg_bytes, res.output_bytes = _trace(cfg, shape, policy)
    except Exception as e:
        res.status = "error"
        res.reason = f"{type(e).__name__}: {e}"[:500]
        if verbose:
            traceback.print_exc()
        return res
    finally:
        quiet.setLevel(level)
    res.compile_s = time.time() - t0

    res.flops = counts.flops
    res.op_output_bytes = counts.op_output_bytes
    res.hbm_bytes = res.arg_bytes + counts.op_output_bytes
    res.temp_bytes = counts.temp_bytes
    res.collective_wire_bytes = counts.collective_wire_bytes
    res.collective_wire_bytes_nvlink = counts.collective_wire_bytes_nvlink
    res.collective_wire_bytes_network = counts.collective_wire_bytes_network
    res.collective_by_type = dict(counts.collective_bytes_by_type)
    res.n_collectives = counts.collective_ops
    res.n_collectives_comm_debug = counts.comm_debug_ops
    res.kernels = counts.kernels
    res.flops_by_op = counts.flops_by_op
    res.flops_by_phase = counts.flops_by_phase
    res.top_hbm_ops = counts.top_hbm_ops
    res.top_live_ops = counts.top_live_ops
    res.top_flop_ops = counts.top_flop_ops
    res.top_collectives = counts.top_collectives

    res.t_compute = res.flops / PEAK_FLOPS
    res.t_memory = res.hbm_bytes / HBM_BW
    res.t_collective = (res.collective_wire_bytes_nvlink / LINK_BW
                        + res.collective_wire_bytes_network / NET_BW)
    terms = {"compute": res.t_compute, "memory": res.t_memory,
             "collective": res.t_collective}
    res.bottleneck = max(terms, key=terms.get)
    res.model_flops_per_chip = model_flops_per_chip(cfg, shape, n_chips)
    res.useful_ratio = res.model_flops_per_chip / res.flops if res.flops else 0.0

    if verbose:
        print(
            f"[{mesh_name}] {arch} x {shape_name}: trace {res.compile_s:.1f}s | "
            f"args {res.arg_bytes / 2**30:.2f} GiB out {res.output_bytes / 2**30:.2f} GiB "
            f"temp {res.temp_bytes / 2**30:.2f} GiB | "
            f"flops/chip {res.flops:.3e} | hbm {res.hbm_bytes:.3e} B | "
            f"wire {res.collective_wire_bytes_nvlink:.3e} B nvlink + "
            f"{res.collective_wire_bytes_network:.3e} B network in {res.n_collectives} "
            f"collectives | terms c/m/x = {res.t_compute * 1e3:.2f}/{res.t_memory * 1e3:.2f}/"
            f"{res.t_collective * 1e3:.2f} ms -> {res.bottleneck} | "
            f"useful {res.useful_ratio:.2f}"
        )
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    archs = sorted(all_configs()) if args.arch == "all" else [args.arch]
    shape_names = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results = []
    for mp in meshes:
        for arch in archs:
            for sn in shape_names:
                results.append(run_cell(arch, sn, multi_pod=mp))

    ok = sum(1 for r in results if r.status == "ok")
    sk = sum(1 for r in results if r.status == "skipped")
    er = sum(1 for r in results if r.status == "error")
    print(f"\n== dry-run summary: {ok} ok, {sk} skipped, {er} errors ==")
    for r in results:
        if r.status == "error":
            print(f"  ERROR {r.mesh} {r.arch} x {r.shape}: {r.reason}")

    if args.out:
        with open(args.out, "w") as f:
            json.dump([asdict(r) for r in results], f, indent=1)
        print(f"wrote {args.out}")

    if er:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
