#!/usr/bin/env python3
"""The sharded path across cards: models under their ``ShardingPolicy`` on a
(1, 4) ("data", "model") mesh of four NCCL ranks, one card a rank, through
``make_prefill`` / ``make_serve_step`` with ``policy=``, against the
unsharded port on one card.

    python3 tools/sharded_cards.py              # needs 4 cards
    python3 tools/sharded_cards.py --gloo-one-card   # 2 gloo ranks on card 0
    python3 tools/sharded_cards.py --cpu        # 4 gloo ranks on the CPU, reduced

On the cards (fp32, random weights from seed 0, prompts of 4 x 1024, then
DECODE_STEPS decode steps of the prompts' first tokens):

* starcoder2-15b at full width and depth (48 heads: "heads" mode), against
  the same model unsharded on card 0;
* dbrx-132b at DBRX_SHORT layers against the one-card run of those layers
  (the depth ``chip_smoke.py`` holds on one card), then at DBRX_LONG layers,
  as many as the four cards hold, with their memory and wall time.

Each line gives each card's peak memory, the wall of each call (host clock,
from a barrier, after a warm-up call), the logits' distance from the
one-card run (max |diff| over max |logit|) and the card's name and power
limit. The weights take the models' own init scales with the residual
branches' output projections over sqrt(2 L) (``init_scale``), so that a
random 40-layer stack stays well-conditioned: fp32 rounding moves its
logits by about 1e-6, and each sharded run is held to TOL.
``--gloo-one-card`` tries a (1, 2) mesh of two gloo ranks on one card:
an all-gather, a reduce-scatter and an all-reduce of CUDA DTensors.
``--cpu`` runs reduced configs (2 layers) on 4 gloo ranks of the CPU against
the unsharded port, which is this script's test. Exits non-zero if a
route's logits are off by more than TOL.
"""
import argparse
import json
import math
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.runtime.pipeline_ranks import spawn_stages  # noqa: E402

SEED, B, S, DECODE_STEPS, TOL = 0, 4, 1024, 8, 1e-5
STARCODER, DBRX, DBRX_SHORT, DBRX_LONG = "starcoder2-15b", "dbrx-132b", 4, 16
MESH = (1, 4)


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "no nvidia-smi"


def _serve(cfg, params, tokens, steps, policy=None, device=None):
    """Prefill and ``steps`` decode steps: (prefill logits, decode logits,
    wall ms of a warm prefill, of a warm decode step)."""
    from repro_torch.models import transformer as tf
    from repro_torch.runtime.serve import make_prefill, make_serve_step
    from repro_torch.runtime.sharding import shard_cache

    dev = tokens.device
    pre = make_prefill(cfg, device, policy=policy)
    step = make_serve_step(cfg, device, policy=policy)

    def cache():
        c = tf.init_cache(cfg, tokens.shape[0], steps, torch.float32, device=dev)
        return c if policy is None else shard_cache(c, policy)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if policy is not None:
            torch.distributed.barrier()

    logits = pre(params, {"tokens": tokens})
    c = cache()
    dec = [step(params, c, {"tokens": tokens[:, t:t + 1]}, t)[0] for t in range(steps)]
    sync()
    t0 = time.perf_counter()
    pre(params, {"tokens": tokens})
    sync()
    t1 = time.perf_counter()
    step(params, cache(), {"tokens": tokens[:, :1]}, 0)
    sync()
    t2 = time.perf_counter()
    full = (lambda x: x.full_tensor()) if policy is not None else (lambda x: x)
    return (full(logits).cpu(), torch.stack([full(d)[:, 0].cpu() for d in dec], 1),
            (t1 - t0) * 1e3, (t2 - t1) * 1e3)


def init_scale(path: str, shape, n_layers: int) -> float:
    """The standard deviation the models' own init gives the leaf at ``path``
    (one layer's ``shape``): 1 for the embedding, 1 / sqrt(fan-in) for a
    product (the model dimension for the q/k/v projections, heads x head
    size for ``wo``); the output projections of the residual branches
    (``wo``, ``w_out``) also over sqrt(2 L), GPT-2's depth scaling, so that a
    deep random stack stays well-conditioned."""
    leaf = path.rsplit("/", 1)[-1]
    if path == "embed":
        return 1.0
    fan_in = (shape[0] if leaf in ("wq", "wk", "wv")
              else math.prod(shape[:-1]) if leaf == "wo" else shape[-2])
    depth = math.sqrt(2 * n_layers) if leaf in ("wo", "w_out") else 1.0
    return fan_in ** -0.5 / depth


def draw_params(cfg, seed, device, policy=None):
    """Params of ``cfg`` drawn layer by layer on ``device`` (N(0,
    ``init_scale``^2), norms and vectors 0) from one generator, in one
    order: whole, or under ``policy`` cut to this rank's shards as each
    layer is drawn, so that no card holds more than one layer of a leaf
    whole. The same ``seed`` gives
    the same values either way."""
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    from repro_torch.launch import specs
    from repro_torch.runtime.sharding import placements
    from repro_torch.tree import tree_map_with_path

    gen = torch.Generator(device=device).manual_seed(seed)
    meta = specs.params_specs(cfg, dtype=torch.float32)
    spec_of = {}
    if policy is not None:
        tree_map_with_path(lambda p, sp: spec_of.__setitem__(p, sp), policy.param_specs(meta))

    def draw(shape, dtype, path):
        if path.endswith("norm") or len(shape) < 2:
            return torch.zeros(shape, dtype=dtype, device=device)
        x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return x.mul_(init_scale(path, shape, cfg.num_layers)).to(dtype)

    def whole_or_shard(x, pl):
        if policy is None:
            return x
        return distribute_tensor(x, policy.mesh, pl, src_data_rank=None).to_local()

    def make(path, m):
        pl = placements(policy.mesh, spec_of[path]) if policy is not None else None
        if "blocks/" not in path:
            local = whole_or_shard(draw(m.shape, m.dtype, path), pl)
        else:  # layer by layer into the stack: one layer whole at a time
            cut = pl and [Shard(p.dim - 1) if p.is_shard() else p for p in pl]
            local = None
            for i in range(m.shape[0]):
                part = whole_or_shard(draw(m.shape[1:], m.dtype, path), cut)
                if local is None:
                    local = torch.empty((m.shape[0], *part.shape), dtype=m.dtype, device=device)
                local[i] = part
        if policy is None:
            return local
        return DTensor.from_local(local.contiguous(), policy.mesh, pl, run_check=False,
                                  shape=m.shape,
                                  stride=torch.empty(m.shape, device="meta").stride())

    return tree_map_with_path(make, meta)


def rank_body(rank, device, cases, mesh_shape, tokens, steps) -> dict:
    """Every case ``(name, cfg, want)`` on this rank, its params drawn shard
    by shard. Returns each case's walls, memory and (where ``want`` is
    given) the logits' distance from it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.runtime.sharding import make_policy

    torch.backends.cuda.matmul.allow_tf32 = False
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh = init_device_mesh(device.type, mesh_shape, mesh_dim_names=("data", "model"))
    tokens = tokens.to(device)
    out = {}
    for name, cfg, want in cases:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        policy = make_policy(cfg, mesh)
        params = draw_params(cfg, SEED, device, policy)
        logits, dec, pre_ms, step_ms = _serve(cfg, params, tokens, steps, policy=policy)
        row = {"prefill_ms": pre_ms, "decode_step_ms": step_ms,
               "peak_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                           if device.type == "cuda" else 0.0),
               "finite": bool(torch.isfinite(logits).all() and torch.isfinite(dec).all()),
               "attn_mode": policy.attn_mode, "fsdp": policy.fsdp}
        if want is not None:
            row["prefill_err"] = ((logits - want[0]).abs().max() / want[0].abs().max()).item()
            row["decode_err"] = ((dec - want[1]).abs().max() / want[1].abs().max()).item()
        out[name] = row
        del params
        if device.type == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def one_card(cfg, tokens, steps, device) -> tuple:
    """The unsharded run: ((prefill logits, decode logits), prefill ms,
    decode step ms)."""
    params = draw_params(cfg, SEED, device)
    logits, dec, pre_ms, step_ms = _serve(cfg, params, tokens.to(device), steps, device=device)
    del params
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return (logits, dec), pre_ms, step_ms


def gloo_one_card() -> int:
    """Two gloo ranks on card 0: a plain all-reduce of a CUDA tensor, then a
    (1, 2) DTensor mesh's all-gather, reduce-scatter and all-reduce, each in
    a spawn of its own (a rank that crashes ends only its probe)."""
    card = card_line()
    for probe in ("plain all-reduce", "all-gather", "reduce-scatter", "all-reduce"):
        try:
            got = spawn_stages(2, _gloo_probe, probe, backend="gloo", timeout_s=300)[0]
        except (RuntimeError, TimeoutError) as e:
            got = " ".join(str(e).split())[:200]
        print(f"gloo, 2 ranks on one card, {probe} of CUDA tensors: {got}  [{card}]", flush=True)
    return 0


def _gloo_probe(rank, device, probe):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    x = torch.arange(16.0, device=device).reshape(4, 4)
    if probe == "plain all-reduce":
        y = x.clone()
        dist.all_reduce(y)
        return "ok" if torch.equal(y, 2 * x) else "wrong values"
    mesh = init_device_mesh("cuda", (1, 2), mesh_dim_names=("data", "model"))
    src, dst, want = {
        "all-gather": ([Replicate(), Shard(0)], [Replicate(), Replicate()], x),
        "reduce-scatter": ([Replicate(), Partial()], [Replicate(), Shard(0)], 2 * x),
        "all-reduce": ([Replicate(), Partial()], [Replicate(), Replicate()], 2 * x)}[probe]
    local = x.chunk(2)[rank] if probe == "all-gather" else x
    got = DTensor.from_local(local, mesh, src, run_check=False).redistribute(mesh, dst)
    return "ok" if torch.equal(got.full_tensor(), want) else "wrong values"


def run(cpu: bool) -> tuple[dict, int]:
    """Every case against the one-card run, a line each: (what each rank
    returned, by case; the number of cases that failed)."""
    from repro_torch.configs import get_config

    if cpu:
        cfgs = {STARCODER: replace(get_config(STARCODER).reduced(), num_layers=2),
                DBRX: replace(get_config(DBRX).reduced(), num_layers=2)}
        b, s, steps, device, backend = 2, 16, 2, torch.device("cpu"), "gloo"
    else:
        cfgs = {STARCODER: get_config(STARCODER),
                f"{DBRX} {DBRX_SHORT} layers": replace(get_config(DBRX), num_layers=DBRX_SHORT)}
        b, s, steps, device, backend = B, S, DECODE_STEPS, torch.device("cuda", 0), "nccl"
    card = card_line() if device.type == "cuda" else "cpu"
    tokens = torch.randint(0, min(c.vocab_size for c in cfgs.values()), (b, s),
                           generator=torch.Generator().manual_seed(SEED))
    cases = []
    for name, cfg in cfgs.items():
        want, pre_ms, step_ms = one_card(cfg, tokens, steps, device)
        print(f"{name} one card: prefill {b} x {s} {pre_ms:.1f} ms, decode step "
              f"{step_ms:.1f} ms  [{card}]", flush=True)
        cases.append((name, cfg, want))
    if not cpu:
        cases.append((f"{DBRX} {DBRX_LONG} layers", replace(get_config(DBRX),
                                                            num_layers=DBRX_LONG), None))
    ranks = spawn_stages(4, rank_body, cases, MESH, tokens, steps, backend=backend,
                         device=None if device.type == "cuda" else "cpu", timeout_s=3000)
    bad = 0
    for name, _, want in cases:
        rows = [r[name] for r in ranks]
        err = "" if want is None else (f", logits vs one card: prefill "
                                       f"{rows[0]['prefill_err']:.3e}, decode "
                                       f"{rows[0]['decode_err']:.3e}")
        print(f"{name} on a {MESH} mesh of 4 {backend} ranks ({rows[0]['attn_mode']}, fsdp "
              f"{rows[0]['fsdp']}): prefill " + " / ".join(f"{r['prefill_ms']:.1f}" for r in rows)
              + " ms, decode step " + " / ".join(f"{r['decode_step_ms']:.1f}" for r in rows)
              + " ms, peak " + " / ".join(f"{r['peak_gb']:.2f}" for r in rows) + " GB" + err
              + f"  [{card}]", flush=True)
        bad += not all(r["finite"] for r in rows)
        if want is not None:
            bad += not (rows[0]["prefill_err"] <= TOL and rows[0]["decode_err"] <= TOL)
    return {name: [r[name] for r in ranks] for name, *_ in cases}, bad


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--gloo-one-card", action="store_true")
    args = ap.parse_args()
    if args.gloo_one_card:
        return gloo_one_card()
    if not args.cpu and torch.cuda.device_count() < 4:
        print(f"sharded_cards: 4 cards needed, {torch.cuda.device_count()} found",
              file=sys.stderr)
        return 1
    rows, bad = run(args.cpu)
    print(json.dumps(rows))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
