#!/usr/bin/env python3
"""The sharded path across cards: models under their ``ShardingPolicy`` on a
(1, 4) ("data", "model") mesh of four NCCL ranks, one card a rank, through
``make_prefill`` / ``make_serve_step`` / ``make_train_step`` with
``policy=``, against the unsharded port on one card.

    python3 tools/sharded_cards.py              # needs 4 cards
    python3 tools/sharded_cards.py --gloo-one-card   # 2 gloo ranks on card 0
    python3 tools/sharded_cards.py --cpu        # 4 gloo ranks on the CPU, reduced

On the cards (fp32, random weights from seed 0, prompts of 4 x 1024, then
DECODE_STEPS decode steps of the prompts' first tokens):

* starcoder2-15b at full width and depth (48 heads: "heads" mode), against
  the same model unsharded on card 0;
* dbrx-132b at DBRX_SHORT layers against the one-card run of those layers
  (the depth ``chip_smoke.py`` holds on one card), then at DBRX_LONG layers,
  as many as the four cards hold, with their memory and wall time;
* rwkv6-7b and zamba2-7b at full width and depth (their wkv6 and SSD-scan
  kernels on each rank's 64 / 4 and 112 / 4 heads through ``local_map``),
  each also run on one card with every prompt alone (re-batched): that
  run's distance from the batched one is the one card's own fp32 noise
  (``recurrent_ok``);
* one AdamW train step (remat) of qwen3-0.6b at full width and depth on
  B x S tokens, on every card once unsharded (the reference, same weights
  and batch) and then sharded, held to ``_check_step``'s tolerances of the
  train tests (``check_step``), shard by shard.

Each line gives each card's peak memory, the wall of each call (host clock,
from a barrier, after a warm-up call), the logits' distance from the
one-card run (max |diff| over max |logit|), the kernels' launches on each
rank and the card's name and power limit. The weights take the models' own
init (``init_scale``, ``INIT_CONST``) with the residual branches' output
projections over sqrt(2 L), so that a random 40-layer stack stays
well-conditioned: fp32 rounding moves its logits by about 1e-6, and each
sharded run is held to TOL. A random 32-layer rwkv stack still amplifies
fp32 reassociation (its re-batched one-card run is ~1e-4 off), so a
recurrent model beyond TOL is held as ``chip_smoke.py`` holds rwkv6-7b on
one card: the reference's ssm criterion (softmax within SSM_PROB_TOL, the
same argmax everywhere), or, where argmaxes differ, no farther from the
one card than its re-batched run and no fewer equal argmaxes.
``--gloo-one-card`` tries a (1, 2) mesh of two gloo ranks on one card:
an all-gather, a reduce-scatter and an all-reduce of CUDA DTensors.
``--cpu`` runs reduced configs (2 layers) on 4 gloo ranks of the CPU against
the unsharded port, which is this script's test (reduced qwen3-0.6b,
rwkv6-7b and zamba2-7b, 2 layers, for the new cases). Exits non-zero if a
route's logits are off by more than their bound or the train step fails a
tolerance.
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
RWKV, ZAMBA, TRAIN_ARCH = "rwkv6-7b", "zamba2-7b", "qwen3-0.6b"
MESH = (1, 4)
# the train step's tolerances, as tests/test_torch_train.py::_check_step
# holds a step: metrics at STEP_RTOL (atol STEP_ATOL), each moment leaf at
# MOMENT_TOL of its largest |m|, params within LR x PARAM_SURE where the
# clipped gradient is at least 1e-6 (|m| >= 1e-7) and within 2 x LR elsewhere
LR, STEP_RTOL, STEP_ATOL, MOMENT_TOL, PARAM_SURE = 1e-3, 1e-5, 1e-7, 1e-4, 1e-2
KERNELS = ("flash_attention", "rwkv6", "ssd_scan")
SSM_PROB_TOL = 2e-2  # tests/test_models.py:97-109, as chip_smoke.py holds rwkv6-7b
# leaves whose init is a constant (the models' own), and the standard
# deviations of the models' own draws that no fan-in gives
INIT_CONST = {"mu_x": 0.5, "cm_mu_r": 0.5, "cm_mu_k": 0.5, "ln_x": 1.0, "D": 1.0}
INIT_STD = {"mu": 0.1, "B_mix": 0.05, "B_w": 0.05, "w0": 0.5, "u": 0.5, "A_log": 0.5,
            "conv_w": 0.5}


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

    logits = pre(params, {"tokens": tokens})
    c = cache()
    dec = [step(params, c, {"tokens": tokens[:, t:t + 1]}, t)[0] for t in range(steps)]
    _sync(dev, policy)
    t0 = time.perf_counter()
    pre(params, {"tokens": tokens})
    _sync(dev, policy)
    t1 = time.perf_counter()
    step(params, cache(), {"tokens": tokens[:, :1]}, 0)
    _sync(dev, policy)
    t2 = time.perf_counter()
    full = (lambda x: x.full_tensor()) if policy is not None else (lambda x: x)
    return (full(logits).cpu(), torch.stack([full(d)[:, 0].cpu() for d in dec], 1),
            (t1 - t0) * 1e3, (t2 - t1) * 1e3)


def init_scale(path: str, shape, n_layers: int) -> float:
    """The standard deviation the models' own init gives the leaf at ``path``
    (one layer's ``shape``): 1 for the embedding, ``INIT_STD`` where the
    model draws at a fixed scale, 1 / sqrt(fan-in) for a product (the model
    dimension for the q/k/v projections, heads x head size for ``wo``); the
    output projections of the residual branches (attention's ``wo``, the
    MLP's, MoE's and mamba's ``w_out``, rwkv's time-mix ``Wo`` and
    channel-mix ``cm_Wv``) also over sqrt(2 L), GPT-2's depth scaling, so
    that a deep random stack stays well-conditioned."""
    leaf = path.rsplit("/", 1)[-1]
    if path == "embed":
        return 1.0
    if leaf in INIT_STD:
        return INIT_STD[leaf]
    fan_in = (shape[0] if leaf in ("wq", "wk", "wv")
              else math.prod(shape[:-1]) if leaf == "wo" else shape[-2])
    depth = math.sqrt(2 * n_layers) if leaf in ("wo", "w_out", "Wo", "cm_Wv") else 1.0
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
        leaf = path.rsplit("/", 1)[-1]
        if leaf in INIT_CONST:
            return torch.full(shape, INIT_CONST[leaf], dtype=dtype, device=device)
        if path.endswith("norm") or (len(shape) < 2 and leaf not in INIT_STD):
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


def kernel_mods() -> dict:
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.rwkv6 import kernel as wkv6
    from repro_torch.kernels.ssd_scan import kernel as ssd

    return dict(zip(KERNELS, (fa, wkv6, ssd)))


def _sync(device, policy=None) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if policy is not None:
        torch.distributed.barrier()


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def _held(device) -> int:
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.memory_allocated(device)


def train_batch(cfg, b: int, s: int) -> dict:
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1),
                         generator=torch.Generator().manual_seed(SEED + 1))
    return {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}


def _train_step(cfg, batch, device, policy=None):
    """One AdamW step (remat) from freshly drawn params, then the same step
    again, timed from a barrier: ((params, state, metrics), wall ms, peak
    bytes above what was held before the draw, launches in the first step)."""
    from repro_torch.runtime.optimizer import AdamWConfig, adamw_init
    from repro_torch.runtime.train import make_train_step

    mods = kernel_mods()
    held = _held(device)
    params = draw_params(cfg, SEED, device, policy)
    opt_cfg = AdamWConfig(lr=LR, warmup_steps=0)
    state = adamw_init(opt_cfg, params)
    step = make_train_step(cfg, opt_cfg, remat=True, device=None if policy else device,
                           policy=policy)
    for mod in mods.values():
        mod.launches = 0
    out = step(params, state, batch)
    _sync(device, policy)
    launches = {name: mod.launches for name, mod in mods.items()}
    peak = _peak(device) - held
    t0 = time.perf_counter()
    again = step(params, state, batch)
    _sync(device, policy)
    ms = (time.perf_counter() - t0) * 1e3
    del again, params, state
    return out, ms, peak, launches


def check_step(got, want) -> dict:
    """``got`` (a sharded step's params, state, metrics) against ``want``
    (the same step's on one card, whole tensors on this rank's card), shard
    by shard, as ``_check_step`` holds a step: the worst of each criterion
    as a share of its bound (at most 1 passes)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.runtime.pspec import settled
    from repro_torch.runtime.sharding import gather
    from repro_torch.tree import tree_leaves

    def local(x, whole):
        if not isinstance(x, DTensor):
            return x, whole
        x = settled(x)  # a moment may hold a pending sum (a norm's, over "model")
        cut = distribute_tensor(whole, x.device_mesh, x.placements, src_data_rank=None)
        return x.to_local(), cut.to_local()

    (gp, gs, gm), (wp, ws, wm) = got, want
    worst = {}
    for k in ("nll", "z_loss", "moe_aux", "lr", "grad_norm"):
        g, w = float(gather({"x": gm[k]})["x"]), float(wm[k])
        worst[k] = abs(g - w) / (STEP_ATOL + STEP_RTOL * abs(w))
    for name in ("m", "v"):
        worst[name] = 0.0
        for a, b in zip(tree_leaves(gs[name]), tree_leaves(ws[name])):
            la, lb = local(a, b)
            bound = MOMENT_TOL * b.abs().max().item() + 1e-30
            worst[name] = max(worst[name], (la - lb).abs().max().item() / bound)
    worst["params_sure"] = worst["params"] = 0.0
    for a, b, m in zip(tree_leaves(gp), tree_leaves(wp), tree_leaves(ws["m"])):
        (la, lb), (_, lm) = local(a, b), local(a, m)
        diff = (la.float() - lb.float()).abs()
        sure = lm.abs() >= 1e-7
        if bool(sure.any()):
            worst["params_sure"] = max(worst["params_sure"],
                                       diff[sure].max().item() / (LR * PARAM_SURE))
        worst["params"] = max(worst["params"], diff.max().item() / (2 * LR))
    return worst


def rank_body(rank, device, cases, mesh_shape, tokens, steps) -> dict:
    """Every case on this rank, its params drawn shard by shard: a serving
    case ``{"kind": "serve", "name", "cfg", "want"}`` returns its walls,
    memory, launches and (where ``want`` is given) the logits' distance
    from it; a train case ``{"kind": "train", "name", "cfg", "batch"}``
    runs the step on this card unsharded, then sharded, and returns both
    walls and peaks, the launches and ``check_step``'s worst shares."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.runtime.sharding import make_policy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh = init_device_mesh(device.type, mesh_shape, mesh_dim_names=("data", "model"))
    tokens = tokens.to(device)
    mods = kernel_mods()
    out = {}
    for case in cases:
        name, cfg = case["name"], case["cfg"]
        policy = make_policy(cfg, mesh)
        if case["kind"] == "train":
            batch = {k: v.to(device) for k, v in case["batch"].items()}
            want, one_ms, one_peak, _ = _train_step(cfg, batch, device)
            if device.type == "cuda":
                torch.cuda.empty_cache()
            got, ms, peak, launches = _train_step(cfg, batch, device, policy)
            row = {"one_card_ms": one_ms, "one_card_peak_gb": one_peak / 1e9, "step_ms": ms,
                   "peak_gb": peak / 1e9, "launches": launches, "worst": check_step(got, want),
                   "finite": all(math.isfinite(float(v)) for v in want[2].values()),
                   "attn_mode": policy.attn_mode, "fsdp": policy.fsdp}
            del want, got
        else:
            held = _held(device)
            params = draw_params(cfg, SEED, device, policy)
            for mod in mods.values():
                mod.launches = 0
            logits, dec, pre_ms, step_ms = _serve(cfg, params, tokens, steps, policy=policy)
            row = {"prefill_ms": pre_ms, "decode_step_ms": step_ms,
                   "peak_gb": (_peak(device) - held) / 1e9,
                   "launches": {n: mod.launches for n, mod in mods.items()},
                   "finite": bool(torch.isfinite(logits).all() and torch.isfinite(dec).all()),
                   "attn_mode": policy.attn_mode, "fsdp": policy.fsdp}
            if case["want"] is not None:
                for what, got, want in zip(("prefill", "decode"), (logits, dec), case["want"]):
                    row[f"{what}_err"], row[f"{what}_prob"], row[f"{what}_top1"] = distance(
                        got, want)
            del params
        out[name] = row
        if device.type == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def distance(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(max |diff| over max |logit|, max |softmax diff|, positions whose
    argmax agrees) of two logits tensors."""
    err = ((got - want).abs().max() / want.abs().max()).item()
    prob = (torch.softmax(got, -1) - torch.softmax(want, -1)).abs().max().item()
    return err, prob, int((got.argmax(-1) == want.argmax(-1)).sum())


def recurrent_ok(row: dict, noise: dict, what: str, positions: int) -> bool:
    """The sharded run's ``what`` logits against one card's beyond TOL, held
    as ``chip_smoke.py`` holds rwkv6-7b: softmax within SSM_PROB_TOL and
    either every argmax equal, or no farther than the re-batched one-card
    run and no fewer equal argmaxes than it."""
    err, prob, top1 = row[f"{what}_err"], row[f"{what}_prob"], row[f"{what}_top1"]
    floor_err, _, floor_top1 = noise[what]
    return prob <= SSM_PROB_TOL and (top1 == positions
                                     or (err <= floor_err and top1 >= floor_top1))


def one_card(cfg, tokens, steps, device, rebatch: bool = False) -> tuple:
    """The unsharded run: ((prefill logits, decode logits), prefill ms,
    decode step ms, the re-batched run's ``distance`` from it, by "prefill"
    and "decode", or None). Re-batched: every prompt prefilled and decoded
    alone."""
    params = draw_params(cfg, SEED, device)
    logits, dec, pre_ms, step_ms = _serve(cfg, params, tokens.to(device), steps, device=device)
    noise = None
    if rebatch:
        alone = [_serve(cfg, params, tokens[i:i + 1].to(device), steps, device=device)[:2]
                 for i in range(tokens.shape[0])]
        noise = {what: distance(torch.cat(parts), w)
                 for what, parts, w in zip(("prefill", "decode"), zip(*alone), (logits, dec))}
    del params
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return (logits, dec), pre_ms, step_ms, noise


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

    def two(arch):
        return replace(get_config(arch).reduced(), num_layers=2)

    if cpu:
        cfgs = {STARCODER: two(STARCODER), DBRX: two(DBRX), RWKV: two(RWKV), ZAMBA: two(ZAMBA)}
        train_cfg = two(TRAIN_ARCH)
        b, s, steps, device, backend = 2, 16, 2, torch.device("cpu"), "gloo"
    else:
        cfgs = {STARCODER: get_config(STARCODER),
                f"{DBRX} {DBRX_SHORT} layers": replace(get_config(DBRX), num_layers=DBRX_SHORT),
                RWKV: get_config(RWKV), ZAMBA: get_config(ZAMBA)}
        train_cfg = get_config(TRAIN_ARCH)
        b, s, steps, device, backend = B, S, DECODE_STEPS, torch.device("cuda", 0), "nccl"
    card = card_line() if device.type == "cuda" else "cpu"
    tokens = torch.randint(0, min(c.vocab_size for c in cfgs.values()), (b, s),
                           generator=torch.Generator().manual_seed(SEED))
    cases, noises = [], {}
    for name, cfg in cfgs.items():
        recurrent = cfg.family in ("ssm", "hybrid")
        want, pre_ms, step_ms, noises[name] = one_card(cfg, tokens, steps, device,
                                                       rebatch=recurrent)
        rebatched = "" if noises[name] is None else ", every prompt alone vs the batch: " + (
            ", ".join(f"{what} {e:.3e} (softmax {p:.3e}, argmax equal {t}/{want[i].shape[0] * want[i].shape[1]})"
                      for i, (what, (e, p, t)) in enumerate(noises[name].items())))
        print(f"{name} one card: prefill {b} x {s} {pre_ms:.1f} ms, decode step "
              f"{step_ms:.1f} ms{rebatched}  [{card}]", flush=True)
        cases.append({"kind": "serve", "name": name, "cfg": cfg, "want": want})
    if not cpu:
        cases.append({"kind": "serve", "name": f"{DBRX} {DBRX_LONG} layers",
                      "cfg": replace(get_config(DBRX), num_layers=DBRX_LONG), "want": None})
    train_name = f"{TRAIN_ARCH} train step"
    cases.append({"kind": "train", "name": train_name, "cfg": train_cfg,
                  "batch": train_batch(train_cfg, b, s)})
    ranks = spawn_stages(4, rank_body, cases, MESH, tokens, steps, backend=backend,
                         device=None if device.type == "cuda" else "cpu", timeout_s=3000)
    bad = 0
    for case in cases:
        name = case["name"]
        rows = [r[name] for r in ranks]
        head = (f"{name} on a {MESH} mesh of 4 {backend} ranks ({rows[0]['attn_mode']}, fsdp "
                f"{rows[0]['fsdp']})")
        launches = " / ".join(json.dumps({k: v for k, v in r["launches"].items() if v})
                              for r in rows)
        bad += not all(r["finite"] for r in rows)
        if case["kind"] == "train":
            worst = {k: max(r["worst"][k] for r in rows) for k in rows[0]["worst"]}
            print(f"{head}: step {b} x {s} (AdamW, remat) " + " / ".join(
                f"{r['step_ms']:.1f}" for r in rows) + " ms against one card's " + " / ".join(
                f"{r['one_card_ms']:.1f}" for r in rows) + " ms; peak " + " / ".join(
                f"{r['peak_gb']:.2f}" for r in rows) + " GB against one card's " + " / ".join(
                f"{r['one_card_peak_gb']:.2f}" for r in rows) + f" GB; launches a rank "
                f"{launches}; worst share of each tolerance over the ranks (at most 1 passes): "
                + json.dumps({k: float(f"{v:.4g}") for k, v in worst.items()})
                + f"  [{card}]", flush=True)
            bad += not all(v <= 1.0 for v in worst.values())
            continue
        err = ""
        if case["want"] is not None:
            r, noise = rows[0], noises[name]
            held = []
            for what, w in zip(("prefill", "decode"), case["want"]):
                positions = w.shape[0] * w.shape[1]
                if r[f"{what}_err"] <= TOL:
                    held.append(f"{what} {r[what + '_err']:.3e} (TOL {TOL:.0e})")
                    continue
                ok = noise is not None and recurrent_ok(r, noise, what, positions)
                bad += not ok
                held.append(f"{what} {r[what + '_err']:.3e} beyond TOL, softmax "
                            f"{r[what + '_prob']:.3e}, argmax equal {r[what + '_top1']}/"
                            f"{positions}: {'held' if ok else 'FAILS'} by the ssm criterion")
            err = ", logits vs one card: " + "; ".join(held)
        print(f"{head}: prefill " + " / ".join(f"{r['prefill_ms']:.1f}" for r in rows)
              + " ms, decode step " + " / ".join(f"{r['decode_step_ms']:.1f}" for r in rows)
              + " ms, peak " + " / ".join(f"{r['peak_gb']:.2f}" for r in rows) + " GB"
              + f", launches a rank {launches}" + err + f"  [{card}]", flush=True)
    return {case["name"]: [r[case["name"]] for r in ranks] for case in cases}, bad


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
