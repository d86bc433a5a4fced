"""Rank body of the sharded parity tests: reduced configs on a (2, 2)
("data", "model") mesh of gloo ranks on the CPU, run through the port's
entry points with ``policy=``. It imports the port only (no JAX), so the
spawned ranks start quickly; the tests compare what rank 0 returns."""
import numpy as np
import torch

MESH = (2, 2)
# arch -> fields of the policy set by hand: gemma3's reduced 4 heads divide
# "model" 2 ("heads" mode), so "dmodel" is forced; dbrx's reduced size is far
# below the FSDP threshold, so FSDP is forced
SERVE_CASES = {
    "qwen3-0.6b": {},
    "gemma3-4b": {"attn_mode": "dmodel"},
    "zamba2-7b": {},
    "rwkv6-7b": {},
    "dbrx-132b": {"fsdp": True},
}
DECODE_STEPS = 4
# arch -> the policy fields set by hand for its train step: dbrx (MoE) on
# FSDP, its reduced 4 heads in one k/v group (each "model" rank narrows k/v
# to its group); zamba2's SSD scan on each rank's heads (B and C read whole)
TRAIN_CASES = {"qwen3-0.6b": {}, "dbrx-132b": {"fsdp": True}, "zamba2-7b": {}}


def policy_for(cfg, mesh, overrides):
    from repro_torch.runtime import sharding as sh

    pol = sh.make_policy(cfg, mesh)
    for name, value in overrides.items():
        setattr(pol, name, value)
    return pol


def run(rank, device, inputs_path):
    """``inputs_path``: a pickle of (``serve_inputs``: {arch: (numpy params,
    tokens (b, s))}, ``train_inputs``: {arch: (numpy params, numpy batch,
    lr)}, ``pick_inputs``: (logits (b, s, V), labels (b, s), cotangents of
    the logsumexp and of the pick, as numpy)), read from a file so that the
    spawn's arguments stay small (the spawn writes a process's arguments
    down a pipe the new process reads only once it has imported torch, so
    large ones start the ranks one after another). Rank 0 returns
    {arch: {"prefill", "decode", "placements"}, "train": {arch: (params,
    opt state, metrics)}, "pick": {"lse", "picked", "grad_lse",
    "grad_picked"}, "device_refused": bool} as numpy and numbers."""
    import logging
    import pickle

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.runtime import optimizer as opt
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.serve import make_prefill, make_serve_step
    from repro_torch.runtime.train import make_train_step

    # DTensor's planning advice (gloo's all-to-all fallback, sequential
    # all-reduces) would land between the test run's progress dots
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    with open(inputs_path, "rb") as f:
        serve_inputs, train_inputs, pick_inputs = pickle.load(f)
    mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data", "model"))
    out = {}
    try:  # under a policy the device is the mesh's
        make_prefill(get_config("qwen3-0.6b").reduced(), "cuda",
                     policy=policy_for(get_config("qwen3-0.6b").reduced(), mesh, {}))
        out["device_refused"] = False
    except ValueError:
        out["device_refused"] = True
    for arch, (tree, toks) in serve_inputs.items():
        cfg = get_config(arch).reduced()
        pol = policy_for(cfg, mesh, SERVE_CASES[arch])
        params = sh.shard_params(bridge.params_from_numpy(tree, device="cpu"), pol)
        b, s = toks.shape
        logits = make_prefill(cfg, policy=pol)(params, {"tokens": toks})
        cache = sh.shard_cache(tf.init_cache(cfg, b, s, torch.float32, device="cpu"), pol)
        step = make_serve_step(cfg, policy=pol)
        dec = []
        for pos in range(DECODE_STEPS):
            lg, cache = step(params, cache, {"tokens": toks[:, pos:pos + 1]}, pos)
            dec.append(lg.full_tensor()[:, 0])
        out[arch] = {"prefill": logits.full_tensor().numpy(),
                     "decode": torch.stack(dec, 1).numpy(),
                     "placements": str(logits.placements)}
    out["train"] = {}
    for arch, (tree, batch, lr) in train_inputs.items():
        cfg = get_config(arch).reduced()
        pol = policy_for(cfg, mesh, TRAIN_CASES[arch])
        params = sh.shard_params(bridge.params_from_numpy(tree, device="cpu"), pol)
        c = opt.AdamWConfig(lr=lr, warmup_steps=0)
        p, s, m = make_train_step(cfg, c, remat=False, policy=pol)(
            params, opt.adamw_init(c, params), batch)
        p, s = sh.gather(p), sh.gather(s)
        out["train"][arch] = (bridge.params_to_numpy(p), bridge.opt_state_to_numpy(s),
                              {k: float(sh.gather({"x": v})["x"]) for k, v in m.items()})
    out["pick"] = pick(mesh, *pick_inputs)
    return out if rank == 0 else None


def pick(mesh, logits, labels, d_lse, d_picked) -> dict:
    """``train.lse_and_label_logits`` on logits split over the batch
    ("data") and the vocab ("model"), labels over the batch: its values and
    the logits' gradient under the given cotangents, whole, as numpy."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.runtime.train import lse_and_label_logits

    x = distribute_tensor(torch.from_numpy(logits), mesh, [Shard(0), Shard(2)])
    x = x.detach().requires_grad_()
    lab = distribute_tensor(torch.from_numpy(labels), mesh, [Shard(0), Replicate()])
    lse, picked = lse_and_label_logits(x, lab)
    out = {"lse": lse.full_tensor().detach().numpy(),
           "picked": picked.full_tensor().detach().numpy()}
    for name, y, dy in (("grad_lse", lse, d_lse), ("grad_picked", picked, d_picked)):
        dy = distribute_tensor(torch.from_numpy(dy), mesh, list(y.placements))
        (g,) = torch.autograd.grad(y, x, dy, retain_graph=True)
        out[name] = g.full_tensor().numpy()
    return out


def numpy_tokens(vocab: int, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)
