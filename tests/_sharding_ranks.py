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


def policy_for(cfg, mesh, overrides):
    from repro_torch.runtime import sharding as sh

    pol = sh.make_policy(cfg, mesh)
    for name, value in overrides.items():
        setattr(pol, name, value)
    return pol


def run(rank, device, inputs_path):
    """``inputs_path``: a pickle of (``serve_inputs``: {arch: (numpy params,
    tokens (b, s))}, ``train_inputs``: (arch, numpy params, numpy batch,
    lr)), read from a file so that the spawn's arguments stay small (the
    spawn writes a process's arguments down a pipe the new process reads
    only once it has imported torch, so large ones start the ranks one
    after another). Rank 0 returns
    {arch: {"prefill", "decode", "placements"}, "train": (params, opt
    state, metrics), "device_refused": bool} as numpy and numbers."""
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
        serve_inputs, train_inputs = pickle.load(f)
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
    arch, tree, batch, lr = train_inputs
    cfg = get_config(arch).reduced()
    pol = policy_for(cfg, mesh, {})
    params = sh.shard_params(bridge.params_from_numpy(tree, device="cpu"), pol)
    c = opt.AdamWConfig(lr=lr, warmup_steps=0)
    p, s, m = make_train_step(cfg, c, remat=False, policy=pol)(params, opt.adamw_init(c, params),
                                                               batch)
    p, s = sh.gather(p), sh.gather(s)
    out["train"] = (bridge.params_to_numpy(p), bridge.opt_state_to_numpy(s),
                    {k: float(sh.gather({"x": v})["x"]) for k, v in m.items()})
    return out if rank == 0 else None


def numpy_tokens(vocab: int, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)
