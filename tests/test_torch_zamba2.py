"""Zamba2 in its published layout (``HybridConfig``) on the port's normal path
against the benchmark's plain reference (``cardbench/reference/zamba2.py``),
at a tiny size in float64: two B/C groups, shared calls on concat(x,
embedding) into 2 blocks across 3 irregular hybrid ids, each call's LoRA and
projection, exact GELU. ``make_prefill`` and a prompt fed through
``make_serve_step`` and then decoded greedily agree with the reference's full
forward at every position; each part of the layout changed alone breaks the
agreement; the registered presets keep the JAX package's layout.

The port computes norms, RoPE and the scan in fp32 whatever its inputs, so
the float64 forward agrees to fp32 rounding: ``TOL`` in units of the
reference logits' RMS; every fault below misses it by orders of magnitude.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from cardbench import compare, hybrid, hybrid_weights  # noqa: E402
from cardbench.reference import zamba2 as ref  # noqa: E402
from repro_torch.configs import all_configs  # noqa: E402
from repro_torch.configs.base import ArchConfig, HybridConfig  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.runtime.serve import make_prefill, make_serve_step  # noqa: E402

TOL = 1e-4
SEED, B, S = 11, 2, 24
FILE = {
    "name": "tiny-zamba2-published", "hidden_size": 32, "num_hidden_layers": 6,
    "vocab_size": 53, "hybrid_layer_ids": [1, 2, 5],
    "layers_block_type": ["mamba", "hybrid", "hybrid", "mamba", "mamba", "hybrid"],
    "num_mem_blocks": 2, "num_attention_heads": 2, "num_key_value_heads": 2,
    "attention_head_dim": 24, "attention_hidden_size": 64, "ffn_hidden_size": 40,
    "adapter_rank": 4, "n_mamba_heads": 4, "mamba_headdim": 16, "mamba_d_state": 8,
    "mamba_ngroups": 2, "mamba_d_conv": 4, "mamba_expand": 2, "rope_theta": 10000,
    "rms_norm_eps": 1e-05, "use_shared_mlp_adapter": True, "use_shared_attention_adapter": False,
    "use_mem_rope": True, "add_bias_linear": False, "use_conv_bias": True,
    "time_step_limit": None,
    "port": {"family": "hybrid", "mlp": "geglu", "act": "gelu_erf",
             "norm": "rms_one_plus_scale"}}
H = hybrid.hybrid_dims(FILE)
CFG = HybridConfig(**hybrid.port_fields(H))


def _reference(tokens):
    dt = torch.float64
    glob = {k: hybrid_weights.global_leaf(H, SEED, k, "cpu", dt) for k in ("embed", "final_norm")}
    return ref.logits(H, lambda i: hybrid_weights.mamba_layer(H, SEED, i, "cpu", dt),
                      lambda b: hybrid_weights.shared_block(H, SEED, b, "cpu", dt),
                      lambda j: hybrid_weights.call(H, SEED, j, "cpu", dt), glob, tokens)["fp32"]


@pytest.fixture(scope="module")
def setup():
    params = hybrid_weights.model(H, SEED, "cpu", torch.float64)
    tokens = torch.randint(0, H.vocab, (B, S), generator=torch.Generator().manual_seed(3))
    return params, tokens, _reference(tokens)


def _prefill(params, tokens):
    return make_prefill(CFG, "cpu")(params, {"tokens": tokens})


def test_layout():
    assert [(b.kind, b.n, b.shared_idx) for b in tf.layer_plan(CFG)] == [
        ("mamba", 1, -1), ("shared_attn", 1, 0), ("mamba", 1, -1), ("shared_attn", 1, 1),
        ("mamba", 3, -1), ("shared_attn", 1, 0), ("mamba", 1, -1)]
    params = tf.init_params(CFG, 0, torch.float32, "cpu")
    drawn = hybrid_weights.model(H, 0, "cpu")
    flat = [(k, tuple(v.shape)) for k, v in _leaves(params)]
    assert flat == [(k, tuple(v.shape)) for k, v in _leaves(drawn)]
    assert sum(v.numel() for _, v in _leaves(params)) == CFG.param_count()
    caches = tf.init_cache(CFG, B, 16, torch.float32, "cpu")
    assert caches[1]["k"].shape == (1, B, 16, 2, 24)
    assert caches[0]["conv"].shape == (1, B, 3, 64 + 2 * 2 * 8)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def test_prefill_matches_reference(setup):
    params, tokens, want = setup
    assert compare.logit_err(_prefill(params, tokens), want) < TOL


def test_serve_steps_match_reference(setup):
    """A prompt fed through the serve step a position a step, then greedy
    decode: the logits of every served position against the reference's
    full forward over the prompt and the served tokens."""
    params, tokens, _ = setup
    step = make_serve_step(CFG, "cpu")
    caches = tf.init_cache(CFG, B, 40, torch.float64, "cpu")
    P, new = 12, 10
    got = []
    for t in range(P):
        logits, _ = step(params, caches, {"tokens": tokens[:, t:t + 1]}, t)
    seq = [tokens[:, :P]]
    for t in range(P, P + new):
        got.append(logits)
        nxt = logits[:, -1].argmax(-1)[:, None]
        seq.append(nxt)
        logits, _ = step(params, caches, {"tokens": nxt}, t)
    got.append(logits)
    want = _reference(torch.cat(seq, 1))[:, P - 1:]
    assert compare.logit_err(torch.cat(got, 1), want) < TOL


def _fault(monkeypatch, name: str) -> None:
    call = tf._shared_call
    if name == "one_group":  # every head reads the first group of B and C
        split = ssm._split_bc
        monkeypatch.setattr(ssm, "_split_bc", lambda cfg, xbc: tuple(
            t[..., :1, :].expand(t.shape) for t in split(cfg, xbc)))
    elif name == "no_concat":  # the call reads concat(x, x), not concat(x, x0)
        monkeypatch.setattr(tf, "_shared_call", lambda cfg, p, c, x, x0, *a: call(
            cfg, p, c, x, x, *a))
    elif name == "no_adapter":
        monkeypatch.setattr(tf, "_shared_call", lambda cfg, p, c, x, x0, *a: call(
            cfg, p, {**c, "adapter_b": torch.zeros_like(c["adapter_b"])}, x, x0, *a))
    elif name == "no_projection":  # the call's linear left out
        monkeypatch.setattr(tf, "_shared_call", lambda cfg, p, c, x, x0, *a: call(
            cfg, p, {**c, "linear": torch.eye(c["linear"].shape[-1], dtype=x.dtype)}, x, x0,
            *a))
    elif name == "inner_residual":  # the call adds its input back, as a dense layer would
        monkeypatch.setattr(tf, "_shared_call", lambda cfg, p, c, x, x0, *a: call(
            cfg, p, c, x, x0, *a) + x)
    else:
        raise ValueError(name)


@pytest.mark.parametrize("name", ["one_group", "no_concat", "no_adapter", "no_projection",
                                  "inner_residual"])
def test_each_part_changed_alone_fails(setup, monkeypatch, name):
    params, tokens, want = setup
    _fault(monkeypatch, name)
    assert compare.logit_err(_prefill(params, tokens), want) > 100 * TOL


def test_presets_keep_the_jax_layout():
    """The published layout's settings are fields of ``HybridConfig`` alone:
    every registered preset keeps the JAX package's fields and reads one
    group, the ``attn_every`` plan and no adapter."""
    names = {f.name for f in dataclasses.fields(ArchConfig)}
    assert not names & {"ssm_groups", "hybrid_layer_ids", "adapter_rank"}
    for cfg in all_configs().values():
        assert type(cfg) is ArchConfig
        assert (cfg.ssm_groups, cfg.hybrid_layer_ids, cfg.adapter_rank) == (1, (), 0)
    params = tf.init_params(all_configs()["zamba2-7b"].reduced(), 0, torch.float32, "cpu")
    assert [b for b in params["blocks"] if "mamba" not in b] == [{}, {}]


def test_config_checks():
    with pytest.raises(ValueError, match="hybrid_layer_ids"):
        dataclasses.replace(CFG, hybrid_layer_ids=(2, 1))
    with pytest.raises(ValueError, match="groups"):
        dataclasses.replace(CFG, ssm_groups=3)
    assert isinstance(CFG, HybridConfig)
