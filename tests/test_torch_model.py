"""The port's transformer against the JAX package on bridged fp32 weights
(reduced configs, CPU): forward at rtol = atol = 2e-3
(tests/test_models.py:111), decode against forward, decode against JAX
decode, the weight bridge, and the device rule; the MoE kind (dbrx-132b,
grok-1-314b) and the patch and frame frontends (internvl2-76b,
musicgen-large) against JAX; every config's forward and decode step."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the machine with the card has no JAX

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _parity import jax_tree, numpy_params  # noqa: E402
from repro.configs import all_configs, get_config as jget  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import bridge, resolve_device  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.runtime import serve  # noqa: E402

TOL = dict(rtol=2e-3, atol=2e-3)
DENSE = ["qwen3-0.6b", "starcoder2-15b", "h2o-danube-3-4b", "gemma3-4b"]
ALL_ARCHS = sorted(all_configs())


def _setup(arch, seed):
    jcfg, cfg = jget(arch).reduced(), get_config(arch).reduced()
    tree = numpy_params(jcfg, seed)
    return jcfg, cfg, jax_tree(tree), bridge.params_from_numpy(tree, device="cpu")


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_jax(arch):
    jcfg, cfg, jp, tp = _setup(arch, seed=0)
    toks = _tokens(cfg, 2, 96, seed=1)  # 96 > reduced window 64
    want, _ = jtf.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    got, aux = tf.forward(cfg, tp, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, 96, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux["moe_aux"]) == 0.0


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "h2o-danube-3-4b"])
def test_forward_layers_in_parts_is_forward(arch):
    """A uniform dense stack run in two ranges of ``forward_layers`` and then
    ``final_logits`` (a pipeline's stage bodies) gives ``forward``'s logits
    bit for bit."""
    cfg = get_config(arch).reduced()
    params = bridge.params_from_numpy(numpy_params(jget(arch).reduced(), seed=2), device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 80, seed=4)).long()
    want, _ = tf.forward(cfg, params, {"tokens": toks})
    stack, L = params["blocks"][0], cfg.num_layers
    x = tf.embed(params["embed"], toks)
    x = tf.forward_layers(cfg, stack, 0, L // 2, x)
    x = tf.forward_layers(cfg, stack, L // 2, L, x)
    assert torch.equal(tf.final_logits(cfg, params, x), want)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward(arch):
    """Token-by-token decode reproduces the full-sequence logits; 80 steps
    wrap the ring buffer of the windowed layers (window 64)."""
    cfg = get_config(arch).reduced()
    params = bridge.params_from_numpy(numpy_params(jget(arch).reduced(), seed=3), device="cpu")
    S = 80 if cfg.attn in ("swa", "local_global") else 24
    toks = torch.from_numpy(_tokens(cfg, 1, S, seed=7)).long()
    full, _ = tf.forward(cfg, params, {"tokens": toks})
    cache = tf.init_cache(cfg, 1, max_len=S, dtype=torch.float32, device="cpu")
    outs = []
    for t in range(S):
        lg, cache = tf.decode_step(cfg, params, cache, {"tokens": toks[:, t:t + 1]}, t)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(), **TOL)


def test_decode_step_matches_jax():
    arch = "qwen3-0.6b"
    jcfg, cfg, jp, tp = _setup(arch, seed=5)
    B, L = 2, 16
    toks = _tokens(cfg, B, 6, seed=9)
    jcache = jtf.init_cache(jcfg, B, L, jnp.float32)
    tcache = tf.init_cache(cfg, B, L, torch.float32, "cpu")
    step = jax.jit(lambda p, c, b, pos: jtf.decode_step(jcfg, p, c, b, pos))
    for t in range(toks.shape[1]):
        want, jcache = step(jp, jcache, {"tokens": jnp.asarray(toks[:, t:t + 1])}, jnp.int32(t))
        got, tcache = tf.decode_step(cfg, tp, tcache,
                                     {"tokens": torch.from_numpy(toks[:, t:t + 1]).long()}, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for jc, tc in zip(jcache, tcache):
        for name in ("k", "v"):
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **TOL)


@pytest.mark.parametrize("arch,dtype", [(a, jnp.float32) for a in ALL_ARCHS]
                         + [("qwen3-0.6b", jnp.bfloat16)])
def test_bridge_round_trip_bit_equal(arch, dtype):
    """JAX -> torch -> numpy keeps every leaf's bits, for every reduced
    config's tree (layer stacks, the zamba2 ``shared`` list, lm_head)."""
    cfg = jget(arch).reduced()
    tree = jax.tree.map(np.asarray, jtf.init_params(cfg, jax.random.PRNGKey(0), dtype))
    back = bridge.params_to_numpy(bridge.params_from_numpy(tree, device="cpu"))
    flat_a, struct_a = jax.tree.flatten(tree)
    flat_b, struct_b = jax.tree.flatten(back)
    assert struct_a == struct_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_init_params_shapes_match_jax():
    jcfg, cfg = jget("qwen3-0.6b").reduced(), get_config("qwen3-0.6b").reduced()
    jshapes = jax.tree.map(lambda a: tuple(a.shape),
                           jax.eval_shape(lambda: jtf.init_params(jcfg, jax.random.PRNGKey(0),
                                                                  jnp.float32)))
    tp = tf.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    tshapes = jax.tree.map(lambda a: tuple(a.shape), bridge.params_to_numpy(tp))
    assert tshapes == jshapes
    again = tf.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    assert torch.equal(tp["embed"], again["embed"])  # seeded


def test_device_none_means_cuda():
    cfg = get_config("qwen3-0.6b").reduced()
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    calls = [
        lambda: tf.init_params(cfg),
        lambda: tf.init_cache(cfg, 1, 8),
        lambda: serve.make_prefill(cfg),
        lambda: serve.make_serve_step(cfg),
        lambda: serve.ServingEngine(cfg, {}),
        lambda: bridge.params_from_numpy({"a": np.zeros(2, np.float32)}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_rwkv6_builds_on_cpu():
    """rwkv6-7b is a ported kind: random params from a seed, a forward and a
    decode step run on the CPU with finite logits."""
    cfg = get_config("rwkv6-7b").reduced()
    params = tf.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 5, seed=0)).long()
    logits, aux = tf.forward(cfg, params, {"tokens": toks})
    assert logits.shape == (2, 5, cfg.vocab_size) and bool(torch.isfinite(logits).all())
    assert float(aux["moe_aux"]) == 0.0
    cache = tf.init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    lg, out = tf.decode_step(cfg, params, cache, {"tokens": toks[:, :1]}, 0)
    assert out is cache and lg.shape == (2, 1, cfg.vocab_size)
    assert bool(torch.isfinite(lg).all())


def test_zamba2_init_params_builds_jax_tree():
    """zamba2-7b is a ported kind: ``init_params`` builds the JAX tree's
    structure and shapes (stacked mamba blocks, ``{}`` for each shared_attn
    occurrence, ``params["shared"]`` with the unstacked shared blocks), and a
    forward and a decode step run on the CPU with finite logits."""
    jcfg, cfg = jget("zamba2-7b").reduced(), get_config("zamba2-7b").reduced()
    jshapes = jax.tree.map(lambda a: tuple(a.shape),
                           jax.eval_shape(lambda: jtf.init_params(jcfg, jax.random.PRNGKey(0),
                                                                  jnp.float32)))
    params = tf.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), bridge.params_to_numpy(params)) == jshapes
    assert [sorted(b) for b in params["blocks"]] == [["mamba", "norm"], [],
                                                     ["mamba", "norm"], []]
    assert len(params["shared"]) == jcfg.n_shared_attn
    toks = torch.from_numpy(_tokens(cfg, 2, 5, seed=0)).long()
    logits, _ = tf.forward(cfg, params, {"tokens": toks})
    assert logits.shape == (2, 5, cfg.vocab_size) and bool(torch.isfinite(logits).all())
    cache = tf.init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    lg, out = tf.decode_step(cfg, params, cache, {"tokens": toks[:, :1]}, 0)
    assert out is cache and bool(torch.isfinite(lg).all())


# ------------------------------------------ moe kind, patch and frame frontends --
FRONTIER = ["dbrx-132b", "grok-1-314b", "internvl2-76b", "musicgen-large"]


def _batch(cfg, b, s, seed, patch=True):
    """numpy inputs as tests/test_models.py:make_batch draws them: tokens, or
    0.02 N(0, 1) frame embeddings, plus a patch prefix for ``patch_embed``."""
    r = np.random.default_rng(seed)
    if cfg.frontend == "frame_embed":
        return {"frame_embeds": (0.02 * r.standard_normal((b, s, cfg.d_model))).astype(np.float32)}
    batch = {"tokens": r.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.frontend == "patch_embed" and patch:
        batch["patch_embeds"] = (0.02 * r.standard_normal((b, cfg.n_prefix_embeds, cfg.d_model))
                                 ).astype(np.float32)
    return batch


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if k == "tokens" else torch.from_numpy(v)
            for k, v in batch.items()}


@pytest.mark.parametrize("arch,patch", [(a, True) for a in FRONTIER]
                         + [("internvl2-76b", False)])
def test_frontier_forward_matches_jax(arch, patch):
    """Logits and moe_aux at 2e-3; 2 x 40 tokens are one dispatch group of 80
    (moe_group 64 reduced: gl 80 after the split, C 50)."""
    jcfg, cfg, jp, tp = _setup(arch, seed=0)
    batch = _batch(cfg, 2, 40, seed=1, patch=patch)
    want, waux = jtf.forward(jcfg, jp, _jax_batch(batch))
    got, aux = tf.forward(cfg, tp, _torch_batch(batch))
    assert got.shape == (2, 40, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux["moe_aux"]), float(waux["moe_aux"]), **TOL)
    assert (float(aux["moe_aux"]) > 0) == (cfg.family == "moe")
    assert aux["moe_dropped"].dtype == torch.int64 and int(aux["moe_dropped"]) >= 0


def test_moe_forward_counts_dropped_pairs():
    """``moe_dropped`` is the sum over layers of the (token, k) pairs each
    layer's routing dropped; a prompt shorter than the capacity floor 4
    drops none."""
    _, cfg, _, tp = _setup("dbrx-132b", seed=0)
    toks = torch.from_numpy(_tokens(cfg, 1, 4, seed=2)).long()
    assert int(tf.forward(cfg, tp, {"tokens": toks})[1]["moe_dropped"]) == 0
    same = torch.full((2, 64), 7, dtype=torch.long)  # one token everywhere: one queue
    _, aux = tf.forward(cfg, tp, {"tokens": same})
    assert int(aux["moe_dropped"]) > 0


@pytest.mark.parametrize("arch", FRONTIER)
def test_frontier_decode_step_matches_jax(arch):
    """Logits and k/v caches after each of 6 steps at batch 2 (both lanes
    in one dispatch group at MoE layers, as in JAX); internvl2 decodes
    tokens, musicgen frame embeddings."""
    jcfg, cfg, jp, tp = _setup(arch, seed=5)
    B, L, S = 2, 16, 6
    batch = _batch(cfg, B, S, seed=9, patch=False)
    jcache = jtf.init_cache(jcfg, B, L, jnp.float32)
    tcache = tf.init_cache(cfg, B, L, torch.float32, "cpu")
    step = jax.jit(lambda p, c, b, pos: jtf.decode_step(jcfg, p, c, b, pos))
    for t in range(S):
        bt = {k: v[:, t:t + 1] for k, v in batch.items()}
        want, jcache = step(jp, jcache, _jax_batch(bt), jnp.int32(t))
        got, tcache = tf.decode_step(cfg, tp, tcache, _torch_batch(bt), t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for jc, tc in zip(jcache, tcache):
        for name in ("k", "v"):
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **TOL)


@pytest.mark.parametrize("arch", FRONTIER)
def test_frontier_decode_matches_forward(arch):
    """Token-by-token decode reproduces the forward: musicgen on frame
    embeddings (as tests/test_models.py:72-76 holds it), internvl2 on tokens
    (decode never sees a patch prefix), dbrx and grok on a prompt of 4, the
    capacity floor, where the forward's one group of 4 can drop nothing
    (a longer prompt drops pairs at prefill that decode, one token a group,
    never does: why the reference leaves MoE out)."""
    cfg = get_config(arch).reduced()
    params = bridge.params_from_numpy(numpy_params(jget(arch).reduced(), seed=3), device="cpu")
    S = 4 if cfg.family == "moe" else 24
    batch = _torch_batch(_batch(cfg, 1, S, seed=7, patch=False))
    full, aux = tf.forward(cfg, params, batch)
    assert int(aux["moe_dropped"]) == 0
    cache = tf.init_cache(cfg, 1, max_len=S, dtype=torch.float32, device="cpu")
    outs = []
    for t in range(S):
        lg, cache = tf.decode_step(cfg, params, cache,
                                   {k: v[:, t:t + 1] for k, v in batch.items()}, t)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(), **TOL)


def test_vlm_prefix_embeds_change_output():
    """The twin of tests/test_models.py:116: the patch prefix reaches the
    logits, at its own positions and (through attention) after them; a
    prefix longer than the sequence is ignored, as at decode."""
    cfg = get_config("internvl2-76b").reduced()
    params = tf.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    assert params["patch_proj"].shape == (cfg.d_model, cfg.d_model)
    batch = _torch_batch(_batch(cfg, 1, 32, seed=0))
    l1, _ = tf.forward(cfg, params, batch)
    l2, _ = tf.forward(cfg, params, {**batch, "patch_embeds": batch["patch_embeds"] + 1.0})
    assert float((l1 - l2).abs().max()) > 1e-4
    P = cfg.n_prefix_embeds
    assert float((l1[:, P:] - l2[:, P:]).abs().max()) > 1e-4
    short = {"tokens": batch["tokens"][:, :P - 1]}
    np.testing.assert_array_equal(
        tf.forward(cfg, params, {**short, "patch_embeds": batch["patch_embeds"]})[0].numpy(),
        tf.forward(cfg, params, short)[0].numpy())


def test_init_params_builds_jax_tree_for_every_config():
    for arch in ALL_ARCHS:
        jcfg, cfg = jget(arch).reduced(), get_config(arch).reduced()
        jshapes = jax.tree.map(lambda a: tuple(a.shape),
                               jax.eval_shape(lambda: jtf.init_params(
                                   jcfg, jax.random.PRNGKey(0), jnp.float32)))
        tp = tf.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
        assert jax.tree.map(lambda a: tuple(a.shape), bridge.params_to_numpy(tp)) == jshapes


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_config_forward_shapes_and_finite(arch):
    """The twin of TestArchSmoke.test_forward_shapes_and_finite
    (tests/test_models.py:30): the port's own seeded init, B 2, S 64."""
    cfg = get_config(arch).reduced()
    params = tf.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    logits, aux = tf.forward(cfg, params, _torch_batch(_batch(cfg, 2, 64, seed=0)))
    assert logits.shape == (2, 64, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert bool(torch.isfinite(aux["moe_aux"]))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_config_decode_step_shapes(arch):
    """The twin of TestArchSmoke.test_decode_step_shapes
    (tests/test_models.py:62)."""
    cfg = get_config(arch).reduced()
    params = tf.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    cache = tf.init_cache(cfg, 2, max_len=128, dtype=torch.float32, device="cpu")
    logits, out = tf.decode_step(cfg, params, cache, _torch_batch(_batch(cfg, 2, 1, seed=0)), 0)
    assert out is cache and logits.shape == (2, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
