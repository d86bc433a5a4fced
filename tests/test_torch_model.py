"""The port's dense transformer against the JAX package on bridged fp32
weights (reduced configs, CPU): forward at rtol = atol = 2e-3
(tests/test_models.py:111), decode against forward, decode against JAX
decode, the weight bridge, and the device rule."""
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


@pytest.mark.parametrize("arch", ["dbrx-132b", "musicgen-large", "internvl2-76b"])
def test_unported_kinds_raise(arch):
    cfg = get_config(arch).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item"):
        tf.init_params(cfg, device="cpu")


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
