"""The port's serving entry points against the JAX package's on reduced
qwen3-0.6b and rwkv6-7b with bridged fp32 weights: prefill logits, the
serve step, and the continuous-batching engine's greedy tokens."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the machine with the card has no JAX

import jax.numpy as jnp  # noqa: E402

from _parity import jax_tree, numpy_params  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.runtime import serve as jserve  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel  # noqa: E402
from repro_torch.kernels.rwkv6 import kernel as wkv6_kernel  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.runtime import serve  # noqa: E402

ARCH = "qwen3-0.6b"
RWKV = "rwkv6-7b"
TOL = dict(rtol=2e-3, atol=2e-3)


def _setup(seed, out_scale=1.0, arch=ARCH):
    tree = numpy_params(jget(arch).reduced(), seed, out_scale=out_scale)
    return (jget(arch).reduced(), get_config(arch).reduced(), jax_tree(tree),
            bridge.params_from_numpy(tree, device="cpu"))


def test_make_prefill_matches_jax():
    jcfg, cfg, jp, tp = _setup(seed=0)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 40)).astype(np.int32)
    want = jserve.make_prefill(jcfg)(jp, {"tokens": jnp.asarray(toks)})
    kernel.launches = 0
    got = serve.make_prefill(cfg, device="cpu")(tp, {"tokens": toks})
    assert kernel.launches == 0  # CPU tensors take the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_make_serve_step_matches_jax():
    jcfg, cfg, jp, tp = _setup(seed=2)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 5)).astype(np.int32)
    jstep, tstep = jserve.make_serve_step(jcfg), serve.make_serve_step(cfg, device="cpu")
    jc = jtf.init_cache(jcfg, 2, 8, jnp.float32)
    tc = tf.init_cache(cfg, 2, 8, torch.float32, "cpu")
    for t in range(toks.shape[1]):
        want, jc = jstep(jp, jc, {"tokens": jnp.asarray(toks[:, t:t + 1])}, jnp.int32(t))
        got, tc = tstep(tp, tc, {"tokens": toks[:, t:t + 1]}, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _drive(engine, prompts, new_tokens):
    for p, n in zip(prompts, new_tokens):
        engine.submit(p, max_new_tokens=n)
    done = engine.run_until_drained()
    return {r.rid: (r.generated, r.done) for r in done}, engine.pos


def test_engine_tokens_match_jax():
    """6 requests over 2 slots: slot reuse, uneven lengths, the re-fed last
    prompt token; greedy ids must equal the JAX engine's."""
    jcfg, cfg, jp, tp = _setup(seed=4, out_scale=4.0)
    r = np.random.default_rng(5)
    prompts = [list(map(int, r.integers(1, cfg.vocab_size, n))) for n in (3, 5, 2, 4, 6, 3)]
    new_tokens = [4, 6, 3, 5, 4, 7]
    want, want_pos = _drive(jserve.ServingEngine(jcfg, jp, batch_slots=2, max_len=32),
                            prompts, new_tokens)
    eng = serve.ServingEngine(cfg, tp, batch_slots=2, max_len=32, device="cpu")
    got, got_pos = _drive(eng, prompts, new_tokens)
    assert got == want
    assert got_pos == want_pos
    assert [len(got[i][0]) for i in range(6)] == new_tokens
    assert len({t for g, _ in got.values() for t in g}) > 3  # tokens really vary


def test_engine_writes_only_its_lane():
    _, cfg, _, tp = _setup(seed=6)
    eng = serve.ServingEngine(cfg, tp, batch_slots=3, max_len=16, device="cpu")
    before = [{k: c.clone() for k, c in cache.items()} for cache in eng.caches]
    eng.submit([5, 6, 7], max_new_tokens=1)
    eng._admit()  # admitted into slot 0 only
    for b, c in zip(before, eng.caches):
        for k in c:
            assert torch.equal(c[k][:, 1:], b[k][:, 1:])
            assert not torch.equal(c[k][:, 0], b[k][:, 0])


# ------------------------------------------------------------------ rwkv6-7b --
def test_rwkv_make_prefill_matches_jax():
    jcfg, cfg, jp, tp = _setup(seed=0, arch=RWKV)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 40)).astype(np.int32)
    want = jserve.make_prefill(jcfg)(jp, {"tokens": jnp.asarray(toks)})
    wkv6_kernel.launches = 0
    got = serve.make_prefill(cfg, device="cpu")(tp, {"tokens": toks})
    assert wkv6_kernel.launches == 0  # CPU tensors take the plain versions
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rwkv_make_serve_step_matches_jax():
    """Logits and the three rwkv cache leaves after every step."""
    jcfg, cfg, jp, tp = _setup(seed=2, arch=RWKV)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 5)).astype(np.int32)
    jstep, tstep = jserve.make_serve_step(jcfg), serve.make_serve_step(cfg, device="cpu")
    jc = jtf.init_cache(jcfg, 2, 8, jnp.float32)
    tc = tf.init_cache(cfg, 2, 8, torch.float32, "cpu")
    for t in range(toks.shape[1]):
        want, jc = jstep(jp, jc, {"tokens": jnp.asarray(toks[:, t:t + 1])}, jnp.int32(t))
        got, tc = tstep(tp, tc, {"tokens": toks[:, t:t + 1]}, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for jcache, tcache in zip(jc, tc):
            for name in ("shift_tm", "shift_cm", "wkv"):
                np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]), **TOL)


def test_rwkv_engine_tokens_match_jax():
    """6 requests over 2 slots: each reused slot starts from the state its
    previous request left (the JAX engine resets the position, not the rwkv
    lane), and the greedy ids equal the JAX engine's."""
    jcfg, cfg, jp, tp = _setup(seed=4, out_scale=4.0, arch=RWKV)
    r = np.random.default_rng(5)
    prompts = [list(map(int, r.integers(1, cfg.vocab_size, n))) for n in (3, 5, 2, 4, 6, 3)]
    new_tokens = [4, 6, 3, 5, 4, 7]
    want, want_pos = _drive(jserve.ServingEngine(jcfg, jp, batch_slots=2, max_len=32),
                            prompts, new_tokens)
    eng = serve.ServingEngine(cfg, tp, batch_slots=2, max_len=32, device="cpu")
    got, got_pos = _drive(eng, prompts, new_tokens)
    assert got == want
    assert got_pos == want_pos
    assert [len(got[i][0]) for i in range(6)] == new_tokens
    assert len({t for g, _ in got.values() for t in g}) > 3  # tokens really vary
    fresh, _ = _drive(serve.ServingEngine(cfg, tp, batch_slots=6, max_len=32, device="cpu"),
                      prompts, new_tokens)
    assert fresh[0] == got[0] and fresh[1] == got[1]  # first in their slots: same state
    assert any(fresh[i] != got[i] for i in range(2, 6))  # the carried state shows


def test_rwkv_engine_writes_only_its_lane():
    _, cfg, _, tp = _setup(seed=6, arch=RWKV)
    eng = serve.ServingEngine(cfg, tp, batch_slots=3, max_len=16, device="cpu")
    before = [{k: c.clone() for k, c in cache.items()} for cache in eng.caches]
    eng.submit([5, 6, 7], max_new_tokens=1)
    eng._admit()  # admitted into slot 0 only
    for b, c in zip(before, eng.caches):
        assert set(c) == {"shift_tm", "shift_cm", "wkv"}
        for k in c:
            assert torch.equal(c[k][:, 1:], b[k][:, 1:])
            assert not torch.equal(c[k][:, 0], b[k][:, 0])
