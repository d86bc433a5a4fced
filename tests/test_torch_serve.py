"""The port's serving entry points against the JAX package's on reduced
configs with bridged fp32 weights: prefill logits, the serve step, and the
continuous-batching engine's greedy tokens (qwen3-0.6b, rwkv6-7b; the patch
and frame frontends of internvl2-76b and musicgen-large; dbrx-132b, whose
MoE layers route the engine's lanes together)."""
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


# -------------------------------------- frontends and MoE lanes in the engine --
VLM, AUDIO, MOE = "internvl2-76b", "musicgen-large", "dbrx-132b"


def _embeds(cfg, b, s, seed):
    return (0.02 * np.random.default_rng(seed).standard_normal((b, s, cfg.d_model))
            ).astype(np.float32)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_make_prefill_takes_embeddings(arch):
    """``make_prefill`` passes ``patch_embeds`` and ``frame_embeds`` through,
    in their dtype, as JAX's does."""
    jcfg, cfg, jp, tp = _setup(seed=0, arch=arch)
    if arch == AUDIO:
        batch = {"frame_embeds": _embeds(cfg, 2, 24, seed=1)}
    else:
        batch = {"tokens": np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24)
                                                             ).astype(np.int32),
                 "patch_embeds": _embeds(cfg, 2, cfg.n_prefix_embeds, seed=2)}
    want = jserve.make_prefill(jcfg)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got = serve.make_prefill(cfg, device="cpu")(tp, batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if arch == VLM:  # the prefix was used
        plain = serve.make_prefill(cfg, device="cpu")(tp, {"tokens": batch["tokens"]})
        assert float((plain - got).abs().max()) > 1e-4


def test_make_serve_step_takes_frame_embeds():
    jcfg, cfg, jp, tp = _setup(seed=2, arch=AUDIO)
    frames = _embeds(cfg, 2, 5, seed=3)
    jstep, tstep = jserve.make_serve_step(jcfg), serve.make_serve_step(cfg, device="cpu")
    jc = jtf.init_cache(jcfg, 2, 8, jnp.float32)
    tc = tf.init_cache(cfg, 2, 8, torch.float32, "cpu")
    for t in range(frames.shape[1]):
        want, jc = jstep(jp, jc, {"frame_embeds": jnp.asarray(frames[:, t:t + 1])},
                         jnp.int32(t))
        got, tc = tstep(tp, tc, {"frame_embeds": frames[:, t:t + 1]}, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _requests(cfg, n, seed=5):
    r = np.random.default_rng(seed)
    lengths = [3, 5, 2, 4, 6, 3, 4, 2, 5, 3][:n]
    prompts = [list(map(int, r.integers(1, cfg.vocab_size, k))) for k in lengths]
    return prompts, [4, 6, 3, 5, 4, 7, 3, 5, 6, 4][:n]


@pytest.mark.parametrize("arch", [MOE, VLM])
def test_frontier_engine_tokens_match_jax(arch):
    """6 requests over 4 slots; greedy ids equal the JAX engine's. At 4 slots
    an MoE layer's capacity (at least 4) holds every lane's pairs, so the
    lanes could not disturb each other even if decoded apart."""
    jcfg, cfg, jp, tp = _setup(seed=4, out_scale=4.0, arch=arch)
    prompts, new_tokens = _requests(cfg, 6)
    want, want_pos = _drive(jserve.ServingEngine(jcfg, jp, batch_slots=4, max_len=32),
                            prompts, new_tokens)
    got, got_pos = _drive(serve.ServingEngine(cfg, tp, batch_slots=4, max_len=32,
                                              device="cpu"), prompts, new_tokens)
    assert got == want
    assert got_pos == want_pos
    assert len({t for g, _ in got.values() for t in g}) > 3  # tokens really vary


def test_moe_engine_at_8_slots_matches_jax():
    """At 8 slots the 8 lanes' tokens (all fed the stepped lane's token) fill
    one dispatch group past its capacity (reduced dbrx: C 5 for 16 pairs),
    so lane i's output depends on the other lanes, as in the JAX engine,
    which decodes them all. The port's engine does the same and gives JAX's
    ids; decoding each lane alone gives other ids."""
    jcfg, cfg, jp, tp = _setup(seed=4, out_scale=4.0, arch=MOE)
    prompts, new_tokens = _requests(cfg, 10)
    want, _ = _drive(jserve.ServingEngine(jcfg, jp, batch_slots=8, max_len=32),
                     prompts, new_tokens)
    got, _ = _drive(serve.ServingEngine(cfg, tp, batch_slots=8, max_len=32, device="cpu"),
                    prompts, new_tokens)
    assert got == want
    alone = serve.ServingEngine(cfg, tp, batch_slots=8, max_len=32, device="cpu")
    alone._lanes_share_routing = False  # each lane its own group, as a dense model decodes
    assert _drive(alone, prompts, new_tokens)[0] != want


def test_moe_engine_writes_only_its_lane():
    _, cfg, _, tp = _setup(seed=6, arch=MOE)
    eng = serve.ServingEngine(cfg, tp, batch_slots=3, max_len=16, device="cpu")
    eng.submit([5, 6, 7], max_new_tokens=1)
    eng._admit()  # slot 0 holds its 3 prompt tokens; the other lanes stay as they were
    for cache in eng.caches:
        for k, c in cache.items():
            assert not torch.equal(c[:, 0, :3], torch.zeros_like(c[:, 0, :3]))
            assert torch.equal(c[:, 1:], torch.zeros_like(c[:, 1:]))
