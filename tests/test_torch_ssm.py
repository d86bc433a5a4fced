"""The port's Mamba2 block and the zamba2 hybrid stack (zamba2-7b, reduced:
4 mamba layers, 2 shared attention blocks over 2 occurrences) against the
JAX package on bridged fp32 weights, on the CPU: the block's pieces, its
forward and its decode step (output and both cache leaves, written in
place), the param and cache trees, the model's forward at rtol = atol = 2e-3
(tests/test_models.py:111), decode against JAX decode and against forward
(the reference holds zamba2 to 2e-3 on logits, tests/test_models.py:72-114),
and the serving entry points: prefill, serve step and the engine's greedy
token ids, with more requests than slots."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the machine with the card has no JAX

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _parity import jax_tree, numpy_params  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.runtime import serve as jserve  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.runtime import serve  # noqa: E402

ARCH = "zamba2-7b"
TOL = dict(rtol=2e-3, atol=2e-3)
# one mamba layer's fp32 ops in another order; the forward's chunked scan
# (chunk 128) takes differences of cumulative log decays of size ~50, so its
# outputs carry ~1e-5 relative rounding
PIECE_TOL = dict(rtol=1e-4, atol=1e-4)


def _setup(seed, out_scale=1.0):
    jcfg, cfg = jget(ARCH).reduced(), get_config(ARCH).reduced()
    tree = numpy_params(jcfg, seed, out_scale=out_scale)
    return jcfg, cfg, jax_tree(tree), bridge.params_from_numpy(tree, device="cpu")


def _mamba0(jp, tp):
    """The first layer's mamba params of both trees."""
    return (jax.tree.map(lambda a: a[0], jp["blocks"][0]["mamba"]),
            {k: v[0] for k, v in tp["blocks"][0]["mamba"].items()})


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_reduced_plan_has_both_kinds():
    cfg = get_config(ARCH).reduced()
    assert [(b.kind, b.n, b.shared_idx) for b in tf.layer_plan(cfg)] == [
        ("mamba", 2, -1), ("shared_attn", 1, 0), ("mamba", 2, -1), ("shared_attn", 1, 1)]
    assert (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state) == (8, 32, 16)


def test_causal_conv_and_softplus_match_jax():
    jcfg, cfg, jp, tp = _setup(seed=0)
    jl, tl = _mamba0(jp, tp)
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    xbc = _normal((2, 9, conv_dim), 1)
    b = _normal((conv_dim,), 2)  # the init's bias is zero; test a nonzero one
    _close(ssm._causal_conv(torch.from_numpy(xbc), tl["conv_w"], torch.from_numpy(b)),
           jssm._causal_conv(jnp.asarray(xbc), jl["conv_w"], jnp.asarray(b)), PIECE_TOL)
    x = np.array([-30.0, -1.0, 0.0, 0.5, 19.0, 20.5, 40.0], np.float32)
    np.testing.assert_array_equal(ssm._softplus(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.nn.softplus(jnp.asarray(x))))


def test_mamba_forward_matches_jax():
    jcfg, cfg, jp, tp = _setup(seed=1)
    jl, tl = _mamba0(jp, tp)
    x = _normal((2, 40, cfg.d_model), 3)
    ssd_kernel.launches = 0
    got = ssm.mamba_forward(tl, cfg, torch.from_numpy(x))
    assert ssd_kernel.launches == 0  # CPU tensors take ssd_chunked
    assert got.shape == x.shape
    _close(got, jssm.mamba_forward(jl, jcfg, jnp.asarray(x)), PIECE_TOL)


def test_mamba_decode_step_matches_jax_in_place():
    """Output and both cache leaves from a nonzero cache; the new ``conv``
    and ``ssm`` are written into the tensors given."""
    jcfg, cfg, jp, tp = _setup(seed=2)
    jl, tl = _mamba0(jp, tp)
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    x = _normal((2, 1, cfg.d_model), 4)
    conv = _normal((2, cfg.ssm_conv - 1, conv_dim), 5, 0.5)
    state = _normal((2, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim), 6, 0.5)
    want, jcache = jssm.mamba_decode_step(jl, jcfg, jnp.asarray(x),
                                          {"conv": jnp.asarray(conv), "ssm": jnp.asarray(state)})
    cache = {"conv": torch.from_numpy(conv.copy()), "ssm": torch.from_numpy(state.copy())}
    leaves = dict(cache)
    got = ssm.mamba_decode_step(tl, cfg, torch.from_numpy(x), cache)
    assert all(cache[k] is leaves[k] for k in cache)
    _close(got, want, PIECE_TOL)
    for k in ("conv", "ssm"):
        _close(cache[k], jcache[k], PIECE_TOL)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["fp32", "bf16"])
def test_init_params_and_cache_match_jax(dtype):
    """Same tree structure, shapes and leaf dtypes as the JAX package's (the
    mamba ``A_log``, ``dt_bias``, ``D`` and the ``ssm`` state stay fp32), with
    ``params["shared"]`` holding the unstacked shared blocks."""
    jcfg, cfg = jget(ARCH).reduced(), get_config(ARCH).reduced()
    tdtype = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype]

    def spec(tree):
        return jax.tree.map(lambda a: (tuple(a.shape), np.dtype(a.dtype).name), tree)

    jparams = jax.eval_shape(lambda: jtf.init_params(jcfg, jax.random.PRNGKey(0), dtype))
    tparams = tf.init_params(cfg, seed=0, dtype=tdtype, device="cpu")
    assert spec(bridge.params_to_numpy(tparams)) == spec(jparams)
    assert len(tparams["shared"]) == 2 and tparams["blocks"][1] == {} == tparams["blocks"][3]
    assert tparams["shared"][0]["attn"]["wq"].dim() == 3  # unstacked
    jcache = jax.eval_shape(lambda: jtf.init_cache(jcfg, 3, 16, dtype))
    tcache = tf.init_cache(cfg, 3, 16, tdtype, "cpu")
    assert spec(bridge.params_to_numpy(tcache)) == spec(jcache)


def test_forward_matches_jax():
    jcfg, cfg, jp, tp = _setup(seed=0)
    toks = _tokens(cfg, 2, 96, seed=1)
    want, _ = jtf.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    ssd_kernel.launches = fa_kernel.launches = 0
    got, aux = tf.forward(cfg, tp, {"tokens": torch.from_numpy(toks).long()})
    assert ssd_kernel.launches == fa_kernel.launches == 0
    assert got.shape == (2, 96, cfg.vocab_size)
    _close(got, want, TOL)
    assert float(aux["moe_aux"]) == 0.0


def test_decode_step_matches_jax():
    """Logits and every cache leaf (mamba conv and ssm, each shared
    occurrence's k and v) after every step."""
    jcfg, cfg, jp, tp = _setup(seed=5)
    B, L = 2, 16
    toks = _tokens(cfg, B, 6, seed=9)
    jcache = jtf.init_cache(jcfg, B, L, jnp.float32)
    tcache = tf.init_cache(cfg, B, L, torch.float32, "cpu")
    step = jax.jit(lambda p, c, b, pos: jtf.decode_step(jcfg, p, c, b, pos))
    for t in range(toks.shape[1]):
        want, jcache = step(jp, jcache, {"tokens": jnp.asarray(toks[:, t:t + 1])}, jnp.int32(t))
        got, out = tf.decode_step(cfg, tp, tcache,
                                  {"tokens": torch.from_numpy(toks[:, t:t + 1]).long()}, t)
        assert out is tcache
        _close(got, want, TOL)
        for jc, tc in zip(jcache, tcache):
            assert set(jc) == set(tc)
            for name in tc:
                _close(tc[name], jc[name], TOL)


def test_decode_matches_forward():
    """tests/test_models.py:72-114 for zamba2: token-by-token decode
    reproduces the full-sequence logits at rtol = atol = 2e-3."""
    cfg = get_config(ARCH).reduced()
    params = bridge.params_from_numpy(numpy_params(jget(ARCH).reduced(), seed=3), device="cpu")
    S = 24
    toks = torch.from_numpy(_tokens(cfg, 1, S, seed=7)).long()
    full, _ = tf.forward(cfg, params, {"tokens": toks})
    cache = tf.init_cache(cfg, 1, max_len=S, dtype=torch.float32, device="cpu")
    outs = []
    for t in range(S):
        lg, cache = tf.decode_step(cfg, params, cache, {"tokens": toks[:, t:t + 1]}, t)
        outs.append(lg[:, 0])
    _close(torch.stack(outs, 1), full.numpy(), TOL)


# ---------------------------------------------------------------- serving --
def test_make_prefill_matches_jax():
    jcfg, cfg, jp, tp = _setup(seed=0)
    toks = _tokens(cfg, 3, 40, seed=1)
    want = jserve.make_prefill(jcfg)(jp, {"tokens": jnp.asarray(toks)})
    ssd_kernel.launches = 0
    got = serve.make_prefill(cfg, device="cpu")(tp, {"tokens": toks})
    assert ssd_kernel.launches == 0  # CPU tensors take the plain versions
    _close(got, want, TOL)


def test_make_serve_step_matches_jax():
    jcfg, cfg, jp, tp = _setup(seed=2)
    toks = _tokens(cfg, 2, 5, seed=3)
    jstep, tstep = jserve.make_serve_step(jcfg), serve.make_serve_step(cfg, device="cpu")
    jc = jtf.init_cache(jcfg, 2, 8, jnp.float32)
    tc = tf.init_cache(cfg, 2, 8, torch.float32, "cpu")
    for t in range(toks.shape[1]):
        want, jc = jstep(jp, jc, {"tokens": jnp.asarray(toks[:, t:t + 1])}, jnp.int32(t))
        got, tc = tstep(tp, tc, {"tokens": toks[:, t:t + 1]}, t)
        _close(got, want, TOL)


def _drive(engine, prompts, new_tokens):
    for p, n in zip(prompts, new_tokens):
        engine.submit(p, max_new_tokens=n)
    done = engine.run_until_drained()
    return {r.rid: (r.generated, r.done) for r in done}, engine.pos


def test_engine_tokens_match_jax():
    """6 requests over 2 slots: each reused slot starts from the mamba state
    its previous request left (the JAX engine resets the position, not the
    lane), and the greedy ids equal the JAX engine's."""
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
    kinds = [set(c) for c in eng.caches]
    assert kinds == [{"conv", "ssm"}, {"k", "v"}, {"conv", "ssm"}, {"k", "v"}]
    for b, c in zip(before, eng.caches):
        for k in c:
            assert torch.equal(c[k][:, 1:], b[k][:, 1:])
            assert not torch.equal(c[k][:, 0], b[k][:, 0])
