"""The port's rwkv model (rwkv6-7b, reduced) against the JAX package on
bridged fp32 weights, on the CPU: the time-mix pieces, the block functions
with a nonzero shift and state, the forward at rtol = atol = 2e-3
(tests/test_models.py:111), decode against JAX decode (logits and every
cache leaf) and decode against forward under the reference's ssm criterion
(tests/test_models.py:97-109).

The forward agrees with JAX because both take the chunked wkv6 form on the
CPU for s > 1; the chunked form leaves its regime at this init (a few
channels' 16-step log decay falls below -60), so it is not the sequential
recurrence there, and decode (sequential) is held to forward only by the
ssm criterion."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the machine with the card has no JAX

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _parity import jax_tree, numpy_params  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.rwkv6 import kernel  # noqa: E402
from repro_torch.models import rwkv  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

ARCH = "rwkv6-7b"
TOL = dict(rtol=2e-3, atol=2e-3)
PIECE_TOL = dict(rtol=1e-5, atol=1e-5)  # one layer's fp32 ops in another order


def _setup(seed):
    jcfg, cfg = jget(ARCH).reduced(), get_config(ARCH).reduced()
    tree = numpy_params(jcfg, seed)
    return jcfg, cfg, jax_tree(tree), bridge.params_from_numpy(tree, device="cpu")


def _layer0(jp, tp):
    """The first layer's time-mix params of both trees."""
    return (jax.tree.map(lambda a: a[0], jp["blocks"][0]["tm"]),
            {k: v[0] for k, v in tp["blocks"][0]["tm"].items()})


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_ddlerp_decay_group_norm_match_jax():
    jcfg, cfg, jp, tp = _setup(seed=0)
    jl, tl = _layer0(jp, tp)
    x, xx = _normal((2, 7, cfg.d_model), 1), _normal((2, 7, cfg.d_model), 2)
    want = jrwkv._ddlerp(jl, jnp.asarray(x), jnp.asarray(xx))
    got = rwkv._ddlerp(tl, torch.from_numpy(x), torch.from_numpy(xx))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _close(g, w, PIECE_TOL)
    w_tm = rwkv._decay(tl, got[3])
    assert w_tm.dtype == torch.float32
    assert float(w_tm.min()) > 0.0 and float(w_tm.max()) < 1.0
    _close(w_tm, jrwkv._decay(jl, want[3]), PIECE_TOL)
    H = cfg.d_model // cfg.ssm_head_dim
    y = _normal((2, 7, cfg.d_model), 3, scale=0.01)  # small spread: eps matters
    scale = _normal((cfg.d_model,), 4) + 1.0
    _close(rwkv._group_norm(torch.from_numpy(y), torch.from_numpy(scale), H),
           jrwkv._group_norm(jnp.asarray(y), jnp.asarray(scale), H), PIECE_TOL)


@pytest.mark.parametrize("s", [1, 9])
def test_time_mix_matches_jax(s):
    """Nonzero shift and state; s = 1 takes the sequential wkv6, s = 9 the
    chunked form, in both packages. The state given is not changed."""
    jcfg, cfg, jp, tp = _setup(seed=1)
    jl, tl = _layer0(jp, tp)
    H, P = cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim
    x, shift = _normal((2, s, cfg.d_model), 5), _normal((2, cfg.d_model), 6)
    state = _normal((2, H, P, P), 7, scale=0.5)
    want = jrwkv.rwkv_time_mix(jl, jcfg, *map(jnp.asarray, (x, shift, state)))
    tstate = torch.from_numpy(state.copy())
    got = rwkv.rwkv_time_mix(tl, cfg, *map(torch.from_numpy, (x, shift)), tstate)
    for g, w in zip(got, want):
        _close(g, w, TOL)
    assert np.array_equal(tstate.numpy(), state)


def test_time_mix_state_out_in_place():
    _, cfg, jp, tp = _setup(seed=2)
    _, tl = _layer0(jp, tp)
    H, P = cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim
    x, shift = _normal((1, 1, cfg.d_model), 8), _normal((1, cfg.d_model), 9)
    state = torch.from_numpy(_normal((1, H, P, P), 10, scale=0.5))
    want = rwkv.rwkv_time_mix(tl, cfg, torch.from_numpy(x), torch.from_numpy(shift),
                              state.clone())
    got = rwkv.rwkv_time_mix(tl, cfg, torch.from_numpy(x), torch.from_numpy(shift), state,
                             state_out=state)
    assert got[2] is state
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_channel_mix_matches_jax():
    jcfg, cfg, jp, tp = _setup(seed=3)
    jl, tl = _layer0(jp, tp)
    x, shift = _normal((2, 6, cfg.d_model), 11), _normal((2, cfg.d_model), 12)
    want = jrwkv.rwkv_channel_mix(jl, jcfg, jnp.asarray(x), jnp.asarray(shift))
    got = rwkv.rwkv_channel_mix(tl, cfg, torch.from_numpy(x), torch.from_numpy(shift))
    for g, w in zip(got, want):
        _close(g, w, PIECE_TOL)


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.bfloat16, jnp.bfloat16)])
def test_init_params_and_cache_match_jax(dtype, jdtype):
    """Shapes and dtypes of every leaf equal JAX's; ``w0``, ``u``, ``ln_x``
    and the wkv cache stay fp32 in a bf16 model."""
    jcfg, cfg = jget(ARCH).reduced(), get_config(ARCH).reduced()

    def spec(tree):
        return jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), tree)

    jparams = jax.eval_shape(lambda: jtf.init_params(jcfg, jax.random.PRNGKey(0), jdtype))
    tparams = tf.init_params(cfg, seed=0, dtype=dtype, device="cpu")
    assert spec(bridge.params_to_numpy(tparams)) == spec(jparams)
    jcache = jax.eval_shape(lambda: jtf.init_cache(jcfg, 3, 16, jdtype))
    tcache = tf.init_cache(cfg, 3, 16, dtype=dtype, device="cpu")
    assert spec(bridge.params_to_numpy(tcache)) == spec(jcache)
    assert tcache[0]["wkv"].dtype == torch.float32
    again = tf.init_params(cfg, seed=0, dtype=dtype, device="cpu")
    assert torch.equal(tparams["blocks"][0]["tm"]["w0"], again["blocks"][0]["tm"]["w0"])


def test_forward_matches_jax():
    jcfg, cfg, jp, tp = _setup(seed=0)
    toks = _tokens(cfg, 2, 64, seed=1)
    want, _ = jtf.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    kernel.launches = 0
    got, _ = tf.forward(cfg, tp, {"tokens": torch.from_numpy(toks).long()})
    assert kernel.launches == 0  # CPU tensors take the plain versions
    assert got.shape == (2, 64, cfg.vocab_size)
    _close(got, want, TOL)


def test_decode_step_matches_jax():
    """Logits and all three cache leaves (shift_tm, shift_cm, wkv) after
    each step; the port writes them into its cache in place."""
    jcfg, cfg, jp, tp = _setup(seed=5)
    B = 2
    toks = _tokens(cfg, B, 6, seed=9)
    jcache = jtf.init_cache(jcfg, B, 16, jnp.float32)
    tcache = tf.init_cache(cfg, B, 16, torch.float32, "cpu")
    leaves = [dict(c) for c in tcache]
    step = jax.jit(lambda p, c, b, pos: jtf.decode_step(jcfg, p, c, b, pos))
    for t in range(toks.shape[1]):
        want, jcache = step(jp, jcache, {"tokens": jnp.asarray(toks[:, t:t + 1])}, jnp.int32(t))
        got, tcache = tf.decode_step(cfg, tp, tcache,
                                     {"tokens": torch.from_numpy(toks[:, t:t + 1]).long()}, t)
        _close(got, want, TOL)
        for jc, tc, orig in zip(jcache, tcache, leaves):
            assert set(tc) == {"shift_tm", "shift_cm", "wkv"}
            for name in tc:
                assert tc[name] is orig[name]  # updated in place
                _close(tc[name], jc[name], TOL)


def test_decode_matches_forward():
    """The reference's ssm criterion on the reference test's own inputs
    (tests/test_models.py:80-83: JAX init from key 3, tokens from key 7): the
    same top-1 everywhere and softmax probabilities within 2e-2 (decode is
    sequential, the CPU forward chunked; on other draws of this init the
    chunked form's out-of-regime error can flip a near-tied top-1, in the
    JAX package as here)."""
    jcfg, cfg = jget(ARCH).reduced(), get_config(ARCH).reduced()
    S = 24
    tree = jax.tree.map(np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(3), jnp.float32))
    params = bridge.params_from_numpy(tree, device="cpu")
    key = jax.random.split(jax.random.PRNGKey(7), 3)[1]
    toks = torch.tensor(np.asarray(jax.random.randint(key, (1, S), 0, cfg.vocab_size))).long()
    full, _ = tf.forward(cfg, params, {"tokens": toks})
    cache = tf.init_cache(cfg, 1, max_len=S, dtype=torch.float32, device="cpu")
    outs = []
    for t in range(S):
        lg, cache = tf.decode_step(cfg, params, cache, {"tokens": toks[:, t:t + 1]}, t)
        outs.append(lg[:, 0])
    dec = torch.stack(outs, 1)
    np.testing.assert_allclose(torch.softmax(dec, -1).numpy(), torch.softmax(full, -1).numpy(),
                               atol=2e-2)
    assert torch.equal(dec.argmax(-1), full.argmax(-1))
