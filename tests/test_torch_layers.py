"""The port's layer primitives against the JAX package's on the same numpy
inputs (fp32, CPU), at rtol = atol = 1e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the machine with the card has no JAX

import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_rmsnorm_nonzero_scale():
    r = _rng(0)
    x = r.standard_normal((2, 7, 64)).astype(np.float32)
    scale = (0.3 * r.standard_normal(64)).astype(np.float32)  # exercises the (1 + scale)
    want = np.asarray(jl.rmsnorm(jnp.asarray(x), jnp.asarray(scale), 1e-6))
    got = tl.rmsnorm(_t(x), _t(scale), 1e-6).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_split_half(theta):
    r = _rng(2)
    x = r.standard_normal((2, 40, 4, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(100, 140), (2, 40)).astype(np.int32)
    want = np.asarray(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = tl.apply_rope(_t(x), _t(pos), theta).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kind,act", [("swiglu", "silu"), ("geglu", "gelu"),
                                      ("dense", "gelu"), ("dense", "sqrelu")])
def test_mlp(kind, act):
    r = _rng(3)
    d, f = 32, 64
    x = r.standard_normal((2, 5, d)).astype(np.float32)
    p = {"w_in": (r.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32),
         "w_out": (r.standard_normal((f, d)) / np.sqrt(f)).astype(np.float32)}
    if kind != "dense":
        p["w_gate"] = (r.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32)
    want = np.asarray(jl.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                             kind, act))
    got = tl.mlp({k: _t(v) for k, v in p.items()}, _t(x), kind, act).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("tied", [True, False])
def test_embed_unembed(tied):
    r = _rng(4)
    vocab, d = 50, 16
    table = r.standard_normal((vocab, d)).astype(np.float32)
    head = r.standard_normal((d, vocab)).astype(np.float32)
    tokens = r.integers(0, vocab, (2, 9))
    want_e = np.asarray(jl.embed(jnp.asarray(table), jnp.asarray(tokens)))
    got_e = tl.embed(_t(table), _t(tokens)).numpy()
    np.testing.assert_array_equal(got_e, want_e)
    w = table if tied else head
    want = np.asarray(jl.unembed(jnp.asarray(w), jnp.asarray(want_e), tied))
    got = tl.unembed(_t(w), _t(got_e), tied).numpy()
    np.testing.assert_allclose(got, want, **TOL)
