"""The port's wkv6: its plain versions against the JAX oracle, the JAX chunked
form and the JAX kernel (in interpret mode) at the shapes and tolerances of
tests/test_kernels.py (TestWKV6, TestChunkedFallbacks), the dispatch by
device and sequence length, and the checks of the CUDA wrapper, which run
before anything is built. The CUDA kernel itself is checked on a card
(tests/test_torch_gpu.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the machine with the card has no JAX

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rwkv6.kernel import wkv6_tpu  # noqa: E402
from repro.kernels.rwkv6.ref import wkv6_chunked as jax_chunked  # noqa: E402
from repro.kernels.rwkv6.ref import wkv6_reference as jax_reference  # noqa: E402
from repro_torch.kernels import SOURCES  # noqa: E402
from repro_torch.kernels.rwkv6 import kernel, ops  # noqa: E402
from repro_torch.kernels.rwkv6.ref import CLAMP, wkv6_chunked, wkv6_reference  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_kernels.py:204 (kernel vs oracle)
CHUNKED_TOL = dict(rtol=3e-4, atol=3e-4)  # tests/test_kernels.py:264 (chunked vs oracle)


def _inputs(b=1, s=48, H=2, P=16, seed=0, state_scale=0.0, w_shift=2.0):
    """TestWKV6's distributions, drawn with numpy: r, k ~ 0.5 N, v ~ N,
    w = sigmoid(N + w_shift), u ~ 0.5 N, state ~ state_scale N."""
    r = np.random.default_rng(seed)
    rr = (0.5 * r.standard_normal((b, s, H, P))).astype(np.float32)
    kk = (0.5 * r.standard_normal((b, s, H, P))).astype(np.float32)
    vv = r.standard_normal((b, s, H, P)).astype(np.float32)
    ww = (1.0 / (1.0 + np.exp(-(r.standard_normal((b, s, H, P)) + w_shift)))).astype(np.float32)
    uu = (0.5 * r.standard_normal((H, P))).astype(np.float32)
    st = (state_scale * r.standard_normal((b, H, P, P))).astype(np.float32)
    return rr, kk, vv, ww, uu, st


def _torch(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _jax(arrs):
    return [jnp.asarray(a) for a in arrs]


def _close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


# (s, jax kernel chunk, state scale): tests/test_kernels.py:199-213, the last
# the nonzero initial state
CASES = [(48, 16, 0.0), (64, 64, 0.0), (50, 16, 0.0), (32, 16, 1.0)]


@pytest.mark.parametrize("s,chunk,state_scale", CASES)
def test_reference_matches_jax_oracle_and_kernel(s, chunk, state_scale):
    arrs = _inputs(s=s, seed=s, state_scale=state_scale)
    got = wkv6_reference(*_torch(arrs))
    _close(got, jax_reference(*_jax(arrs)), TOL)
    _close(got, wkv6_tpu(*_jax(arrs), chunk=chunk, interpret=True), TOL)


@pytest.mark.parametrize("s,chunk,state_scale", CASES)
def test_chunked_matches_jax_chunked_and_kernel(s, chunk, state_scale):
    arrs = _inputs(s=s, seed=s + 1, state_scale=state_scale)
    got = wkv6_chunked(*_torch(arrs))
    _close(got, jax_chunked(*_jax(arrs)), TOL)
    _close(got, wkv6_tpu(*_jax(arrs), chunk=chunk, interpret=True), CHUNKED_TOL)


@pytest.mark.parametrize("s,P", [(16, 8), (32, 8), (40, 16), (16, 16)])
def test_reference_sweep_matches_jax(s, P):
    """tests/test_kernels.py:223-229 (the property sweep), at 3e-4."""
    arrs = _inputs(s=s, P=P, seed=s + P)
    y, _ = wkv6_reference(*_torch(arrs))
    y_kernel, _ = wkv6_tpu(*_jax(arrs), chunk=16, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_kernel), rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_chunked_matches_sequential(chunk):
    """tests/test_kernels.py:251-266: ragged s = 100, nonzero state."""
    arrs = _inputs(b=2, s=100, H=3, P=16, seed=1, state_scale=0.3)
    t = _torch(arrs)
    _close(wkv6_chunked(*t, chunk=chunk), wkv6_reference(*t), CHUNKED_TOL)
    _close(wkv6_chunked(*t, chunk=chunk), jax_chunked(*_jax(arrs), chunk=chunk), TOL)


def test_chunked_strong_decay():
    """tests/test_kernels.py:268-281: w = sigmoid(N - 3) ~ 0.05, within the
    chunked form's regime but with fp32 loss under the wide exponents: 2e-2."""
    arrs = _inputs(b=2, s=64, H=2, P=16, seed=2, w_shift=-3.0)
    t = _torch(arrs)
    y_ch, _ = wkv6_chunked(*t)
    y_ref, _ = wkv6_reference(*t)
    np.testing.assert_allclose(y_ch.numpy(), y_ref.numpy(), rtol=2e-2, atol=2e-2)
    y_jax, _ = jax_chunked(*_jax(arrs))
    np.testing.assert_allclose(y_ch.numpy(), np.asarray(y_jax), rtol=2e-2, atol=2e-2)


def test_chunked_outside_its_regime_matches_jax_not_the_recurrence():
    """At the model's decays, fixed per channel over time (w = exp(-exp(w0)),
    w0 ~ N(0, 0.5), with one channel a head at w0 = 2.25, w ~ 7.6e-5, as the
    full-width init reaches), a 16-step log decay falls below -CLAMP and the
    chunked form is no longer the recurrence, in the JAX package as here:
    the port keeps it for CPU parity only, and the CUDA kernel runs the
    sequential recurrence, as wkv6_tpu does."""
    b, s, H, P = 1, 64, 4, 64
    rr, kk, vv, _, uu, st = _inputs(b=b, s=s, H=H, P=P, seed=11)
    w0 = 0.5 * np.random.default_rng(12).standard_normal((H, P))
    w0[:, 0] = 2.25
    ww = np.broadcast_to(np.exp(-np.exp(w0)), (b, s, H, P)).astype(np.float32).copy()
    arrs = (rr, kk, vv, ww, uu, st)
    y_ch, _ = wkv6_chunked(*_torch(arrs))
    y_seq, _ = wkv6_reference(*_torch(arrs))
    y_jax, _ = jax_chunked(*_jax(arrs))
    np.testing.assert_allclose(y_ch.numpy(), np.asarray(y_jax), **TOL)
    assert float((y_ch - y_seq).abs().max()) > 1.0  # far beyond any kernel tolerance


def test_clamp_is_the_reference_value():
    from repro.kernels.rwkv6.ref import CLAMP as JAX_CLAMP

    assert CLAMP == JAX_CLAMP == 60.0


@pytest.mark.parametrize("s", [1, 5])
def test_cpu_dispatch_by_length(s):
    """s == 1 takes the sequential version, s > 1 the chunked form (the JAX
    package's CPU dispatch), bit for bit; no kernel launch."""
    t = _torch(_inputs(s=s, seed=7, state_scale=0.5))
    plain = wkv6_reference if s == 1 else wkv6_chunked
    kernel.launches = 0
    y, st = ops.wkv6(*t)
    want_y, want_st = plain(*t)
    assert kernel.launches == 0
    assert torch.equal(y, want_y) and torch.equal(st, want_st)


def test_cpu_dispatch_writes_state_out_in_place():
    t = _torch(_inputs(s=1, seed=8, state_scale=0.5))
    want_y, want_st = wkv6_reference(*t)
    state = t[5]
    y, st = ops.wkv6(*t, state_out=state)
    assert st is state
    assert torch.equal(y, want_y) and torch.equal(state, want_st)


def test_wrapper_refuses_cpu_tensors():
    kernel.launches = 0
    with pytest.raises(ValueError, match="CUDA"):
        kernel.wkv6_cuda(*_torch(_inputs(s=4, seed=3)))
    assert kernel.launches == 0


def test_wrapper_refuses_non_fp32():
    t = _torch(_inputs(s=4, seed=3))
    t[0] = t[0].to(torch.bfloat16)
    with pytest.raises(TypeError, match="fp32"):
        kernel.wkv6_cuda(*t)


def test_wrapper_refuses_non_contiguous():
    t = _torch(_inputs(s=4, H=4, P=16, seed=3))
    t[2] = t[2].transpose(1, 2).contiguous().transpose(1, 2)  # same shape, other strides
    with pytest.raises(ValueError, match="contiguous"):
        kernel.wkv6_cuda(*t)


@pytest.mark.parametrize("P", [4, 12, 128])
def test_wrapper_refuses_head_size(P):
    with pytest.raises(ValueError, match="head size"):
        kernel.wkv6_cuda(*_torch(_inputs(s=4, P=P, seed=3)))


def test_wrapper_refuses_bad_shapes_and_chunk():
    t = _torch(_inputs(s=4, seed=3))
    with pytest.raises(ValueError, match="one shape"):
        kernel.wkv6_cuda(t[0], t[1][:, :3], *t[2:])
    with pytest.raises(ValueError, match="state"):
        kernel.wkv6_cuda(*t[:5], t[5][:, :1])
    with pytest.raises(ValueError, match="chunk"):
        kernel.wkv6_cuda(*t, chunk=kernel.TILE_FLOATS // 16 + 1)
    with pytest.raises(ValueError, match="empty"):
        kernel.wkv6_cuda(*(a[:, :0] for a in t[:4]), *t[4:])


def test_source_is_listed():
    assert SOURCES["wkv6"] == kernel.SOURCE and kernel.SOURCE.exists()
    text = kernel.SOURCE.read_text()
    assert "src/repro/kernels/rwkv6/kernel.py:57" in text
    assert 'extern "C" int wkv6_fwd' in text


def test_bound_at_prefill_shape():
    """The bound chip_smoke.py reports for the rwkv6-7b prefill (b=4, s=1024,
    H=64, P=64): 344 MB of r/k/v/w, y, u and the state in and out at the HBM
    rate, above the 5.4 GFLOP (5 P^2 a step and head) at the fp32 peak."""
    from repro_torch import hw

    b, s, H, P = 4, 1024, 64, 64
    n_bytes = 4 * (5 * b * s * H * P + H * P + 2 * b * H * P * P)
    flops = 5 * b * s * H * P * P
    t, by = hw.bound_seconds(n_bytes, flops, hw.FP32_FLOPS)
    assert by == "bytes"
    assert abs(t - 1.0268e-4) < 1e-8
    t_ops, _ = hw.bound_seconds(0, flops, hw.FP32_FLOPS)
    assert abs(t_ops - 8.013e-5) < 1e-8
