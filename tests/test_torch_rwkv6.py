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
        kernel.wkv6_cuda(*t, chunk=kernel.max_chunk(16) + 1)
    with pytest.raises(ValueError, match="empty"):
        kernel.wkv6_cuda(*(a[:, :0] for a in t[:4]), *t[4:])


def test_source_is_listed():
    assert SOURCES["wkv6"] == kernel.SOURCE and kernel.SOURCE.exists()
    text = kernel.SOURCE.read_text()
    assert "src/repro/kernels/rwkv6/kernel.py:57" in text
    assert 'extern "C" int wkv6_fwd' in text
    assert f"constexpr int STAGES = {kernel.STAGES};" in text  # the ring smem_bytes counts
    for P in kernel.HEAD_SIZES:
        for pc, r, cpt in kernel.PLANS[P]:
            assert f"WKV_CASE({P}, {r}, {pc}, {cpt})" in text


# (b, H, P): the rwkv6-7b prefill and decode steps, the engine's decode lane,
# and every instantiated head size at the TestWKV6 shapes
PLAN_SHAPES = [(4, 64, 64), (1, 64, 64), (2, 64, 64), (1, 2, 8), (1, 2, 16), (2, 3, 32),
               (2, 4, 64)]


@pytest.mark.parametrize("b,H,P", PLAN_SHAPES)
def test_plan_for_every_shape(b, H, P):
    """Columns split over P / pc blocks a (batch, head) and into groups of CPT
    a thread, rows into float4 groups over R threads; whole warps or one
    part warp of at least eight lanes (the r.u.k sums take eight lanes a
    step); at least WIDE_GRID blocks wherever the column split can reach
    them; the ring fits shared memory at the longest legal tile."""
    pl = kernel.plan(b, 100, H, P)
    pc, r, cpt = pl["pc"], pl["r"], pl["cpt"]
    assert P % pc == 0 and pl["blocks_per_head"] == P // pc
    assert pc % 4 == 0 and pc % cpt == 0 and P % (4 * r) == 0 and cpt in (1, 2, 4)
    assert pl["threads"] == pc // cpt * r and pl["threads"] % 8 == 0
    assert pl["threads"] < 32 or pl["threads"] % 32 == 0
    assert pl["chunk"] == kernel.DEFAULT_CHUNK
    if P == 64:
        assert b * H * pl["blocks_per_head"] >= min(kernel.WIDE_GRID, 4 * b * H)
    longest = kernel.plan(b, 10**6, H, P, chunk=kernel.max_chunk(P))
    assert longest["smem_bytes"] <= kernel.MAX_SMEM
    assert kernel.smem_bytes(P, pc, kernel.max_chunk(P) + 1) > kernel.MAX_SMEM \
        or pc < max(p[0] for p in kernel.PLANS[P])


def test_plan_at_prefill_and_decode_shapes():
    """rwkv6-7b prefill (b 4, s 1024, H 64, P 64): 256 blocks of all 64
    columns (each stages the head's r, k and w once), four threads a
    column, four columns a thread (64 threads), two slots of 48 steps in
    98,752 bytes (two blocks an SM); the decode step (b 1, s 1): 16 columns
    a block, 256 blocks of 32 threads (64 blocks before the column split),
    no ring and no shared memory."""
    pre = kernel.plan(4, 1024, 64, 64)
    assert (pre["pc"], pre["r"], pre["cpt"], kernel.STAGES, pre["chunk"]) == (64, 4, 4, 2, 48)
    assert pre["threads"] == 64 and 4 * 64 * pre["blocks_per_head"] == 256
    assert pre["smem_bytes"] == 98752 and 2 * (98752 + 1024) <= 228 * 1024
    dec = kernel.plan(1, 1, 64, 64)
    assert (dec["pc"], dec["r"], dec["cpt"], dec["chunk"]) == (16, 2, 1, 1)
    assert dec["threads"] == 32 and 64 * dec["blocks_per_head"] == 256
    assert pre["ring"] and not dec["ring"] and dec["smem_bytes"] == 0


def test_chunk_range():
    """``chunk`` is legal from 1 to the longest tile whose ring fits shared
    memory at the larger plan of the head size; the tiles the checks use (8 and 32 at P = 16)
    stay legal, and the tile is the chunk cut to the sequence."""
    assert [kernel.max_chunk(P) for P in (8, 16, 32, 64)] == [1019, 514, 258, 113]
    for c in (1, 8, 32, 343):
        kernel.plan(1, 64, 2, 16, c)
    assert kernel.plan(1, 10, 2, 16, 32)["chunk"] == 10
    for c in (0, 114):
        with pytest.raises(ValueError, match="chunk"):
            kernel.plan(4, 1024, 64, 64, c)


def test_bound_at_decode_shape():
    """The decode step's bound chip_smoke.py reports (b 1, s 1, H 64, P 64):
    the state read and written once dominates, 2.20 MB at the HBM rate."""
    from repro_torch import hw

    b, s, H, P = 1, 1, 64, 64
    n_bytes = 4 * (5 * b * s * H * P + H * P + 2 * b * H * P * P)
    t, by = hw.bound_seconds(n_bytes, 5 * b * s * H * P * P, hw.FP32_FLOPS)
    assert by == "bytes" and n_bytes == 2_195_456
    assert abs(t - 6.554e-7) < 1e-10


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


# ------------------------------------------------------------- gradients --
def _model_decay_inputs(b=2, s=24, H=2, P=16, seed=21):
    """A non-zero initial state and the model's decays: w = exp(-exp(w0 +
    0.1 N)) per token, w0 ~ 0.5 N per channel, one channel a head at w0 =
    2.25 (w ~ 7.6e-5, as the full-width init reaches), where a 16-step log
    decay passes -CLAMP."""
    rr, kk, vv, _, uu, st = _inputs(b=b, s=s, H=H, P=P, seed=seed, state_scale=0.5)
    g = np.random.default_rng(seed + 1)
    w0 = 0.5 * g.standard_normal((H, P))
    w0[:, 0] = 2.25
    ww = np.exp(-np.exp(w0 + 0.1 * g.standard_normal((b, s, H, P)))).astype(np.float32)
    return rr, kk, vv, ww, uu, st


def _fake_kernel(calls):
    """The kernel's stand-in on the CPU: the sequential recurrence it runs,
    computed outside autograd as the kernel is, each call counted."""
    def fake(r, k, v, w, u, state, state_out=None):
        calls.append(r.shape)
        with torch.no_grad():
            return wkv6_reference(r, k, v, w, u, state)
    return fake


def test_wkv6_function_gradients_match_jax_vjp(monkeypatch):
    """``WKV6``'s backward (the kernel replaced by the plain recurrence) gives
    all six inputs the gradients of ``jax.vjp`` of the JAX oracle
    ``wkv6_reference``, with cotangents on y and on the final state, at b 2,
    s 24, H 2, P 16 with one channel a head at w ~ 7.6e-5: fp32 sums of 24
    steps in another order (~2e-7 seen), held to 1e-5 of each gradient's
    largest |value|."""
    import jax

    monkeypatch.setattr(kernel, "wkv6_cuda", _fake_kernel([]))
    arrs = _model_decay_inputs()
    assert np.exp(np.log(arrs[3][:, :16, :, 0]).sum(1)).max() < np.exp(-CLAMP)
    g = np.random.default_rng(22)
    gy = g.standard_normal(arrs[0].shape).astype(np.float32)
    gs = g.standard_normal(arrs[5].shape).astype(np.float32)
    _, vjp = jax.vjp(jax_reference, *_jax(arrs))
    want = vjp((jnp.asarray(gy), jnp.asarray(gs)))
    args = [x.requires_grad_() for x in _torch(arrs)]
    y, final = ops.WKV6.apply(*args)
    got = torch.autograd.grad((y, final), args, (torch.from_numpy(gy), torch.from_numpy(gs)))
    for name, a, b in zip("r k v w u state".split(), got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * np.abs(b).max(),
                                   err_msg=name)


def test_wkv6_reference_gradcheck():
    """The version the backward differentiates passes a float64 gradcheck in
    every input, the w ~ 7.6e-5 channel included."""
    arrs = _model_decay_inputs(b=1, s=6, H=2, P=4, seed=23)
    args = tuple(torch.from_numpy(a).double().requires_grad_() for a in arrs)
    assert torch.autograd.gradcheck(wkv6_reference, args)


@pytest.mark.parametrize("remat", [False, True])
def test_wkv6_function_plumbing(monkeypatch, remat):
    """With the kernel replaced by the plain recurrence, ``WKV6`` gives the
    gradients autograd gives through ``wkv6_reference`` itself, bit for bit,
    to only the inputs that need one; under remat (``torch.utils.checkpoint``,
    as the models' forward takes it) the forward runs twice and the backward
    calls no kernel."""
    calls = []
    monkeypatch.setattr(kernel, "wkv6_cuda", _fake_kernel(calls))
    arrs = _torch(_model_decay_inputs(seed=24))
    need = [True, True, False, True, True, True]
    g = torch.from_numpy(np.random.default_rng(25).standard_normal(arrs[0].shape)
                         .astype(np.float32))

    def loss(fn, args):
        y, final = fn(*args)
        return (y * g).sum() + final.square().sum()

    args = [x.clone().requires_grad_(n) for x, n in zip(arrs, need)]
    if remat:
        out = torch.utils.checkpoint.checkpoint(loss, ops.WKV6.apply, args, use_reentrant=False)
    else:
        out = loss(ops.WKV6.apply, args)
    assert len(calls) == 1
    out.backward()
    assert len(calls) == (2 if remat else 1)
    ref = [x.clone().requires_grad_(n) for x, n in zip(arrs, need)]
    loss(wkv6_reference, ref).backward()
    for a, b, n in zip(args, ref, need):
        assert (a.grad is None) == (not n)
        if n:
            assert torch.equal(a.grad, b.grad)


def test_cpu_dispatch_under_grad_takes_the_plain_version():
    """On the CPU a gradient flows through the JAX package's CPU dispatch
    (the chunked form), not through ``WKV6``."""
    args = [x.requires_grad_() for x in _torch(_inputs(s=8, seed=26, state_scale=0.5))]
    y, _ = ops.wkv6(*args)
    assert "WKV6" not in type(y.grad_fn).__name__
    y_ch, _ = wkv6_chunked(*args)
    assert torch.equal(y, y_ch)
