"""The port's flash attention: its plain version against the JAX kernel (in
interpret mode) and the JAX oracle at the shapes and tolerances of
tests/test_kernels.py, the CUDA kernel's numerical route (3xTF32, emulated
on the CPU) against the same oracle, the dispatch by device, the bounds
chip_smoke.py reports, and (on a card only) the CUDA kernel against the
plain version (tests/test_torch_gpu.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the machine with the card has no JAX

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_attention_tpu  # noqa: E402
from repro.kernels.flash_attention.ref import mha_reference as jax_mha  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    banded_attention,
    chunked_attention,
    kept_pairs,
    mha_reference,
    mha_tf32,
    repeat_kv,
    split_tf32,
    tf32_round,
)

# (b, s, H, G, hd, window): tests/test_kernels.py:28-50
SHAPES = [
    (2, 64, 4, 4, 32, None),  # MHA
    (2, 64, 8, 2, 32, None),  # GQA 4:1
    (2, 96, 4, 1, 64, None),  # MQA, ragged seq vs 32-blocks
    (2, 128, 2, 2, 16, None),
    (1, 128, 4, 2, 32, 16),
    (1, 128, 4, 2, 32, 32),
    (1, 128, 4, 2, 32, 100),
]


def _qkv(b, s, H, G, hd, seed, dtype=np.float32, t=None):
    r = np.random.default_rng(seed)
    t = s if t is None else t
    q = (0.5 * r.standard_normal((b, s, H, hd))).astype(np.float32)
    k = (0.5 * r.standard_normal((b, t, G, hd))).astype(np.float32)
    v = r.standard_normal((b, t, G, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("b,s,H,G,hd,window", SHAPES)
def test_plain_matches_jax(b, s, H, G, hd, window):
    q, k, v = _qkv(b, s, H, G, hd, seed=s * H + hd + (window or 0))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_kernel = np.asarray(flash_attention_tpu(jq, jk, jv, causal=True, window=window,
                                                 block_q=32, block_k=32, interpret=True))
    want_ref = np.asarray(jax_mha(jq, jk, jv, causal=True, window=window))
    got = mha_reference(*map(torch.from_numpy, (q, k, v)), causal=True, window=window).numpy()
    np.testing.assert_allclose(got, want_kernel, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, want_ref, rtol=2e-5, atol=2e-5)


def test_plain_bf16_matches_jax():
    q, k, v = _qkv(1, 64, 4, 2, 32, seed=7)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(flash_attention_tpu(jq, jk, jv, block_q=32, block_k=32,
                                          interpret=True).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = mha_reference(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2, atol=3e-2)


def test_plain_rows_sum_to_one():
    q, k, _ = _qkv(1, 64, 2, 2, 32, seed=10)
    v = np.ones((1, 64, 2, 32), np.float32)
    out = mha_reference(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(out, np.ones_like(out), rtol=1e-5)


def test_repeat_kv_order():
    k = torch.arange(2 * 3 * 2 * 4, dtype=torch.float32).reshape(2, 3, 2, 4)
    r = repeat_kv(k, 3)
    assert r.shape == (2, 3, 6, 4)
    for h in range(6):
        assert torch.equal(r[:, :, h], k[:, :, h // 3])


def test_cpu_dispatch_takes_plain_version():
    """s = 48 >= 2 x window 20: the CPU dispatch takes the banded version, as
    JAX's does."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 48, 4, 2, 16, seed=3))
    kernel.launches = 0
    out = ops.flash_attention(q, k, v, causal=True, window=20)
    assert kernel.launches == 0
    assert ops.plain_path(48, 48, True, 20) == "banded"
    torch.testing.assert_close(out, banded_attention(q, k, v, window=20), rtol=0, atol=0)


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 2, 2, 16, seed=4))
    kernel.launches = 0
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention_cuda(q, k, v)
    assert kernel.launches == 0


def test_bound_at_prefill_shape():
    """The bounds chip_smoke.py reports for the qwen3-0.6b prefill attention:
    17.2 GFLOP of causal work over the fp32 CUDA-core peak (the bound of the
    kernel's earlier CUDA-core version) and, as the kernel computes it,
    3 x 17.2 GFLOP over the TF32
    tensor-core peak; both above the 0.03 ms the 100.7 MB of q/k/v/o take at
    the HBM rate."""
    from repro_torch import hw

    b, s, H, G, hd = 4, 1024, 16, 8, 128
    flops = 4 * hd * b * H * kept_pairs(s, s)
    assert flops == 4 * hd * b * H * s * (s + 1) // 2
    n_bytes = 4 * (2 * b * s * H * hd + 2 * b * s * G * hd)
    t, by = hw.bound_seconds(n_bytes, flops, hw.FP32_FLOPS)
    assert by == "operations"
    assert abs(t - 2.5667e-4) < 1e-8
    t, by = hw.bound_seconds(n_bytes, 3 * flops, hw.TF32_TENSOR_FLOPS)
    assert by == "operations" and abs(t - 1.0422e-4) < 1e-8
    t_bytes, by = hw.bound_seconds(n_bytes, 0, hw.FP32_FLOPS)
    assert by == "bytes" and abs(t_bytes - 3.005e-5) < 1e-8


# (b, s, H, G, hd, window, GFLOP, 3xTF32 bound ms): the three shapes the
# main paths run the kernel at (qwen3-0.6b prefill, zamba2-7b prefill, the
# h2o-danube-3-4b pipeline's microbatch)
MAIN_PATH_SHAPES = [
    (4, 1024, 16, 8, 128, None, 17.20, 0.1042),
    (4, 1024, 32, 32, 112, None, 30.09, 0.1824),
    (1, 4608, 32, 8, 120, 4096, 161.09, 0.9763),
]


@pytest.mark.parametrize("b,s,H,G,hd,window,gflop,bound_ms", MAIN_PATH_SHAPES)
def test_tf32_bound_at_main_path_shapes(b, s, H, G, hd, window, gflop, bound_ms):
    """3 x the masked pairs' operations over the TF32 tensor-core peak: the
    kernel's bound at each shape the main paths launch it at."""
    from repro_torch import hw

    flops = 4 * hd * b * H * kept_pairs(s, s, causal=True, window=window)
    assert round(flops / 1e9, 2) == gflop
    n_bytes = 4 * (2 * b * s * H * hd + 2 * b * s * G * hd)
    t, by = hw.bound_seconds(n_bytes, 3 * flops, hw.TF32_TENSOR_FLOPS)
    assert by == "operations" and round(t * 1e3, 4) == bound_ms


@pytest.mark.parametrize("s,t,causal,window,want", [
    (4608, 4608, True, 4096, 4096 * 4097 // 2 + 512 * 4096),  # 10,487,808
    (1024, 1024, True, None, 1024 * 1025 // 2),
    (5, 7, False, None, 35),
    (6, 6, True, 2, 1 + 2 * 5),
    (6, 6, False, 2, 6 + 6 + 5 + 4 + 3 + 2),  # cols row-1 .. 5
    (8, 3, True, None, 1 + 2 + 3 * 6),
])
def test_kept_pairs(s, t, causal, window, want):
    assert kept_pairs(s, t, causal=causal, window=window) == want
    qi, kj = np.arange(s)[:, None], np.arange(t)[None, :]
    mask = np.ones((s, t), bool)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= kj > qi - window
    assert int(mask.sum()) == want


def test_tf32_round_is_cvt_rna():
    """Round to nearest on 10 mantissa bits, ties away from zero (cvt.rna),
    and big + small (small truncated to TF32) recovers fp32 to 2^-21."""
    ulp = 2.0 ** -10  # a TF32 ulp at 1
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + 3 * ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      3.0 * 2 ** -20, -0.0])
    want = torch.tensor([1.0, 1 + ulp, 1 + 2 * ulp, -(1 + ulp), 1.0, 3.0 * 2 ** -20, -0.0])
    assert torch.equal(tf32_round(x), want)
    r = np.random.default_rng(0)
    y = torch.from_numpy(r.standard_normal(4096).astype(np.float32))
    big, small = split_tf32(y)
    assert torch.equal(tf32_round(big), big) and torch.equal(tf32_round(small), small)
    assert ((big - y).abs() <= y.abs() * 2.0 ** -11).all()
    assert ((big + small - y).abs() <= y.abs() * 2.0 ** -21).all()


@pytest.mark.parametrize("b,s,H,G,hd,window", SHAPES)
def test_3xtf32_route_matches_jax(b, s, H, G, hd, window):
    """The kernel's products as 3xTF32 hold the JAX kernel (interpret mode)
    and oracle to the plain version's tolerance, 2e-5."""
    q, k, v = _qkv(b, s, H, G, hd, seed=s * H + hd + (window or 0))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_kernel = np.asarray(flash_attention_tpu(jq, jk, jv, causal=True, window=window,
                                                 block_q=32, block_k=32, interpret=True))
    want_ref = np.asarray(jax_mha(jq, jk, jv, causal=True, window=window))
    got = mha_tf32(*map(torch.from_numpy, (q, k, v)), causal=True, window=window).numpy()
    np.testing.assert_allclose(got, want_kernel, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, want_ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,s,H,G,hd,window", SHAPES)
def test_plain_tf32_misses_parity(b, s, H, G, hd, window):
    """Why the kernel splits: one TF32 product per product, at the same
    inputs, is off the JAX oracle by more than 2e-5."""
    q, k, v = _qkv(b, s, H, G, hd, seed=s * H + hd + (window or 0))
    want = np.asarray(jax_mha(*map(jnp.asarray, (q, k, v)), causal=True, window=window))
    got = mha_tf32(*map(torch.from_numpy, (q, k, v)), causal=True, window=window,
                   split=False).numpy()
    err = np.abs(got - want) - 2e-5 * np.abs(want)
    assert err.max() > 2e-5


# ------------------------------- chunked / banded versions and the CPU dispatch --
def _jax_ref():
    from repro.kernels.flash_attention import ref as jref

    return jref


@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 17),
                                           (True, 64), (False, 40)])
def test_chunked_matches_jax(causal, window):
    """TestChunkedFallbacks' shape (tests/test_kernels.py:236-241: 2 x 200,
    4/2 heads, hd 32, 64 x 32 tiles) against JAX's ``chunked_attention`` and
    the dense oracle, at its 3e-5; windows make the tile skip of the port
    (tiles the mask hides) count."""
    q, k, v = _qkv(2, 200, 4, 2, 32, seed=11)
    want = np.asarray(_jax_ref().chunked_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                                   window=window, block_q=64, block_k=32))
    got = chunked_attention(*map(torch.from_numpy, (q, k, v)), causal=causal, window=window,
                            block_q=64, block_k=32).numpy()
    dense = jax_mha(*map(jnp.asarray, (q, k, v)), causal=causal, window=window)
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(got, np.asarray(dense), rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("window", [17, 64])
def test_banded_matches_jax(window):
    """tests/test_kernels.py:243-249: 2 x 200, windows 17 and 64, 64-row q
    chunks, against JAX's ``banded_attention`` and the windowed dense oracle
    at 3e-5."""
    q, k, v = _qkv(2, 200, 4, 2, 32, seed=12 + window)
    want = np.asarray(_jax_ref().banded_attention(*map(jnp.asarray, (q, k, v)), window=window,
                                                  block_q=64))
    got = banded_attention(*map(torch.from_numpy, (q, k, v)), window=window,
                           block_q=64).numpy()
    dense = jax_mha(*map(jnp.asarray, (q, k, v)), causal=True, window=window)
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(got, np.asarray(dense), rtol=3e-5, atol=3e-5)


def test_banded_bf16_matches_jax():
    q, k, v = _qkv(1, 96, 4, 2, 32, seed=13)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(_jax_ref().banded_attention(jq, jk, jv, window=24, block_q=32)
                      .astype(jnp.float32))
    got = banded_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)), window=24,
                           block_q=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("s,t", [(1, 1), (8, 8), (64, 64), (127, 127), (128, 128),
                                 (200, 200), (1, 300), (16, 300), (2048, 2048),
                                 (2049, 2049), (1, 2049), (4100, 4100)])
@pytest.mark.parametrize("window", [None, 1, 64, 150, 1024, 2048])
@pytest.mark.parametrize("causal", [True, False])
def test_cpu_dispatch_picks_jax_path(monkeypatch, s, t, window, causal):
    """The plain version the port's CPU dispatch takes is the one JAX's CPU
    dispatch (``repro.kernels.flash_attention.ops``) calls, over a grid of
    (s, t, window, causal); JAX's three versions are replaced by recorders."""
    from repro.kernels.flash_attention import ops as jops

    called = []
    for name, path in (("banded_attention", "banded"), ("chunked_attention", "chunked"),
                       ("mha_reference", "dense")):
        monkeypatch.setattr(jops, name, lambda *a, _p=path, **kw: called.append(_p))
    jops.flash_attention(np.zeros((1, s, 1, 8)), np.zeros((1, t, 1, 8)),
                         np.zeros((1, t, 1, 8)), causal=causal, window=window)
    assert called == [ops.plain_path(s, t, causal, window)]


@pytest.mark.parametrize("window", [None, 64])
def test_long_sequence_matches_jax(window):
    """t = 2100 > CHUNKED_THRESHOLD at a narrow width: the CPU dispatch takes
    the chunked version (no window) or the banded one (window 64), as JAX's
    does; both against JAX's dispatch at 3e-5."""
    from repro.kernels.flash_attention import ops as jops

    q, k, v = _qkv(1, 2100, 2, 1, 16, seed=14)
    want = np.asarray(jops.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                           window=window))
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True, window=window)
    assert ops.plain_path(2100, 2100, True, window) == ("chunked" if window is None else "banded")
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("fn,kw", [
    (chunked_attention, dict(causal=True, block_q=16, block_k=8)),
    (chunked_attention, dict(causal=True, window=9, block_q=16, block_k=8)),
    (banded_attention, dict(window=9, block_q=16)),
])
def test_plain_versions_gradcheck(fn, kw):
    """Both long-sequence versions are differentiable: float64 gradcheck at
    40 rows (ragged against the tiles), GQA 2:1."""
    r = np.random.default_rng(15)
    q, k, v = (torch.from_numpy(r.standard_normal(shape)).requires_grad_()
               for shape in ((1, 40, 2, 8), (1, 40, 1, 8), (1, 40, 1, 8)))
    assert torch.autograd.gradcheck(lambda a, b, c: fn(a, b, c, **kw), (q, k, v),
                                    fast_mode=True)


@pytest.mark.parametrize("path,s,window", [("chunked", 2100, None), ("banded", 200, 64),
                                           ("dense", 200, None)])
def test_plain_gradient_matches_jax(path, s, window):
    """The gradient of each plain version the dispatch takes against
    ``jax.grad`` of JAX's CPU dispatch on the same inputs and cotangent, at
    1e-4 (a gradient sums s terms a row in another order)."""
    import jax
    from repro.kernels.flash_attention import ops as jops

    q, k, v = _qkv(1, s, 2, 1, 16, seed=16)
    g = np.random.default_rng(17).standard_normal(q.shape).astype(np.float32)
    want = jax.grad(lambda a, b, c: (jops.flash_attention(a, b, c, causal=True, window=window)
                                     * g).sum(), argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    assert ops.plain_path(s, s, True, window) == path
    out = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)


def test_autograd_function_backward_is_plain_gradient(monkeypatch):
    """``FlashAttention``'s backward on the CPU, with the kernel replaced by
    the dense plain version: its gradients are the plain version's, a
    gradient for only the inputs that need one, float64 gradcheck; the
    backward launches no kernel."""
    calls = []

    def fake_kernel(q, k, v, **kw):
        calls.append(1)
        return mha_reference(q, k, v, **kw)

    monkeypatch.setattr(kernel, "flash_attention_cuda", fake_kernel)
    r = np.random.default_rng(18)
    q, k, v = (torch.from_numpy(r.standard_normal(shape)) for shape in
               ((1, 48, 4, 8), (1, 48, 2, 8), (1, 48, 2, 8)))
    for window in (None, 20):  # dense and banded recomputes
        args = [x.clone().requires_grad_() for x in (q, k, v)]
        out = ops.FlashAttention.apply(*args, True, window, None)
        ref_args = [x.clone().requires_grad_() for x in (q, k, v)]
        ref = ops.plain_attention(*ref_args, causal=True, window=window)
        g = torch.randn_like(out)
        calls.clear()
        got = torch.autograd.grad(out, args, g)
        want = torch.autograd.grad(ref, ref_args, g)
        assert not calls  # the backward recomputes with the plain version
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    kq = q.clone().requires_grad_()
    out = ops.FlashAttention.apply(kq, k, v, True, None, None)
    (dq,) = torch.autograd.grad(out.sum(), (kq,))
    assert dq.shape == q.shape
    assert torch.autograd.gradcheck(
        lambda a, b, c: ops.FlashAttention.apply(a, b, c, True, 20, None),
        tuple(x[:, :24].clone().requires_grad_() for x in (q, k, v)), fast_mode=True)
