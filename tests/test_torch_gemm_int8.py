"""The port's INT8 PU GEMM: its plain version and its CPU dispatch against the
JAX oracle and the JAX kernel (in interpret mode), bit for bit, at the shapes
of tests/test_kernels.py (TestGemmInt8), with ``w`` row-major and
column-major, and at ResNet-50's ragged ones; the arithmetic shift on
negative accumulators; the card's float64 product wrapping as the int32
product does; the split-K planner over ResNet-50's GEMMs and an int32
emulation of its K slices; ``chip_smoke.RESNET50_GEMMS`` against the repo's
own lowering of ResNet-50; and the checks of the CUDA wrapper, which run
before anything is built. The CUDA kernels themselves are checked on a card
(tests/test_torch_gpu.py)."""
import functools
import importlib.util
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the machine with the card has no JAX
pytest.importorskip("hypothesis", reason="property tests need the optional hypothesis extra")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.compiler.fusion import fuse  # noqa: E402
from repro.compiler.graph import WEIGHTED_OPS  # noqa: E402
from repro.compiler.zoo import resnet50  # noqa: E402
from repro.kernels.gemm_int8.kernel import gemm_int8_tpu  # noqa: E402
from repro.kernels.gemm_int8.ref import gemm_int8_reference as jax_reference  # noqa: E402
from repro_torch import hw  # noqa: E402
from repro_torch.kernels import SOURCES  # noqa: E402
from repro_torch.kernels.gemm_int8 import kernel, ops  # noqa: E402
from repro_torch.kernels.gemm_int8.ref import (  # noqa: E402
    _float64_product, gemm_int8_reference, requantize)

ROOT = Path(__file__).resolve().parents[1]
TILES = dict(bm=32, bn=32, bk=64)  # TestGemmInt8's tiles of the JAX kernel
H100_SMS = 132


@functools.cache
def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _inputs(m, n, k, seed, residual=False, bias_range=1000):
    """int8 a (m, k) and w (k, n) uniform on [-128, 128), int32 bias on
    [-bias_range, bias_range), int8 residual (m, n); numpy, from a seed."""
    r = np.random.default_rng(seed)
    a = r.integers(-128, 128, (m, k)).astype(np.int8)
    w = r.integers(-128, 128, (k, n)).astype(np.int8)
    b = r.integers(-bias_range, bias_range, n).astype(np.int32)
    res = r.integers(-128, 128, (m, n)).astype(np.int8) if residual else None
    return a, w, b, res


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _col(w):
    """The same (K, N) matrix column-major: K contiguous."""
    return w.t().contiguous().t()


def _check(a, w, b, res, shift, relu, col=False):
    """The port's plain version and CPU dispatch (``w`` column-major where
    ``col``) against the JAX oracle and ``gemm_int8_tpu`` in interpret mode,
    all bit-equal; returns the output."""
    tw = _col(_t(w)) if col else _t(w)
    got = gemm_int8_reference(_t(a), tw, _t(b), shift=shift, relu=relu, residual=_t(res))
    via_ops = ops.gemm_int8(_t(a), tw, _t(b), shift=shift, relu=relu, residual=_t(res))
    want = jax_reference(_j(a), _j(w), _j(b), shift=shift, relu=relu, residual=_j(res))
    bias = _j(b) if b is not None else jnp.zeros((w.shape[1],), jnp.int32)
    tpu = gemm_int8_tpu(_j(a), _j(w), bias, _j(res), shift=shift, relu=relu, interpret=True,
                        **TILES)
    assert got.dtype == via_ops.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(via_ops.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(tpu))
    return got


@pytest.mark.parametrize("m,n,k", [(64, 64, 64), (128, 128, 256), (100, 72, 300)])
def test_matches_jax(m, n, k):
    """tests/test_kernels.py:93-101."""
    a, w, b, _ = _inputs(m, n, k, seed=m + n + k)
    _check(a, w, b, None, shift=7, relu=False)


@pytest.mark.parametrize("m,n,k", [(64, 64, 64), (128, 128, 256), (100, 72, 300)])
def test_column_major_matches_jax(m, n, k):
    """The dispatch with ``w`` column-major (the layout of the K-major
    kernel on the card) computes the same function."""
    a, w, b, _ = _inputs(m, n, k, seed=m + n + k)
    assert kernel.w_layout(_col(_t(w))) == "col" and kernel.w_layout(_t(w)) == "row"
    _check(a, w, b, None, shift=7, relu=False, col=True)


def test_fused_residual_relu():
    """The FusedConvAdd(ReLU) epilogue, tests/test_kernels.py:103-113."""
    a, w, _, res = _inputs(64, 64, 128, seed=4, residual=True)
    out = _check(a, w, np.zeros(64, np.int32), res, shift=7, relu=True)
    assert int(out.min()) >= 0


def test_saturation():
    """tests/test_kernels.py:115-120: saturates instead of wrapping."""
    a = np.full((32, 512), 127, np.int8)
    w = np.full((512, 32), 127, np.int8)
    out = _check(a, w, np.zeros(32, np.int32), None, shift=0, relu=False)
    assert int(out.max()) == 127
    neg = _check(a, -w, np.zeros(32, np.int32), None, shift=0, relu=False)
    assert int(neg.min()) == -128


@pytest.mark.parametrize("shift", [0, 4, 8])
@pytest.mark.parametrize("relu", [False, True])
def test_shift_relu_grid(shift, relu):
    a, w, b, _ = _inputs(48, 32, 96, seed=10 * shift + relu, bias_range=64)
    _check(a, w, b, None, shift=shift, relu=relu)


@settings(max_examples=6, deadline=None)
@given(m=st.sampled_from([16, 32, 48]), k=st.sampled_from([64, 96]),
       shift=st.sampled_from([0, 4, 8]), relu=st.booleans())
def test_property_sweep(m, k, shift, relu):
    """tests/test_kernels.py:122-134, inputs from numpy."""
    a, w, b, _ = _inputs(m, 32, k, seed=m + k, bias_range=64)
    _check(a, w, b, None, shift=shift, relu=relu)


@pytest.mark.parametrize("shift", [1, 3, 5, 7])
def test_negative_accumulators_shift_arithmetically(shift):
    """All-negative products at odd shifts: a logical shift would turn them
    into large positives that saturate at 127; the arithmetic one rounds half
    up toward +inf (-3.5 -> -3, -4.5 -> -4)."""
    a = np.full((16, 32), -3, np.int8)
    w = np.full((32, 16), 5, np.int8)
    b = np.arange(-8, 8, dtype=np.int32) * 37
    out = _check(a, w, b, None, shift=shift, relu=False)
    acc = -3 * 5 * 32 + b.astype(np.int64)
    want = (acc + (1 << (shift - 1))) >> shift
    np.testing.assert_array_equal(out.numpy(), np.clip(np.broadcast_to(want, (16, 16)),
                                                       -128, 127))
    assert (out.numpy() < 0).all()


def test_bias_none():
    a, w, _, res = _inputs(33, 40, 64, seed=5, residual=True)
    _check(a, w, None, res, shift=7, relu=False)
    zeros = gemm_int8_reference(_t(a), _t(w), torch.zeros(40, dtype=torch.int32), residual=_t(res))
    assert torch.equal(ops.gemm_int8(_t(a), _t(w), residual=_t(res)), zeros)


@pytest.mark.parametrize("m,n,k,relu,residual", [
    (64, 96, 147, True, False),  # conv1's ragged K (positions cut to 64)
    (2, 1000, 2048, False, False),  # fc: N = 1000, M = the batch
    (48, 256, 64, True, True),  # a FusedConvAdd(ReLU)
])
def test_resnet50_ragged_shapes(m, n, k, relu, residual):
    a, w, b, res = _inputs(m, n, k, seed=k, residual=residual)
    _check(a, w, b, res, shift=7, relu=relu)


# ------------------------------------------- the card's float64 product --
def test_float64_product_is_the_int32_product():
    r = np.random.default_rng(17)
    a = torch.from_numpy(r.integers(-128, 128, (37, 300)).astype(np.int8))
    w = torch.from_numpy(r.integers(-128, 128, (300, 29)).astype(np.int8))
    want = a.to(torch.int32) @ w.to(torch.int32)
    got = _float64_product(a, w)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(_float64_product(a, _col(w)), want)


@pytest.mark.parametrize("k,wrapped", [(2**17, -2**31), (3 * 2**16, -2**30)])
def test_float64_product_wraps_as_int32(k, wrapped):
    """All -128: the true sum 2^14 K wraps modulo 2^32 as JAX's int32 dot and
    the int32 matmul do. At K = 3 2^16 a direct float-to-int32 cast gives
    -2^31 (x86's out-of-range value; PTX saturates to 2^31 - 1), not the
    wrapped -2^30: the product goes through int64."""
    a = torch.full((1, k), -128, dtype=torch.int8)
    w = torch.full((k, 1), -128, dtype=torch.int8)
    assert int(_float64_product(a, w)) == wrapped
    assert int(a.to(torch.int32) @ w.to(torch.int32)) == wrapped
    assert int(np.asarray(jnp.dot(jnp.asarray(a.numpy(), jnp.int32),
                                  jnp.asarray(w.numpy(), jnp.int32)))[0, 0]) == wrapped
    out = gemm_int8_reference(a, w, torch.zeros(1, dtype=torch.int32), shift=0)
    assert int(out) == -128


# ------------------------------------------------------- the split-K plan --
def _resnet50_nodes(batch):
    """(name, M, N, K) of each of the 54 GEMM nodes at ``batch``."""
    return [(name, batch * n, m, k) for name, m, n, k, _, _, count in _smoke().RESNET50_GEMMS
            for _ in range(count)]


FEW_BLOCK = ("layer3.0.conv2", "layer4.0.conv2", "layer4.1.conv1", "layer3.1.conv1",
             "layer2.0.conv2", "fc")


@pytest.mark.parametrize("batch", [1, 16])
def test_split_k_over_resnet50(batch):
    nodes = _resnet50_nodes(batch)
    assert len(nodes) == 54
    split = set()
    for name, M, N, K in nodes:
        bn = kernel.block_n(M, N, H100_SMS)
        S = kernel.split_k(M, N, K, H100_SMS)
        blocks = -(-M // kernel.BM) * -(-N // bn)
        tiles = -(-K // kernel.BK)
        assert bn in (64, 128) and 1 <= S <= kernel.MAX_SPLITS
        slices = kernel.k_slices(K, S)
        assert len(slices) == S and slices[0][0] == 0 and slices[-1][1] == K
        for (lo, hi), (nxt, _) in zip(slices, slices[1:]):
            assert hi == nxt and hi % kernel.BK == 0  # whole tiles, no gap
        if S > 1:
            assert blocks < H100_SMS and blocks * S <= H100_SMS, name
            assert all(hi - lo >= 2 * kernel.BK for lo, hi in slices), name
            split.add(name)
        else:
            assert blocks >= H100_SMS or tiles < 4 or H100_SMS // blocks < 2, name
    if batch == 1:  # the few-block long-K GEMMs fill the card by slices
        assert set(FEW_BLOCK) <= split
        for name, M, N, K in nodes:
            if name in FEW_BLOCK:
                blocks = -(-M // kernel.BM) * -(-N // kernel.block_n(M, N, H100_SMS))
                assert blocks <= 16 and blocks * kernel.split_k(M, N, K, H100_SMS) >= 64
    assert "conv1" not in split  # K = 147: three tiles, never split


def _split_emulation(a, w, b, shift, relu, residual, sms=H100_SMS):
    """The K-major kernel's arithmetic on the CPU: the planner's K slices,
    each an int32 product (a block of the cluster), their sum on uint32
    (emulated in int64 modulo 2^32), then the epilogue."""
    M, K = a.shape
    S = kernel.split_k(M, w.shape[1], K, sms)
    total = torch.zeros((M, w.shape[1]), dtype=torch.int64)
    for lo, hi in kernel.k_slices(K, S):
        part = a[:, lo:hi].to(torch.int32) @ w[lo:hi].to(torch.int32)
        total = (total + part.to(torch.int64)) & 0xFFFFFFFF
    acc = torch.where(total >= 2**31, total - 2**32, total).to(torch.int32)
    return S, requantize(acc, b, shift=shift, relu=relu, residual=residual)


@pytest.mark.parametrize("m,n,k,relu,residual", [
    (256, 256, 2304, True, False),  # layer3.0.conv2 at batch 1: 8 slices
    (64, 512, 4608, True, True),  # layer4.0.conv2's shape with a residual
    (1, 1000, 2048, False, False),  # fc at batch 1
    (16, 72, 300, False, False),  # ragged K, split into 2
])
def test_split_emulation_matches_reference(m, n, k, relu, residual):
    a, w, b, res = (_t(x) for x in _inputs(m, n, k, seed=m + k, residual=residual))
    S, got = _split_emulation(a, w, b, 7, relu, res)
    assert S > 1
    assert torch.equal(got, gemm_int8_reference(a, w, b, shift=7, relu=relu, residual=res))


def test_split_emulation_wraps():
    """M = N = 1, K = 2^17, all -128: 8 slices whose sum 2^31 wraps to
    -2^31, as the unsplit int32 product does; the output is -128."""
    a = torch.full((1, 2**17), -128, dtype=torch.int8)
    w = torch.full((2**17, 1), -128, dtype=torch.int8)
    zero = torch.zeros(1, dtype=torch.int32)
    S, got = _split_emulation(a, w, zero, 0, False, None)
    assert S == kernel.MAX_SPLITS
    assert int(got) == -128 == int(gemm_int8_reference(a, w, zero, shift=0))


def test_resnet50_table_is_the_fused_graph():
    """chip_smoke.RESNET50_GEMMS holds one row (name, m, n, k, relu, residual,
    count) per distinct GEMM shape of fuse(resnet50(256)), named by its first
    node; all 54 GEMM nodes requantise by 7."""
    smoke = _smoke()
    nodes = [nd for nd in fuse(resnet50(256)).nodes if nd.op in WEIGHTED_OPS]
    key = lambda nd: (nd.m, nd.n, nd.k, nd.relu, nd.residual_input is not None)  # noqa: E731
    counts = Counter(key(nd) for nd in nodes)
    first = {}
    for nd in nodes:
        first.setdefault(key(nd), nd.name)
    want = sorted((first[kk], *kk, n) for kk, n in counts.items())
    assert sorted(smoke.RESNET50_GEMMS) == want
    assert len(nodes) == 54 and len(want) == 22
    assert {nd.scale_shift for nd in nodes} == {smoke.RESNET50_SHIFT} == {7}


# ------------------------------------------------------- the CUDA wrapper --
def test_cuda_wrapper_refuses_before_building(monkeypatch):
    def no_build():
        raise AssertionError("the wrapper built the kernel before checking its inputs")

    monkeypatch.setattr(kernel, "_fwd", no_build)
    a, w, b, res = (_t(x) for x in _inputs(16, 8, 32, seed=1, residual=True))
    call = kernel.gemm_int8_cuda
    with pytest.raises(TypeError, match="a is torch.int16"):
        call(a.to(torch.int16), w, b, shift=7, relu=False)
    with pytest.raises(TypeError, match="w is torch.uint8"):
        call(a, w.to(torch.uint8), b, shift=7, relu=False)
    with pytest.raises(TypeError, match="bias is torch.int64"):
        call(a, w, b.long(), shift=7, relu=False)
    with pytest.raises(TypeError, match="residual is torch.int32"):
        call(a, w, b, res.int(), shift=7, relu=False)
    with pytest.raises(ValueError, match="want a"):
        call(a, w[:31], b, shift=7, relu=False)
    with pytest.raises(ValueError, match="want a"):
        call(a[None], w, b, shift=7, relu=False)
    with pytest.raises(ValueError, match="want bias"):
        call(a, w, b[:7], shift=7, relu=False)
    with pytest.raises(ValueError, match="want residual"):
        call(a, w, b, res[:, :7], shift=7, relu=False)
    with pytest.raises(ValueError, match="empty"):
        call(a[:0], w, b, shift=7, relu=False)
    for shift in (-1, 32, 7.0, True):
        with pytest.raises(ValueError, match="shift"):
            call(a, w, b, shift=shift, relu=False)
    neither = torch.empty((32, 16), dtype=torch.int8)[:, ::2]  # (K, N), strides (2N, 2)
    with pytest.raises(ValueError, match="contiguous"):
        call(a, neither.copy_(w), b, shift=7, relu=False)
    with pytest.raises(ValueError, match="contiguous"):
        call(a.t().contiguous().t(), w, b, shift=7, relu=False)
    with pytest.raises(ValueError, match="CUDA device"):
        call(a, w, b, shift=7, relu=False)  # CPU tensors never reach the kernel
    with pytest.raises(ValueError, match="CUDA device"):  # column-major w passes the checks
        call(a, _col(w), b, shift=7, relu=False)
    assert kernel.launches == 0


def test_dispatch_refuses_other_devices():
    a, w, b, _ = (_t(x) for x in _inputs(4, 4, 4, seed=2))
    with pytest.raises(ValueError, match="no gemm_int8 path for device meta"):
        ops.gemm_int8(a.to("meta"), w.to("meta"), b.to("meta"))


def test_source_is_listed():
    assert SOURCES["gemm_int8"] == kernel.SOURCE and kernel.SOURCE.exists()
    text = kernel.SOURCE.read_text()
    assert "src/repro/kernels/gemm_int8/kernel.py:62" in text
    assert 'extern "C" int gemm_int8_fwd' in text
    assert 'extern "C" int gemm_int8_kmajor_fwd' in text
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in text
    assert "cp.async.cg.shared.global" in text and "ldmatrix.sync.aligned.m8n8.x4" in text


def test_bound_at_the_timed_shape():
    """The bound chip_smoke.py reports for layer3's 3x3 conv at batch 16
    (M = 4096, N = 256, K = 2304): 11.08 MB of a, w, bias and output at the
    HBM rate, above 4.83 G int8 operations at the tensor-core peak."""
    M, N, K = 4096, 256, 2304
    n_bytes = M * K + K * N + 4 * N + M * N
    t, by = hw.bound_seconds(n_bytes, 2 * M * N * K, hw.INT8_TENSOR_OPS)
    assert by == "bytes"
    assert abs(t - 3.3065e-6) < 1e-9
    t_ops, _ = hw.bound_seconds(0, 2 * M * N * K, hw.INT8_TENSOR_OPS)
    assert abs(t_ops - 2.4415e-6) < 1e-9
