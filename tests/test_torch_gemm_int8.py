"""The port's INT8 PU GEMM: its plain version and its CPU dispatch against the
JAX oracle and the JAX kernel (in interpret mode), bit for bit, at the shapes
of tests/test_kernels.py (TestGemmInt8) and at ResNet-50's ragged ones; the
arithmetic shift on negative accumulators; ``chip_smoke.RESNET50_GEMMS``
against the repo's own lowering of ResNet-50; and the checks of the CUDA
wrapper, which run before anything is built. The CUDA kernel itself is
checked on a card (tests/test_torch_gpu.py)."""
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
from repro_torch.kernels.gemm_int8.ref import gemm_int8_reference  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TILES = dict(bm=32, bn=32, bk=64)  # TestGemmInt8's tiles of the JAX kernel


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


def _check(a, w, b, res, shift, relu):
    """The port's plain version and CPU dispatch against the JAX oracle and
    ``gemm_int8_tpu`` in interpret mode, all bit-equal; returns the output."""
    got = gemm_int8_reference(_t(a), _t(w), _t(b), shift=shift, relu=relu, residual=_t(res))
    via_ops = ops.gemm_int8(_t(a), _t(w), _t(b), shift=shift, relu=relu, residual=_t(res))
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


def test_resnet50_table_is_the_fused_graph():
    """chip_smoke.RESNET50_GEMMS holds one row (name, m, n, k, relu, residual,
    count) per distinct GEMM shape of fuse(resnet50(256)), named by its first
    node; all 54 GEMM nodes requantise by 7."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
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
    with pytest.raises(ValueError, match="contiguous"):
        call(a, w.t().contiguous().t(), b, shift=7, relu=False)
    with pytest.raises(ValueError, match="CUDA device"):
        call(a, w, b, shift=7, relu=False)  # CPU tensors never reach the kernel
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
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in text


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
