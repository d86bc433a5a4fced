"""The CUDA kernels (flash attention, wkv6, the SSD scan, the INT8 PU GEMM)
against their plain PyTorch versions, the pipeline executor on CUDA
streams against the plain forward, the executor across processes (ranks on
one card over gloo; over nccl where there are two cards), the MoE FFN and the patch and frame
frontends on the card against the same code on the CPU, and training on
the card: each kernel's gradient (``FlashAttention``, ``WKV6``, ``SSDScan``)
against the plain version's, the kernels alone without grad, a train step
against the same step on the CPU, and the DSE's float64 torch scorer on the
card against its numpy scorer. This file imports no JAX (the
machine with the card has none); every test here needs a CUDA device and
skips without one:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ops  # noqa: E402
from repro_torch.kernels.gemm_int8 import kernel as gemm_kernel  # noqa: E402
from repro_torch.kernels.gemm_int8 import ops as gemm_ops  # noqa: E402
from repro_torch.kernels.gemm_int8.ref import gemm_int8_reference  # noqa: E402
from repro_torch.kernels.flash_attention.ref import mha_reference  # noqa: E402
from repro_torch.kernels.rwkv6 import kernel as wkv6_kernel  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wkv6_ops  # noqa: E402
from repro_torch.kernels.rwkv6.ref import wkv6_reference  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_reference  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.runtime import optimizer as opt  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.runtime import pipeline as pp  # noqa: E402
from repro_torch.runtime import pipeline_ranks as pr  # noqa: E402
from repro_torch.runtime import train  # noqa: E402

# (b, s, H, G, hd, window, dtype, tol): the shapes and tolerances of
# tests/test_kernels.py:28-61, head dims 112 (zamba2-7b's shared blocks, MHA)
# and 120 (h2o-danube-3-4b, windowed), and the qwen3-0.6b serving prefill
# shape (1024-long fp32 sums in another order than the plain softmax: 1e-4)
CASES = [
    (2, 96, 4, 4, 112, None, torch.float32, 2e-5),
    (1, 130, 4, 2, 120, 64, torch.float32, 2e-5),
    (1, 64, 4, 4, 112, None, torch.bfloat16, 3e-2),
    (2, 64, 4, 4, 32, None, torch.float32, 2e-5),
    (2, 64, 8, 2, 32, None, torch.float32, 2e-5),
    (2, 96, 4, 1, 64, None, torch.float32, 2e-5),
    (2, 128, 2, 2, 16, None, torch.float32, 2e-5),
    (1, 128, 4, 2, 32, 16, torch.float32, 2e-5),
    (1, 128, 4, 2, 32, 32, torch.float32, 2e-5),
    (1, 128, 4, 2, 32, 100, torch.float32, 2e-5),
    (1, 64, 4, 2, 32, None, torch.bfloat16, 3e-2),
    (4, 1024, 16, 8, 128, None, torch.float32, 1e-4),
    # the kernel's tiles (256 q rows, 32 kv rows; 64 and 16 at hd 256): s
    # not a multiple of either, windows whose left edge falls mid-tile at hd
    # 112 and 120, hd 16 and 256 at ragged s
    (1, 161, 4, 2, 64, None, torch.float32, 2e-5),
    (2, 200, 8, 8, 128, None, torch.float32, 2e-5),
    (1, 300, 4, 4, 112, 77, torch.float32, 2e-5),
    (1, 333, 8, 2, 120, 45, torch.float32, 2e-5),
    (1, 150, 4, 2, 16, None, torch.float32, 2e-5),
    (1, 77, 4, 2, 256, None, torch.float32, 2e-5),
    (1, 99, 2, 1, 256, 20, torch.float32, 2e-5),
    (1, 150, 4, 4, 112, None, torch.bfloat16, 3e-2),
    # musicgen-large's MHA at hd 64 (32 heads, 32 kv heads) at a reduced length
    (2, 256, 32, 32, 64, None, torch.float32, 2e-5),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _qkv(b, s, H, G, hd, seed, dtype):
    r = np.random.default_rng(seed)
    arrs = (0.5 * r.standard_normal((b, s, H, hd)), 0.5 * r.standard_normal((b, s, G, hd)),
            r.standard_normal((b, s, G, hd)))
    return tuple(torch.from_numpy(a.astype(np.float32)).to("cuda", dtype) for a in arrs)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,H,G,hd,window,dtype,tol", CASES)
def test_cuda_kernel_matches_plain(cuda, b, s, H, G, hd, window, dtype, tol):
    q, k, v = _qkv(b, s, H, G, hd, seed=s + hd, dtype=dtype)
    before = kernel.launches
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ref = mha_reference(q, k, v, causal=True, window=window)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("s,hd,window", [(64, 32, None), (150, 112, None), (130, 120, 64)])
def test_cuda_kernel_bf16_within_twice_plain_error(cuda, s, hd, window):
    """bf16 in, fp32 math: the kernel's error against fp32 math on the same
    bf16 inputs is at most twice the plain bf16 version's."""
    q, k, v = _qkv(1, s, 4, 2, hd, seed=s + hd + 1, dtype=torch.bfloat16)
    out = kernel.flash_attention_cuda(q, k, v, causal=True, window=window)
    ref = mha_reference(q, k, v, causal=True, window=window)
    exact = mha_reference(q.float(), k.float(), v.float(), causal=True, window=window)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    k_err = (out.float() - exact).abs().max().item()
    p_err = (ref.float() - exact).abs().max().item()
    assert k_err <= 2 * p_err, (k_err, p_err)


@pytest.mark.gpu
@pytest.mark.parametrize("hd,window", [(32, None), (120, None), (120, 50)])
def test_cuda_kernel_rows_sum_to_one(cuda, hd, window):
    q, k, _ = _qkv(1, 130, 4, 2, hd, seed=hd, dtype=torch.float32)
    v = torch.ones_like(k)
    out = kernel.flash_attention_cuda(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, torch.ones_like(out), rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_cuda_kernel_refuses_non_contiguous(cuda):
    q, k, v = _qkv(1, 64, 4, 2, 32, seed=0, dtype=torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.flash_attention_cuda(q.transpose(1, 2), k, v)


# ------------------------------------------------------------------- wkv6 --
def _wkv6_inputs(b, s, H, P, seed, state_scale=0.0, model_decay=False):
    """TestWKV6's distributions (tests/test_kernels.py:189-197), or with
    ``model_decay`` the model's decay regime w = exp(-exp(N(0, 0.5)))."""
    r = np.random.default_rng(seed)
    rr = 0.5 * r.standard_normal((b, s, H, P))
    kk = 0.5 * r.standard_normal((b, s, H, P))
    vv = r.standard_normal((b, s, H, P))
    if model_decay:
        ww = np.exp(-np.exp(0.5 * r.standard_normal((b, s, H, P))))
    else:
        ww = 1.0 / (1.0 + np.exp(-(r.standard_normal((b, s, H, P)) + 2.0)))
    uu = 0.5 * r.standard_normal((H, P))
    st = state_scale * r.standard_normal((b, H, P, P))
    return [torch.from_numpy(a.astype(np.float32)).cuda() for a in (rr, kk, vv, ww, uu, st)]


# (b, s, H, P, state scale, model decay, tol): tests/test_kernels.py:199-229
# (s 48/64/50, the nonzero state, the P = 8 sweep) at 2e-4, P = 32 and 64,
# and the rwkv6-7b prefill shape, where y reaches ~10 and the kernel sums
# 64 products in another order than the plain einsum (fp32: 1e-4)
WKV6_CASES = [
    (1, 48, 2, 16, 0.0, False, 2e-4),
    (1, 64, 2, 16, 0.0, False, 2e-4),
    (1, 50, 2, 16, 0.0, False, 2e-4),
    (1, 32, 2, 16, 1.0, False, 2e-4),
    (1, 40, 2, 8, 0.0, False, 2e-4),
    (2, 70, 3, 32, 0.5, False, 2e-4),
    (2, 100, 4, 64, 0.5, True, 2e-4),
    (4, 1024, 64, 64, 0.0, True, 1e-4),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,H,P,state_scale,model_decay,tol", WKV6_CASES)
def test_wkv6_kernel_matches_plain(cuda, b, s, H, P, state_scale, model_decay, tol):
    args = _wkv6_inputs(b, s, H, P, seed=s + P, state_scale=state_scale,
                        model_decay=model_decay)
    before = wkv6_kernel.launches
    y, st = wkv6_ops.wkv6(*args)
    torch.cuda.synchronize()
    assert wkv6_kernel.launches == before + 1
    y_ref, st_ref = wkv6_reference(*args)
    torch.testing.assert_close(y, y_ref, rtol=tol, atol=tol)
    torch.testing.assert_close(st, st_ref, rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("P", [8, 16, 64])
def test_wkv6_kernel_decode_step_in_place(cuda, P):
    """s = 1 with the state aliased (the decode path's cache update)."""
    args = _wkv6_inputs(2, 1, 64 // P * 4, P, seed=P, state_scale=0.5, model_decay=True)
    state = args[5]
    y_ref, st_ref = wkv6_reference(*args[:5], state.clone())
    before = wkv6_kernel.launches
    y, st = wkv6_ops.wkv6(*args, state_out=state)
    torch.cuda.synchronize()
    assert wkv6_kernel.launches == before + 1
    assert st is state
    torch.testing.assert_close(y, y_ref, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(state, st_ref, rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
def test_wkv6_kernel_tile_invariance(cuda):
    """The tile decides only when inputs are staged, not the order of the
    sums: chunk 8 and 32 agree at 1e-5 (tests/test_kernels.py:215-221)."""
    args = _wkv6_inputs(1, 64, 2, 16, seed=4)
    before = wkv6_kernel.launches
    y1, s1 = wkv6_kernel.wkv6_cuda(*args, chunk=8)
    y2, s2 = wkv6_kernel.wkv6_cuda(*args, chunk=32)
    torch.cuda.synchronize()
    assert wkv6_kernel.launches == before + 2
    torch.testing.assert_close(y1, y2, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s1, s2, rtol=1e-5, atol=1e-5)


def _offset_copy(x, floats=1):
    """``x`` again, contiguous but starting ``floats`` past a 16-byte boundary:
    the kernels then stage it with 4-byte copies."""
    buf = torch.empty(x.numel() + floats, dtype=x.dtype, device=x.device)
    out = buf[floats:].view(x.shape)
    out.copy_(x)
    return out


# (b, H, P): every instantiated plan (wkv6_kernel.plan), the rwkv6-7b decode
# lane's column split (P = 64 at b = 1) and its prefill plan (b = 4)
WKV6_PLAN_SHAPES = [(1, 2, 8), (1, 2, 16), (2, 3, 32), (1, 64, 64), (4, 64, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,H,P", WKV6_PLAN_SHAPES)
def test_wkv6_kernel_every_plan(cuda, b, H, P):
    """Each plan against the plain version at TestWKV6's tolerance, s = 77
    (a ragged last tile), nonzero state."""
    args = _wkv6_inputs(b, 77, H, P, seed=b + H + P, state_scale=0.5)
    y, st = wkv6_kernel.wkv6_cuda(*args)
    y_ref, st_ref = wkv6_reference(*args)
    torch.testing.assert_close(y, y_ref, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(st, st_ref, rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("b,H,P", WKV6_PLAN_SHAPES)
def test_wkv6_kernel_tile_invariance_every_plan(cuda, b, H, P):
    """The order of every sum depends on the plan, not the tile: tiles of 1,
    16 and 75 steps (and 4-byte copies of unaligned rows) give the same bits."""
    args = _wkv6_inputs(b, 77, H, P, seed=b + H + P + 1, state_scale=0.5)
    outs = [wkv6_kernel.wkv6_cuda(*args, chunk=c) for c in (1, 16, 75)]
    outs.append(wkv6_kernel.wkv6_cuda(*(_offset_copy(a) for a in args[:4]), *args[4:]))
    torch.cuda.synchronize()
    for y, st in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(st, outs[0][1])


@pytest.mark.gpu
def test_wkv6_kernel_decode_column_split_in_place(cuda):
    """The rwkv6-7b decode step: b = 1, H = 64, P = 64, 16 columns a block
    (256 blocks), the state read and written in place; and the same step
    at b = 4, whose plan keeps all 64 columns in a block."""
    assert wkv6_kernel.plan(1, 1, 64, 64)["pc"] == 16
    assert wkv6_kernel.plan(4, 1, 64, 64)["pc"] == 64
    for b in (1, 4):
        args = _wkv6_inputs(b, 1, 64, 64, seed=64 + b, state_scale=0.5, model_decay=True)
        state = args[5]
        y_ref, st_ref = wkv6_reference(*args[:5], state.clone())
        y, st = wkv6_kernel.wkv6_cuda(*args, state_out=state)
        torch.cuda.synchronize()
        assert st is state
        torch.testing.assert_close(y, y_ref, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(state, st_ref, rtol=2e-4, atol=2e-4)


# --------------------------------------------------------------- ssd scan --
def _ssd_inputs(b, s, H, P, N, seed, model=False):
    """TestSSDScan's distributions (tests/test_kernels.py:139-146): xh, B, C ~
    N(0, 1), dt = softplus(N(0, 1)), A = -exp(0.5 N(0, 1)); the model draws dt
    and A the same way (dt_bias 0, A_log ~ N(0, 0.5))."""
    r = np.random.default_rng(seed)
    xh = r.standard_normal((b, s, H, P))
    dt = np.logaddexp(r.standard_normal((b, s, H)), 0.0)
    A = -np.exp(0.5 * r.standard_normal(H))
    B = r.standard_normal((b, s, N))
    C = r.standard_normal((b, s, N))
    return [torch.from_numpy(a.astype(np.float32)).cuda() for a in (xh, dt, A, B, C)]


# (b, s, H, P, N, tol): the TestSSDScan lengths (64, 96, ragged 100) at
# b=1, H=2, P=16, N=8 and 2e-4, the reduced zamba2 shape, and one
# (P, N) = (64, 64) case at the zamba2-7b head count, where each y sums 64
# products in another order than the plain einsum (1e-4)
SSD_CASES = [
    (1, 64, 2, 16, 8, 2e-4),
    (1, 96, 2, 16, 8, 2e-4),
    (1, 100, 2, 16, 8, 2e-4),
    (2, 70, 8, 32, 16, 2e-4),
    (2, 200, 112, 64, 64, 1e-4),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,H,P,N,tol", SSD_CASES)
def test_ssd_kernel_matches_plain(cuda, b, s, H, P, N, tol):
    """y and the final state against the sequential recurrence, and the
    dispatch (y only) through the kernel."""
    args = _ssd_inputs(b, s, H, P, N, seed=s + P + N)
    before = ssd_kernel.launches
    y, h = ssd_kernel.ssd_scan_cuda(*args)
    y_ops = ssd_ops.ssd_scan(*args)
    torch.cuda.synchronize()
    assert ssd_kernel.launches == before + 2
    y_ref, h_ref = ssd_reference(*args)
    torch.testing.assert_close(y, y_ref, rtol=tol, atol=tol)
    torch.testing.assert_close(h, h_ref, rtol=tol, atol=tol)
    assert torch.equal(y_ops, y)
    torch.testing.assert_close(ssd_chunked(*args), y, rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [32, 48, 64])
@pytest.mark.parametrize("P", [8, 16])
@pytest.mark.parametrize("N", [4, 8])
def test_ssd_kernel_sweep(cuda, s, P, N):
    """tests/test_kernels.py:176-184 (the property sweep, every draw), 3e-4."""
    args = _ssd_inputs(1, s, 2, P, N, seed=s + P + N)
    y, h = ssd_kernel.ssd_scan_cuda(*args)
    y_ref, h_ref = ssd_reference(*args)
    torch.testing.assert_close(y, y_ref, rtol=3e-4, atol=3e-4)
    torch.testing.assert_close(h, h_ref, rtol=3e-4, atol=3e-4)


@pytest.mark.gpu
def test_ssd_kernel_tile_invariance(cuda):
    """The tile decides only when inputs are staged, not the order of the
    sums: tiles of 8, 32 and 42 steps give the same bits."""
    args = _ssd_inputs(1, 100, 4, 64, 64, seed=4)
    outs = [ssd_kernel.ssd_scan_cuda(*args, chunk=c) for c in (8, 32, 42)]
    torch.cuda.synchronize()
    for y, h in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(h, outs[0][1])


@pytest.mark.gpu
@pytest.mark.parametrize("P,N", ssd_kernel.SHAPES)
def test_ssd_kernel_every_plan(cuda, P, N):
    """Each instantiated (P, N) and its plan against the sequential
    recurrence at TestSSDScan's tolerance, s = 77 (a ragged last tile)."""
    args = _ssd_inputs(2, 77, 3, P, N, seed=P + N)
    y, h = ssd_kernel.ssd_scan_cuda(*args)
    y_ref, h_ref = ssd_reference(*args)
    torch.testing.assert_close(y, y_ref, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(h, h_ref, rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("P,N", ssd_kernel.SHAPES)
def test_ssd_kernel_tile_invariance_every_plan(cuda, P, N):
    """Tiles of 1, 16 and 77 steps, and 4-byte copies of unaligned rows of
    xh, B and C, give the same bits at every plan."""
    args = _ssd_inputs(2, 77, 3, P, N, seed=P + N + 1)
    outs = [ssd_kernel.ssd_scan_cuda(*args, chunk=c) for c in (1, 16, 77)]
    xh, dt, A, B, C = args
    outs.append(ssd_kernel.ssd_scan_cuda(_offset_copy(xh), dt, A, _offset_copy(B),
                                         _offset_copy(C)))
    torch.cuda.synchronize()
    for y, h in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(h, outs[0][1])


# -------------------------------------------------------------- gemm int8 --
def _gemm_inputs(m, n, k, seed, residual=False, bias_range=1000):
    r = np.random.default_rng(seed)
    a = r.integers(-128, 128, (m, k)).astype(np.int8)
    w = r.integers(-128, 128, (k, n)).astype(np.int8)
    b = r.integers(-bias_range, bias_range, n).astype(np.int32)
    res = r.integers(-128, 128, (m, n)).astype(np.int8) if residual else None
    return [None if x is None else torch.from_numpy(x).cuda() for x in (a, w, b, res)]


def _layout(w, layout):
    """The same (K, N) matrix row-major (N contiguous) or column-major (K
    contiguous); each layout takes its own kernel."""
    return w if layout == "row" else w.t().contiguous().t()


# (m, n, k, shift, relu, residual): TestGemmInt8's shapes
# (tests/test_kernels.py:93-134) with their epilogues, and five of
# ResNet-50's GEMMs at batch 1 as chip_smoke.py maps them (M = positions,
# N = output channels): conv1 (ragged K = 147), layer3's FusedConvAdd(ReLU),
# fc (M = 1, N = 1000), layer3's 3x3 conv and layer4's with a residual (few
# blocks, long K: the column-major kernel splits K on them, as on fc). Integer
# sums are exact in any order: bit-equal.
GEMM_CASES = [
    (64, 64, 64, 7, False, False),
    (128, 128, 256, 7, False, False),
    (100, 72, 300, 7, False, False),
    (64, 64, 128, 7, True, True),
    (48, 32, 96, 0, False, False),
    (48, 32, 96, 4, True, False),
    (16, 32, 64, 8, True, False),
    (16384, 64, 147, 7, True, False),
    (256, 1024, 256, 7, True, True),
    (1, 1000, 2048, 7, False, False),
    (256, 256, 2304, 7, True, False),
    (64, 512, 4608, 7, True, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["row", "col"])
@pytest.mark.parametrize("m,n,k,shift,relu,residual", GEMM_CASES)
def test_gemm_int8_kernel_matches_plain(cuda, m, n, k, shift, relu, residual, layout):
    a, w, b, res = _gemm_inputs(m, n, k, seed=m + n + k, residual=residual)
    before = gemm_kernel.launches
    out = gemm_ops.gemm_int8(a, _layout(w, layout), b, shift=shift, relu=relu, residual=res)
    torch.cuda.synchronize()
    assert gemm_kernel.launches == before + 1
    want = gemm_int8_reference(a, w, b, shift=shift, relu=relu, residual=res)
    assert out.dtype == torch.int8 and torch.equal(out, want)
    cpu = gemm_int8_reference(*(x.cpu() for x in (a, w, b)), shift=shift, relu=relu,
                              residual=None if res is None else res.cpu())
    assert torch.equal(want.cpu(), cpu)  # float64 on the card = int32 on the CPU


@pytest.mark.gpu
def test_gemm_int8_splits_k_on_few_block_shapes(cuda):
    """On the card's SM count the planner splits the few-block cases above,
    and the split is bit-equal to the unsplit row-major kernel."""
    sms = gemm_kernel.sm_count(torch.cuda.current_device())
    for m, n, k in ((1, 1000, 2048), (256, 256, 2304), (64, 512, 4608)):
        assert gemm_kernel.split_k(m, n, k, sms) > 1
        a, w, b, _ = _gemm_inputs(m, n, k, seed=k)
        col = gemm_kernel.gemm_int8_cuda(a, _layout(w, "col"), b, shift=7, relu=False)
        row = gemm_kernel.gemm_int8_cuda(a, w, b, shift=7, relu=False)
        assert torch.equal(col, row)


@pytest.mark.gpu
def test_gemm_int8_wraps_as_jax(cuda):
    """M = N = 1, K = 2^17, all -128: the sum 2^31 wraps to -2^31, as JAX's
    int32 dot does, and the output at shift 0 is -128 from the row-major
    kernel, the column-major one (K split into slices), the plain version on
    the card and the CPU's int32 product; a saturating route gives +127."""
    K = 2**17
    a = torch.full((1, K), -128, dtype=torch.int8, device="cuda")
    w = torch.full((K, 1), -128, dtype=torch.int8, device="cuda")
    w_col = torch.empty_strided((K, 1), (1, K), dtype=torch.int8, device="cuda").copy_(w)
    assert gemm_kernel.w_layout(w) == "row" and gemm_kernel.w_layout(w_col) == "col"
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    outs = [gemm_kernel.gemm_int8_cuda(a, w, zero, shift=0, relu=False),
            gemm_kernel.gemm_int8_cuda(a, w_col, zero, shift=0, relu=False),
            gemm_int8_reference(a, w, zero, shift=0),
            gemm_int8_reference(a.cpu(), w.cpu(), zero.cpu(), shift=0)]
    torch.cuda.synchronize()
    assert [int(o) for o in outs] == [-128] * 4


@pytest.mark.gpu
def test_gemm_int8_saturates_and_shifts_negatives(cuda):
    a = torch.full((32, 512), 127, dtype=torch.int8, device="cuda")
    w = torch.full((512, 32), 127, dtype=torch.int8, device="cuda")
    for layout in ("row", "col"):
        out = gemm_ops.gemm_int8(a, _layout(w, layout), shift=0)
        assert int(out.min()) == int(out.max()) == 127
        assert int(gemm_ops.gemm_int8(a, _layout(-w, layout), shift=0).max()) == -128
    a = torch.full((16, 32), -3, dtype=torch.int8, device="cuda")
    w = torch.full((32, 16), 5, dtype=torch.int8, device="cuda")
    b = (torch.arange(-8, 8, dtype=torch.int32) * 37).cuda()
    for shift in (1, 3, 5, 7):
        for layout in ("row", "col"):
            got = gemm_ops.gemm_int8(a, _layout(w, layout), b, shift=shift)
            assert torch.equal(got, gemm_int8_reference(a, w, b, shift=shift))
            assert bool((got < 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["row", "col"])
def test_gemm_int8_unaligned_rows_take_the_byte_loads(cuda, layout):
    """Contiguous operands one byte off their allocation: the kernels'
    16-byte loads would be misaligned, so the row-major kernel takes its
    byte loads and the column-major one its word gathers."""
    m, n, k = 96, 64, 128
    a0, w0, b, res0 = _gemm_inputs(m, n, k, seed=7, residual=True)
    a = torch.empty(m * k + 1, dtype=torch.int8, device="cuda")[1:].view(m, k).copy_(a0)
    if layout == "row":
        w = torch.empty(k * n + 1, dtype=torch.int8, device="cuda")[1:].view(k, n).copy_(w0)
    else:
        w = torch.empty(k * n + 1, dtype=torch.int8, device="cuda")[1:].view(n, k).t()
        w.copy_(w0)
    assert gemm_kernel.w_layout(w) == layout
    out = gemm_kernel.gemm_int8_cuda(a, w, b, res0, shift=7, relu=True)
    assert torch.equal(out, gemm_int8_reference(a0, w0, b, shift=7, relu=True, residual=res0))


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("m,n,k", [(130, 72, 147), (33, 65, 300), (64, 256, 2053)])
def test_gemm_int8_column_major_gathers_at_any_alignment(cuda, m, n, k, offset):
    """The column-major kernel's word gathers (K % 16 != 0 or a base off 16
    bytes) at every byte offset, ragged M and N, and a long odd K that
    splits, against the plain version."""
    a0, w0, b, res0 = _gemm_inputs(m, n, k, seed=k + offset, residual=True)
    a = torch.empty(m * k + offset, dtype=torch.int8, device="cuda")[offset:].view(m, k)
    w = torch.empty(k * n + offset, dtype=torch.int8, device="cuda")[offset:].view(n, k).t()
    a.copy_(a0)
    w.copy_(w0)
    out = gemm_kernel.gemm_int8_cuda(a, w, b, res0, shift=7, relu=True)
    assert torch.equal(out, gemm_int8_reference(a0, w0, b, shift=7, relu=True, residual=res0))


@pytest.mark.gpu
def test_gemm_int8_refuses_non_contiguous(cuda):
    """w of neither layout (strides (2N, 2)) and a column-major a are
    refused; a column-major w is a layout of the contract."""
    a, w, b, _ = _gemm_inputs(64, 64, 64, seed=0)
    neither = torch.empty((64, 128), dtype=torch.int8, device="cuda")[:, ::2].copy_(w)
    with pytest.raises(ValueError, match="contiguous"):
        gemm_kernel.gemm_int8_cuda(a, neither, b, shift=7, relu=False)
    with pytest.raises(ValueError, match="contiguous"):
        gemm_kernel.gemm_int8_cuda(a.t(), w, b, shift=7, relu=False)
    out = gemm_kernel.gemm_int8_cuda(a, w.t().contiguous().t(), b, shift=7, relu=False)
    assert torch.equal(out, gemm_int8_reference(a, w, b, shift=7))


# ------------------------------------------------------ pipeline executor --
@pytest.mark.gpu
@pytest.mark.parametrize("L,S", [(4, 4), (5, 4)])
def test_pipeline_on_streams_matches_forward(cuda, L, S):
    """Reduced h2o-danube-3-4b (window 64) at s = 96, fp32: the executor on
    one CUDA stream a stage, its tokens CUDA events, against the plain
    forward at 2e-3; the token counts are the programs'."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = replace(get_config("h2o-danube-3-4b").reduced(), num_layers=L)
    params = tf.init_params(cfg, seed=0, dtype=torch.float32)
    M, mb, s = 3, 2, 96
    toks = torch.randint(0, cfg.vocab_size, (M, mb, s), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(1))
    plan = pp.plan_pipeline(cfg, n_stages=S, microbatches=M, seq_len=s, microbatch_size=mb)
    fn = pp.make_pipeline_forward(cfg, plan)
    out = fn(pp.stack_stage_params(cfg, params, plan), toks)
    want, _ = tf.forward(cfg, params, {"tokens": toks.reshape(M * mb, s)})
    torch.testing.assert_close(out.reshape(M * mb, s, -1), want, rtol=2e-3, atol=2e-3)
    assert fn.counts == pp.program_sync_counts(plan)
    assert [len(ms) for ms in fn.stage_ms] == [M] * S


def _rank_call(L, S, backend):
    """Reduced h2o-danube-3-4b at s = 96 (window 64), fp32, S ranks of the
    executor across processes, their params shared from this process by CUDA
    IPC; and the one-card executor, run first (it builds the flash kernel, so
    the ranks only load it)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = replace(get_config("h2o-danube-3-4b").reduced(), num_layers=L)
    params = tf.init_params(cfg, seed=0, dtype=torch.float32)
    M, mb, s = 3, 2, 96
    toks = torch.randint(0, cfg.vocab_size, (M, mb, s),
                         generator=torch.Generator().manual_seed(1))
    plan = pp.plan_pipeline(cfg, n_stages=S, microbatches=M, seq_len=s, microbatch_size=mb)
    sp = pp.stack_stage_params(cfg, params, plan)
    one = pp.make_pipeline_forward(cfg, plan)(sp, toks.cuda()).cpu()
    slices = pr.PerRank([pr.stage_slice(cfg, sp, plan, r) for r in range(S)])
    ranks = pr.spawn_stages(S, pr.forward_rank, cfg, plan, slices, toks, backend=backend,
                            timeout_s=300)
    want, _ = tf.forward(cfg, params, {"tokens": toks.reshape(M * mb, s).cuda()})
    return plan, M, one, want.cpu(), ranks


@pytest.mark.gpu
@pytest.mark.parametrize("L,S", [(4, 2), (5, 2)])
def test_ranks_on_one_card_over_gloo_match_the_one_card_executor(cuda, L, S):
    """Two ranks on one card, the host transport (pinned SB/RB, each copy
    synchronized): the logits of the one-card executor (1e-5; the same
    kernels on the same inputs) and of the plain forward (2e-3), the
    programs' token operations, a Compute time and the messages a round."""
    plan, M, one, want, ranks = _rank_call(L, S, "gloo")
    out = ranks[-1]["logits"]
    torch.testing.assert_close(out, one, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out.reshape(want.shape), want, rtol=2e-3, atol=2e-3)
    assert [r["counts"] for r in ranks] == pp.program_sync_counts(plan)
    assert [len(r["stage_ms"]) for r in ranks] == [M] * S
    kinds = [[m[0] for m in r["messages"]] for r in ranks]
    assert [k.count("d2h") for k in kinds] == [M * (i < S - 1) for i in range(S)]
    assert [k.count("h2d") for k in kinds] == [M * (i > 0) for i in range(S)]


@pytest.mark.gpu
@pytest.mark.parametrize("S", [2, 4])
def test_ranks_over_nccl_one_card_a_rank(cuda, S):
    """The device transport (SB/RB on the cards, REQs and ACKs in process
    groups of their own), S ranks on S cards: held to the one-card
    executor and the plain forward. Runs only where there are S cards."""
    if torch.cuda.device_count() < S:
        pytest.skip(f"the nccl transport takes one card a rank; this machine has "
                    f"{torch.cuda.device_count()}, not {S}")
    plan, M, one, want, ranks = _rank_call(4, S, "nccl")
    out = ranks[-1]["logits"]
    torch.testing.assert_close(out, one, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out.reshape(want.shape), want, rtol=2e-3, atol=2e-3)
    assert [r["counts"] for r in ranks] == pp.program_sync_counts(plan)
    assert [len(r["stage_ms"]) for r in ranks] == [M] * S
    assert all(r["messages"] == [] or {m[0] for m in r["messages"]} == {"send_recv"}
               for r in ranks)  # the device transport's copies stay on the cards


# ------------------------------------------- MoE and frontends, card vs CPU --
def _on(tree, device):
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_on(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["dbrx-132b", "grok-1-314b"])
@pytest.mark.parametrize("shared", [0.0, 1.0])
def test_moe_mlp_on_cuda_matches_cpu(cuda, arch, shared):
    """Reduced configs, 1 x 131 tokens (two groups of 65 and a ragged
    tail); ``shared`` = 1 adds one vector to every token, so pairs drop. The
    keep mask equal, y and aux at 1e-4 (fp32, TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    p = moe.init_moe(torch.Generator().manual_seed(0), (), cfg, torch.float32, "cpu")
    r = np.random.default_rng(1)
    x = 0.5 * r.standard_normal((1, 131, cfg.d_model)) + shared * r.standard_normal(cfg.d_model)
    x = torch.from_numpy(x.astype(np.float32))
    want = moe.moe_mlp(p, cfg, x)
    got = moe.moe_mlp(_on(p, "cuda"), cfg, x.cuda())
    assert torch.equal(got[2].cpu(), want[2])
    assert bool((~want[2]).any()) == bool(shared)
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["dbrx-132b", "internvl2-76b", "musicgen-large"])
def test_frontier_models_on_cuda_match_cpu(cuda, arch):
    """Reduced configs on the card (flash attention at prefill) against the
    CPU: the forward with a patch prefix or frame embeddings, then 6 decode
    steps at batch 2, logits at 2e-3."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    params = tf.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    r = np.random.default_rng(2)
    B, S = 2, 48

    def embeds(s):
        return torch.from_numpy((0.02 * r.standard_normal((B, s, cfg.d_model))).astype(np.float32))

    if cfg.frontend == "frame_embed":
        batch = {"frame_embeds": embeds(S)}
    else:
        batch = {"tokens": torch.from_numpy(r.integers(0, cfg.vocab_size, (B, S)))}
        if cfg.frontend == "patch_embed":
            batch["patch_embeds"] = embeds(cfg.n_prefix_embeds)
    want, waux = tf.forward(cfg, params, batch)
    cparams = _on(params, "cuda")
    before = kernel.launches
    got, aux = tf.forward(cfg, cparams, _on(batch, "cuda"))
    assert kernel.launches - before == cfg.num_layers
    torch.testing.assert_close(got.cpu(), want, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(aux["moe_aux"].cpu(), waux["moe_aux"], rtol=2e-3, atol=2e-3)
    caches = [tf.init_cache(cfg, B, 8, torch.float32, dev) for dev in ("cpu", "cuda")]
    for t in range(6):
        step = {k: v[:, t:t + 1] for k, v in batch.items() if k != "patch_embeds"}
        want, _ = tf.decode_step(cfg, params, caches[0], step, t)
        got, _ = tf.decode_step(cfg, cparams, caches[1], _on(step, "cuda"), t)
        torch.testing.assert_close(got.cpu(), want, rtol=2e-3, atol=2e-3)


# --------------------------------------------------------------- training --
# (b, s, H, G, hd, window): the main-path shapes of the gradient: qwen3-0.6b's
# train step, gemma3-4b at hd 256 with s beyond its window (the backward
# recomputes with the banded version), h2o-danube-3-4b at hd 120 with s
# beyond its window (the chunked version: t > 2048)
GRAD_SHAPES = [
    (4, 1024, 16, 8, 128, None),
    (1, 2048, 8, 4, 256, 1024),
    (1, 4608, 32, 8, 120, 4096),
]


def _grad_inputs(b, s, H, G, hd, seed, dtype=torch.float32):
    r = np.random.default_rng(seed)
    arrs = (0.5 * r.standard_normal((b, s, H, hd)), 0.5 * r.standard_normal((b, s, G, hd)),
            r.standard_normal((b, s, G, hd)), r.standard_normal((b, s, H, hd)))
    return [torch.from_numpy(a).to("cuda", dtype) for a in arrs]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,H,G,hd,window", GRAD_SHAPES)
def test_flash_gradient_is_plain_gradient(cuda, b, s, H, G, hd, window):
    """On tensors that need a gradient the dispatch takes ``FlashAttention``:
    one kernel launch, the kernel's output (within 1e-4 of the plain one, as
    at the prefill shapes) and the plain version's gradients (its backward
    recomputes them: 1e-5, the same ops on the same inputs)."""
    q, k, v, g = _grad_inputs(b, s, H, G, hd, seed=s + hd)
    args = [x.clone().requires_grad_() for x in (q, k, v)]
    before = kernel.launches
    out = ops.flash_attention(*args, causal=True, window=window)
    assert kernel.launches - before == 1 and out.grad_fn is not None
    got = torch.autograd.grad(out, args, g)
    assert kernel.launches - before == 1  # the backward launches none
    ref_args = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = ops.plain_attention(*ref_args, causal=True, window=window)
    want = torch.autograd.grad(ref, ref_args, g)
    torch.testing.assert_close(out.detach(), ref.detach(), rtol=1e-4, atol=1e-4)
    for a, w in zip(got, want):
        assert float(a.abs().max()) > 0
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("s,window", [(40, None), (72, 24)])
def test_flash_gradcheck(cuda, s, window):
    """gradcheck in float64 on the plain version the backward recomputes
    (dense at s 40, banded at s 72 >= 2 x window 24), then the Function in
    fp32 on the kernel against those float64 gradients at 1e-4."""
    q, k, v, g = _grad_inputs(1, s, 4, 2, 32, seed=s, dtype=torch.float64)
    assert ops.plain_path(s, s, True, window) == ("dense" if window is None else "banded")
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    assert torch.autograd.gradcheck(
        lambda a, b_, c: ops.plain_attention(a, b_, c, causal=True, window=window), plain,
        fast_mode=True)
    want = torch.autograd.grad(ops.plain_attention(*plain, causal=True, window=window),
                               plain, g)
    args = [x.float().requires_grad_() for x in (q, k, v)]
    out = ops.FlashAttention.apply(*args, True, window, None)
    got = torch.autograd.grad(out, args, g.float())
    for a, w in zip(got, want):
        torch.testing.assert_close(a.double(), w, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_qwen3_layer_gives_wq_a_gradient(cuda):
    """The fault this gradient repairs: one reduced qwen3 layer on the card,
    whose attention output came from the kernel, gives ``wq`` (and every
    other leaf upstream of it) a non-zero gradient equal to the CPU's at
    1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = replace(get_config("qwen3-0.6b").reduced(), num_layers=1)
    params = tf.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 48)))
    grads = []
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda x: x.detach().to(dev, copy=True).requires_grad_(), params)
        leaves = tree_leaves(p)
        logits, _ = tf.forward(cfg, p, {"tokens": toks.to(dev)})
        logits.square().mean().backward()
        grads.append([x.grad for x in leaves])
        wq = p["blocks"][0]["attn"]["wq"]
    assert float(wq.grad.abs().max()) > 0
    for a, w in zip(grads[1], grads[0]):
        torch.testing.assert_close(a.cpu(), w, rtol=1e-4, atol=1e-4)


# (b, s, H, P): a TestWKV6 shape, and a fifth of the rwkv6-7b training shape's
# heads at its length (b 4, s 1024, H 64, P 64 in chip_smoke.py)
WKV6_GRAD_SHAPES = [(2, 24, 2, 16), (2, 1024, 16, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,H,P", WKV6_GRAD_SHAPES)
def test_wkv6_gradient_is_plain_gradient(cuda, b, s, H, P):
    """On tensors that need a gradient the dispatch takes ``WKV6``: one kernel
    launch, its outputs with a ``grad_fn``, y and the final state within
    the kernel check's 2e-4 of the plain recurrence (the model's decays and
    a non-zero initial state), and, with cotangents on both outputs, the
    gradients of all six inputs that autograd gives through
    ``wkv6_reference`` (the backward recomputes them: the same ops on the
    same inputs, 1e-5)."""
    args = _wkv6_inputs(b, s, H, P, seed=s + P, state_scale=0.5, model_decay=True)
    r = np.random.default_rng(s)
    gy, gs = (torch.from_numpy(r.standard_normal(x.shape).astype(np.float32)).cuda()
              for x in (args[0], args[5]))
    live = [x.clone().requires_grad_() for x in args]
    before = wkv6_kernel.launches
    y, final = wkv6_ops.wkv6(*live)
    assert wkv6_kernel.launches - before == 1
    assert type(y.grad_fn).__name__ == "WKV6Backward" and final.grad_fn is y.grad_fn
    got = torch.autograd.grad((y, final), live, (gy, gs))
    assert wkv6_kernel.launches - before == 1  # the backward launches none
    ref = [x.clone().requires_grad_() for x in args]
    y_ref, final_ref = wkv6_reference(*ref)
    want = torch.autograd.grad((y_ref, final_ref), ref, (gy, gs))
    torch.testing.assert_close(y.detach(), y_ref.detach(), rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(final.detach(), final_ref.detach(), rtol=2e-4, atol=2e-4)
    for name, a, w in zip("r k v w u state".split(), got, want):
        assert float(a.abs().max()) > 0, name
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5, msg=name)


@pytest.mark.gpu
def test_wkv6_without_grad_launches_the_kernel_alone(cuda):
    """Under ``inference_mode`` and ``no_grad`` (every serving path) the
    dispatch launches the kernel itself, with no ``WKV6`` node, and may
    write ``state_out`` in place; under grad ``state_out`` raises."""
    args = _wkv6_inputs(1, 8, 2, 16, seed=0, state_scale=0.5)
    args[0].requires_grad_()
    for mode in (torch.inference_mode, torch.no_grad):
        before = wkv6_kernel.launches
        with mode():
            y, _ = wkv6_ops.wkv6(*args)
        assert wkv6_kernel.launches - before == 1 and y.grad_fn is None
    out = torch.empty_like(args[5])
    with torch.no_grad():
        _, st = wkv6_ops.wkv6(*args, state_out=out)
    assert st is out
    before = wkv6_kernel.launches
    with pytest.raises(ValueError, match="state_out"):
        wkv6_ops.wkv6(*args, state_out=out)
    assert wkv6_kernel.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,H,P,N", [(2, 40, 2, 16, 8), (2, 200, 2, 16, 8),
                                       (1, 1024, 16, 64, 64)])
def test_ssd_gradient_is_plain_gradient(cuda, b, s, H, P, N):
    """On tensors that need a gradient the dispatch takes ``SSDScan``: one
    kernel launch, y with a ``grad_fn`` and within the kernel check's 2e-4
    of ``ssd_chunked``, and the gradients of xh, dt, A, B and C that
    autograd gives through ``ssd_chunked`` (the backward recomputes them:
    the same ops on the same inputs, 1e-5 relative to each gradient's
    largest |value|); s 40 is one ragged chunk, s 200 two, s 1024 the
    zamba2-7b training length at a seventh of its heads."""
    args = _ssd_inputs(b, s, H, P, N, seed=s + N)
    g = torch.from_numpy(np.random.default_rng(s).standard_normal(args[0].shape)
                         .astype(np.float32)).cuda()
    live = [x.clone().requires_grad_() for x in args]
    before = ssd_kernel.launches
    y = ssd_ops.ssd_scan(*live)
    assert ssd_kernel.launches - before == 1 and type(y.grad_fn).__name__ == "SSDScanBackward"
    got = torch.autograd.grad(y, live, g)
    assert ssd_kernel.launches - before == 1
    ref = [x.clone().requires_grad_() for x in args]
    y_ref = ssd_chunked(*ref)
    want = torch.autograd.grad(y_ref, ref, g)
    torch.testing.assert_close(y.detach(), y_ref.detach(), rtol=2e-4, atol=2e-4)
    for name, a, w in zip(("xh", "dt", "A", "B", "C"), got, want):
        scale = float(w.abs().max())
        assert float(a.abs().max()) > 0, name
        torch.testing.assert_close(a, w, rtol=0, atol=1e-5 * scale, msg=name)


@pytest.mark.gpu
def test_ssd_without_grad_launches_the_kernel_alone(cuda):
    """Under ``inference_mode`` and ``no_grad`` the dispatch launches the
    kernel itself, with no ``SSDScan`` node."""
    xs = _ssd_inputs(1, 8, 2, 16, 8, seed=0)
    xs[1].requires_grad_()
    for mode in (torch.inference_mode, torch.no_grad):
        before = ssd_kernel.launches
        with mode():
            y = ssd_ops.ssd_scan(*xs)
        assert ssd_kernel.launches - before == 1 and y.grad_fn is None


def _launches_a_forward(cfg) -> dict:
    """Each kernel's launches in one forward of ``cfg``: flash attention a
    dense or shared-attention layer, wkv6 an rwkv layer, the SSD scan a
    mamba layer."""
    kinds = {"rwkv": "wkv6", "mamba": "ssd_scan"}
    out = {"flash_attention": 0, "wkv6": 0, "ssd_scan": 0}
    for blk in tf.layer_plan(cfg):
        out[kinds.get(blk.kind, "flash_attention")] += blk.n
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("arch,S,remat", [("qwen3-0.6b", 64, True), ("gemma3-4b", 160, False),
                                          ("dbrx-132b", 64, False), ("rwkv6-7b", 64, False),
                                          ("rwkv6-7b", 64, True), ("zamba2-7b", 64, False),
                                          ("zamba2-7b", 200, True)])
def test_train_step_on_cuda_matches_cpu(cuda, monkeypatch, arch, S, remat):
    """One reduced AdamW step on the card (each kernel forward, the plain
    gradient; gemma3 at s 160 beyond its window 64, zamba2 at s 200 over two
    SSD chunks) against the same step on the CPU: metrics at 1e-5 relative,
    moments at 1e-4 of each leaf's largest; each kernel launches once a
    layer of its kind (twice with remat). The CPU's rwkv forward is the
    chunked form, which the reduced init takes outside its regime (a
    channel's 16-step log decay passes -CLAMP), so for rwkv6 the CPU step
    runs the sequential ``wkv6_reference`` the kernel runs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    c = opt.AdamWConfig(lr=1e-3, warmup_steps=0)
    params = tf.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    r = np.random.default_rng(4)
    toks = r.integers(0, cfg.vocab_size, (2, S + 1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    mods = {"flash_attention": kernel, "wkv6": wkv6_kernel, "ssd_scan": ssd_kernel}
    out = {}
    for dev in ("cpu", "cuda"):
        with monkeypatch.context() as mp:
            if dev == "cpu" and cfg.family == "ssm":
                mp.setattr(wkv6_ops, "wkv6", lambda *a, state_out=None: wkv6_reference(*a))
            p = _on(params, dev)
            before = {name: mod.launches for name, mod in mods.items()}
            step = train.make_train_step(cfg, c, remat=remat, device=dev)
            _, st, m = step(p, opt.adamw_init(c, p), batch)
        out[dev] = (st, {k: float(v) for k, v in m.items()},
                    {name: mod.launches - before[name] for name, mod in mods.items()})
    per = _launches_a_forward(cfg)
    assert out["cpu"][2] == {name: 0 for name in mods}
    assert out["cuda"][2] == {name: n * (2 if remat else 1) for name, n in per.items()}
    for k, w in out["cpu"][1].items():
        assert out["cuda"][1][k] == pytest.approx(w, rel=1e-5, abs=1e-7), k
    for name in ("m", "v"):
        for a, w in zip(tree_leaves(out["cuda"][0][name]),
                        tree_leaves(out["cpu"][0][name])):
            torch.testing.assert_close(a.cpu(), w, rtol=0,
                                       atol=1e-4 * float(w.abs().max()) + 1e-30)


# ---------------------------------------------------- the DSE's torch scorer --
@pytest.mark.gpu
@pytest.mark.parametrize("pool", [(5, 5), (32, 32)], ids=["u50", "32+32"])
@pytest.mark.parametrize("graph", ["tiny_cnn", "resnet50"])
def test_dse_torch_scorer_on_cuda_matches_numpy(cuda, graph, pool):
    """The float64 torch scorer on the card against the numpy scorer on every
    field at the JAX package's accelerator-scorer tolerance; the results come
    back as numpy float64. The pools are built as the U50's 5 + 5 (PU1x on
    SLR 0, PU2x on SLR 1)."""
    from repro_torch.compiler import analyze, zoo
    from repro_torch.core.pu import PUSpec
    from repro_torch.dse import batched

    n1, n2 = pool
    pus = ([PUSpec(pid=i, kind="PU1x", sa_rows=64, sa_cols=4, slr=0) for i in range(n1)]
           + [PUSpec(pid=n1 + i, kind="PU2x", sa_rows=64, sa_cols=8, slr=1) for i in range(n2)])
    g = zoo.tiny_cnn(channels=(16, 32, 32), hw=16) if graph == "tiny_cnn" else zoo.resnet50(256)
    an = analyze(g, pus)
    configs = [(a, b) for a in range(n1 + 1) for b in range(n2 + 1) if a + b]
    ref = batched.score_details(an, configs, pus=pus)
    got = batched.score_details(an, configs, pus=pus, backend="torch")  # device None: the card
    assert got.configs == ref.configs
    for f in ("fps", "latency", "tops", "pbe", "round_seconds", "uncoupled_seconds",
              "binding_bound"):
        a = getattr(got, f)
        assert isinstance(a, np.ndarray) and a.dtype == np.float64, f
        np.testing.assert_allclose(a, getattr(ref, f), rtol=1e-9, atol=1e-12, err_msg=f)
