"""The port's SSD scan: its plain versions against the JAX oracle, the JAX
model's chunked form and the JAX kernel (in interpret mode) at the shapes and
tolerances of tests/test_kernels.py (TestSSDScan), the final state against
the explicit recurrence, the dispatch by device, and the checks of the CUDA
wrapper, which run before anything is built. The CUDA kernel itself is
checked on a card (tests/test_torch_gpu.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the machine with the card has no JAX

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan.kernel import ssd_scan_tpu  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_reference as jax_reference  # noqa: E402
from repro.models.ssm import ssd_chunked as jax_chunked  # noqa: E402
from repro_torch.kernels import SOURCES  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel, ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_reference  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_kernels.py:152-160 (kernel, chunked vs oracle)
SWEEP_TOL = dict(rtol=3e-4, atol=3e-4)  # tests/test_kernels.py:184 (the property sweep)


def _inputs(b=1, s=64, H=2, P=16, N=8, seed=0):
    """TestSSDScan's distributions, drawn with numpy: xh, B, C ~ N(0, 1),
    dt = softplus(N(0, 1)), A = -exp(0.5 N(0, 1))."""
    r = np.random.default_rng(seed)
    xh = r.standard_normal((b, s, H, P))
    dt = np.logaddexp(r.standard_normal((b, s, H)), 0.0)
    A = -np.exp(0.5 * r.standard_normal(H))
    B = r.standard_normal((b, s, N))
    C = r.standard_normal((b, s, N))
    return tuple(a.astype(np.float32) for a in (xh, dt, A, B, C))


def _torch(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _jax(arrs):
    return [jnp.asarray(a) for a in arrs]


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def _recurrence_state(xh, dt, A, B, C):
    """The final state by the explicit numpy recurrence
    (tests/test_kernels.py:163-171)."""
    b, s, H, P = xh.shape
    h = np.zeros((b, H, B.shape[-1], P), np.float32)
    for t in range(s):
        decay = np.exp(dt[:, t] * A[None])
        h = h * decay[:, :, None, None] + np.einsum("bh,bn,bhp->bhnp", dt[:, t], B[:, t],
                                                    xh[:, t])
    return h


# (s, jax kernel chunk): tests/test_kernels.py:148, ragged s = 100 included
CASES = [(64, 16), (64, 64), (96, 32), (100, 32)]


@pytest.mark.parametrize("s,chunk", CASES)
def test_reference_matches_jax_oracle_and_kernel(s, chunk):
    """y against the JAX oracle; y and the final state against ssd_scan_tpu."""
    arrs = _inputs(s=s, seed=s + chunk)
    y, h = ssd_reference(*_torch(arrs))
    assert y.shape == arrs[0].shape and h.shape == (1, 2, 8, 16)
    _close(y, jax_reference(*_jax(arrs)), TOL)
    y_k, h_k = ssd_scan_tpu(*_jax(arrs), chunk=chunk, interpret=True)
    _close(y, y_k, TOL)
    _close(h, h_k, TOL)


@pytest.mark.parametrize("s,chunk", CASES + [(80, 32), (100, 128)])
def test_chunked_matches_jax_chunked_and_recurrence(s, chunk):
    """tests/test_kernels.py:154-159 (ssd_chunked vs the recurrence), and the
    JAX model's own chunked form at the same chunk."""
    arrs = _inputs(s=s, seed=s + chunk + 1)
    t = _torch(arrs)
    got = ssd_chunked(*t, chunk=chunk)
    _close(got, jax_chunked(*_jax(arrs), chunk=chunk), TOL)
    _close(got, ssd_reference(*t)[0], TOL)


def test_final_state_matches_recurrence():
    """tests/test_kernels.py:161-171."""
    arrs = _inputs(s=64, seed=2)
    _, h = ssd_reference(*_torch(arrs))
    np.testing.assert_allclose(h.numpy(), _recurrence_state(*arrs), **TOL)


@pytest.mark.parametrize("s", [32, 48, 64])
@pytest.mark.parametrize("P", [8, 16])
@pytest.mark.parametrize("N", [4, 8])
def test_reference_sweep_matches_jax_kernel(s, P, N):
    """tests/test_kernels.py:176-184 (the property sweep, every draw), at 3e-4."""
    arrs = _inputs(s=s, P=P, N=N, seed=s + P + N)
    y, h = ssd_reference(*_torch(arrs))
    y_k, h_k = ssd_scan_tpu(*_jax(arrs), chunk=16, interpret=True)
    _close(y, y_k, SWEEP_TOL)
    _close(h, h_k, SWEEP_TOL)


def test_cpu_dispatch_takes_chunked():
    """On the CPU ``ops.ssd_scan`` is ``ssd_chunked`` at chunk 128 (the JAX
    model's CPU path), bit for bit, with no kernel launch."""
    t = _torch(_inputs(s=40, seed=7))
    kernel.launches = 0
    y = ops.ssd_scan(*t)
    assert kernel.launches == 0
    assert torch.equal(y, ssd_chunked(*t))


def test_dispatch_refuses_other_devices():
    t = [a.to("meta") for a in _torch(_inputs(s=4, seed=3))]
    with pytest.raises(ValueError, match="meta"):
        ops.ssd_scan(*t)


def test_wrapper_refuses_cpu_tensors():
    kernel.launches = 0
    with pytest.raises(ValueError, match="CUDA"):
        kernel.ssd_scan_cuda(*_torch(_inputs(s=4, seed=3)))
    assert kernel.launches == 0


def test_wrapper_refuses_non_fp32():
    t = _torch(_inputs(s=4, seed=3))
    t[3] = t[3].to(torch.bfloat16)
    with pytest.raises(TypeError, match="fp32"):
        kernel.ssd_scan_cuda(*t)


def test_wrapper_refuses_non_contiguous():
    t = _torch(_inputs(s=4, H=4, seed=3))
    t[0] = t[0].transpose(1, 2).contiguous().transpose(1, 2)  # same shape, other strides
    with pytest.raises(ValueError, match="contiguous"):
        kernel.ssd_scan_cuda(*t)


@pytest.mark.parametrize("P,N", [(64, 16), (32, 64), (12, 8), (16, 16)])
def test_wrapper_refuses_unbuilt_shapes(P, N):
    with pytest.raises(ValueError, match=r"\(P, N\) = \(%d, %d\) not built" % (P, N)):
        kernel.ssd_scan_cuda(*_torch(_inputs(s=4, P=P, N=N, seed=3)))


def test_wrapper_refuses_bad_shapes_and_chunk():
    t = _torch(_inputs(s=4, seed=3))
    with pytest.raises(ValueError, match="want dt"):
        kernel.ssd_scan_cuda(t[0], t[1][:, :3], *t[2:])
    with pytest.raises(ValueError, match="want dt"):
        kernel.ssd_scan_cuda(*t[:4], t[4][..., :4])
    with pytest.raises(ValueError, match="chunk"):
        kernel.ssd_scan_cuda(*t, chunk=kernel.max_chunk(16, 8) + 1)
    with pytest.raises(ValueError, match="chunk"):
        kernel.ssd_scan_cuda(*t, chunk=0)
    with pytest.raises(ValueError, match="empty"):
        kernel.ssd_scan_cuda(t[0][:, :0], t[1][:, :0], t[2], t[3][:, :0], t[4][:, :0])


def _grouped(s, H, G, N=8, seed=0):
    """``_inputs`` with B and C in G groups of heads, (b, s, G, N)."""
    xh, dt, A, _, _ = _inputs(s=s, H=H, N=N, seed=seed)
    r = np.random.default_rng(seed + 1)
    B, C = (r.standard_normal((1, s, G, N)).astype(np.float32) for _ in range(2))
    return xh, dt, A, B, C


def _grouped_recurrence(xh, dt, A, B, C):
    """y and the final state by the explicit numpy recurrence, head h
    reading group h // (H / G)."""
    b, s, H, P = xh.shape
    G, N = B.shape[2:]
    grp = np.arange(H) // (H // G)
    h = np.zeros((b, H, N, P), np.float32)
    ys = []
    for t in range(s):
        decay = np.exp(dt[:, t] * A[None])
        h = h * decay[:, :, None, None] + np.einsum("bh,bhn,bhp->bhnp", dt[:, t],
                                                    B[:, t][:, grp], xh[:, t])
        ys.append(np.einsum("bhn,bhnp->bhp", C[:, t][:, grp], h))
    return np.stack(ys, 1), h


@pytest.mark.parametrize("s,H,G", [(64, 4, 2), (100, 4, 2), (100, 8, 4)])
def test_groups_match_recurrence(s, H, G):
    """B and C in G groups (Zamba2 as published): the recurrence, the
    chunked form and the CPU dispatch against the explicit recurrence."""
    arrs = _grouped(s, H, G, seed=s + G)
    y_want, h_want = _grouped_recurrence(*arrs)
    t = _torch(arrs)
    y, h = ssd_reference(*t)
    _close(y, y_want, TOL)
    _close(h, h_want, TOL)
    _close(ssd_chunked(*t), y_want, TOL)
    _close(ops.ssd_scan(*t), y_want, TOL)


def test_one_group_as_before():
    """B and C of one group, (b, s, N) or (b, s, 1, N), give the same bits."""
    xh, dt, A, B, C = _torch(_inputs(s=100, seed=9))
    assert torch.equal(ssd_chunked(xh, dt, A, B, C),
                       ssd_chunked(xh, dt, A, B[:, :, None], C[:, :, None]))
    for a, b in zip(ssd_reference(xh, dt, A, B, C),
                    ssd_reference(xh, dt, A, B[:, :, None], C[:, :, None])):
        assert torch.equal(a, b)


def test_wrapper_refuses_bad_groups():
    xh, dt, A, B, C = _torch(_grouped(4, 4, 2, seed=3))
    with pytest.raises(ValueError, match="do not split"):
        kernel.ssd_scan_cuda(xh, dt, A, B.repeat(1, 1, 3, 1)[:, :, :3].contiguous(),
                             C.repeat(1, 1, 3, 1)[:, :, :3].contiguous())
    with pytest.raises(ValueError, match="want dt"):
        kernel.ssd_scan_cuda(xh, dt, A, B, C[:, :, 0])


def test_default_chunk_is_legal_for_every_shape():
    for P, N in kernel.SHAPES:
        assert 1 <= kernel.DEFAULT_CHUNK <= kernel.max_chunk(P, N)
        assert kernel.plan(P, N, 1024)["smem_bytes"] <= kernel.MAX_SMEM


@pytest.mark.parametrize("P,N", kernel.SHAPES)
def test_plan_for_every_shape(P, N):
    """Every instantiated (P, N) splits its columns over two blocks, its N
    rows into float4 groups over R threads and its columns into groups of
    CPT a thread; a block is under one warp or whole warps (the shuffles'
    mask), and the ring fits shared memory at the longest legal tile."""
    pl = kernel.plan(P, N, 100)
    pc, r, cpt = pl["pc"], pl["r"], pl["cpt"]
    assert P % pc == 0 and pl["blocks_per_head"] == P // pc == 2
    assert pc % 4 == 0 and pc % cpt == 0 and N % (4 * r) == 0 and cpt in (1, 2)
    assert pl["threads"] == pc // cpt * r
    assert pl["threads"] < 32 or pl["threads"] % 32 == 0
    assert pl["chunk"] == kernel.DEFAULT_CHUNK
    longest = kernel.plan(P, N, 10**6, chunk=kernel.max_chunk(P, N))
    assert longest["smem_bytes"] <= kernel.MAX_SMEM
    over = kernel.smem_bytes(N, pc, pl["threads"], kernel.max_chunk(P, N) + 1)
    assert over > kernel.MAX_SMEM


def test_plan_at_prefill_shape():
    """zamba2-7b (b 4, s 1024, H 112, P 64, N 64): 32 columns a block, two
    threads a column (32 rows each) and two columns a thread, so 896 blocks
    of 32 threads; two slots of 24 steps take 31,008 bytes, so seven
    blocks fit an SM (228 KB, 1 KB reserved a block) and the grid is one
    wave on 132 SMs."""
    pl = kernel.plan(64, 64, 1024)
    assert (pl["pc"], pl["r"], pl["cpt"], kernel.STAGES, pl["chunk"]) == (32, 2, 2, 2, 24)
    assert pl["threads"] == 32 and 4 * 112 * pl["blocks_per_head"] == 896
    assert pl["smem_bytes"] == 31008
    assert 7 * (pl["smem_bytes"] + 1024) <= 228 * 1024 and 896 <= 7 * 132


@pytest.mark.parametrize("P,N,s,chunk,tile", [
    (64, 64, 1024, None, 24), (64, 64, 100, 42, 42), (64, 64, 10, 32, 10), (64, 64, 1, None, 1),
    (16, 8, 64, 64, 64), (8, 4, 5, 1, 1)])
def test_plan_tile_is_the_chunk_cut_to_the_sequence(P, N, s, chunk, tile):
    assert kernel.plan(P, N, s, chunk)["chunk"] == tile


def test_chunk_range():
    """``chunk`` is legal from 1 to the longest tile whose ring fits shared
    memory; the tiles the checks use (8, 32, 42 at P = N = 64; 16, 32, 64 at
    the TestSSDScan shape) stay legal."""
    assert kernel.max_chunk(64, 64) == 179
    for c in (1, 8, 32, 42, 179):
        kernel.plan(64, 64, 100, c)
    for c in (16, 32, 64):
        kernel.plan(16, 8, 100, c)
    for c in (0, -1, 180):
        with pytest.raises(ValueError, match="chunk"):
            kernel.plan(64, 64, 100, c)


def test_source_is_listed():
    assert SOURCES["ssd_scan"] == kernel.SOURCE and kernel.SOURCE.exists()
    text = kernel.SOURCE.read_text()
    assert "src/repro/kernels/ssd_scan/kernel.py:78" in text
    assert 'extern "C" int ssd_scan_fwd' in text
    assert f"constexpr int STAGES = {kernel.STAGES};" in text  # the ring smem_bytes counts
    for (P, N), (pc, r, cpt) in kernel.PLANS.items():
        assert f"SSD_CASE({N}, {r}, {pc}, {cpt})" in text


def test_bound_at_prefill_shape():
    """The bound chip_smoke.py reports for the zamba2-7b prefill (b=4, s=1024,
    H=112, P=64, N=64): 7.52 GFLOP (4 N P a step and head) at the fp32 peak,
    above the 246.2 MB of xh, y, dt, A, B, C and the final state at the HBM
    rate."""
    from repro_torch import hw

    b, s, H, P, N = 4, 1024, 112, 64, 64
    n_bytes = 4 * (2 * b * s * H * P + b * s * H + H + 2 * b * s * N + b * H * N * P)
    flops = 4 * b * s * H * P * N
    t, by = hw.bound_seconds(n_bytes, flops, hw.FP32_FLOPS)
    assert by == "operations"
    assert abs(t - 1.1218e-4) < 1e-8
    t_bytes, _ = hw.bound_seconds(n_bytes, 0, hw.FP32_FLOPS)
    assert abs(t_bytes - 7.348e-5) < 1e-8


# ------------------------------------------------------------- gradients --
def _grad_inputs(s, seed, b=2, H=2, P=16, N=8):
    """``_inputs`` with A as its log, ``A_log`` (A = -exp(A_log), as the
    mamba block computes it)."""
    xh, dt, A, B, C = _inputs(b=b, s=s, H=H, P=P, N=N, seed=seed)
    return xh, dt, np.log(-A), B, C


def _with_log_a(fn, exp):
    """``fn`` taking ``A_log`` in place of A, so that a gradient reaches it as
    it reaches the mamba block's parameter."""
    return lambda xh, dt, A_log, B, C: fn(xh, dt, -exp(A_log), B, C)


def _fake_kernel(calls):
    """The kernel's stand-in on the CPU: the sequential recurrence it runs,
    (y, final state) computed outside autograd as the kernel's are, each
    call counted."""
    def fake(xh, dt, A, B, C):
        calls.append(xh.shape)
        with torch.no_grad():
            return ssd_reference(xh, dt, A, B, C)
    return fake


@pytest.mark.parametrize("s", [40, 200])
def test_ssd_function_gradients_match_jax_vjp(monkeypatch, s):
    """``SSDScan``'s backward (the kernel replaced by the plain recurrence)
    gives xh, dt, A_log (through A = -exp(A_log)), B and C the gradients of
    ``jax.vjp`` of the JAX model's ``ssd_chunked`` (chunk 128): s 40 is one
    ragged chunk, s 200 two chunks with the state carried between them. fp32
    sums in another order (up to ~7e-6 seen, in A_log's sum over every
    position), held to 1e-4 of each gradient's largest |value|."""
    import jax

    monkeypatch.setattr(kernel, "ssd_scan_cuda", _fake_kernel([]))
    arrs = _grad_inputs(s, seed=s + 3)
    gy = np.random.default_rng(s + 4).standard_normal(arrs[0].shape).astype(np.float32)
    _, vjp = jax.vjp(_with_log_a(jax_chunked, jnp.exp), *_jax(arrs))
    want = vjp(jnp.asarray(gy))
    args = [x.requires_grad_() for x in _torch(arrs)]
    y = _with_log_a(ops.SSDScan.apply, torch.exp)(*args)
    got = torch.autograd.grad(y, args, torch.from_numpy(gy))
    for name, a, b in zip(("xh", "dt", "A_log", "B", "C"), got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4 * np.abs(b).max(),
                                   err_msg=name)


@pytest.mark.parametrize("s,chunk", [(20, 128), (20, 8)])
def test_ssd_chunked_gradcheck(s, chunk):
    """The version the backward differentiates passes a float64 gradcheck in
    every input: in one chunk, and across three chunks (s 20 at chunk 8), the
    carried state included."""
    arrs = _grad_inputs(s, seed=30, b=1, P=4, N=3)
    args = tuple(torch.from_numpy(a).double().requires_grad_() for a in arrs)
    assert torch.autograd.gradcheck(
        _with_log_a(lambda *t: ssd_chunked(*t, chunk=chunk), torch.exp), args)


@pytest.mark.parametrize("remat", [False, True])
def test_ssd_function_plumbing(monkeypatch, remat):
    """With the kernel replaced by the plain recurrence, ``SSDScan`` gives the
    gradients autograd gives through ``ssd_chunked`` itself, bit for bit, to
    only the inputs that need one; under remat (``torch.utils.checkpoint``,
    as the models' forward takes it) the forward runs twice and the backward
    calls no kernel."""
    calls = []
    monkeypatch.setattr(kernel, "ssd_scan_cuda", _fake_kernel(calls))
    arrs = _torch(_inputs(s=150, seed=31))
    need = [True, True, True, False, True]
    g = torch.from_numpy(np.random.default_rng(32).standard_normal(arrs[0].shape)
                         .astype(np.float32))

    def loss(fn, args):
        return (fn(*args) * g).sum()

    args = [x.clone().requires_grad_(n) for x, n in zip(arrs, need)]
    if remat:
        out = torch.utils.checkpoint.checkpoint(loss, ops.SSDScan.apply, args,
                                                use_reentrant=False)
    else:
        out = loss(ops.SSDScan.apply, args)
    assert len(calls) == 1
    out.backward()
    assert len(calls) == (2 if remat else 1)
    ref = [x.clone().requires_grad_(n) for x, n in zip(arrs, need)]
    loss(ssd_chunked, ref).backward()
    for a, b, n in zip(args, ref, need):
        assert (a.grad is None) == (not n)
        if n:
            assert torch.equal(a.grad, b.grad)


def test_ssd_chunked_keeps_fp32_for_fp32_inputs():
    """The carried state follows float64 inputs (for gradcheck) but stays
    fp32 for fp32 inputs, as JAX carries it: the fp32 result is unchanged."""
    t = _torch(_inputs(s=300, seed=33))
    y = ssd_chunked(*t)
    assert y.dtype == torch.float32
    _close(y, jax_chunked(*_jax([a.numpy() for a in t])), TOL)
    y64 = ssd_chunked(*(a.double() for a in t))
    assert y64.dtype == torch.float64
    torch.testing.assert_close(y64.float(), y, rtol=2e-4, atol=2e-4)
