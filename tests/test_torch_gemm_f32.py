"""The port's 3xTF32 fp32 GEMM on the CPU: the route that ``pspec.product``
takes, as a rule of shape, dtype, grad and sharding; ``product`` on CPU
tensors bit for bit ``x @ w``; the plain emulation of the kernel's
arithmetic (``gemm_f32/ref.py``) within 4x of fp32's error at the
pipeline's depths, while one long truncating accumulator or plain TF32
are far off; the launches ``chip_smoke.py`` expects a forward, against the
products the models hand the route; and the wrapper's checks, which run
before anything is built. The CUDA kernel itself is checked on a card
(tests/test_torch_gpu.py)."""
import functools
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import SOURCES  # noqa: E402
from repro_torch.kernels.gemm_f32 import kernel, ops, ref  # noqa: E402
from repro_torch.runtime import pspec  # noqa: E402

F32 = torch.float32
ROOT = Path(__file__).resolve().parents[1]


@functools.cache
def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _meta(*shape, dtype=F32, requires_grad=False):
    return torch.empty(*shape, dtype=dtype, device="meta", requires_grad=requires_grad)


class _Sharded(torch.Tensor):
    """A tensor subclass, as a DTensor is one: the route declines it."""


@pytest.mark.parametrize("rows,k,n,dtype,grad,sharded,aligned,want", [
    (16, 6144, 6144, F32, False, False, True, False),        # a decode step of starcoder2-15b
    (16, 6144, 24576, F32, False, False, True, False),
    (4608, 3840, 10240, F32, False, False, True, True),      # the pipeline's up projection
    (4608, 10240, 3840, F32, False, False, True, True),      # its down projection
    (4096, 1024, 3072, F32, False, False, True, True),       # a qwen3-0.6b prefill
    (ops.MIN_ROWS, 64, 64, F32, False, False, True, True),   # the threshold itself
    (ops.MIN_ROWS - 1, 64, 64, F32, False, False, True, False),
    (4608, 3840, 10240, torch.bfloat16, False, False, True, False),
    (4608, 3840, 10240, None, False, False, True, False),    # mixed dtypes
    (4608, 3840, 10240, F32, True, False, True, False),      # autograd would record it
    (4608, 3840, 10240, F32, False, True, True, False),      # a DTensor
    (4608, 3840, 10250, F32, False, False, False, False),    # odd row strides
])
def test_route_rule(rows, k, n, dtype, grad, sharded, aligned, want):
    """The route's rule on meta tensors (shapes, strides, dtypes and flags
    only); ``dtype`` None is an fp32 x with a bf16 w."""
    x = _meta(rows, k, dtype=dtype or F32)
    w = _meta(k, n, dtype=dtype or torch.bfloat16, requires_grad=grad)
    assert (w.stride(0) % 4 == 0) is aligned
    if sharded:
        x = x.as_subclass(_Sharded)
    with torch.enable_grad():
        assert ops.route(x, w) is want


def test_route_rule_needs_2d_w():
    assert not ops.route(_meta(4608, 3840), _meta(3840, 10240, 1))


@pytest.mark.parametrize("x_shape,w_shape,want", [
    ((1, 4608, 3840), (3840, 10240), True),
    ((4608, 3840), (3840, 960), True),
    ((16, 1, 6144), (6144, 6144), False),
    ((2, 4608, 3840), (3840, 3840), True),
])
def test_route_reads_the_tensors(x_shape, w_shape, want):
    # meta tensors: the rule reads shapes, strides, dtypes and flags only
    assert ops.route(_meta(*x_shape), _meta(*w_shape)) is want


def test_route_declines_odd_strides_and_grad():
    x, w = _meta(4608, 3840), _meta(3840, 10240)
    assert ops.route(x, w)
    assert not ops.route(x, _meta(10240, 3840).t())            # w stored K-major
    assert not ops.route(_meta(4608, 3842)[:, :3840], w)       # rows 3842 floats apart
    assert not ops.route(x.to(torch.bfloat16), w.to(torch.bfloat16))
    with torch.enable_grad():
        assert not ops.route(x, _meta(3840, 10240, requires_grad=True))
    with torch.no_grad():
        assert ops.route(x, _meta(3840, 10240, requires_grad=True))


@pytest.mark.parametrize("x_shape,n", [((4, 300, 64), 48), ((512, 96), 40), ((16, 1, 64), 8)])
def test_product_on_cpu_is_matmul(x_shape, n):
    g = torch.Generator().manual_seed(7)
    x = torch.randn(*x_shape, generator=g)
    w = torch.randn(x_shape[-1], n, generator=g)
    before = (kernel.launches, ops.declined)
    assert torch.equal(pspec.product(x, w), x @ w)
    assert (kernel.launches, ops.declined) == before  # the CPU is not a declined CUDA call


@pytest.mark.parametrize("K", [3840, 10240])
def test_emulation_within_fp32_error(K):
    g = torch.Generator().manual_seed(K)
    x = torch.randn(32, K, generator=g)
    w = torch.randn(K, 24, generator=g) / K ** 0.5
    want = ref.gemm_float64(x, w)
    fp32 = ref.rms_error(x @ w, want)
    assert ref.rms_error(ref.gemm_tf32(x, w), want) <= 4 * fp32


@pytest.mark.parametrize("K", [3840, 10240])
def test_why_it_splits_and_promotes(K):
    """Plain TF32 is >100x off fp32, and one accumulator over all of K,
    added to with truncation as the tensor cores add, drifts >10x."""
    g = torch.Generator().manual_seed(K + 1)
    x = torch.randn(32, K, generator=g)
    w = torch.randn(K, 24, generator=g) / K ** 0.5
    want = ref.gemm_float64(x, w)
    fp32 = ref.rms_error(x @ w, want)
    assert ref.rms_error(ref.gemm_tf32(x, w, split=False), want) > 100 * fp32
    assert ref.rms_error(ref.gemm_tf32(x, w, promote=None), want) > 10 * fp32


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma3-4b", "rwkv6-7b", "zamba2-7b",
                                  "dbrx-132b", "internvl2-76b", "musicgen-large", "grok-1-314b",
                                  "h2o-danube-3-4b"])
def test_products_a_forward_match_chip_smoke(arch, monkeypatch):
    """``chip_smoke.f32_a_forward``, the launches it expects of a forward
    from MIN_ROWS rows, against the products the models hand the route: a
    forward of the arch's reduced config (its layer plan, tie and MLP kind)
    at MIN_ROWS tokens on the CPU, each ``pspec.product`` held to ``route``
    as if on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf

    cfg = get_config(arch).reduced()
    taken = []

    def spy(x, w):
        taken.append(ops.route(x, w))
        return x @ w

    monkeypatch.setattr(pspec, "matmul", spy)
    params = tf.init_params(cfg, seed=0, dtype=F32, device="cpu")
    s = ops.MIN_ROWS
    g = torch.Generator().manual_seed(0)
    if cfg.frontend == "frame_embed":
        batch = {"frame_embeds": 0.02 * torch.randn(1, s, cfg.d_model, generator=g)}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, s), generator=g)}
        if cfg.frontend == "patch_embed":
            batch["patch_embeds"] = 0.02 * torch.randn(1, cfg.n_prefix_embeds, cfg.d_model,
                                                       generator=g)
    with torch.no_grad():
        tf.forward(cfg, params, batch)
    assert sum(taken) == _smoke().f32_a_forward(cfg)
    assert len(taken) - sum(taken) == int(cfg.tie_embeddings)  # the tied head alone


def test_rows_view():
    x = torch.zeros(2, 3, 8)
    assert kernel.rows_view(x).shape == (6, 8)
    assert kernel.rows_view(x.transpose(0, 1)) is None
    assert kernel.rows_view(torch.zeros(8, 4).t()) is None


@pytest.mark.parametrize("x,w,err", [
    (torch.zeros(4, 8), torch.zeros(8, 4), ValueError),            # on the CPU
    (_meta(4, 8), _meta(8, 4, 2), ValueError),                       # w not 2-D
    (_meta(4, 8), _meta(6, 4), ValueError),                          # K differs
])
def test_wrapper_refuses_before_building(x, w, err):
    with pytest.raises(err):
        kernel.gemm_f32_cuda(x, w)


def test_sources_include_the_kernel():
    assert SOURCES["gemm_f32"] == kernel.SOURCE and kernel.SOURCE.exists()
