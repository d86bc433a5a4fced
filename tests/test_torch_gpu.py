"""The CUDA flash-attention kernel against its plain PyTorch version, on the
card. This file imports no JAX (the machine with the card has none); every
test here needs a CUDA device and skips without one:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import kernel, ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import mha_reference  # noqa: E402

# (b, s, H, G, hd, window, dtype, tol): the shapes and tolerances of
# tests/test_kernels.py:28-61, and the qwen3-0.6b serving prefill shape
# (1024-long fp32 sums in another order than the plain softmax: 1e-4)
CASES = [
    (2, 64, 4, 4, 32, None, torch.float32, 2e-5),
    (2, 64, 8, 2, 32, None, torch.float32, 2e-5),
    (2, 96, 4, 1, 64, None, torch.float32, 2e-5),
    (2, 128, 2, 2, 16, None, torch.float32, 2e-5),
    (1, 128, 4, 2, 32, 16, torch.float32, 2e-5),
    (1, 128, 4, 2, 32, 32, torch.float32, 2e-5),
    (1, 128, 4, 2, 32, 100, torch.float32, 2e-5),
    (1, 64, 4, 2, 32, None, torch.bfloat16, 3e-2),
    (4, 1024, 16, 8, 128, None, torch.float32, 1e-4),
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
def test_cuda_kernel_refuses_non_contiguous(cuda):
    q, k, v = _qkv(1, 64, 4, 2, 32, seed=0, dtype=torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.flash_attention_cuda(q.transpose(1, 2), k, v)
