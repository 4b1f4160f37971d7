"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Marked ``gpu``: each test skips where there is no CUDA device
(the kernels have no CPU mode).  Imports torch only, so it runs on a
machine without JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import rmsnorm as trn  # noqa: E402

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (on the card only)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,hq,hkv,d", [
    (2, 256, 256, 4, 2, 64), (1, 1000, 1000, 4, 1, 128),
    (1, 100, 130, 2, 2, 40), (2, 64, 64, 4, 4, 256),
    (2, 130, 70, 4, 2, 32), (2, 2048, 2048, 16, 8, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain_on_card(cuda, b, sq, sk, hq, hkv, d,
                                            causal, dtype):
    g = torch.Generator(device="cpu").manual_seed(0)
    dt = _DTYPES[dtype]
    q = torch.randn(b, sq, hq, d, generator=g).to(cuda, dt)
    k = torch.randn(b, sk, hkv, d, generator=g).to(cuda, dt)
    v = torch.randn(b, sk, hkv, d, generator=g).to(cuda, dt)
    before = tops.flash_attention.launches
    got = tops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tops.flash_attention.launches == before + 1
    want = tfa.flash_attention_plain(q, k, v, causal=causal,
                                     scale=1 / np.sqrt(d))
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_kernel_takes_strided_heads_on_card(cuda, d):
    """q/k/v as head slices of one fused projection (strided, not
    contiguous): the kernel indexes them in place."""
    g = torch.Generator(device="cpu").manual_seed(1)
    b, s, hq, hkv = 2, 300, 8, 2
    qkv = torch.randn(b, s, hq + 2 * hkv, d, generator=g).to(cuda,
                                                              torch.bfloat16)
    q, k, v = qkv[:, :, :hq], qkv[:, :, hq:hq + hkv], qkv[:, :, hq + hkv:]
    got = tops.flash_attention(q, k, v, causal=True)
    want = tfa.flash_attention_plain(q, k, v, causal=True,
                                     scale=1 / np.sqrt(d))
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("n,d", [(4096, 1024), (65536, 128), (1001, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_matches_plain_on_card(cuda, n, d, dtype):
    g = torch.Generator(device="cpu").manual_seed(0)
    dt = _DTYPES[dtype]
    x = torch.randn(n, d, generator=g).to(cuda, dt)
    s = (torch.randn(d, generator=g) * 0.1).to(cuda, dt)
    before = tops.rmsnorm.launches
    got = tops.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert tops.rmsnorm.launches == before + 1
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    torch.testing.assert_close(got.float(),
                               trn.rmsnorm_plain(x, s).float(),
                               atol=tol, rtol=tol)
