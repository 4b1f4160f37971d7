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
from repro_torch.kernels import rglru_scan as trg  # noqa: E402
from repro_torch.kernels import rmsnorm as trn  # noqa: E402
from repro_torch.kernels import wkv6 as twk  # noqa: E402

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


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,d", [(1, 64, 128), (2, 1000, 384), (3, 33, 130),
                                   (1, 1, 5), (2, 2048, 2560)])
@pytest.mark.parametrize("h0", [False, True])
def test_rglru_kernel_matches_plain_on_card(cuda, b, s, d, h0):
    g = torch.Generator(device="cpu").manual_seed(0)
    la = (-torch.randn(b, s, d, generator=g).abs() * 0.2).to(cuda)
    bb = (torch.randn(b, s, d, generator=g) * 0.5).to(cuda)
    h = torch.randn(b, d, generator=g).to(cuda) if h0 else None
    before = tops.rglru_scan.launches
    got = tops.rglru_scan(la, bb, h)
    torch.cuda.synchronize()
    assert tops.rglru_scan.launches == before + 1
    torch.testing.assert_close(got, trg.rglru_scan_plain(la, bb, h),
                               atol=1e-5, rtol=1e-4)


@pytest.mark.gpu
def test_rglru_kernel_takes_strided_time_major_views_on_card(cuda):
    """The scan site's (B,S,D) views of time-major (S,B,D) storage, and a
    bf16 input (cast to f32 by the wrapper)."""
    g = torch.Generator(device="cpu").manual_seed(1)
    la = (-torch.rand(777, 3, 200, generator=g)).to(cuda).transpose(0, 1)
    bb = torch.randn(777, 3, 200, generator=g).to(cuda).transpose(0, 1)
    got = tops.rglru_scan(la, bb)
    torch.testing.assert_close(got, trg.rglru_scan_plain(la, bb),
                               atol=1e-5, rtol=1e-4)
    got16 = tops.rglru_scan(la, bb.to(torch.bfloat16))
    torch.testing.assert_close(
        got16, trg.rglru_scan_plain(la, bb.to(torch.bfloat16)),
        atol=1e-5, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,d", [(1, 64, 2, 64), (1, 1000, 2, 32),
                                     (2, 97, 3, 16), (1, 4096, 1, 64),
                                     (2, 2048, 40, 64)])
@pytest.mark.parametrize("strong", [False, True])
def test_wkv6_kernel_matches_plain_on_card(cuda, b, s, h, d, strong):
    g = torch.Generator(device="cpu").manual_seed(0)
    r, k, v = ((torch.randn(b, s, h, d, generator=g) * 0.5).to(cuda)
               for _ in range(3))
    lw = torch.full((b, s, h, d), -np.exp(2.0)) if strong \
        else -torch.randn(b, s, h, d, generator=g).abs() * 0.3
    u = (torch.randn(h, d, generator=g) * 0.1).to(cuda)
    before = tops.wkv6.launches
    got = tops.wkv6(r, k, v, lw.to(cuda), u)
    torch.cuda.synchronize()
    assert tops.wkv6.launches == before + 1
    want = twk.wkv6_plain(r, k, v, lw.to(cuda), u)
    assert torch.isfinite(want).all()
    torch.testing.assert_close(got, want, atol=5e-5, rtol=1e-3)


@pytest.mark.gpu
def test_wkv6_kernel_takes_strided_inputs_on_card(cuda):
    """r/k/v/log_w as slices of one fused projection (strided)."""
    g = torch.Generator(device="cpu").manual_seed(2)
    b, s, h, d = 2, 300, 4, 64
    fused = torch.randn(b, s, h, 4 * d, generator=g).to(cuda) * 0.5
    r, k, v, w = fused.split(d, dim=-1)
    lw = -w.abs()
    u = (torch.randn(h, d, generator=g) * 0.1).to(cuda)
    assert not r.is_contiguous()
    torch.testing.assert_close(tops.wkv6(r, k, v, lw, u),
                               twk.wkv6_plain(r, k, v, lw, u),
                               atol=5e-5, rtol=1e-3)


# ---------------------------------------------------------------------------
# the redesigned kernels: flash attention's wgmma path and the chunked WKV-6
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal", [
    (2, 2048, 2048, 16, 8, 128, True),     # path Q
    (2, 256, 256, 4, 2, 64, True), (2, 256, 256, 4, 2, 64, False),
    (1, 1000, 1000, 4, 1, 128, True),      # ragged S: TMA zero-fill + mask
    (2, 130, 70, 4, 2, 64, True), (2, 130, 70, 4, 2, 128, False),
    (1, 70, 130, 2, 1, 128, True)])
def test_flash_wgmma_path_matches_plain_on_card(cuda, b, sq, sk, hq, hkv, d,
                                                causal):
    g = torch.Generator(device="cpu").manual_seed(3)
    q = torch.randn(b, sq, hq, d, generator=g).to(cuda, torch.bfloat16)
    k = torch.randn(b, sk, hkv, d, generator=g).to(cuda, torch.bfloat16)
    v = torch.randn(b, sk, hkv, d, generator=g).to(cuda, torch.bfloat16)
    assert tfa.select_path(q, k, v) == "wgmma"
    before = tops.flash_attention.launches_by_path["wgmma"]
    got = tops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tops.flash_attention.launches_by_path["wgmma"] == before + 1
    want = tfa.flash_attention_plain(q, k, v, causal=causal,
                                     scale=1 / np.sqrt(d))
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    # scale-aware too: bf16 rounding alone gives about 3e-3
    assert tfa.block_rel_err(got, want) <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
def test_flash_wgmma_path_takes_fused_heads_on_card(cuda, d):
    """q/k/v as head slices of one fused QKV projection: the tensor maps
    take the strides as they are."""
    g = torch.Generator(device="cpu").manual_seed(4)
    b, s, hq, hkv = 2, 333, 8, 2
    qkv = torch.randn(b, s, hq + 2 * hkv, d, generator=g).to(cuda,
                                                              torch.bfloat16)
    q, k, v = qkv[:, :, :hq], qkv[:, :, hq:hq + hkv], qkv[:, :, hq + hkv:]
    before = tops.flash_attention.launches_by_path["wgmma"]
    got = tops.flash_attention(q, k, v, causal=True)
    assert tops.flash_attention.launches_by_path["wgmma"] == before + 1
    want = tfa.flash_attention_plain(q, k, v, causal=True,
                                     scale=1 / np.sqrt(d))
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    # scale-aware too: bf16 rounding alone gives about 3e-3
    assert tfa.block_rel_err(got, want) <= 1e-2


@pytest.mark.gpu
def test_flash_kernel_refuses_a_path_the_inputs_do_not_fit_on_card(cuda):
    q = torch.zeros(1, 64, 2, 40, device=cuda, dtype=torch.bfloat16)
    out = torch.empty_like(q)
    with pytest.raises(RuntimeError, match="path wgmma"):
        tfa.launch(q, q, q, out, causal=True, scale=1.0, path="wgmma")
    q = torch.zeros(1, 64, 2, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="path mma"):
        tfa.launch(q, q, q, torch.empty_like(q), causal=True, scale=1.0,
                   path="mma")


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,d", [
    (1, 1, 1, 16), (1, 63, 2, 32), (1, 65, 1, 64), (2, 1000, 3, 16),
    (1, 4096, 1, 64), (2, 2048, 40, 64), (1, 1000, 2, 32)])
@pytest.mark.parametrize("log_w", [None, -np.exp(2.0), -20.0],
                         ids=["drawn", "clamp", "m20"])
def test_wkv6_chunked_kernel_matches_plain_on_card(cuda, b, s, h, d, log_w):
    g = torch.Generator(device="cpu").manual_seed(5)
    r, k, v = ((torch.randn(b, s, h, d, generator=g) * 0.5).to(cuda)
               for _ in range(3))
    lw = torch.full((b, s, h, d), log_w) if log_w is not None \
        else -torch.randn(b, s, h, d, generator=g).abs() * 0.3
    u = (torch.randn(h, d, generator=g) * 0.1).to(cuda)
    before = tops.wkv6.launches
    got = tops.wkv6(r, k, v, lw.to(cuda), u)
    torch.cuda.synchronize()
    assert tops.wkv6.launches == before + 1
    want = twk.wkv6_plain(r, k, v, lw.to(cuda), u)
    assert torch.isfinite(got).all() and torch.isfinite(want).all()
    torch.testing.assert_close(got, want, atol=5e-5, rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32, 64])
def test_wkv6_chunked_kernel_takes_strided_inputs_on_card(cuda, d):
    """r/k/v/log_w as slices of one fused projection, across chunks."""
    g = torch.Generator(device="cpu").manual_seed(6)
    b, s, h = 2, 700, 3
    fused = torch.randn(b, s, h, 4 * d, generator=g).to(cuda) * 0.5
    r, k, v, w = fused.split(d, dim=-1)
    lw = -w.abs() * 4
    u = (torch.randn(h, d, generator=g) * 0.1).to(cuda)
    torch.testing.assert_close(tops.wkv6(r, k, v, lw, u),
                               twk.wkv6_plain(r, k, v, lw, u),
                               atol=5e-5, rtol=1e-3)


# ---------------------------------------------------------------------------
# the redesigned RMSNorm (variants) and RG-LRU scan (load routes)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,dtype,scale_dtype", [
    (65537, 128, "bfloat16", "bfloat16"),   # a ragged half-warp row group
    (65537, 128, "float32", "float32"),
    (4096, 2560, "float32", "float32"), (4096, 2560, "bfloat16", "bfloat16"),
    (1001, 4104, "float32", "float32"), (1001, 4104, "bfloat16", "bfloat16"),
    (4096, 1024, "bfloat16", "float32"),    # scale wider than x
    (333, 2560, "float32", "bfloat16"),     # scale narrower than x
    (33, 8, "bfloat16", "bfloat16"),        # one vector a row: 32 rows a warp
    (1001, 136, "bfloat16", "bfloat16")])   # 17 vectors a row on 16 lanes
def test_rmsnorm_variants_match_plain_on_card(cuda, n, d, dtype, scale_dtype):
    g = torch.Generator(device="cpu").manual_seed(7)
    x = torch.randn(n, d, generator=g).to(cuda, _DTYPES[dtype])
    s = (torch.randn(d, generator=g) * 0.1).to(cuda, _DTYPES[scale_dtype])
    name = trn.variant_name(trn.select_variant(x))
    before = tops.rmsnorm.launches_by_variant.get(name, 0)
    got = tops.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert tops.rmsnorm.launches_by_variant[name] == before + 1
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    torch.testing.assert_close(got.float(), trn.rmsnorm_plain(x, s).float(),
                               atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", [(128, 32), (1024, 16), (0, 64), (0, 3)])
def test_rmsnorm_kernel_refuses_a_variant_the_inputs_do_not_fit_on_card(
        cuda, variant):
    x = torch.zeros(64, 128, device=cuda, dtype=torch.bfloat16)
    s = torch.zeros(128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="variant"):
        trn.launch(x, s, torch.empty_like(x), 1e-6, variant=variant)


def _rglru_inputs(cuda, b, s, d, time_major, seed=8):
    g = torch.Generator(device="cpu").manual_seed(seed)
    shape = (s, b, d) if time_major else (b, s, d)
    la = (-torch.randn(*shape, generator=g).abs() * 0.2).to(cuda)
    bb = (torch.randn(*shape, generator=g) * 0.5).to(cuda)
    if time_major:
        la, bb = la.transpose(0, 1), bb.transpose(0, 1)
    return la, bb


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,d,time_major", [
    (2, 2048, 2560, True),     # path R
    (2, 1000, 384, False),     # S not a multiple of the stage
    (2, 1000, 256, True), (3, 1000, 130, False), (2, 1000, 130, True),
    (1, 33, 5, False),         # B*D below 32
    (1, 64, 32, False), (1, 1, 4, False)])
@pytest.mark.parametrize("route", ["tma", "cp_async"])
def test_rglru_routes_match_plain_on_card(cuda, b, s, d, time_major, route):
    la, bb = _rglru_inputs(cuda, b, s, d, time_major)
    out = torch.empty(b, s, d, device=cuda)
    if route == "tma" and trg.select_route(la, bb) != "tma":
        with pytest.raises(RuntimeError, match="route tma"):
            trg.launch(la, bb, out, route="tma")
        return
    trg.launch(la, bb, out, route=route)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, trg.rglru_scan_plain(la, bb),
                               atol=1e-5, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,d,time_major,route", [
    (2, 2048, 2560, True, "tma"), (2, 1000, 384, False, "tma"),
    (3, 1000, 130, False, "cp_async"), (1, 33, 5, False, "cp_async")])
@pytest.mark.parametrize("h0", [False, True])
def test_rglru_wrapper_counts_its_route_on_card(cuda, b, s, d, time_major,
                                                route, h0):
    la, bb = _rglru_inputs(cuda, b, s, d, time_major, seed=9)
    h = torch.randn(b, d, device=cuda) if h0 else None
    assert trg.select_route(la, bb) == route
    before = dict(tops.rglru_scan.launches_by_route)
    got = tops.rglru_scan(la, bb, h)
    torch.cuda.synchronize()
    assert tops.rglru_scan.launches_by_route == {
        k: n + (k == route) for k, n in before.items()}
    torch.testing.assert_close(got, trg.rglru_scan_plain(la, bb, h),
                               atol=1e-5, rtol=1e-4)
