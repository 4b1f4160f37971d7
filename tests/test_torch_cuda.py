"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Marked ``gpu``: each test skips where there is no CUDA device
(the kernels have no CPU mode).  Imports torch only, so it runs on a
machine without JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import contextlib

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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_at_recurrentgemma_width_on_card(cuda, dtype):
    """RecurrentGemma-2B's local attention at S = window: MQA, 10 query
    heads of 256, causal -- the ``scalar`` path (head dim 256 takes neither
    ``wgmma`` nor ``mma``); f32 at 2e-5, bf16 within 1e-2 block-relative."""
    g = torch.Generator(device="cpu").manual_seed(6)
    dt = _DTYPES[dtype]
    q = torch.randn(2, 2048, 10, 256, generator=g).to(cuda, dt)
    k = torch.randn(2, 2048, 1, 256, generator=g).to(cuda, dt)
    v = torch.randn(2, 2048, 1, 256, generator=g).to(cuda, dt)
    assert tfa.select_path(q, k, v) == "scalar"
    before = tops.flash_attention.launches_by_path["scalar"]
    got = tops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert tops.flash_attention.launches_by_path["scalar"] == before + 1
    want = tfa.flash_attention_plain(q, k, v, causal=True,
                                     scale=1 / np.sqrt(256))
    if dtype == "float32":
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    else:
        assert tfa.block_rel_err(got, want) <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,d,time_major", [
    (2, 2048, 2560, True),     # a prefill's time-major views
    (4, 1, 2560, False)])      # one decode step
@pytest.mark.parametrize("route", ["tma", "cp_async"])
def test_rglru_routes_continue_from_a_nonzero_state_on_card(
        cuda, b, s, d, time_major, route):
    """A decode continuation: ``h0`` folded into ``b[:, 0]`` as the
    wrapper folds it, then each route forced."""
    la, bb = _rglru_inputs(cuda, b, s, d, time_major, seed=10)
    h0 = torch.randn(b, d, generator=torch.Generator().manual_seed(11)).to(
        cuda)
    folded = bb.clone()
    folded[:, 0] += torch.exp(la[:, 0]) * h0
    assert trg.select_route(la, folded) == "tma"     # either route fits
    out = torch.empty(b, s, d, device=cuda)
    trg.launch(la, folded, out, route=route)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, trg.rglru_scan_plain(la, bb, h0),
                               atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# a whole (reduced) model on the card: the kernels at every site, serving
# ---------------------------------------------------------------------------


def _reduced_qwen3(device, dtype=torch.float32):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("qwen3_0_6b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), dtype=dtype,
                        device=device)
    tokens = torch.randint(0, cfg.vocab, (2, 64),
                           generator=torch.Generator().manual_seed(1))
    return cfg, model, params, tokens.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_plan_binds_the_kernels_at_every_site_on_card(cuda, dtype):
    """The forced all-kernel plan of a reduced model's prefill launches
    flash once a layer and RMSNorm at every norm; in f32 it matches the
    unsubstituted program at 1e-4 (in bf16 a rounding flip moves later
    layers by more than the verifier's 1e-2: only finite outputs of the
    program's shapes are checked)."""
    from repro_torch.core.offload import OffloadConfig, Offloader
    from repro_torch.models import REFERENCE_PLAN

    cfg, model, params, tokens = _reduced_qwen3(cuda, _DTYPES[dtype])
    plan = REFERENCE_PLAN.replace(compute_dtype=dtype)
    ctx = Offloader(OffloadConfig(options={"example_args": (tokens,)})).prepare(
        lambda tok: model.prefill(params, {"tokens": tok}, plan))
    engine = ctx.bundle.context["engine"]
    bits = tuple(2 if ctx.graph.by_name(s.region).meta.get("pattern") else 0
                 for s in ctx.coding.sites)
    sub = engine.substitute(ctx.coding.decode(bits))
    assert [c.chosen for c in sub.report.choices if c.pattern] == \
        ["cuda"] * (5 * cfg.n_layers + 1)
    tops.reset_launch_counts()
    logits, state = sub(tokens)
    torch.cuda.synchronize()
    assert tops.launch_counts()["flash_attention"] == cfg.n_layers
    assert tops.launch_counts()["rmsnorm"] == 4 * cfg.n_layers + 1
    want_logits, want_state = engine.reference()
    assert logits.shape == want_logits.shape
    assert bool(torch.isfinite(logits).all())
    if dtype == "bfloat16":
        return
    torch.testing.assert_close(logits, want_logits, atol=1e-4, rtol=0)
    for kv, want in zip(state["kv"], want_state["kv"]):
        torch.testing.assert_close(kv.k, want.k, atol=1e-4, rtol=0)
        torch.testing.assert_close(kv.v, want.v, atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_prefill_and_decode_on_card_match_the_cpu(cuda):
    from repro_torch.models import REFERENCE_PLAN

    plan = REFERENCE_PLAN.replace(compute_dtype="float32")
    _, model, params, tokens = _reduced_qwen3(cuda)
    _, _, cpu_params, cpu_tokens = _reduced_qwen3("cpu")
    with torch.no_grad():
        outs = []
        for p, t in ((params, tokens), (cpu_params, cpu_tokens)):
            _, state = model.prefill(p, {"tokens": t}, plan,
                                     cache_capacity=70)
            logits, state = model.decode(p, t[:, :1], state, plan)
            outs.append((logits, state))
    (g, gs), (c, cs) = outs
    assert gs["cache_len"].device.type == "cuda"
    torch.testing.assert_close(g.cpu(), c, atol=1e-4, rtol=0)
    for a, b in zip(gs["kv"], cs["kv"]):
        torch.testing.assert_close(a.k.cpu(), b.k, atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_server_generates_on_card(cuda):
    from repro_torch.models import OFFLOAD_PLAN, REFERENCE_PLAN
    from repro_torch.runtime.serve import Server

    cfg, model, params, tokens = _reduced_qwen3(cuda, torch.bfloat16)
    server = Server(model, params, OFFLOAD_PLAN)
    a = server.generate({"tokens": tokens}, 6)
    b = server.generate({"tokens": tokens}, 6)
    assert a.shape == (2, 6) and ((a >= 0) & (a < cfg.vocab)).all()
    np.testing.assert_array_equal(a, b)
    server.swap_plan(REFERENCE_PLAN)
    np.testing.assert_array_equal(
        server.generate({"tokens": tokens}, 6),
        Server(model, params, REFERENCE_PLAN).generate({"tokens": tokens}, 6))


def _reduced_hybrid(device, dtype=torch.float32):
    """RecurrentGemma reduced to 5 layers (two pre-blocks, one macro
    block; window 32), weights from seed 0, 64 tokens."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("recurrentgemma_2b").reduced(),
                              n_layers=5)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), dtype=dtype,
                        device=device)
    tokens = torch.randint(0, cfg.vocab, (2, 32),
                           generator=torch.Generator().manual_seed(1))
    return cfg, model, params, tokens.to(device)


@pytest.mark.gpu
def test_hybrid_prefill_plan_binds_the_kernels_at_every_site_on_card(cuda):
    """The forced all-kernel plan of a reduced hybrid prefill (S = window,
    so local attention is exactly causal): RG-LRU at each recurrent
    sublayer, flash at the attention sublayer, RMSNorm at every norm; it
    verifies against the unsubstituted program."""
    from repro_torch.core.offload import OffloadConfig, Offloader
    from repro_torch.models import REFERENCE_PLAN

    cfg, model, params, tokens = _reduced_hybrid(cuda)
    plan = REFERENCE_PLAN.replace(compute_dtype="float32")
    ctx = Offloader(OffloadConfig(options={"example_args": (tokens,)})).prepare(
        lambda tok: model.prefill(params, {"tokens": tok}, plan))
    engine = ctx.bundle.context["engine"]
    bits = tuple(2 if ctx.graph.by_name(s.region).meta.get("pattern") else 0
                 for s in ctx.coding.sites)
    sub = engine.substitute(ctx.coding.decode(bits))
    chosen = sorted(c.pattern for c in sub.report.choices
                    if c.chosen == "cuda")
    assert chosen == ["linear_recurrence"] * 4 + ["rmsnorm"] * 11 + \
        ["softmax_attention"]
    tops.reset_launch_counts()
    sub(tokens)
    torch.cuda.synchronize()
    assert tops.launch_counts() == {"flash_attention": 1, "rmsnorm": 11,
                                    "rglru_scan": 4, "wkv6": 0}
    assert engine.verify(sub).ok


@pytest.mark.gpu
def test_hybrid_server_generates_the_cpu_tokens_on_card(cuda):
    """Greedy tokens of a reduced hybrid model in f32 under
    ``OFFLOAD_PLAN`` (the ``assoc`` scan in prefill, RG-LRU states and
    ring caches in decode; 32 + 6 tokens wrap the window of 32) on the card
    and on the CPU."""
    from repro_torch.models import OFFLOAD_PLAN
    from repro_torch.runtime.serve import Server

    plan = OFFLOAD_PLAN.replace(compute_dtype="float32")
    toks = []
    for dev in (cuda, "cpu"):
        cfg, model, params, tokens = _reduced_hybrid(dev)
        server = Server(model, params, plan)
        toks.append(server.generate({"tokens": tokens}, 6))
        np.testing.assert_array_equal(
            toks[-1], server.generate({"tokens": tokens}, 6))
    assert toks[0].shape == (2, 6) and ((toks[0] >= 0)
                                        & (toks[0] < cfg.vocab)).all()
    np.testing.assert_array_equal(toks[0], toks[1])


# ---------------------------------------------------------------------------
# the MoE and SSM families (paths E and F)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4096, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_generic_loop_at_olmoe_width_on_card(cuda, n, dtype):
    """d_model 2048 has no row-in-registers instance: OLMoE's ln1, ln2 and
    final norm take the generic loop at 32 lanes a row."""
    g = torch.Generator(device="cpu").manual_seed(11)
    x = torch.randn(n, 2048, generator=g).to(cuda, _DTYPES[dtype])
    s = (torch.randn(2048, generator=g) * 0.1).to(cuda, _DTYPES[dtype])
    assert trn.variant_name(trn.select_variant(x)) == "generic_l32"
    before = tops.rmsnorm.launches_by_variant.get("generic_l32", 0)
    got = tops.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert tops.rmsnorm.launches_by_variant["generic_l32"] == before + 1
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    torch.testing.assert_close(got.float(), trn.rmsnorm_plain(x, s).float(),
                               atol=tol, rtol=tol)


def _reduced_family(arch, device):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=device)
    tokens = torch.randint(0, cfg.vocab, (2, 32),
                           generator=torch.Generator().manual_seed(1))
    return cfg, model, params, tokens.to(device)


@pytest.mark.gpu
def test_moe_prefill_plan_on_card_matches_the_cpu(cuda):
    """The forced all-kernel plan of a reduced OLMoE prefill (the
    ``scatter_ep`` MoE, f32) launches flash once a layer and RMSNorm at
    every norm, and matches the unsubstituted prefill on the CPU at 1e-4."""
    from repro_torch.core.offload import OffloadConfig, Offloader
    from repro_torch.models import REFERENCE_PLAN

    plan = REFERENCE_PLAN.replace(compute_dtype="float32",
                                  moe_impl="scatter_ep")
    cfg, model, params, tokens = _reduced_family("olmoe_1b_7b", cuda)
    ctx = Offloader(OffloadConfig(options={"example_args": (tokens,)})).prepare(
        lambda tok: model.prefill(params, {"tokens": tok}, plan))
    engine = ctx.bundle.context["engine"]
    bits = tuple(2 if ctx.graph.by_name(s.region).meta.get("pattern") else 0
                 for s in ctx.coding.sites)
    sub = engine.substitute(ctx.coding.decode(bits))
    tops.reset_launch_counts()
    logits, state = sub(tokens)
    torch.cuda.synchronize()
    assert tops.launch_counts()["flash_attention"] == cfg.n_layers
    assert tops.launch_counts()["rmsnorm"] == 4 * cfg.n_layers + 1
    _, _, cpu_params, cpu_tokens = _reduced_family("olmoe_1b_7b", "cpu")
    with torch.no_grad():
        want_logits, want_state = model.prefill(
            cpu_params, {"tokens": cpu_tokens}, plan)
    torch.testing.assert_close(logits.cpu(), want_logits, atol=1e-4, rtol=0)
    for kv, want in zip(state["kv"], want_state["kv"]):
        torch.testing.assert_close(kv.k.cpu(), want.k, atol=1e-4, rtol=0)
        torch.testing.assert_close(kv.v.cpu(), want.v, atol=1e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["scatter_ep", "dense_onehot"])
def test_moe_forward_repeats_bit_for_bit_on_card(cuda, impl):
    """OLMoE's routing (64 experts, top-8) over 4096 tokens at a reduced
    width: two forwards give the same bits (no atomics in the dispatch or
    the combine), so a later layer's routing repeats."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import REFERENCE_PLAN
    from repro_torch.models.moe import MoE

    cfg = get_config("olmoe_1b_7b")
    cfg = dataclasses.replace(cfg, d_model=256, moe=dataclasses.replace(
        cfg.moe, d_ff_expert=128))
    moe = MoE(cfg, dtype=torch.float32, device=cuda,
              generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 2048, 256,
                    generator=torch.Generator().manual_seed(1)).to(cuda)
    plan = REFERENCE_PLAN.replace(compute_dtype="float32", moe_impl=impl)
    with torch.no_grad():
        a, aux_a = moe(x, plan)
        b, aux_b = moe(x, plan)
    assert torch.equal(a, b)
    assert torch.equal(aux_a.load_balance, aux_b.load_balance)


@pytest.mark.gpu
def test_rwkv_chunked_prefill_and_decode_on_card_match_the_cpu(cuda):
    """A reduced RWKV-6 under the chunked WKV form (chunks of 8 over 32
    tokens), then two decode steps, on the card and on the CPU, f32."""
    from repro_torch.models import REFERENCE_PLAN

    plan = REFERENCE_PLAN.replace(compute_dtype="float32", wkv_impl="chunked",
                                  wkv_chunk=8)
    outs = []
    for dev in (cuda, "cpu"):
        _, model, params, tokens = _reduced_family("rwkv6_3b", dev)
        with torch.no_grad():
            logits, state = model.prefill(params, {"tokens": tokens}, plan)
            for i in range(2):
                logits, state = model.decode(params, tokens[:, i:i + 1],
                                             state, plan)
        outs.append((logits, state))
    (g, gs), (c, cs) = outs
    torch.testing.assert_close(g.cpu(), c, atol=1e-4, rtol=0)
    for a, b in zip(gs["rwkv"], cs["rwkv"], strict=True):
        for f in ("wkv", "shift_tm", "shift_cm"):
            torch.testing.assert_close(getattr(a, f).cpu(), getattr(b, f),
                                       atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_rwkv_step_and_chunked_prefills_agree_on_card(cuda):
    """The WKV ``step`` form against the ``chunked`` form (chunks of 8
    over 32 tokens) on the card: a reduced RWKV-6 prefill, f32, its logits
    and every state leaf at 1e-4."""
    from repro_torch.models import REFERENCE_PLAN

    outs = []
    for impl in ("step", "chunked"):
        plan = REFERENCE_PLAN.replace(compute_dtype="float32", wkv_impl=impl,
                                      wkv_chunk=8)
        _, model, params, tokens = _reduced_family("rwkv6_3b", cuda)
        with torch.no_grad():
            outs.append(model.prefill(params, {"tokens": tokens}, plan))
    (s_logits, s_state), (c_logits, c_state) = outs
    assert s_logits.device.type == "cuda"
    torch.testing.assert_close(s_logits, c_logits, atol=1e-4, rtol=0)
    for a, b in zip(s_state["rwkv"], c_state["rwkv"], strict=True):
        for f in ("wkv", "shift_tm", "shift_cm"):
            torch.testing.assert_close(getattr(a, f), getattr(b, f),
                                       atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# the enc-dec family (path X)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("sq", [1500, 448])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_at_whisper_non_causal_shapes_on_card(cuda, sq, dtype):
    """Whisper-small's encoder self-attention (1500 frames) and
    cross-attention (448 tokens against 1500 frames), 12 heads of 64,
    non-causal: Sk = 1500 is not a multiple of the KV tile, and in bf16
    these take the ``wgmma`` path."""
    g = torch.Generator(device="cpu").manual_seed(12)
    dt = _DTYPES[dtype]
    q = torch.randn(2, sq, 12, 64, generator=g).to(cuda, dt)
    k = torch.randn(2, 1500, 12, 64, generator=g).to(cuda, dt)
    v = torch.randn(2, 1500, 12, 64, generator=g).to(cuda, dt)
    assert tfa.select_path(q, k, v) == \
        ("wgmma" if dtype == "bfloat16" else "scalar")
    got = tops.flash_attention(q, k, v, causal=False)
    want = tfa.flash_attention_plain(q, k, v, causal=False,
                                     scale=1 / np.sqrt(64))
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert tfa.block_rel_err(got, want) <= (1e-2 if dtype == "bfloat16"
                                            else 1e-4)


def _reduced_whisper(device):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("whisper_small").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=device)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 24), generator=gen)
    frames = torch.randn(2, cfg.encoder_seq, cfg.d_model, generator=gen)
    return cfg, model, params, tokens.to(device), frames.to(device)


@pytest.mark.gpu
def test_whisper_forced_plan_on_card_matches_the_cpu(cuda):
    """The forced plan of a reduced Whisper prefill (f32): ``cuda`` at every
    norm and every decoder self-attention, ``ref`` at the encoder's and
    the cross-attention's non-causal sites.  It launches flash once a
    decoder layer and RMSNorm at every norm, and matches the unsubstituted
    prefill on the CPU at 1e-4."""
    from repro_torch.core.offload import OffloadConfig, Offloader
    from repro_torch.models import REFERENCE_PLAN

    plan = REFERENCE_PLAN.replace(compute_dtype="float32")
    cfg, model, params, tokens, frames = _reduced_whisper(cuda)
    ctx = Offloader(OffloadConfig(options={
        "example_args": (tokens, frames)})).prepare(
            lambda tok, fr: model.prefill(params, {"tokens": tok,
                                                   "frames": fr}, plan))
    engine = ctx.bundle.context["engine"]

    def bit(region):
        if not region.meta.get("pattern"):
            return 0
        module = params.get_submodule(
            region.meta["module"].removeprefix("params."))
        return 2 if getattr(module, "causal", True) else 0

    sub = engine.substitute(ctx.coding.decode(tuple(
        bit(ctx.graph.by_name(s.region)) for s in ctx.coding.sites)))
    n_norms = 2 * cfg.n_encoder_layers + 1 + 3 * cfg.n_layers + 1
    assert sorted(c.chosen for c in sub.report.choices if c.pattern) == \
        sorted(["cuda"] * (n_norms + cfg.n_layers)
               + ["ref"] * (cfg.n_encoder_layers + cfg.n_layers))
    tops.reset_launch_counts()
    logits, state = sub(tokens, frames)
    torch.cuda.synchronize()
    assert tops.launch_counts()["flash_attention"] == cfg.n_layers
    assert tops.launch_counts()["rmsnorm"] == n_norms
    _, _, cpu_params, cpu_tokens, cpu_frames = _reduced_whisper("cpu")
    with torch.no_grad():
        want_logits, want_state = model.prefill(
            cpu_params, {"tokens": cpu_tokens, "frames": cpu_frames}, plan)
    torch.testing.assert_close(logits.cpu(), want_logits, atol=1e-4, rtol=0)
    for kv, want in zip(state["dec"], want_state["dec"], strict=True):
        for f in ("k", "v", "xk", "xv"):
            torch.testing.assert_close(kv[f].cpu(), want[f], atol=1e-4,
                                       rtol=0)


# ---------------------------------------------------------------------------
# training on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_matches_materialized_attention_on_card(cuda, causal):
    """The chunked attention's custom backward (``_Flash``) against autograd
    through the materialized path (``attend_naive``), f32 with TF32 off,
    GQA (4 query / 2 KV heads), a ragged last chunk when non-causal."""
    from repro_torch.models import attention as A
    from repro_torch.models.plan import ExecPlan

    assert not torch.backends.cuda.matmul.allow_tf32
    b, sq, sk, hq, hkv, d = 2, 256, 256 if causal else 200, 4, 2, 64
    g = torch.Generator().manual_seed(0)
    q = torch.randn(b, sq, hq, d, generator=g)
    k, v = (torch.randn(b, sk, hkv, d, generator=g) for _ in range(2))
    do = torch.randn(b, sq, hq, d, generator=g)
    plan = ExecPlan(compute_dtype="float32", attn_kv_chunk=64)
    grads = {}
    for name, fn in (("chunked", A.attend_chunked), ("naive", A.attend_naive)):
        xs = [x.to(cuda).requires_grad_() for x in (q, k, v)]
        out = fn(*xs, torch.arange(sq, device=cuda),
                 torch.arange(sk, device=cuda), causal, 0, plan)
        grads[name] = (out,) + torch.autograd.grad(out, xs, do.to(cuda))
    for got, want in zip(grads["chunked"], grads["naive"]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def _train_step_on(device, arch, over):
    from repro_torch.configs import get_config
    from repro_torch.launch.train import launcher_plan
    from repro_torch.models import build_model
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime.train import init_train_state, make_train_step

    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    plan = launcher_plan(cfg, microbatch=2)[0].replace(
        attn_kv_chunk=16, rglru_chunk=8, wkv_chunk=8, **over)
    state = init_train_state(model, torch.Generator().manual_seed(0),
                             device=device)
    before = {k: p.detach().cpu().clone()
              for k, p in state.params.named_parameters()}
    batch = model.demo_batch(torch.Generator().manual_seed(1), 4, 40,
                             device=device)
    step = make_train_step(model, plan, OptimizerConfig(),
                           lambda s: torch.full((), 1e-3))
    return (before,) + step(state, batch)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,over", [
    ("qwen3_0_6b", {}),
    ("recurrentgemma_2b", {"rglru_impl": "chunked"}),     # associative_scan
    ("recurrentgemma_2b", {"rglru_impl": "step"}),        # scan
    ("rwkv6_3b", {"wkv_impl": "chunked"}),                # scan
], ids=["dense", "hybrid_assoc", "hybrid_step", "ssm"])
def test_train_step_on_card_matches_cpu(cuda, arch, over):
    """One reduced train step (microbatch 2, remat ``dots``, the scans'
    autograd under the checkpoint) on the card against the CPU: loss and
    gradient norm within 1e-5 relative, each first moment within 1e-4 of
    its norm, each parameter's update within 1e-2 of the CPU update's
    norm.  (The first AdamW step moves an element by lr * g / (|g| + eps):
    where |g| is within rounding of eps the two devices' moves differ by a
    good part of lr, in a few elements of a leaf.)"""
    p0, got_state, got = _train_step_on(cuda, arch, over)
    _, want_state, want = _train_step_on("cpu", arch, over)
    for k in ("loss", "grad_norm"):
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5), k
    for (k, p), w in zip(got_state.params.named_parameters(),
                         want_state.params.parameters()):
        moved = float((w.detach() - p0[k]).norm())
        assert float((p.detach().cpu() - w.detach()).norm()) \
            <= 1e-2 * moved, k
        m, wm = got_state.opt.mu[k].cpu(), want_state.opt.mu[k]
        assert float((m - wm).norm()) <= 1e-4 * float(wm.norm()) + 1e-9, k


@pytest.mark.gpu
@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_rglru_step_train_step_on_card_matches_assoc_on_cpu(cuda, remat):
    """The RG-LRU ``step`` train step (the lifted ``scan`` and autograd's
    backward scan) on the card against the ``assoc`` step (plain ops, no
    scan) on the CPU, which shares no scan code with it: loss and gradient
    norm within 1e-5 relative, each first moment (the gradient) within 1e-4
    of its norm.  A scan that drops the carry's gradient between steps
    misses by far more."""
    _, got_state, got = _train_step_on(
        cuda, "recurrentgemma_2b", {"rglru_impl": "step", "remat": remat})
    _, want_state, want = _train_step_on(
        "cpu", "recurrentgemma_2b", {"rglru_impl": "assoc", "remat": remat})
    for k in ("loss", "grad_norm"):
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5), k
    for k, wm in want_state.opt.mu.items():
        m = got_state.opt.mu[k].cpu()
        assert float((m - wm).norm()) <= 1e-4 * float(wm.norm()) + 1e-9, k


@pytest.mark.gpu
def test_lifted_scan_gradients_equal_an_unrolled_loop_on_card(cuda):
    """``layers.remat_safe_scan`` from an initial carry that needs no
    gradient, on this machine's torch: the gradients in xs and the lifted
    input equal those of the same body unrolled."""
    from repro_torch.models.layers import remat_safe_scan

    g = torch.Generator().manual_seed(3)
    la = (-torch.rand(6, 2, 5, generator=g)).to(cuda).requires_grad_()
    b = torch.randn(6, 2, 5, generator=g).to(cuda).requires_grad_()
    u = torch.randn(2, 5, generator=g).to(cuda).requires_grad_()
    h0 = torch.zeros(2, 5, device=cuda)

    def step(h, x, u):
        h = torch.exp(x[0]) * h + x[1] * u
        return h, h.clone()

    h_last, hs = remat_safe_scan(step, h0, (la, b), (u,))
    got = torch.autograd.grad((hs ** 2).sum() + h_last.sum(), [la, b, u])
    h, ys = h0, []
    for t in range(6):
        h, y = step(h, (la[t], b[t]), u)
        ys.append(y)
    want = torch.autograd.grad((torch.stack(ys) ** 2).sum() + h.sum(),
                               [la, b, u])
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
def test_scan_export_releases_the_program_on_card(cuda):
    """The export frontend's release of what dynamo cached, on this
    machine's torch: a reduced hybrid model's parameters on the card die
    once the caller drops them."""
    import gc
    import weakref

    from repro_torch.configs import get_config
    from repro_torch.core.frontends.export_frontend import build_graph
    from repro_torch.models import build_model
    from repro_torch.models.plan import ExecPlan

    cfg = get_config("recurrentgemma_2b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=cuda)
    plan = ExecPlan(compute_dtype="float32")
    tokens = torch.randint(0, cfg.vocab, (1, 16)).to(cuda)
    alive = weakref.ref(params.embed)
    graph = build_graph(lambda t: model.prefill(params, {"tokens": t}, plan),
                        tokens)
    assert sum(r.kind == "loop" for r in graph.regions) == 2
    del graph, params
    gc.collect()
    assert alive() is None


#: ``RMS_SRC`` of ``tests/test_frontend_differential.py`` (copied: this file
#: imports no JAX)
RMS_SRC = """
def rms_app(x, scale, n, d):
    out = np.zeros((n, d))
    for i in range(n):
        ss = 0.0
        for t in range(d):
            ss = ss + x[i][t] * x[i][t]
        inv = 1.0 / np.sqrt(ss / d + 1e-06)
        for t in range(d):
            out[i][t] = x[i][t] * inv * (1.0 + scale[t])
    return out
"""


@pytest.mark.gpu
def test_python_source_plan_runs_the_rmsnorm_kernel_on_card(cuda):
    """``RMS_SRC`` planned through the python_ast frontend on the card (no
    ``device``: ``cuda``), the forced chromosome with ``gpu_kernel`` on the
    matched loop nest: it binds ``cuda``, launches the RMSNorm kernel once a
    run, and matches the interpreted program and the CPU plan's output."""
    from repro_torch.core.frontends.ast_frontend import Executor
    from repro_torch.core.offload import OffloadConfig, Offloader

    rng = np.random.default_rng(7)
    inputs = dict(x=rng.standard_normal((48, 16)),
                  scale=rng.standard_normal(16) * 0.1)
    outs = {}
    for device in (None, "cpu"):
        offloader = Offloader(OffloadConfig(
            repeats=1, device=device, options={"consts": {"n": 48, "d": 16}}))
        ctx = offloader.prepare(RMS_SRC, inputs)
        forced = tuple(2 if ctx.graph.by_name(s.region).meta.get("pattern")
                       else 0 for s in ctx.coding.sites)
        assert forced == (2,)
        art = offloader.apply(ctx, forced)
        assert art.report.substituted == {ctx.coding.sites[0].region: "cuda"}
        tops.reset_launch_counts()
        outs[device] = art.run(**inputs)["out"]
        assert tops.launch_counts()["rmsnorm"] == (1 if device is None else 0)
    assert art.executor().device.type == "cpu"
    ref = Executor(ctx.target, {}, device="cpu").run(**inputs)["out"]
    np.testing.assert_allclose(outs[None], ref, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(outs[None], outs["cpu"], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# function-block genes and overlapped prepares on the card
# ---------------------------------------------------------------------------


class _CausalAttention(torch.nn.Module):
    def forward(self, q, k, v):
        s = q @ k.T / np.sqrt(q.shape[-1])
        mask = torch.tril(torch.ones(q.shape[0], k.shape[0],
                                     dtype=torch.bool, device=q.device))
        return torch.softmax(torch.where(mask, s, -1e30), dim=-1) @ v


class _AttentionStack(torch.nn.Module):
    """Phase K1's program at (512, 256) -> head 128: RMSNorm and causal
    attention as submodules, the projections and residual between them."""

    def __init__(self, d, dh, dev):
        super().__init__()
        from repro_torch.models.layers import RMSNorm
        g = torch.Generator().manual_seed(0)
        self.norm = RMSNorm(d, device=dev)
        with torch.no_grad():
            self.norm.weight.copy_(torch.randn(d, generator=g) * 0.1)
        self.wq, self.wk, self.wv, self.wo = (
            torch.nn.Parameter((torch.randn(a, b, generator=g)
                                / np.sqrt(a)).to(dev))
            for a, b in ((d, dh), (d, dh), (d, dh), (dh, d)))
        self.attention = _CausalAttention()

    def forward(self, x):
        xn = self.norm(x)
        o = self.attention(xn @ self.wq, xn @ self.wk, xn @ self.wv)
        return x + o @ self.wo


def _stack_plan(cuda, **options):
    from repro_torch.core.frontends.registry import OffloadConfig
    from repro_torch.core.ga import GAConfig
    from repro_torch.core.offload import Offloader

    model = _AttentionStack(256, 128, cuda)
    x = torch.randn(512, 256, generator=torch.Generator().manual_seed(1)
                    ).to(cuda)
    offloader = Offloader(OffloadConfig(
        ga=GAConfig(population=4, generations=2, seed=0), repeats=1,
        options={"example_args": (x,), **options}))
    return model, x, offloader


@pytest.mark.gpu
def test_attention_stack_block_variants_and_loop_arm_on_card(cuda):
    """Phase K1 at a small size: the block window binds both variants,
    each verifies on the card and launches no kernel; the loop arm's
    forced chromosome launches the RMSNorm and flash kernels once each."""
    from repro_torch.core.verifier import verify

    model, x, offloader = _stack_plan(cuda)
    res = offloader.plan(model)
    assert res.verification["verified"]
    engine = res.details["engine"]
    blocks = [r for r in res.graph.regions if r.meta.get("block_members")]
    assert len(blocks) == 1 and blocks[0].meta["pattern"] == "attention_stack"
    with torch.no_grad():
        want = model(x)
    for variant in ("block_chunked", "block_fused"):
        v, chosen = engine.verify_block(blocks[0].name, variant)
        assert chosen == variant and v.ok, v
        sub = engine.substitute({blocks[0].name: variant})
        tops.reset_launch_counts()
        got = sub(x)
        torch.cuda.synchronize()
        assert not any(tops.launch_counts().values())
        assert verify(want, got).ok

    model, x, offloader = _stack_plan(cuda, block_sites=False)
    res = offloader.plan(model)
    assert not any(r.meta.get("block_members") for r in res.graph.regions)
    engine = res.details["engine"]
    forced = {s.region: "cuda" for s in res.coding.sites
              if res.graph.by_name(s.region).meta.get("pattern")}
    sub = engine.substitute(forced)
    tops.reset_launch_counts()
    got = sub(x)
    torch.cuda.synchronize()
    assert {k: n for k, n in tops.launch_counts().items() if n} == \
        {"flash_attention": 1, "rmsnorm": 1}
    assert verify(want, got).ok


@pytest.mark.gpu
def test_overlapped_prepares_plan_the_serial_search_on_card(cuda):
    """One block program planned with its prepares serial and on 4
    threads: each chromosome's time a fixed function of its bits, the
    prepares real; the same best bits and the same measured chromosomes."""
    from repro_torch.core.ga import Evaluation

    out = {}
    for workers in (0, 4):
        model, x, offloader = _stack_plan(cuda)
        offloader.config.ga.compile_workers = workers
        ctx = offloader.prepare(model)
        real = ctx.bundle.fitness_factory(ctx.coding)
        measured = []

        class Fixed:
            def prepare(self, bits):
                return real.prepare(bits)

            def measure(self, prep):
                measured.append(prep.bits)
                if prep.failure is not None:
                    return prep.failure
                return Evaluation(prep.bits, 1.0 - 0.01 * sum(
                    (i + 1) * int(v) for i, v in enumerate(prep.bits)), True)

        ctx.config.fitness_fn = Fixed()
        res = offloader.search(ctx)
        out[workers] = (res.best.bits, sorted(measured))
    assert out[0] == out[4]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_lower_cell_traces_fake_cuda_tensors_like_meta_ones_on_card(cuda,
                                                                    kind):
    """The dry run's default trace (fake tensors on the card) gives the
    meta trace's FLOPs, bytes and memory, layer extrapolation included."""
    import dataclasses

    from repro_torch import hlo_analysis as ha
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.models import REFERENCE_PLAN

    cfg = dataclasses.replace(get_config("qwen3_0_6b").reduced(), n_layers=5)
    shape = ShapeSpec("s", 64, 2, kind)
    plan = REFERENCE_PLAN.replace(compute_dtype="float32", remat="dots",
                                  attn_impl="chunked")

    def totals(low):
        c = low.compile()
        m = c.memory_analysis()
        h = ha.analyze_hlo(c, 1)
        return (h.flops, h.bytes, m.argument_size_in_bytes,
                m.output_size_in_bytes, m.temp_size_in_bytes)

    on_card = lower_cell(cfg, shape, plan)[0]
    assert on_card.repeat is not None
    vals = [n.meta["val"] for n in on_card.gm.graph.nodes
            if n.op == "placeholder"]
    assert {v.device.type for v in vals} == {"cuda"}
    assert totals(on_card) == totals(lower_cell(cfg, shape, plan, "cpu")[0])


# ---------------------------------------------------------------------------
# the planning service on the card
# ---------------------------------------------------------------------------


def _kernels_first(values):
    """A deterministic fitness that ranks a chromosome by its count of
    ``gpu_kernel`` genes: the search's winner binds the kernels."""
    from repro_torch.core.ga import Evaluation

    return Evaluation(tuple(values),
                      1.0 - 0.1 * sum(int(v) == 2 for v in values), True)


@pytest.mark.gpu
def test_service_endpoint_runs_the_kernels_and_warm_loads_on_card(
        cuda, tmp_path):
    """Phase V1's steps 3-4 at a small size: the planning service's
    endpoint verifies against the unsubstituted program and launches the
    flash and RMSNorm kernels; a new service on the same directory
    warm-loads the plan (no search, no measurement) and its artifact's
    output is bit-equal to the first one's."""
    from repro_torch.core.frontends.registry import OffloadConfig
    from repro_torch.core.ga import GAConfig
    from repro_torch.core.verifier import verify
    from repro_torch.obs import metrics
    from repro_torch.service import PlanService

    def measurements():
        fam = metrics.snapshot().get("eval.measurements", {})
        return sum(s["value"] for s in fam.get("series", ()))

    model = _AttentionStack(256, 128, cuda)
    x = torch.randn(512, 256, generator=torch.Generator().manual_seed(1)
                    ).to(cuda)
    config = OffloadConfig(
        fitness_fn=_kernels_first, repeats=1,
        ga=GAConfig(population=4, generations=3, seed=0),
        options={"example_args": (x,), "block_sites": False})
    with PlanService(str(tmp_path), config=config) as svc:
        plan = svc.plan(model)
        assert plan.record.bits == (2, 2)
        call = svc.endpoint(plan.fingerprint)
        tops.reset_launch_counts()
        out = call(x)
        torch.cuda.synchronize()
        counts = tops.launch_counts()
    assert (counts["flash_attention"], counts["rmsnorm"]) == (1, 1)
    with torch.no_grad():
        want = model(x)
    assert verify(want, out, rtol=1e-2, atol=1e-2).ok
    before = measurements()
    with PlanService(str(tmp_path), config=config) as svc2:
        warm = svc2.plan(model)
    assert warm.warm and svc2.stats.warm_loads == 1
    assert svc2.stats.searches == 0 and measurements() == before
    tops.reset_launch_counts()
    again = warm(x)
    torch.cuda.synchronize()
    assert tops.launch_counts()["flash_attention"] == 1
    assert torch.equal(again, out)


# ---------------------------------------------------------------------------
# captured programs (core/device_program.py): the port's jax.jit
# ---------------------------------------------------------------------------

_FAMILIES = ("qwen3_0_6b", "recurrentgemma_2b", "olmoe_1b_7b", "rwkv6_3b",
             "whisper_small")


def _same(a, b) -> bool:
    from torch.utils import _pytree as pytree

    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def _captured_block(cuda, label):
    """Path ``label``'s program at small widths on the card (Q a reduced
    Qwen3 block, R a reduced RG-LRU sublayer, W one WKV-6 head as a scan):
    its example arguments and its all-reference and all-kernel
    substitutions."""
    from torch._higher_order_ops.scan import scan

    from repro_torch.configs import get_config
    from repro_torch.core.offload import OffloadConfig, Offloader
    from repro_torch.models.transformer import DenseBlock, RecurrentSublayer

    g = torch.Generator().manual_seed(0)
    if label == "Q":
        cfg = get_config("qwen3_0_6b").reduced()
        target = DenseBlock(cfg, device=cuda, generator=g)
        args = ((torch.randn(2, 64, cfg.d_model, generator=g) * 0.1).to(cuda),)
    elif label == "R":
        cfg = get_config("recurrentgemma_2b").reduced()
        target = RecurrentSublayer(cfg, device=cuda, generator=g)
        args = ((torch.randn(2, 64, cfg.d_model, generator=g) * 0.1).to(cuda),)
    else:
        def target(r, k, v, lw, u):
            def step(s, rkvw):
                rt, kt, vt, lwt = rkvw
                kv = kt[:, None] * vt[None, :]
                y = rt @ (s + u[:, None] * kv)
                return torch.exp(lwt)[:, None] * s + kv, y
            _, ys = scan(step, torch.zeros(r.shape[-1], v.shape[-1],
                                           device=r.device), (r, k, v, lw))
            return ys
        r, k, v = (torch.randn(128, 64, generator=g) for _ in range(3))
        lw = -torch.exp(torch.randn(128, 64, generator=g) - 0.6)
        args = tuple(t.to(cuda) for t in
                     (r, k, v, lw, torch.randn(64, generator=g) * 0.1))
    ctx = Offloader(OffloadConfig(options={"example_args": args})).prepare(
        target)
    engine = ctx.bundle.context["engine"]
    bits = tuple(2 if ctx.graph.by_name(s.region).meta.get("pattern")
                 and not ctx.graph.by_name(s.region).meta.get("block_members")
                 else 0 for s in ctx.coding.sites)
    return args, (engine.substitute({}),
                  engine.substitute(ctx.coding.decode(bits)))


@pytest.mark.gpu
@pytest.mark.parametrize("label", ["Q", "R", "W"])
def test_captured_program_equals_eager_and_replays_new_inputs_on_card(
        cuda, label):
    """A substituted program's first call on the card runs eagerly and
    captures; each later call is one replay, bit for bit the eager
    program's, launching what an eager call launches; a replay after new
    inputs gives the new result and leaves the earlier one as it was."""
    args, subs = _captured_block(cuda, label)
    assert any(c.chosen == "cuda" for c in subs[1].report.choices)
    for sub in subs:
        with torch.no_grad():
            eager = sub.gm(*args)
        tops.reset_launch_counts()
        first = sub(*args)
        once = tops.launch_counts()
        again = sub(*args)
        torch.cuda.synchronize()
        twice = tops.launch_counts()
        (prog,) = sub.captured.programs.values()
        assert prog.captured and prog.replays == 1 and prog.capture_s > 0
        assert _same(first, eager) and _same(again, eager)
        assert {k: twice[k] - once[k] for k in once} == once
        new = tuple(a.flip(0) for a in args)
        with torch.no_grad():
            eager_new = sub.gm(*new)
        got_new = sub(*new)
        assert _same(got_new, eager_new) and not _same(got_new, eager)
        assert _same(again, eager)
        assert prog.replays == 2 and len(sub.captured.programs) == 1


def _family_on(arch, device):
    from repro_torch.configs import get_config
    from repro_torch.models import OFFLOAD_PLAN, build_model

    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    g = torch.Generator().manual_seed(0)
    params = model.init(g, torch.float32, device=device)
    batch = model.demo_batch(g, 2, 16, device=device)
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    return model, params, OFFLOAD_PLAN.replace(compute_dtype="float32"), inputs


@pytest.mark.gpu
@pytest.mark.parametrize("arch", _FAMILIES)
def test_captured_decode_equals_eager_on_card(cuda, arch):
    """Three decode steps of each family: the captured step (state
    donated, written back in place) gives the eager step's logits and
    state bit for bit, one capture then a replay a step; ``generate``
    gives the eager server's tokens."""
    from torch.utils import _pytree as pytree

    from repro_torch.core.device_program import disable_capture
    from repro_torch.runtime.serve import Server

    model, params, plan, inputs = _family_on(arch, cuda)
    server = Server(model, params, plan)
    bound = server._bound
    with torch.no_grad():
        logits, state0 = bound.prefill(inputs, 20)
        tok = torch.argmax(logits[:, -1], -1, keepdim=True).to(torch.int32)
        runs = []
        for captured in (False, True):
            st = pytree.tree_map(lambda t: t.clone(), state0)
            t, out = tok, []
            with contextlib.nullcontext() if captured else disable_capture():
                for _ in range(3):
                    lg, st = bound.decode(t, st)
                    out.append(lg)
                    t = torch.argmax(lg[:, -1], -1, keepdim=True).to(
                        torch.int32)
            runs.append((out, dict(pytree.tree_flatten_with_path(st)[0])))
    (eager, e_state), (got, c_state) = runs
    assert all(torch.equal(a, b) for a, b in zip(got, eager))
    for path, leaf in e_state.items():
        assert torch.equal(c_state[path], leaf), pytree.keystr(path)
    (prog,) = bound._decode.programs.values()
    assert prog.replays == 2
    a = server.generate(inputs, 5)
    with disable_capture():
        b = server.generate(inputs, 5)
    np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_capture_error_raises_and_does_not_fall_back_on_card(cuda):
    """A program that reads a device value on the host runs eagerly once,
    then its capture fails: the call raises, nothing is cached, and no
    eager run takes the replay's place; in the GA the chromosome is
    invalid with the error."""
    import math

    from repro_torch.core.device_program import CapturedFunction
    from repro_torch.core.fitness import WallClockFitness

    calls = []

    def reads_back(x):
        calls.append(1)
        return x * float(x.sum())

    x = torch.ones(4, device=cuda)
    cf = CapturedFunction(reads_back)
    with pytest.raises(RuntimeError, match="capture failed"):
        cf(x)
    assert cf.programs == {} and len(calls) == 2
    ev = WallClockFitness(
        lambda bits: (lambda: CapturedFunction(reads_back)(x)))((0,))
    assert not ev.valid and math.isinf(ev.time_s)
    assert "capture failed" in ev.detail["error"]
    ok = CapturedFunction(lambda y: y * 2)      # the card still captures
    ok(x)
    assert torch.equal(ok(x), x * 2)


@pytest.mark.gpu
def test_swap_plan_during_generate_finishes_on_the_old_snapshot_on_card(cuda):
    """``swap_plan`` from inside a generation (at its third sample): the
    call finishes on the old snapshot's captured programs, the next one
    runs the new snapshot's, each with its plan's tokens."""
    from repro_torch.models import REFERENCE_PLAN
    from repro_torch.runtime.serve import Server

    model, params, plan, inputs = _family_on("qwen3_0_6b", cuda)
    other = REFERENCE_PLAN.replace(compute_dtype="bfloat16")
    want_old = Server(model, params, plan).generate(inputs, 6)
    want_new = Server(model, params, other).generate(inputs, 6)
    server = Server(model, params, plan)
    old = server._bound
    sample, n = server._sample, [0]

    def swapping(logits, gen):
        n[0] += 1
        if n[0] == 3:
            server.swap_plan(other)
        return sample(logits, gen)

    server._sample = swapping
    got = server.generate(inputs, 6)
    new = server._bound
    assert new is not old and new.plan is other
    np.testing.assert_array_equal(got, want_old)
    (prog,) = old._decode.programs.values()
    assert prog.replays == 4 and new._decode.programs == {}
    np.testing.assert_array_equal(server.generate(inputs, 6), want_new)
    (prog,) = new._decode.programs.values()
    assert prog.replays == 4


@pytest.mark.gpu
def test_programs_sharing_a_pool_replay_in_any_order_on_card(cuda):
    """Two programs captured into one ``GraphPool`` (a search's chromosomes)
    replay in another order than they were captured, on new inputs too,
    each with the eager program's outputs."""
    from repro_torch.core.device_program import (CapturedFunction,
                                                 GraphPool, disable_capture)

    pool = GraphPool()
    fns = [CapturedFunction(lambda t: torch.relu(t @ t) + 1.0),
           CapturedFunction(lambda t: torch.tanh(t * 3.0) @ t.T)]
    for f in fns:
        f.pool = pool
    x = torch.randn(256, 256, generator=torch.Generator().manual_seed(0)
                    ).to(cuda)
    for f in fns:
        f(x)
    for t in (x, x.flip(0), x * 0.5):
        got = [f(t) for f in reversed(fns)][::-1]
        with disable_capture():
            want = [f(t) for f in fns]
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(next(iter(f.programs.values())).replays == 3 for f in fns)
