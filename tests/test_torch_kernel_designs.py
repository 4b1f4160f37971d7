"""The redesigned kernels' host-side logic and algorithms, on the CPU.

- The flash-attention path predicate (``select_path``): which of the CUDA
  kernel's paths (``"wgmma"``, ``"mma"``, ``"scalar"``) given inputs take;
  and ``block_rel_err``, the scale-aware check the card runs beside the
  element-wise one, against a fault the element-wise check misses.
- ``wkv6_chunked_plain``, the plain twin of the WKV-6 kernel's
  chunk-parallel algorithm, against the step loop (``wkv6_plain``), the JAX
  oracle (``repro.kernels.ref.wkv6_ref``) and the Pallas kernel in
  interpret mode (``repro.kernels.ops.wkv6``), at the reference tests'
  tolerance (atol 5e-5, rtol 1e-3), and at decays where the TPU kernel's
  closed form overflows.
- The RMSNorm variant predicate (``select_variant``): which instance and
  how many lanes a row given widths and dtypes take, and its refusal of a
  width that is not a multiple of 8.
- The RG-LRU route predicate (``select_route``): which load route (``"tma"``
  or ``"cp_async"``) given strides and alignments take.
- CPU calls count no variant and no route.

The kernels themselves run on the card in ``test_torch_cuda.py``."""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import rglru_scan as trg  # noqa: E402
from repro_torch.kernels import rmsnorm as trn  # noqa: E402
from repro_torch.kernels import wkv6 as twk  # noqa: E402

WKV_TOL = {"atol": 5e-5, "rtol": 1e-3}
BF16, F32 = torch.bfloat16, torch.float32


# ---------------------------------------------------------------------------
# (i) the flash-attention path predicate
# ---------------------------------------------------------------------------


def _qkv(b, sq, sk, hq, hkv, d, dtype):
    return (torch.empty(b, sq, hq, d, dtype=dtype),
            torch.empty(b, sk, hkv, d, dtype=dtype),
            torch.empty(b, sk, hkv, d, dtype=dtype))


def _fused_heads(b, s, hq, hkv, d, dtype, pad=0):
    """q/k/v as head slices of one fused projection, each head ``d`` wide
    inside a row of ``(hq + 2 hkv) * d + pad`` elements."""
    width = (hq + 2 * hkv) * d + pad
    flat = torch.empty(b, s, width, dtype=dtype)
    heads = flat[..., :(hq + 2 * hkv) * d].unflatten(-1, (hq + 2 * hkv, d))
    return heads[:, :, :hq], heads[:, :, hq:hq + hkv], heads[:, :, hq + hkv:]


@pytest.mark.parametrize("case,want", [
    (lambda: _qkv(2, 2048, 2048, 16, 8, 128, BF16), "wgmma"),   # path Q
    (lambda: _qkv(2, 256, 256, 4, 2, 64, BF16), "wgmma"),
    (lambda: _qkv(2, 130, 70, 4, 2, 64, BF16), "wgmma"),        # Sq != Sk
    (lambda: _qkv(1, 1000, 1000, 4, 1, 128, BF16), "wgmma"),    # ragged S
    (lambda: _fused_heads(2, 300, 8, 2, 128, BF16), "wgmma"),   # strided heads
    (lambda: _qkv(2, 130, 70, 4, 2, 32, BF16), "mma"),
    (lambda: _qkv(1, 100, 130, 2, 2, 40, BF16), "scalar"),      # hd 40
    (lambda: _qkv(2, 64, 64, 4, 4, 256, BF16), "scalar"),
    (lambda: _qkv(2, 2048, 2048, 16, 8, 128, F32), "scalar"),   # f32
    (lambda: _fused_heads(2, 33, 4, 2, 128, BF16, pad=4), "scalar"),  # seq stride not 16 B
    (lambda: tuple(t[..., 4:68] for t in _qkv(1, 64, 64, 2, 2, 72, BF16)),
     "scalar"),                                                 # base off 16 B
    (lambda: (torch.empty(1, 64, 2, 64, dtype=BF16),
              *(t.to(F32) for t in _qkv(1, 64, 64, 2, 2, 64, BF16)[1:])),
     "scalar"),                                                 # mixed dtypes
], ids=["path_q", "hd64", "sq_ne_sk", "ragged", "fused_heads", "hd32",
        "hd40", "hd256", "f32", "unaligned_seq_stride", "unaligned_base",
        "mixed_dtypes"])
def test_flash_path_predicate(case, want):
    q, k, v = case()
    assert tfa.select_path(q, k, v) == want


def test_flash_cpu_call_counts_no_path():
    tops.reset_launch_counts()
    q, k, v = (torch.randn(1, 8, 2, 64).to(BF16) for _ in range(3))
    tops.flash_attention(q, k, v)
    assert tops.flash_attention.launches_by_path == {"scalar": 0, "mma": 0,
                                                     "wgmma": 0}
    tops.flash_attention.launches_by_path["wgmma"] = 3
    tops.reset_launch_counts()
    assert set(tops.flash_attention.launches_by_path.values()) == {0}


@pytest.mark.parametrize("fault,within", [("none", True),
                                          ("late_tile", False)])
def test_flash_block_check_sees_late_row_faults(fault, within):
    """At path Q's sequence length a causal row near the end averages ~2000
    values, so its outputs are ~0.04: a kernel-like result (P rounded to
    bf16, f32 sums) passes both checks, while one whose late query rows
    weigh one key tile 5% too much passes the element-wise 2e-2 and fails
    ``block_rel_err``'s 1e-2."""
    rng = np.random.default_rng(7)
    s, d = 2048, 128
    q, k, v = (torch.from_numpy(_f32(rng, 1, s, 2, d)).to(BF16)
               for _ in range(3))
    want = tfa.flash_attention_plain(q, k, v, causal=True,
                                     scale=1 / math.sqrt(d))
    qh, kh, vh = (t.float().transpose(1, 2) for t in (q, k, v))
    scores = (qh @ kh.transpose(-1, -2) / math.sqrt(d)).masked_fill(
        ~torch.ones(s, s, dtype=torch.bool).tril(), tfa.NEG_INF)
    p = (scores - scores.amax(-1, keepdim=True)).exp()
    if fault == "late_tile":
        p[..., 1536:, 1536:1664] *= 1.05
    got = ((p.to(BF16).float() @ vh) / p.sum(-1, keepdim=True)) \
        .transpose(1, 2).to(BF16)
    assert torch.allclose(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert (tfa.block_rel_err(got, want) <= 1e-2) == within


# ---------------------------------------------------------------------------
# (ii) the chunked WKV-6 twin against the step loop, the JAX oracle and the
#      Pallas kernel (the sweep of tests/test_torch_scan_kernels.py)
# ---------------------------------------------------------------------------


def _f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _wkv_inputs(rng, b, s, h, d, log_w=None):
    r, k, v = (_f32(rng, b, s, h, d, scale=0.5) for _ in range(3))
    lw = -np.abs(_f32(rng, b, s, h, d)) * 0.3 if log_w is None \
        else np.full((b, s, h, d), log_w, np.float32)
    u = _f32(rng, h, d, scale=0.1)
    return r, k, v, lw, u


def _wkv_oracle(r, k, v, lw, u):
    """``repro.kernels.ref.wkv6_ref`` in the model layout."""
    b, s, h, d = r.shape

    def flat(a):
        return jnp.asarray(a).transpose(0, 2, 1, 3).reshape(b * h, s, d)
    uf = jnp.broadcast_to(jnp.asarray(u)[None], (b, h, d)).reshape(b * h, 1, d)
    y = jref.wkv6_ref(flat(r), flat(k), flat(v), flat(lw), uf)
    return np.asarray(y.reshape(b, h, s, d).transpose(0, 2, 1, 3))


def _chunked(*arrays):
    return twk.wkv6_chunked_plain(*map(torch.from_numpy, arrays)).numpy()


@pytest.mark.parametrize("b,s,h,d,chunk", [
    (1, 64, 2, 64, 16),
    (2, 128, 2, 64, 32),
    (1, 96, 4, 32, 64),    # ragged against the kernel's and the reference's chunk
])
def test_wkv6_chunked_twin_matches_pallas_and_oracles(rng, b, s, h, d, chunk):
    r, k, v, lw, u = _wkv_inputs(rng, b, s, h, d)
    got = _chunked(r, k, v, lw, u)
    pallas = np.asarray(jops.wkv6(*map(jnp.asarray, (r, k, v, lw, u)),
                                  chunk=chunk))
    np.testing.assert_allclose(got, pallas, **WKV_TOL)
    np.testing.assert_allclose(got, _wkv_oracle(r, k, v, lw, u), **WKV_TOL)
    step = twk.wkv6_plain(*map(torch.from_numpy, (r, k, v, lw, u))).numpy()
    np.testing.assert_allclose(got, step, **WKV_TOL)


@pytest.mark.parametrize("b,s,h,d", [(2, 200, 3, 16), (1, 129, 1, 64)])
def test_wkv6_chunked_twin_matches_step_loop_across_chunks(rng, b, s, h, d):
    """Several chunks (the state pass), the last one ragged."""
    r, k, v, lw, u = _wkv_inputs(rng, b, s, h, d)
    step = twk.wkv6_plain(*map(torch.from_numpy, (r, k, v, lw, u))).numpy()
    np.testing.assert_allclose(_chunked(r, k, v, lw, u), step, **WKV_TOL)


# ---------------------------------------------------------------------------
# (iii) decays where the closed form's exp(-cumsum log w) overflows f32
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("log_w", [-math.exp(2.0), -20.0], ids=["clamp", "m20"])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 1000])
def test_wkv6_chunked_twin_is_finite_at_strong_decay(rng, log_w, s):
    """At -e^2 (the model's clamp) or -20 every step, a 64-step chunk's
    cumulated decay reaches -473 or -1280: exp(+473) is inf in f32.  The
    chunked form takes only exponents <= 0, so it stays finite and matches
    the step loop."""
    d = 64 if s <= 65 else 16
    r, k, v, lw, u = _wkv_inputs(rng, 1, s, 2, d, log_w=log_w)
    got = _chunked(r, k, v, lw, u)
    assert np.isfinite(got).all()
    step = twk.wkv6_plain(*map(torch.from_numpy, (r, k, v, lw, u))).numpy()
    np.testing.assert_allclose(got, step, **WKV_TOL)


# ---------------------------------------------------------------------------
# (iv) the RMSNorm variant predicate and the RG-LRU route predicate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,dtype,want", [
    (8, F32, (0, 2)), (8, BF16, (0, 1)),          # one or two vectors a row
    (64, F32, (0, 16)), (64, BF16, (0, 8)),
    (128, F32, (128, 32)), (128, BF16, (128, 16)),  # q/k-norm: two rows a warp
    (136, F32, (0, 32)), (136, BF16, (0, 16)),      # 17 vectors: 16 lanes
    (1024, F32, (1024, 32)), (1024, BF16, (1024, 32)),
    (2560, F32, (2560, 32)), (2560, BF16, (2560, 32)),
])
def test_rmsnorm_variant_predicate(d, dtype, want):
    assert trn.select_variant(torch.empty(3, d, dtype=dtype)) == want
    # leading dims do not move it
    assert trn.select_variant(torch.empty(2, 5, d, dtype=dtype)) == want


@pytest.mark.parametrize("variant,name", [((128, 16), "d128_l16"),
                                          ((2560, 32), "d2560_l32"),
                                          ((0, 1), "generic_l1")])
def test_rmsnorm_variant_names(variant, name):
    assert trn.variant_name(variant) == name


@pytest.mark.parametrize("d", [4, 12, 130])
def test_rmsnorm_variant_predicate_refuses_widths_not_a_multiple_of_8(d):
    with pytest.raises(ValueError, match="multiple of 8"):
        trn.select_variant(torch.empty(2, d, dtype=BF16))


def _misaligned(*shape):
    """An f32 tensor whose base is 4 bytes past a 16-byte boundary."""
    flat = torch.empty(int(np.prod(shape)) + 4)
    off = (4 - flat.data_ptr() % 16 // 4) % 4 + 1
    t = flat[off:off + int(np.prod(shape))].view(shape)
    assert t.data_ptr() % 16 == 4
    return t


@pytest.mark.parametrize("case,want", [
    (lambda: torch.empty(2, 2048, 2560), "tma"),                  # contiguous
    (lambda: torch.empty(2048, 2, 2560).transpose(0, 1), "tma"),  # path R's views
    (lambda: torch.empty(777, 3, 200).transpose(0, 1), "tma"),
    (lambda: torch.empty(3, 33, 130), "cp_async"),                # D = 130
    (lambda: torch.empty(33, 3, 130).transpose(0, 1), "cp_async"),
    (lambda: torch.empty(1, 33, 5), "cp_async"),                  # D = 5
    (lambda: _misaligned(2, 64, 256), "cp_async"),                # base off 4 B
    (lambda: torch.empty(2, 64, 256, dtype=BF16), "cp_async"),    # not f32
], ids=["contiguous", "time_major", "time_major_d200", "d130",
        "d130_time_major", "d5", "misaligned_base", "bf16"])
def test_rglru_route_predicate(case, want):
    la = case()
    assert trg.select_route(la, la) == want
    if want == "tma":   # one input off the route takes the pair off it
        assert trg.select_route(la, _misaligned(*la.shape)) == "cp_async"


def test_cpu_calls_count_no_variant_or_route():
    tops.reset_launch_counts()
    tops.rmsnorm(torch.randn(4, 128, dtype=BF16), torch.zeros(128, dtype=BF16))
    tops.rglru_scan(-torch.rand(2, 8, 32), torch.randn(2, 8, 32))
    assert tops.rmsnorm.launches_by_variant == {}
    assert tops.rglru_scan.launches_by_route == {"cp_async": 0, "tma": 0}
    tops.rmsnorm.launches_by_variant["d128_l16"] = 2
    tops.rglru_scan.launches_by_route["tma"] = 3
    tops.reset_launch_counts()
    assert tops.rmsnorm.launches_by_variant == {}
    assert set(tops.rglru_scan.launches_by_route.values()) == {0}
