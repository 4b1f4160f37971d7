"""The port's kernel wrappers (``repro_torch.kernels.ops``) against the JAX
reference: on CPU tensors the wrappers run their kernels' plain versions,
held against ``repro.kernels.ops`` (Pallas in interpret mode) and
``repro.kernels.ref`` over the sweep of ``tests/test_kernels.py``, at its
tolerances.  The CUDA kernels themselves are tested on the card in
``test_torch_cuda.py``."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(rng, shape, dtype, scale=1.0):
    """The same values as a JAX array and a torch tensor (made in f32 by
    numpy, rounded once to the working dtype)."""
    a = (rng.normal(size=shape) * scale).astype(np.float32)
    jx = jnp.asarray(a, _DTYPES[dtype][0])
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        _DTYPES[dtype][1])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# flash attention: the sweep of tests/test_kernels.py
# ---------------------------------------------------------------------------

_FLASH_SHAPES = [
    (1, 128, 2, 2, 32),
    (2, 256, 4, 2, 64),
    (1, 192, 8, 1, 16),    # MQA, ragged vs block
    (2, 64, 4, 4, 128),
]


@pytest.mark.parametrize("b,s,hq,hkv,d", _FLASH_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_reference(b, s, hq, hkv, d, causal, dtype):
    rng = np.random.default_rng(0)
    jq, q = _pair(rng, (b, s, hq, d), dtype)
    jk, k = _pair(rng, (b, s, hkv, d), dtype)
    jv, v = _pair(rng, (b, s, hkv, d), dtype)
    got = tops.flash_attention(q, k, v, causal=causal)
    assert got.shape == (b, s, hq, d) and got.dtype == q.dtype
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    # the Pallas kernel in interpret mode, at the reference test's blocks
    want = jops.flash_attention(jq, jk, jv, causal=causal, blk_q=64, blk_k=64)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    # the reference oracle in its flattened (B*H, S, D) layout
    flat = lambda a, h: a.transpose(0, 2, 1, 3).reshape(b * h, s, d)  # noqa: E731
    exp = jref.flash_attention_ref(flat(jq, hq), flat(jk, hkv), flat(jv, hkv),
                                   causal=causal, scale=1 / np.sqrt(d),
                                   group=hq // hkv)
    exp = np.asarray(exp.astype(jnp.float32)).reshape(b, hq, s, d)
    np.testing.assert_allclose(_np(got), exp.transpose(0, 2, 1, 3),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("sq,sk", [(48, 80), (80, 48)])
def test_flash_attention_causal_mask_top_left_when_sq_ne_sk(sq, sk):
    """Sq != Sk keeps the reference's top-left aligned mask (col <= row)."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(3, sq, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(3, sk, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(3, sk, 16)).astype(np.float32))
    got = tops.flash_attention(q[None].transpose(1, 2), k[None].transpose(1, 2),
                               v[None].transpose(1, 2), causal=True)
    want = tref.flash_attention_ref(q, k, v, causal=True, scale=0.25)
    jwant = jref.flash_attention_ref(jnp.asarray(q.numpy()),
                                     jnp.asarray(k.numpy()),
                                     jnp.asarray(v.numpy()),
                                     causal=True, scale=0.25)
    np.testing.assert_allclose(_np(want), np.asarray(jwant), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(_np(got[0].transpose(0, 1)), _np(want),
                               atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,d", [(64, 128), (100, 256), (256, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(n, d, dtype):
    rng = np.random.default_rng(0)
    jx, x = _pair(rng, (n, d), dtype)
    js, s = _pair(rng, (d,), "float32", scale=0.1)
    got = tops.rmsnorm(x, s)
    assert got.shape == x.shape and got.dtype == x.dtype
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    for want in (jops.rmsnorm(jx, js), jref.rmsnorm_ref(jx, js)):
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), _np(tref.rmsnorm_ref(x, s)),
                               atol=tol, rtol=tol)


def test_rmsnorm_wrapper_flattens_leading_dims():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(2, 5, 3, 16)).astype(np.float32))
    s = torch.from_numpy(rng.normal(size=(16,)).astype(np.float32))
    np.testing.assert_allclose(
        _np(tops.rmsnorm(x, s)),
        _np(tops.rmsnorm(x.reshape(-1, 16), s)).reshape(2, 5, 3, 16))


# ---------------------------------------------------------------------------
# the wrappers' routing: plain version for CPU tensors only
# ---------------------------------------------------------------------------


def test_wrappers_raise_on_meta_tensors():
    q = torch.empty(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="no kernel for device"):
        tops.rmsnorm(torch.empty(4, 16, device="meta"),
                     torch.empty(16, device="meta"))


def test_cpu_tensors_take_plain_version_without_counting():
    tops.reset_launch_counts()
    x = torch.ones(4, 16)
    tops.rmsnorm(x, torch.zeros(16))
    tops.flash_attention(x.reshape(1, 4, 1, 16), x.reshape(1, 4, 1, 16),
                         x.reshape(1, 4, 1, 16))
    assert tops.launch_counts() == {"flash_attention": 0, "rmsnorm": 0,
                                    "rglru_scan": 0, "wkv6": 0}


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        tops.flash_attention(torch.ones(1, 4, 3, 8), torch.ones(1, 4, 2, 8),
                             torch.ones(1, 4, 2, 8))
    with pytest.raises(ValueError):
        tops.rmsnorm(torch.ones(4, 16), torch.ones(8))
