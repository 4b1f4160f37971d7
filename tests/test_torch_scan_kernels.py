"""The port's scan kernel wrappers (``repro_torch.kernels.ops.rglru_scan``
and ``wkv6``) against the JAX reference: on CPU tensors the wrappers run
their kernels' plain versions (step loops in f32), held against
``repro.kernels.ops`` (Pallas in interpret mode) and ``repro.kernels.ref``
over the sweeps of ``tests/test_kernels.py``, at its tolerances (RG-LRU
atol 1e-5 rtol 1e-4, WKV-6 atol 5e-5 rtol 1e-3).  The CUDA kernels
themselves are tested on the card in ``test_torch_cuda.py``."""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

RGLRU_TOL = {"atol": 1e-5, "rtol": 1e-4}
WKV_TOL = {"atol": 5e-5, "rtol": 1e-3}


def _f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


# ---------------------------------------------------------------------------
# rglru linear recurrence: the sweep of tests/test_kernels.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,s,d,chunk,dblk", [
    (1, 128, 128, 64, 128),
    (2, 256, 256, 128, 128),
    (2, 100, 128, 64, 128),   # ragged seq (the reference pads; the port masks)
    (1, 64, 384, 32, 128),
])
def test_rglru_plain_matches_pallas_and_oracle(rng, b, s, d, chunk, dblk):
    log_a = -np.abs(_f32(rng, b, s, d)) * 0.2
    bb = _f32(rng, b, s, d, scale=0.5)
    got = tops.rglru_scan(*_t(log_a, bb)).numpy()
    pallas = np.asarray(jops.rglru_scan(jnp.asarray(log_a), jnp.asarray(bb),
                                        chunk=chunk, d_block=dblk))
    oracle = np.asarray(jref.rglru_scan_ref(jnp.asarray(log_a),
                                            jnp.asarray(bb)))
    np.testing.assert_allclose(got, pallas, **RGLRU_TOL)
    np.testing.assert_allclose(got, oracle, **RGLRU_TOL)
    np.testing.assert_allclose(tref.rglru_scan_ref(*_t(log_a, bb)).numpy(),
                               oracle, **RGLRU_TOL)


def test_rglru_initial_state_matches_pallas(rng):
    log_a = -np.abs(_f32(rng, 2, 64, 128)) * 0.2
    bb = _f32(rng, 2, 64, 128, scale=0.5)
    h0 = _f32(rng, 2, 128)
    got = tops.rglru_scan(*_t(log_a, bb, h0)).numpy()
    want = np.asarray(jops.rglru_scan(*map(jnp.asarray, (log_a, bb, h0)),
                                      chunk=32))
    np.testing.assert_allclose(got, want, **RGLRU_TOL)


def test_rglru_takes_time_major_views(rng):
    """The scan site hands the wrapper (B,S,D) views of time-major (S,B,D)
    storage; the plain version reads them as they are."""
    log_a = -np.abs(_f32(rng, 50, 3, 20)) * 0.2
    bb = _f32(rng, 50, 3, 20, scale=0.5)
    la_t, b_t = (t.transpose(0, 1) for t in _t(log_a, bb))
    assert not la_t.is_contiguous()
    got = tops.rglru_scan(la_t, b_t).numpy()
    want = np.asarray(jref.rglru_scan_ref(jnp.asarray(log_a).transpose(1, 0, 2),
                                          jnp.asarray(bb).transpose(1, 0, 2)))
    np.testing.assert_allclose(got, want, **RGLRU_TOL)


# ---------------------------------------------------------------------------
# wkv6: the sweep of tests/test_kernels.py
# ---------------------------------------------------------------------------


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


@pytest.mark.parametrize("b,s,h,d,chunk", [
    (1, 64, 2, 64, 16),
    (2, 128, 2, 64, 32),
    (1, 96, 4, 32, 64),    # ragged against the reference's chunk
])
def test_wkv6_plain_matches_pallas_and_oracle(rng, b, s, h, d, chunk):
    r, k, v, lw, u = _wkv_inputs(rng, b, s, h, d)
    got = tops.wkv6(*_t(r, k, v, lw, u)).numpy()
    pallas = np.asarray(jops.wkv6(*map(jnp.asarray, (r, k, v, lw, u)),
                                  chunk=chunk))
    np.testing.assert_allclose(got, pallas, **WKV_TOL)
    np.testing.assert_allclose(got, _wkv_oracle(r, k, v, lw, u), **WKV_TOL)


def test_wkv6_oracle_matches_reference_oracle(rng):
    bh, s, d = 3, 40, 16
    r, k, v = (_f32(rng, bh, s, d, scale=0.5) for _ in range(3))
    lw = -np.abs(_f32(rng, bh, s, d)) * 0.3
    u = _f32(rng, bh, 1, d, scale=0.1)
    got = tref.wkv6_ref(*_t(r, k, v, lw, u)).numpy()
    want = np.asarray(jref.wkv6_ref(*map(jnp.asarray, (r, k, v, lw, u))))
    np.testing.assert_allclose(got, want, **WKV_TOL)


def test_wkv6_strong_decay_matches_step_oracle(rng):
    """log_w at the model's clamp, -exp(2), every step: a 64-step chunk's
    cumulated decay reaches -473, where the reference's split closed form
    (k * exp(-cs)) overflows f32.  So the step oracle alone is the
    yardstick; the port's plain version (and kernel) must stay finite and
    match it."""
    r, k, v, lw, u = _wkv_inputs(rng, 1, 192, 2, 64, log_w=-math.exp(2.0))
    got = tops.wkv6(*_t(r, k, v, lw, u)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _wkv_oracle(r, k, v, lw, u), **WKV_TOL)


# ---------------------------------------------------------------------------
# the wrappers' contract on the CPU
# ---------------------------------------------------------------------------


def test_scan_wrappers_count_no_launch_on_cpu_and_check_shapes(rng):
    tops.reset_launch_counts()
    la = torch.zeros(1, 8, 4)
    tops.rglru_scan(la, la)
    r = torch.zeros(1, 8, 2, 16)
    tops.wkv6(r, r, r, r, torch.zeros(2, 16))
    assert tops.launch_counts() == {"flash_attention": 0, "rmsnorm": 0,
                                    "rglru_scan": 0, "wkv6": 0}
    with pytest.raises(ValueError, match="rglru_scan: bad shapes"):
        tops.rglru_scan(la, torch.zeros(1, 8, 5))
    with pytest.raises(ValueError, match="rglru_scan: bad shapes"):
        tops.rglru_scan(la, la, torch.zeros(1, 5))
    with pytest.raises(ValueError, match="wkv6: bad shapes"):
        tops.wkv6(r, r, r, r, torch.zeros(3, 16))
    with pytest.raises(ValueError, match="several devices"):
        tops.rglru_scan(la, la.to("meta"))
