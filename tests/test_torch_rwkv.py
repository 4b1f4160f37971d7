"""The port's RWKV-6 block (``repro_torch/models/rwkv.py``) against the JAX
reference's (``repro/models/rwkv.py``) on the CPU: the WKV recurrence in
its step and chunked forms from a nonzero state (a chunk that divides S and
one that does not), token shift with a previous token, the data-dependent
lerp, the per-head group norm, the two halves of the block with and without
a carried state, and the whole block; same numpy inputs from a seed, f32,
tolerance 1e-5.  And the recurrence's export: one ``scan`` node a call."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import plan as jplan  # noqa: E402
from repro.models import rwkv as JW  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import similarity as sim  # noqa: E402
from repro_torch.models import REFERENCE_PLAN  # noqa: E402
from repro_torch.models import rwkv as W  # noqa: E402
from repro_torch.models.transformer import RWKVBlock  # noqa: E402

F32 = REFERENCE_PLAN.replace(compute_dtype="float32")
JF32 = jplan.REFERENCE_PLAN.replace(compute_dtype="float32")
ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=0)


def _wkv_inputs(b=2, s=24, h=3, d=16, seed=0):
    """r, k, v ~ N(0, 0.5), log_w drawn as the time mix draws it (a clamp
    of -exp(.) at [-8, 2]), u ~ N(0, 0.1) and a nonzero state."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, s, h, d)) * 0.5 for _ in range(3))
    lw = -np.exp(np.clip(rng.normal(size=(b, s, h, d)) - 1.0, -8.0, 2.0))
    u = rng.normal(size=(h, d)) * 0.1
    s0 = rng.normal(size=(b, h, d, d)) * 0.3
    return [np.asarray(a, np.float32) for a in (r, k, v, lw, u, s0)]


def test_wkv_step_scan_matches_reference_from_a_state():
    xs = _wkv_inputs()
    y, s_t = W.wkv_step_scan(*map(_t, xs), W.WKVRecurrence())
    jy, js_t = JW.wkv_step_scan(*map(jnp.asarray, xs))
    _close(y, jy)
    _close(s_t, js_t)


@pytest.mark.parametrize("s,chunk", [(24, 8), (24, 16), (7, 16)])
def test_wkv_chunked_matches_reference_from_a_state(s, chunk):
    """Chunks of 8 and 16 over S = 24: the chunk scan, and (16 does not
    divide 24) the step fallback; S = 7 < chunk: one chunk of 7."""
    xs = _wkv_inputs(s=s, seed=1)
    y, s_t = W.wkv_chunked(*map(_t, xs), chunk, W.WKVRecurrence())
    jy, js_t = JW.wkv_chunked(*map(jnp.asarray, xs), chunk)
    _close(y, jy)
    _close(s_t, js_t)
    sy, ss_t = W.wkv_step_scan(*map(_t, xs), W.WKVRecurrence())
    _close(y, sy)
    _close(s_t, ss_t)


@pytest.mark.parametrize("with_prev", [False, True])
def test_token_shift_matches_reference(with_prev):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 8)).astype(np.float32)
    prev = rng.normal(size=(2, 8)).astype(np.float32) if with_prev else None
    got = W._token_shift(_t(x), None if prev is None else _t(prev))
    want = JW._token_shift(jnp.asarray(x),
                           None if prev is None else jnp.asarray(prev))
    _close(got, want, 0)


def _tm_params(cfg, seed=0):
    jp = jax.tree_util.tree_map(lambda a: np.array(a),
                                JW.rwkv_init(jax.random.key(seed), cfg))
    return jp, {k: _t(v) for k, v in jp.items()}


@pytest.fixture(scope="module")
def cfgs():
    return jbase.get_config("rwkv6_3b").reduced(), \
        tbase.get_config("rwkv6_3b").reduced()


def test_ddlerp_and_groupnorm_heads_match_reference(cfgs):
    jcfg, _ = cfgs
    jp, tp = _tm_params(jcfg)
    rng = np.random.default_rng(3)
    x, sx = rng.normal(size=(2, 2, 6, jcfg.d_model)).astype(np.float32)
    for got, want in zip(W._ddlerp(_t(x), _t(sx), tp),
                         JW._ddlerp(jnp.asarray(x), jnp.asarray(sx), jp)):
        _close(got, want)
    nh = jcfg.d_model // jcfg.rwkv_head_dim
    scale, bias = rng.normal(size=(2, jcfg.d_model)).astype(np.float32)
    y = (rng.normal(size=(2, 6, jcfg.d_model)) * 3 + 1).astype(np.float32)
    _close(W._groupnorm_heads(_t(y), _t(scale), _t(bias), nh),
           JW._groupnorm_heads(jnp.asarray(y), jnp.asarray(scale),
                               jnp.asarray(bias), nh))


def _state(cfg, b, rng):
    nh, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    return [rng.normal(size=shape).astype(np.float32) * 0.3 for shape in
            ((b, nh, hd, hd), (b, cfg.d_model), (b, cfg.d_model))]


@pytest.mark.parametrize("impl", ["step", "chunked"])
@pytest.mark.parametrize("with_state", [False, True])
def test_time_mix_and_channel_mix_match_reference(cfgs, impl, with_state):
    """S = 20 with chunks of 8 (``chunked`` takes the step fallback) and
    S = 16 (two chunks), from zeros or a carried state."""
    jcfg, cfg = cfgs
    jp, tp = _tm_params(jcfg, seed=1)
    rng = np.random.default_rng(4)
    for s in (20, 16):
        x = rng.normal(size=(2, s, jcfg.d_model)).astype(np.float32)
        st = _state(jcfg, 2, rng) if with_state else None
        state = W.RWKVState(*map(_t, st)) if st else None
        jstate = JW.RWKVState(*map(jnp.asarray, st)) if st else None
        plan = F32.replace(wkv_impl=impl, wkv_chunk=8)
        jpl = JF32.replace(wkv_impl=impl, wkv_chunk=8)
        with torch.no_grad():
            got = W.time_mix(_t(x), tp, cfg, plan, state, W.WKVRecurrence())
            got_cm = W.channel_mix(_t(x), tp, cfg, plan, state)
        want = JW.time_mix(jnp.asarray(x), jp, jcfg, jpl, jstate)
        want_cm = JW.channel_mix(jnp.asarray(x), jp, jcfg, jpl, jstate)
        for g, w in zip(got + got_cm, want + want_cm):
            _close(g, w)


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_block_matches_reference(cfgs, with_state):
    jcfg, cfg = cfgs
    blk = JT._rwkv_block_init(jax.random.key(2), jcfg, jnp.float32)
    rng = np.random.default_rng(5)
    blk = dict(blk, ln1_s=jnp.asarray(1 + 0.1 * rng.normal(
        size=jcfg.d_model).astype(np.float32)), ln2_b=jnp.asarray(
        0.1 * rng.normal(size=jcfg.d_model).astype(np.float32)))
    block = RWKVBlock(cfg, device="cpu").requires_grad_(False)
    block.ln1.weight.copy_(_t(blk["ln1_s"]))
    block.ln1.bias.copy_(_t(blk["ln1_b"]))
    block.ln2.weight.copy_(_t(blk["ln2_s"]))
    block.ln2.bias.copy_(_t(blk["ln2_b"]))
    for k, w in blk["tm_cm"].items():
        block.tm_cm[k].copy_(_t(w))
    x = rng.normal(size=(2, 12, jcfg.d_model)).astype(np.float32)
    st = _state(jcfg, 2, rng) if with_state else None
    got, new = block(_t(x), F32,
                     state=W.RWKVState(*map(_t, st)) if st else None)
    want, jnew = JT._rwkv_block_full(
        jnp.asarray(x), blk, jcfg, JF32,
        dict(zip(("wkv", "shift_tm", "shift_cm"), map(jnp.asarray, st)))
        if st else None)
    _close(got, want)
    for f in ("wkv", "shift_tm", "shift_cm"):
        _close(getattr(new, f), jnew[f])


@pytest.mark.parametrize("impl", ["step", "chunked"])
def test_wkv_recurrence_exports_as_one_scan(impl):
    """The submodule's forward is one ``scan`` over time (or chunks): the
    export frontend's loop region, never an unrolled loop."""
    xs = _wkv_inputs(s=16)

    class Mix(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.wkv = W.WKVRecurrence()

        def forward(self, r, k, v, lw, u, s0):
            if impl == "chunked":
                return W.wkv_chunked(r, k, v, lw, u, s0, 8, self.wkv)
            return W.wkv_step_scan(r, k, v, lw, u, s0, self.wkv)

    ep = torch.export.export(Mix(), tuple(map(_t, xs)))
    scans = [n for n in ep.graph_module.graph.nodes if sim.is_scan(n)]
    assert len(scans) == 1
    assert scans[0].meta["nn_module_stack"]
