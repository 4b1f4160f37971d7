"""The port's optimizer, schedules, gradient compression and data pipeline
(``repro_torch/optim``, ``repro_torch/data``): the counterparts of
``tests/test_optim_data.py``, then each against the JAX reference on the
same numpy inputs: AdamW within 1e-6, the schedules within 1e-6 relative,
int8 compression exactly, and the synthetic and token-file batches bit for
bit."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _hypothesis_compat import given, settings, st  # noqa: E402

from repro import data as jdata  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro_torch.data import (Batcher, DataConfig, SyntheticLMDataset,  # noqa: E402
                              TokenFileDataset, make_dataset)
from repro_torch.optim import (OptimizerConfig, adamw_init,  # noqa: E402
                               adamw_update, compress_int8, decompress_int8,
                               ef_compress_update, ef_init, make_schedule)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# the reference's own tests, on the port
# ---------------------------------------------------------------------------


def test_adamw_minimizes_quadratic():
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = adamw_init(params)
    cfg = OptimizerConfig(lr=0.1, weight_decay=0.0)
    for _ in range(200):
        g = {"w": 2 * (params["w"] - target)}
        params, state, _ = adamw_update(g, state, params, cfg, cfg.lr)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=1e-2)
    assert state.step.dtype == torch.int32 and int(state.step) == 200


def test_grad_clipping_bounds_update():
    params = {"w": torch.zeros(4)}
    state = adamw_init(params)
    cfg = OptimizerConfig(lr=1.0, clip_norm=1.0, weight_decay=0.0)
    huge = {"w": torch.full((4,), 1e6)}
    p2, _, metrics = adamw_update(huge, state, params, cfg, cfg.lr)
    assert float(metrics["grad_norm"]) > 1e5
    assert bool((p2["w"].abs() < 10.0).all())


def test_schedule_shapes():
    s = make_schedule("cosine", peak_lr=1e-3, warmup_steps=10, total_steps=100)
    assert float(s(0)) == 0.0
    assert float(s(10)) == pytest.approx(1e-3)
    assert float(s(100)) == pytest.approx(1e-4, rel=0.05)
    assert float(s(5)) == pytest.approx(5e-4)
    assert s(torch.tensor(3, dtype=torch.int32)).dtype == torch.float32


@given(st.integers(0, 2 ** 16), st.floats(0.1, 100.0))
@settings(max_examples=25, deadline=None)
def test_property_int8_roundtrip_error_bound(seed, scale):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=(64,)) * scale).astype(np.float32))
    q, s = compress_int8(x)
    assert q.dtype == torch.int8
    err = (decompress_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) / 2 + 1e-6  # half-ulp of the grid


def test_error_feedback_tracks_exact_sgd():
    rng = np.random.default_rng(3)
    comp = ef_init({"w": torch.zeros(32)})
    exact_sum = np.zeros(32)
    applied_sum = np.zeros(32)
    for _ in range(50):
        g = {"w": torch.from_numpy(rng.normal(size=32).astype(np.float32))}
        exact_sum += g["w"].numpy()
        qs, scales, comp = ef_compress_update(g, comp)
        applied_sum += decompress_int8(qs["w"], scales["w"]).numpy()
    resid = comp.error["w"].abs().numpy()
    np.testing.assert_allclose(applied_sum, exact_sum, atol=resid.max() + 1e-5)
    assert resid.max() < 0.2


def test_synthetic_data_deterministic_and_shard_aware():
    ds = SyntheticLMDataset(DataConfig(seq_len=32, global_batch=8, vocab=100,
                                       seed=7))
    b1 = ds.batch(5, host_id=0, n_hosts=2)
    b2 = ds.batch(5, host_id=0, n_hosts=2)
    b3 = ds.batch(5, host_id=1, n_hosts=2)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(b1["tokens"], b3["tokens"])
    assert b1["tokens"].shape == (4, 32)
    np.testing.assert_array_equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])


def test_batcher_resumes_from_step():
    ds = SyntheticLMDataset(DataConfig(seq_len=16, global_batch=4, vocab=50,
                                       seed=1))
    b = Batcher(ds, start_step=10)
    step, batch = next(b)
    b.close()
    assert step == 10
    np.testing.assert_array_equal(batch["tokens"], ds.batch(10)["tokens"])


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


def test_adamw_update_matches_reference():
    """Three steps fed the same gradients (and lr values) as the reference,
    norm scales among the leaves (weight decay reaches them too), the
    second step's gradients large enough to clip: params, mu and nu within
    1e-6, the step count and the metrics."""
    rng = np.random.default_rng(0)
    shapes = {"embed": (16, 8), "blocks.0.ln1.weight": (8,),
              "blocks.0.wq": (8, 12)}
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    params, jparams = {k: _t(v) for k, v in p.items()}, \
        {k: jnp.asarray(v) for k, v in p.items()}
    cfg, jcfg = OptimizerConfig(), joptim.OptimizerConfig()
    state, jstate = adamw_init(params), joptim.adamw_init(jparams)
    for i, (lr, gscale) in enumerate(((3e-4, 0.05), (1e-3, 10.0),
                                      (5e-4, 0.01))):
        g = {k: (rng.normal(size=s) * gscale).astype(np.float32)
             for k, s in shapes.items()}
        params, state, m = adamw_update({k: _t(v) for k, v in g.items()},
                                        state, params, cfg, lr)
        jparams, jstate, jm = joptim.adamw_update(
            {k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams, jcfg,
            lr)
        for k in shapes:
            for got, want in ((params[k], jparams[k]),
                              (state.mu[k], jstate.mu[k]),
                              (state.nu[k], jstate.nu[k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           atol=1e-6, rtol=0)
        assert int(state.step) == int(jstate.step) == i + 1
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                      rel=1e-6)
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-7)
    assert list(state.mu) == list(shapes)        # keyed in the params' order


def test_adamw_keeps_param_dtype_and_f32_state():
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = adamw_init(params)
    assert state.mu["w"].dtype == torch.float32
    p2, s2, _ = adamw_update({"w": torch.ones(4, dtype=torch.bfloat16)},
                             state, params, OptimizerConfig(), 1e-2)
    assert p2["w"].dtype == torch.bfloat16 and s2.nu["w"].dtype == torch.float32
    assert float(params["w"][0]) == 1.0          # the input is not written


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_schedule_matches_reference(kind):
    kw = dict(peak_lr=3e-4, warmup_steps=7, total_steps=50, final_frac=0.2)
    s, js = make_schedule(kind, **kw), joptim.make_schedule(kind, **kw)
    for step in range(0, 60, 3):
        got, want = float(s(step)), float(js(step))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), (step, got,
                                                                 want)


def test_int8_compression_matches_reference():
    """Half-way values round to even in both; the EF state and payloads
    agree over five steps."""
    rng = np.random.default_rng(1)
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0, 3.2], np.float32)
    q, s = compress_int8(_t(x))
    jq, js = joptim.compress_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    comp, jcomp = ef_init({"w": torch.zeros(40)}), \
        joptim.ef_init({"w": jnp.zeros(40)})
    for _ in range(5):
        g = rng.normal(size=40).astype(np.float32)
        qs, scales, comp = ef_compress_update({"w": _t(g)}, comp)
        jqs, jscales, jcomp = joptim.ef_compress_update(
            {"w": jnp.asarray(g)}, jcomp)
        np.testing.assert_array_equal(qs["w"].numpy(), np.asarray(jqs["w"]))
        assert float(scales["w"]) == pytest.approx(float(jscales["w"]),
                                                   rel=1e-7)
        np.testing.assert_allclose(comp.error["w"].numpy(),
                                   np.asarray(jcomp.error["w"]), atol=1e-7)


@pytest.mark.parametrize("step,host,hosts", [(0, 0, 1), (5, 1, 2), (123, 3, 4)])
def test_synthetic_batches_match_reference_bit_for_bit(step, host, hosts):
    kw = dict(seq_len=34, global_batch=8, vocab=1000, seed=11)
    got = SyntheticLMDataset(DataConfig(**kw)).batch(step, host, hosts)
    want = jdata.SyntheticLMDataset(jdata.DataConfig(**kw)).batch(step, host,
                                                                  hosts)
    assert sorted(got) == sorted(want) == ["labels", "tokens"]
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def test_token_file_batches_match_reference(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(2).integers(0, 600, size=5000).astype(
        np.uint16).tofile(path)
    kw = dict(seq_len=16, global_batch=4, vocab=500, seed=3, path=str(path))
    ds = make_dataset(DataConfig(**kw))
    assert isinstance(ds, TokenFileDataset)
    jds = jdata.make_dataset(jdata.DataConfig(**kw))
    for step in (0, 9):
        got, want = ds.batch(step), jds.batch(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])
        assert got["tokens"].max() < 500
