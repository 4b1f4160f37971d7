"""The port's serving loop against the reference ``Server`` on the CPU:
greedy tokens on a reduced Qwen3 in f32 (weights from the reference's
``init_params`` through ``model_from_jax``), plan hot-swap, the traffic
rate, seeded temperature sampling, and the parameters cast once per plan."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import REFERENCE_PLAN as JREF  # noqa: E402
from repro.models import OFFLOAD_PLAN as JOFF  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.runtime.serve import Server as JServer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import OFFLOAD_PLAN, REFERENCE_PLAN, build_model  # noqa: E402
from repro_torch.models.convert import model_from_jax  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.runtime.serve import ServeConfig, Server  # noqa: E402

F32 = REFERENCE_PLAN.replace(compute_dtype="float32")
JF32 = JREF.replace(compute_dtype="float32")


@pytest.fixture(scope="module")
def served():
    jcfg, cfg = jget_config("qwen3_0_6b").reduced(), \
        get_config("qwen3_0_6b").reduced()
    jm, model = jbuild_model(jcfg), build_model(cfg)
    jparams = jm.init(jax.random.key(0))
    params = model_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                            device="cpu")
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab, size=(3, 12)).astype(np.int32)
    return cfg, model, params, jm, jparams, tokens


@pytest.mark.parametrize("max_new", [1, 8])
def test_greedy_tokens_equal_the_reference_server(served, max_new):
    _, model, params, jm, jparams, tokens = served
    want = JServer(jm, jparams, JF32).generate(
        {"tokens": jnp.asarray(tokens)}, max_new)
    got = Server(model, params, F32).generate(
        {"tokens": torch.from_numpy(tokens)}, max_new)
    assert got.dtype == np.int32 and got.shape == (3, max_new)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_swap_plan_takes_effect_on_the_next_call(served):
    _, model, params, jm, jparams, tokens = served
    off = OFFLOAD_PLAN.replace(compute_dtype="float32", attn_kv_chunk=8)
    server = Server(model, params, F32)
    first = server.generate({"tokens": torch.from_numpy(tokens)}, 6)
    bound = server._bound
    server.swap_plan(off)
    assert server.plan is off and server._bound is not bound
    assert bound.plan is F32                  # the old snapshot is untouched
    swapped = server.generate({"tokens": torch.from_numpy(tokens)}, 6)
    np.testing.assert_array_equal(
        swapped, Server(model, params, off).generate(
            {"tokens": torch.from_numpy(tokens)}, 6))
    jserver = JServer(jm, jparams, JF32)
    jserver.swap_plan(JOFF.replace(compute_dtype="float32", attn_kv_chunk=8))
    np.testing.assert_array_equal(
        swapped, jserver.generate({"tokens": jnp.asarray(tokens)}, 6))
    np.testing.assert_array_equal(first, swapped)     # f32: same argmax


def test_traffic_hz_and_metrics_like_the_reference(served):
    _, model, params, jm, jparams, tokens = served
    obs_metrics.reset()
    server = Server(model, params, F32)
    jserver = JServer(jm, jparams, JF32)
    assert server.traffic_hz() == jserver.traffic_hz() == 0.0
    for _ in range(3):
        server.generate({"tokens": torch.from_numpy(tokens)}, 1)
        jserver.generate({"tokens": jnp.asarray(tokens)}, 1)
    assert server.traffic_hz() == pytest.approx(3 / 60.0)
    assert server.traffic_hz() == jserver.traffic_hz()
    assert server.traffic_hz(window_s=0) == 0.0
    snap = obs_metrics.snapshot()
    text = str(snap)
    assert "serve.generate_seconds" in text and "serve.traffic_hz" in text


def test_temperature_sampling_is_seeded(served):
    cfg, model, params, _, _, tokens = served
    inputs = {"tokens": torch.from_numpy(tokens)}
    hot = ServeConfig(temperature=1.0, seed=3)
    a = Server(model, params, F32, hot).generate(inputs, 8)
    b = Server(model, params, F32, hot).generate(inputs, 8)
    c = Server(model, params, F32, ServeConfig(temperature=1.0,
                                               seed=4)).generate(inputs, 8)
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()
    assert ((a >= 0) & (a < cfg.vocab)).all()


def test_parameters_are_cast_once_to_the_plan_dtype(served):
    _, model, params, _, _, tokens = served
    server = Server(model, params, REFERENCE_PLAN)         # bf16 compute
    cast = server._bound.params
    assert cast is not params
    assert cast.blocks[0].wq.dtype == torch.bfloat16
    assert cast.embed.dtype == torch.bfloat16
    # norm scales stay as they are: the reference reads them in f32
    assert cast.blocks[0].ln1.weight.dtype == torch.float32
    assert params.blocks[0].wq.dtype == torch.float32       # untouched
    torch.testing.assert_close(cast.blocks[0].wq.float(),
                               params.blocks[0].wq.bfloat16().float())
    assert Server(model, params, F32)._bound.params is params  # no copy
    out = server.generate({"tokens": torch.from_numpy(tokens)}, 4)
    assert out.shape == (3, 4)


def test_vlm_generate_reserves_room_for_patches():
    cfg = get_config("llava_next_mistral_7b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = model.demo_batch(torch.Generator().manual_seed(1), 2, 24,
                             device="cpu")
    inputs = {"tokens": batch["tokens"],
              "patch_feats": batch["patch_feats"].float()}
    out = Server(model, params, F32).generate(inputs, 5)
    assert out.shape == (2, 5)
