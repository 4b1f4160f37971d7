"""The port's model zoo against the JAX reference on the CPU: configs, the
ExecPlan ABI, each layer and attention function, and the dense, VLM, MoE,
hybrid and SSM decoders and the enc-dec model (loss, prefill, decode) at
reduced widths in f32
(and under the bf16 ``REFERENCE_PLAN``), weights carried across from the
reference's ``init_params`` by ``model_from_jax``."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import plan as jplan  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.models import OFFLOAD_PLAN, REFERENCE_PLAN, build_model  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import plan as tplan  # noqa: E402
from repro_torch.models.convert import (dense_block_from_jax,  # noqa: E402
                                        model_from_jax)

F32 = REFERENCE_PLAN.replace(compute_dtype="float32")
JF32 = jplan.REFERENCE_PLAN.replace(compute_dtype="float32")
#: the small OFFLOAD_PLAN of tests/test_models_smoke.py:12-14
SMALL = dict(attn_q_chunk=16, attn_kv_chunk=16, rglru_chunk=16,
             wkv_chunk=16, loss_vocab_chunk=64)
PLANS = {"reference": (F32, JF32),
         "offload": (OFFLOAD_PLAN.replace(compute_dtype="float32", **SMALL),
                     jplan.OFFLOAD_PLAN.replace(compute_dtype="float32",
                                                **SMALL))}
#: ``arch@n`` is ``arch`` reduced to ``n`` layers: RecurrentGemma at 5 has
#: two pre-blocks before its macro block, its ``reduced()`` 3 has none
PORTED = ["qwen3_0_6b", "tinyllama_1_1b", "qwen1_5_4b", "gemma_7b",
          "llava_next_mistral_7b", "recurrentgemma_2b",
          "recurrentgemma_2b@5", "olmoe_1b_7b", "llama4_scout_17b_a16e",
          "rwkv6_3b", "whisper_small"]
ATOL = 1e-5
#: the reference's bf16 tolerance (``tests/test_kernels.py``)
BF16_TOL = 2e-2


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=0)


# ---------------------------------------------------------------------------
# configs and the plan ABI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_config_reduced_and_param_count_match_reference(arch):
    ref, port = jbase.get_config(arch), tbase.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == \
        dataclasses.asdict(ref.reduced())
    for active in (False, True):
        assert port.param_count(active) == ref.param_count(active)
        assert port.reduced().param_count(active) == \
            ref.reduced().param_count(active)
    for shape in jbase.ALL_SHAPES:
        tshape = tbase.SHAPES_BY_NAME[shape.name]
        assert port.supports_shape(tshape) == ref.supports_shape(shape)
        assert port.skip_reason(tshape) == ref.skip_reason(shape)
    assert port.subquadratic == ref.subquadratic


def test_registry_aliases_and_shapes_match_reference():
    assert tbase.ARCH_IDS == jbase.ARCH_IDS
    assert tbase._ALIASES == jbase._ALIASES
    for alias, canon in jbase._ALIASES.items():
        assert tbase.get_config(alias).arch_id == canon
    assert [dataclasses.asdict(s) for s in tbase.ALL_SHAPES] == \
        [dataclasses.asdict(s) for s in jbase.ALL_SHAPES]
    assert [s.tokens for s in tbase.ALL_SHAPES] == \
        [s.tokens for s in jbase.ALL_SHAPES]
    assert sorted(tbase.all_configs()) == sorted(jbase.ARCH_IDS)
    with pytest.raises(KeyError, match="unknown arch"):
        tbase.get_config("gpt5")


def test_exec_plan_matches_reference():
    assert [(f.name, f.default) for f in dataclasses.fields(tplan.ExecPlan)] \
        == [(f.name, f.default) for f in dataclasses.fields(jplan.ExecPlan)]
    assert tplan.ExecPlan.OFFLOAD_SITES == jplan.ExecPlan.OFFLOAD_SITES
    assert tplan.ExecPlan.SITE_VARIANTS == jplan.ExecPlan.SITE_VARIANTS
    for name in ("REFERENCE_PLAN", "OFFLOAD_PLAN"):
        assert dataclasses.asdict(getattr(tplan, name)) == \
            dataclasses.asdict(getattr(jplan, name))
    assert OFFLOAD_PLAN.replace(attn_impl="naive").attn_impl == "naive"


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("impl", ["ref", "fused"])
def test_rmsnorm_matches_reference(rng, impl):
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    s = rng.normal(size=(64,)).astype(np.float32) * 0.1
    plan, jp = F32.replace(norm_impl=impl), JF32.replace(norm_impl=impl)
    _close(L.rmsnorm(_t(x), _t(s), 1e-6, plan),
           JL.rmsnorm(jnp.asarray(x), jnp.asarray(s), 1e-6, jp))


def test_layernorm_and_rope_match_reference(rng):
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    s, b = rng.normal(size=(2, 16)).astype(np.float32)
    _close(L.layernorm(_t(x), _t(s), _t(b), 1e-6),
           JL.layernorm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 1e-6))
    pos = np.arange(3, 10, dtype=np.int32)
    for theta in (10_000.0, 1_000_000.0, 0.0):
        _close(L.apply_rope(_t(x), _t(pos), theta),
               JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("impl", ["ref", "fused"])
@pytest.mark.parametrize("act", ["silu", "gelu", "relu_sq"])
def test_mlp_matches_reference(rng, impl, act):
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    p = JL.mlp_init(jax.random.key(0), 32, 48)
    plan, jp = F32.replace(mlp_impl=impl), JF32.replace(mlp_impl=impl)
    _close(L.mlp(_t(x), {k: _t(v) for k, v in p.items()}, act, plan),
           JL.mlp(jnp.asarray(x), p, act, jp))


@pytest.mark.parametrize("scale,softcap", [(False, 0.0), (True, 30.0)])
def test_embed_and_logits_match_reference(rng, scale, softcap):
    table = rng.normal(size=(40, 24)).astype(np.float32)
    tokens = rng.integers(0, 40, size=(2, 6)).astype(np.int32)
    x = L.embed_tokens(_t(tokens), _t(table), F32, scale)
    jx = JL.embed_tokens(jnp.asarray(tokens), jnp.asarray(table), JF32, scale)
    _close(x, jx)
    _close(L.logits_from_hidden(x, _t(table), F32, softcap),
           JL.logits_from_hidden(jx, jnp.asarray(table), JF32, softcap),
           atol=1e-4)


@pytest.mark.parametrize("vocab,chunk,softcap", [(100, 32, 0.0),
                                                 (96, 32, 0.0),
                                                 (100, 128, 0.0),
                                                 (100, 32, 5.0)])
def test_cross_entropy_full_and_chunked_match_reference(rng, vocab, chunk,
                                                        softcap):
    """The chunked loss with a ragged last vocab chunk (100 = 3 * 32 + 4)."""
    h = rng.normal(size=(2, 5, 16)).astype(np.float32)
    table = rng.normal(size=(vocab, 16)).astype(np.float32)
    labels = rng.integers(0, vocab, size=(2, 5)).astype(np.int32)
    plan, jp = (F32.replace(loss_vocab_chunk=chunk),
                JF32.replace(loss_vocab_chunk=chunk))
    want = JL.cross_entropy_chunked(jnp.asarray(h), jnp.asarray(table),
                                    jnp.asarray(labels), jp, softcap)
    _close(L.cross_entropy_chunked(_t(h), _t(table), _t(labels), plan,
                                   softcap), want)
    logits = JL.logits_from_hidden(jnp.asarray(h), jnp.asarray(table), jp,
                                   softcap)
    full = L.cross_entropy_full(_t(np.asarray(logits)), _t(labels))
    _close(full, JL.cross_entropy_full(logits, jnp.asarray(labels)))
    _close(full, want)


# ---------------------------------------------------------------------------
# attention functions
# ---------------------------------------------------------------------------


def _qkv(rng, b=2, s=24, hq=4, hkv=2, d=16):
    q = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    k, v = rng.normal(size=(2, b, s, hkv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("fused,bias,qk_norm", [(False, False, True),
                                                (True, False, True),
                                                (False, True, False),
                                                (True, True, False)])
def test_project_qkv_matches_reference(rng, fused, bias, qk_norm):
    cfg = dataclasses.replace(tbase.get_config("qwen3_0_6b").reduced(),
                              n_kv_heads=2, qkv_bias=bias, qk_norm=qk_norm)
    jcfg = dataclasses.replace(jbase.get_config("qwen3_0_6b").reduced(),
                               n_kv_heads=2, qkv_bias=bias, qk_norm=qk_norm)
    blk = JT._dense_block_init(jax.random.key(1), jcfg, jnp.float32)
    attn = dict(blk["attn"])
    for key in ("bq", "bk", "bv", "q_norm", "k_norm"):
        if key in attn:                     # nonzero, so they are exercised
            attn[key] = jnp.asarray(
                rng.normal(size=attn[key].shape).astype(np.float32) * 0.1)
    blk["attn"] = attn
    block = dense_block_from_jax(jax.tree_util.tree_map(np.asarray, blk),
                                 cfg, device="cpu")
    x = rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    pos = np.arange(9, dtype=np.int32)
    plan, jp = F32.replace(qkv_fused=fused), JF32.replace(qkv_fused=fused)
    with torch.no_grad():
        got = A.project_qkv(_t(x), block, cfg, plan, _t(pos))
    want = JA.project_qkv(jnp.asarray(x), attn, jcfg, jp, jnp.asarray(pos))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 7)])
@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_attend_matches_reference(rng, causal, window, impl):
    """Full attention (naive, and chunked with a ragged last KV chunk of
    24 = 16 + 8) with and without a window."""
    q, k, v = _qkv(rng)
    pos = np.arange(24, dtype=np.int32)
    plan = F32.replace(attn_impl=impl, attn_kv_chunk=16)
    jp = JF32.replace(attn_impl=impl, attn_kv_chunk=16)
    fn, jfn = {"naive": (A.attend_naive, JA.attend_naive),
               "chunked": (A.attend_chunked, JA.attend_chunked)}[impl]
    got = fn(_t(q), _t(k), _t(v), _t(pos), _t(pos), causal, window, plan)
    want = jfn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
               jnp.asarray(pos), jnp.asarray(pos), causal, window, jp)
    _close(got, want)


@pytest.mark.parametrize("s", [32, 28])
def test_local_banded_attention_and_dispatch_match_reference(rng, s):
    """Banded local attention (window 8 over 32 keys), and its ragged
    fallback (28 keys) through the ``attend`` dispatcher."""
    q, k, v = _qkv(rng, s=s)
    pos = np.arange(s, dtype=np.int32)
    got = A.attend(_t(q), _t(k), _t(v), _t(pos), _t(pos), causal=True,
                   attn_kind="local", window=8, plan=F32)
    want = JA.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(pos), jnp.asarray(pos), causal=True,
                     attn_kind="local", window=8, plan=JF32)
    _close(got, want)
    if s % 8 == 0:
        _close(A.attend_local_banded(_t(q), _t(k), _t(v), _t(pos), _t(pos),
                                     8, F32), want)


@pytest.mark.parametrize("ring,window,cache_len", [(False, 0, 5),
                                                   (False, 4, 9),
                                                   (True, 8, 5),
                                                   (True, 8, 21)])
def test_decode_attention_and_cache_update_match_reference(rng, ring, window,
                                                           cache_len):
    """One token against a linear cache (with and without a window) or a
    ring of 8 slots (before and after it wraps), written in place."""
    sc = 8 if ring else 16
    ck, cv = rng.normal(size=(2, 2, sc, 2, 16)).astype(np.float32)
    q1 = rng.normal(size=(2, 1, 4, 16)).astype(np.float32)
    k1, v1 = rng.normal(size=(2, 2, 1, 2, 16)).astype(np.float32)
    n = np.int32(cache_len)
    cache = A.KVCache(_t(ck), _t(cv))
    got_cache = A.cache_update(cache, _t(k1), _t(v1),
                               torch.tensor(cache_len, dtype=torch.int32),
                               ring)
    assert got_cache.k is cache.k             # written in place
    jcache = JA.cache_update(JA.KVCache(jnp.asarray(ck), jnp.asarray(cv)),
                             jnp.asarray(k1), jnp.asarray(v1),
                             jnp.asarray(n), ring)
    _close(got_cache.k, jcache.k)
    _close(got_cache.v, jcache.v)
    got = A.attend_decode(_t(q1), got_cache,
                          torch.tensor(cache_len + 1, dtype=torch.int32),
                          window, F32, ring)
    want = JA.attend_decode(jnp.asarray(q1), jcache, jnp.asarray(n + 1),
                            window, JF32, ring)
    _close(got, want)


def test_attention_site_keeps_q_k_v_inputs():
    """The ``Attention`` submodule takes exactly (q, k, v): what the
    registry's attention binder accepts."""
    import inspect
    params = list(inspect.signature(A.Attention.forward).parameters)
    assert params[:4] == ["self", "q", "k", "v"]


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


def _reduced(base, spec: str):
    arch, _, layers = spec.partition("@")
    cfg = base.get_config(arch).reduced()
    return dataclasses.replace(cfg, n_layers=int(layers)) if layers else cfg


@pytest.fixture(scope="module", params=PORTED)
def zoo(request):
    arch = request.param
    jcfg, cfg = _reduced(jbase, arch), _reduced(tbase, arch)
    jm, model = jbuild_model(jcfg), build_model(cfg)
    jparams = jm.init(jax.random.key(0))
    params = model_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                            device="cpu")
    batch = jm.demo_batch(jax.random.key(1), 2, 64)
    batch = {k: np.asarray(v, np.float32) if v.dtype == jnp.bfloat16
             else np.asarray(v) for k, v in batch.items()}
    return arch, cfg, model, params, jm, jparams, batch


def _state_pairs(state, jstate):
    """(name, port leaf, reference leaf stacked over layers, layer) for
    every leaf of a decode state: dense ``kv``, the hybrid ``pre_rglru``,
    ``macro_rglru`` and ``macro_kv``, the SSM ``rwkv``, or the enc-dec
    ``dec``."""
    assert sorted(state) == sorted(jstate)
    for i, kv in enumerate(state.get("dec", ())):
        assert sorted(kv) == sorted(jstate["dec"])
        for f in ("k", "v", "xk", "xv"):
            yield f"dec.{f}{i}", kv[f], jstate["dec"][f], i
    for i, st in enumerate(state.get("rwkv", ())):
        for f in ("wkv", "shift_tm", "shift_cm"):
            yield f"rwkv.{f}{i}", getattr(st, f), jstate["rwkv"][f], i
    for i, kv in enumerate(state.get("kv", ())):
        for f in ("k", "v"):
            yield f"kv.{f}{i}", getattr(kv, f), jstate["kv"][f], i
    for i, st in enumerate(state.get("pre_rglru", ())):
        for f in ("h", "conv"):
            yield f"pre_rglru.{f}{i}", getattr(st, f), \
                jstate["pre_rglru"][f], i
    for i, rg in enumerate(state.get("macro_rglru", ())):
        assert sorted(rg) == sorted(jstate["macro_rglru"])
        for name, st in rg.items():
            for f in ("h", "conv"):
                yield f"{name}.{f}{i}", getattr(st, f), \
                    jstate["macro_rglru"][name][f], i
    for i, kv in enumerate(state.get("macro_kv", ())):
        for f in ("k", "v"):
            yield f"macro_kv.{f}{i}", getattr(kv, f), \
                jstate["macro_kv"][f], i


def _leaves_per_layer(cfg) -> int:
    """(k, v), (h, conv), an SSM layer's (wkv, shift_tm, shift_cm), or an
    enc-dec layer's (k, v, xk, xv)."""
    return {"ssm": 3, "encdec": 4}.get(cfg.family, 2)


def _in_place_caches(state) -> list:
    """The key caches a decode step writes in place (none for SSM)."""
    return [kv.k for kv in state.get("kv") or state.get("macro_kv") or ()] \
        + [kv["k"] for kv in state.get("dec", ())]


def _tb(batch, drop=()):
    return {k: _t(v) for k, v in batch.items() if k not in drop}


def _jb(batch, drop=()):
    return {k: jnp.asarray(v) for k, v in batch.items() if k not in drop}


@pytest.mark.parametrize("which", ["reference", "offload"])
def test_loss_matches_reference(zoo, which):
    _, cfg, model, params, jm, jparams, batch = zoo
    plan, jp = PLANS[which]
    with torch.no_grad():
        loss, metrics = model.loss(params, _tb(batch), plan)
    jloss, jmetrics = jm.loss(jparams, _jb(batch), jp)
    assert abs(float(loss) - float(jloss)) < 1e-4
    assert sorted(metrics) == sorted(jmetrics)
    assert metrics["loss"] is loss
    for key in ("ce", "moe_lb", "moe_z"):     # MoE: the auxiliary losses
        if key in jmetrics:
            assert abs(float(metrics[key]) - float(jmetrics[key])) < 1e-4
    if cfg.moe is None:
        assert float(metrics["ce"]) == float(loss)


@pytest.mark.parametrize("which", ["reference", "offload"])
def test_prefill_and_decode_match_reference(zoo, which):
    """Last-token logits and every state leaf after a prefill of 64 tokens
    and three decode steps (a hybrid model's window is 32: the prefill
    takes the banded local attention, decode wraps the ring)."""
    _, cfg, model, params, jm, jparams, batch = zoo
    plan, jp = PLANS[which]
    cap = 70
    with torch.no_grad():
        logits, state = model.prefill(params, _tb(batch, ("labels",)), plan,
                                      cache_capacity=cap)
    jlogits, jstate = jm.prefill(jparams, _jb(batch, ("labels",)), jp,
                                 cache_capacity=cap)
    _close(logits, jlogits, 1e-4)
    assert int(state["cache_len"]) == int(jstate["cache_len"])
    assert state["cache_len"].dtype == torch.int32
    pairs = list(_state_pairs(state, jstate))
    assert len(pairs) == _leaves_per_layer(cfg) * cfg.n_layers
    for _, got, want, i in pairs:
        _close(got, want[i], 1e-4)
    caches = _in_place_caches(state)
    for step in range(3):
        tok = batch["tokens"][:, step:step + 1]
        jlogits, jstate = jm.decode(jparams, jnp.asarray(tok), jstate, jp)
        with torch.no_grad():
            logits, state = model.decode(params, _t(tok), state, plan)
        _close(logits, jlogits, 1e-4)
        assert int(state["cache_len"]) == int(jstate["cache_len"])
        for _, got, want, i in _state_pairs(state, jstate):
            _close(got, want[i], 1e-4)
    # the KV caches are updated in place
    assert all(a is b for a, b in zip(_in_place_caches(state), caches,
                                      strict=True))


@pytest.mark.parametrize("which", ["loss", "prefill"])
def test_bf16_reference_plan_matches_reference(zoo, which):
    """The bf16 ``REFERENCE_PLAN`` (the default compute dtype) against the
    reference's, on the same f32 weights, at the reference's bf16
    tolerance."""
    _, _, model, params, jm, jparams, batch = zoo
    plan, jp = REFERENCE_PLAN, jplan.REFERENCE_PLAN
    with torch.no_grad():
        if which == "loss":
            got = model.loss(params, _tb(batch), plan)[0]
        else:
            got = model.prefill(params, _tb(batch, ("labels",)), plan)[0]
    want = jm.loss(jparams, _jb(batch), jp)[0] if which == "loss" else \
        jm.prefill(jparams, _jb(batch, ("labels",)), jp)[0]
    _close(got.float(), np.asarray(want, np.float32), BF16_TOL)


def test_decode_matches_full_forward(zoo):
    """tests/test_models_smoke.py:68-84: prefill S tokens, decode the last
    one, against a prefill of all S + 1."""
    _, cfg, model, params, jm, _, _ = zoo
    gen = torch.Generator().manual_seed(2)
    batch = model.demo_batch(gen, 2, 33 + 1 + (cfg.vision_patches or 0),
                             device="cpu")
    inputs = {k: v.float() if v.is_floating_point() else v
              for k, v in batch.items() if k != "labels"}
    toks = inputs["tokens"]
    short = dict(inputs, tokens=toks[:, :-1])
    cap = toks.shape[1] + (cfg.vision_patches or 0) + 4
    with torch.no_grad():
        _, state = model.prefill(params, short, REFERENCE_PLAN,
                                 cache_capacity=cap)
        lg_step, state2 = model.decode(params, toks[:, -1:], state,
                                       REFERENCE_PLAN)
        lg_full, _ = model.prefill(params, inputs, REFERENCE_PLAN)
    d = (lg_step.float() - lg_full.float()).abs().max().item()
    assert d < 2e-2
    assert int(state2["cache_len"]) == int(state["cache_len"]) + 1


def test_input_and_state_specs_match_reference(zoo):
    _, cfg, model, _, jm, _, _ = zoo
    for kind in ("train", "prefill", "decode"):
        specs = model.input_specs(ShapeSpec("c", 64, 2, kind))
        jspecs = jm.input_specs(jbase.ShapeSpec("c", 64, 2, kind))
        if kind == "decode":
            state, jstate = specs["state"], jspecs["state"]
            assert tuple(specs["token"].shape) == jspecs["token"].shape
            pairs = list(_state_pairs(state, jstate))
            assert len(pairs) == _leaves_per_layer(cfg) * cfg.n_layers
            for name, got, want, _ in pairs:
                assert got.device.type == "meta"
                assert tuple(got.shape) == want.shape[1:], name
                assert str(got.dtype)[6:] == str(want.dtype), name
            assert state["cache_len"].dtype == torch.int32
            continue
        assert sorted(specs) == sorted(jspecs)
        for key, spec in specs.items():
            assert spec.device.type == "meta"
            assert tuple(spec.shape) == jspecs[key].shape
            assert str(spec.dtype)[6:] == str(jspecs[key].dtype)


def test_init_draws_the_reference_distributions():
    cfg = dataclasses.replace(tbase.get_config("qwen1_5_4b").reduced(),
                              d_model=256, d_ff=512, vocab=4096)
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device="cpu").requires_grad_(False)
    blk = params.blocks[0]
    assert float(params.embed.std()) == pytest.approx(0.02, rel=0.05)
    wq = blk.wq * np.sqrt(cfg.d_model)          # truncated N(0,1) at +-2
    assert float(wq.abs().max()) <= 2.0
    assert float(wq.std()) == pytest.approx(0.88, rel=0.05)
    for zero in (blk.bq, blk.bk, blk.bv, blk.ln1.weight,
                 params.final_norm.weight):
        assert not zero.any()
    assert params.lm_head is not None and params.projector is None
    n = sum(p.numel() for p in params.parameters())
    assert n == cfg.param_count() + 2 * cfg.d_model * cfg.n_layers + \
        cfg.d_model                          # + norm scales, uncounted there


def test_model_from_jax_rejects_bad_trees():
    jcfg = jbase.get_config("qwen3_0_6b").reduced()
    cfg = tbase.get_config("qwen3_0_6b").reduced()
    tree = jax.tree_util.tree_map(
        np.asarray, jbuild_model(jcfg).init(jax.random.key(0)))
    model_from_jax(tree, cfg, device="cpu")
    missing = dict(tree)
    del missing["final_norm"]
    extra = dict(tree, lm_head=tree["embed"])
    bad = dict(tree, embed=tree["embed"][:, :8])
    short = dict(tree, blocks=jax.tree_util.tree_map(lambda a: a[:1],
                                                     tree["blocks"]))
    for t, match in ((missing, "differ"), (extra, "differ"),
                     (bad, "shape"), (short, "layers")):
        with pytest.raises(ValueError, match=match):
            model_from_jax(t, cfg, device="cpu")


@pytest.mark.parametrize("arch,sub,leaf", [
    ("olmoe_1b_7b", "moe", "w_router"), ("olmoe_1b_7b", "moe", "w_gate"),
    ("llama4_scout_17b_a16e", "moe", "shared"), ("rwkv6_3b", "tm_cm", "u")])
def test_model_from_jax_rejects_bad_moe_and_rwkv_trees(arch, sub, leaf):
    """A MoE or RWKV block leaf missing, an extra one, or one misshapen."""
    jcfg, cfg = jbase.get_config(arch).reduced(), \
        tbase.get_config(arch).reduced()
    tree = jax.tree_util.tree_map(
        np.asarray, jbuild_model(jcfg).init(jax.random.key(0)))
    model_from_jax(tree, cfg, device="cpu")

    def blocks_with(**kw):
        inner = {k: v for k, v in tree["blocks"][sub].items() if k != leaf}
        inner.update(kw)
        return dict(tree, blocks=dict(tree["blocks"], **{sub: inner}))

    w = tree["blocks"][sub][leaf]
    bad = jax.tree_util.tree_map(lambda a: a[..., :3], w)
    for t, match in ((blocks_with(), "differ"),
                     (blocks_with(**{leaf: w, "extra": w}), "differ"),
                     (blocks_with(**{leaf: bad}), "shape")):
        with pytest.raises(ValueError, match=match):
            model_from_jax(t, cfg, device="cpu")
    if arch == "rwkv6_3b":
        with pytest.raises(ValueError, match="differ"):
            model_from_jax({k: v for k, v in tree.items()
                            if k != "embed_norm_b"}, cfg, device="cpu")


def test_model_entry_points_run_on_cuda_unless_cpu_is_asked_for():
    cfg = tbase.get_config("qwen3_0_6b").reduced()
    model = build_model(cfg)
    if torch.cuda.is_available():
        assert model.init().embed.device.type == "cuda"
        return
    for call in (model.init,
                 lambda: model.demo_batch(torch.Generator(), 1, 4),
                 lambda: model_from_jax({}, cfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.mark.parametrize("s", [20, 6])
def test_local_attention_model_ring_cache_matches_reference(s):
    """A dense trunk with local attention (window 8): prefill past the
    window (a rolled ring cache) and short of it (padded to the window),
    then one decode step into the ring, against the reference."""
    def local(cfg):
        return dataclasses.replace(cfg.reduced(), attn_kind="local",
                                   local_window=8)

    jcfg, cfg = local(jbase.get_config("qwen3_0_6b")), \
        local(tbase.get_config("qwen3_0_6b"))
    jm, model = jbuild_model(jcfg), build_model(cfg)
    jparams = jm.init(jax.random.key(0))
    params = model_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                            device="cpu")
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab, size=(2, s)).astype(np.int32)
    jlogits, jstate = jm.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                                 JF32)
    with torch.no_grad():
        logits, state = model.prefill(params, {"tokens": _t(tokens)}, F32)
    _close(logits, jlogits, 1e-4)
    for i, kv in enumerate(state["kv"]):
        assert kv.k.shape[1] == 8
        _close(kv.k, jstate["kv"]["k"][i], 1e-4)
    tok = tokens[:, :1]
    jlogits2, jstate2 = jm.decode(jparams, jnp.asarray(tok), jstate, JF32)
    with torch.no_grad():
        logits2, state2 = model.decode(params, _t(tok), state, F32)
    _close(logits2, jlogits2, 1e-4)
    for i, kv in enumerate(state2["kv"]):
        _close(kv.v, jstate2["kv"]["v"][i], 1e-4)
