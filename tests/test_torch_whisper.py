"""The port's enc-dec family (``repro_torch.models.whisper``) against the
reference's ``repro.models.whisper`` on the CPU, at
``whisper_small.reduced()`` (2 encoder + 2 decoder layers, d_model 64, 4
heads of 16, 16 frames), weights carried across from the reference's
``init_params`` by ``model_from_jax`` and the same numpy inputs from a
seed: the sinusoidal positions, the non-causal attention core, ``encode``,
``decoder_forward``, ``lm_loss``, ``prefill`` and ``decode_step`` in f32
under ``REFERENCE_PLAN`` and ``OFFLOAD_PLAN``.

    PYTHONPATH=src python -m pytest tests/test_torch_whisper.py -q
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import plan as jplan  # noqa: E402
from repro.models import whisper as JWH  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import OFFLOAD_PLAN, REFERENCE_PLAN, build_model  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import whisper as WH  # noqa: E402
from repro_torch.models.convert import model_from_jax  # noqa: E402

ATOL = 1e-5
F32 = REFERENCE_PLAN.replace(compute_dtype="float32")
JF32 = jplan.REFERENCE_PLAN.replace(compute_dtype="float32")
#: the small OFFLOAD_PLAN of tests/test_models_smoke.py:12-14, with a KV
#: chunk of 6: the encoder's and the cross-attention's 16 keys end in a
#: ragged chunk
SMALL = dict(attn_q_chunk=16, attn_kv_chunk=6, loss_vocab_chunk=64)
PLANS = {"reference": (F32, JF32),
         "offload": (OFFLOAD_PLAN.replace(compute_dtype="float32", **SMALL),
                     jplan.OFFLOAD_PLAN.replace(compute_dtype="float32",
                                                **SMALL))}


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=0)


@pytest.fixture(scope="module")
def whisper():
    jcfg = jget_config("whisper_small").reduced()
    cfg = get_config("whisper_small").reduced()
    jm, model = jbuild_model(jcfg), build_model(cfg)
    jparams = jm.init(jax.random.key(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    params = model_from_jax(tree, cfg, device="cpu")
    rng = np.random.default_rng(0)
    batch = {
        "tokens": rng.integers(0, cfg.vocab, size=(2, 12)).astype(np.int32),
        "labels": rng.integers(-1, cfg.vocab, size=(2, 12)).astype(np.int32),
        "frames": rng.normal(size=(2, cfg.encoder_seq, cfg.d_model))
        .astype(np.float32)}
    return cfg, jcfg, model, params, jm, jparams, tree, batch


# ---------------------------------------------------------------------------
# positions and the non-causal attention core
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,d,offset", [(16, 64, 0), (1, 64, 37),
                                        (4, 64, 13)])
def test_sinusoid_positions_match_reference(s, d, offset):
    _close(WH.sinusoid_positions(s, d, offset),
           JWH.sinusoid_positions(s, d, offset), 1e-6)
    if offset:                         # a device scalar, as decode passes
        _close(WH.sinusoid_positions(
            s, d, torch.tensor(offset, dtype=torch.int32)),
            JWH.sinusoid_positions(s, d, jnp.asarray(offset, jnp.int32)),
            1e-6)


@pytest.mark.parametrize("s,d,offset", [(1500, 768, 0), (3, 768, 448)])
def test_sinusoid_positions_at_whisper_width_match_within_an_ulp(s, d,
                                                                 offset):
    """At Whisper's 1500 frames and 448 tokens the two packages' f32
    ``exp`` of the frequencies differ by one ulp in places (XLA's in 38 of
    384 against the correctly rounded value, PyTorch's in 6).  A position
    p scales that ulp (<= 2**-24 for a frequency <= 1) to less than one
    ulp of the angle p * frequency, so the two angles round at most one
    f32 ulp of p apart: the bound here, plus the 1e-6 of the small
    cases."""
    atol = float(np.spacing(np.float32(s + offset - 1))) + 1e-6
    _close(WH.sinusoid_positions(s, d, offset),
           JWH.sinusoid_positions(s, d, offset), atol)


@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("sq", [12, 16])
def test_non_causal_attention_core_matches_reference(impl, sq):
    """``Attention(causal=False)`` with Sq != Sk (the cross-attention) and
    Sq == Sk (the encoder), against the reference's ``attend`` with
    ``causal=False``; chunked over KV chunks of 6, so the last of 16 keys'
    chunks is ragged (4 keys, 2 padded and masked)."""
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, sq, 4, 16)).astype(np.float32)
    k, v = rng.normal(size=(2, 2, 16, 2, 16)).astype(np.float32)
    plan = F32.replace(attn_impl=impl, attn_kv_chunk=6)
    jp = JF32.replace(attn_impl=impl, attn_kv_chunk=6)
    core = A.Attention(causal=False)
    assert core.causal is False and A.Attention().causal is True
    got = core(_t(q), _t(k), _t(v), plan)
    want = JA.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.arange(sq), jnp.arange(16), causal=False,
                     attn_kind="full", window=0, plan=jp)
    _close(got, want)
    causal = A.Attention()(_t(q), _t(k), _t(v), plan)
    assert (causal - got).abs().max() > 1e-3    # the mask is not ignored


# ---------------------------------------------------------------------------
# encoder, decoder, loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["reference", "offload"])
def test_encode_and_decoder_forward_match_reference(whisper, which):
    cfg, jcfg, _, params, _, jparams, _, batch = whisper
    plan, jp = PLANS[which]
    frames, tokens = batch["frames"], batch["tokens"]
    with torch.no_grad():
        enc = WH.encode(params, cfg, plan, _t(frames))
        hidden, caches = WH.decoder_forward(params, cfg, plan, _t(tokens),
                                            enc, want_cache=True,
                                            cache_capacity=20)
    jenc = JWH.encode(jparams, jcfg, jp, jnp.asarray(frames))
    jhidden, jcaches = JWH.decoder_forward(jparams, jcfg, jp,
                                           jnp.asarray(tokens), jenc,
                                           want_cache=True,
                                           cache_capacity=20)
    _close(enc, jenc)
    _close(hidden, jhidden)
    assert len(caches) == cfg.n_layers
    for i, cache in enumerate(caches):
        assert sorted(cache) == sorted(jcaches)
        for f, leaf in cache.items():
            _close(leaf, jcaches[f][i])
    with torch.no_grad():
        bare, none = WH.decoder_forward(params, cfg, plan, _t(tokens), enc)
    assert none is None
    _close(bare, jhidden)


@pytest.mark.parametrize("which", ["reference", "offload"])
def test_lm_loss_matches_reference(whisper, which):
    """Labels of -1 carry no loss."""
    _, _, model, params, jm, jparams, _, batch = whisper
    plan, jp = PLANS[which]
    with torch.no_grad():
        loss, metrics = model.loss(params, {k: _t(v) for k, v in
                                            batch.items()}, plan)
    jloss, jmetrics = jm.loss(jparams, {k: jnp.asarray(v) for k, v in
                                        batch.items()}, jp)
    assert sorted(metrics) == sorted(jmetrics) == ["ce", "loss"]
    _close(loss, jloss)
    assert metrics["loss"] is loss


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["reference", "offload"])
def test_prefill_and_three_decode_steps_match_reference(whisper, which):
    """Last-token logits and every state leaf (``k``, ``v``, ``xk``,
    ``xv``, ``cache_len``) after a prefill of 12 tokens into a cache of 16
    and after each of 3 decode steps; the self caches are written in
    place, the cross caches never change."""
    _, _, model, params, jm, jparams, _, batch = whisper
    plan, jp = PLANS[which]
    inputs = {k: batch[k] for k in ("tokens", "frames")}
    with torch.no_grad():
        logits, state = model.prefill(params, {k: _t(v) for k, v in
                                               inputs.items()}, plan,
                                      cache_capacity=16)
    jlogits, jstate = jm.prefill(jparams, {k: jnp.asarray(v) for k, v in
                                           inputs.items()}, jp,
                                 cache_capacity=16)

    def check(logits, state, jlogits, jstate):
        _close(logits, jlogits, 1e-4)
        assert sorted(state) == sorted(jstate) == ["cache_len", "dec"]
        assert state["cache_len"].dtype == torch.int32
        assert int(state["cache_len"]) == int(jstate["cache_len"])
        for i, kv in enumerate(state["dec"]):
            for f in ("k", "v", "xk", "xv"):
                _close(kv[f], jstate["dec"][f][i], 1e-4)

    check(logits, state, jlogits, jstate)
    leaves = [dict(kv) for kv in state["dec"]]
    xk0 = [kv["xk"].clone() for kv in state["dec"]]
    for step in range(3):
        tok = batch["tokens"][:, step:step + 1]
        with torch.no_grad():
            logits, state = model.decode(params, _t(tok), state, plan)
        jlogits, jstate = jm.decode(jparams, jnp.asarray(tok), jstate, jp)
        check(logits, state, jlogits, jstate)
    for kv, before, x0 in zip(state["dec"], leaves, xk0, strict=True):
        assert all(kv[f] is before[f] for f in kv)
        assert torch.equal(kv["xk"], x0)


def test_decode_matches_the_full_forward(whisper):
    """Prefill S tokens and decode one more, against a prefill of all S +
    1, in f32."""
    _, _, model, params, _, _, _, batch = whisper
    toks, frames = _t(batch["tokens"]), _t(batch["frames"])
    with torch.no_grad():
        _, state = model.prefill(params, {"tokens": toks[:, :-1],
                                          "frames": frames}, F32,
                                 cache_capacity=toks.shape[1])
        step, state = model.decode(params, toks[:, -1:], state, F32)
        full, _ = model.prefill(params, {"tokens": toks, "frames": frames},
                                F32)
    torch.testing.assert_close(step, full, atol=1e-5, rtol=0)
    assert int(state["cache_len"]) == toks.shape[1]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def test_init_lays_out_the_reference_tree_and_draws_its_distributions():
    """Every reference leaf has its counterpart of the same size, and the
    draws: embed N(0, 0.02), projections truncated normals / sqrt(fan_in),
    norm scales zero."""
    import dataclasses

    jcfg = jget_config("whisper_small").reduced()
    cfg = dataclasses.replace(get_config("whisper_small").reduced(),
                              d_model=256, d_ff=512, vocab=4096)
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device="cpu").requires_grad_(False)
    jtree = jbuild_model(dataclasses.replace(
        jcfg, d_model=256, d_ff=512, vocab=4096)).param_shapes()
    n_ref = sum(int(np.prod(x.shape))
                for x in jax.tree_util.tree_leaves(jtree))
    assert sum(p.numel() for p in params.parameters()) == n_ref
    assert float(params.embed.std()) == pytest.approx(0.02, rel=0.05)
    for w in (params.enc_blocks[0].wq, params.blocks[1].xattn.wk):
        w = w * np.sqrt(cfg.d_model)
        assert float(w.abs().max()) <= 2.0
        assert float(w.std()) == pytest.approx(0.88, rel=0.05)
    for norm in (params.final_norm, params.enc_final_norm,
                 params.blocks[0].ln_x, params.enc_blocks[1].ln2):
        assert not norm.weight.any()
    assert params.enc_blocks[0].attn.causal is False
    assert params.blocks[0].attn.causal is True
    assert params.blocks[0].cross.causal is False


def test_model_from_jax_rejects_bad_trees(whisper):
    cfg, _, _, _, _, _, tree, _ = whisper
    model_from_jax(tree, cfg, device="cpu")
    missing = {k: v for k, v in tree.items() if k != "enc_final_norm"}
    extra = dict(tree, lm_head=tree["embed"])
    no_ln_x = dict(tree, blocks={k: v for k, v in tree["blocks"].items()
                                 if k != "ln_x"})
    xattn = dict(tree["blocks"]["xattn"])
    xattn["wq"] = xattn["wq"][..., :8]
    bad = dict(tree, blocks=dict(tree["blocks"], xattn=xattn))
    short = dict(tree, enc_blocks=jax.tree_util.tree_map(
        lambda a: a[:1], tree["enc_blocks"]))
    for t, match in ((missing, "differ"), (extra, "differ"),
                     (no_ln_x, "differ"), (bad, "shape"),
                     (short, "enc_blocks: stacked")):
        with pytest.raises(ValueError, match=match):
            model_from_jax(t, cfg, device="cpu")
    no_mlp = dict(tree, enc_blocks={k: v for k, v in
                                    tree["enc_blocks"].items() if k != "mlp"})
    with pytest.raises(KeyError, match="mlp"):
        model_from_jax(no_mlp, cfg, device="cpu")


def test_lm_params_refuse_the_enc_dec_family():
    """The decoder-only parameters never stand in for an enc-dec model,
    and ``WhisperParams`` holds only that family."""
    from repro_torch.models.transformer import LMParams

    with pytest.raises(ValueError, match="WhisperParams"):
        LMParams(get_config("whisper_small").reduced(), device="cpu")
    with pytest.raises(ValueError, match="enc-dec family"):
        WH.WhisperParams(get_config("qwen3_0_6b").reduced(), device="cpu")
