"""Five zoo configs held to the JAX reference on the CPU, at small widths
that keep what makes each distinct, every leaf the reference initialises
to zero drawn nonzero (the QKV biases, the projector's biases, the norm
scales), weights carried across by ``model_from_jax``:

* L, LLaVA-NeXT-Mistral-7B: a VLM, 16 patches of width 32 before the
  text, GQA with a group of 4;
* B, Qwen1.5-4B: QKV bias, MHA;
* A, Llama-4 Scout: 10 query heads over 2 KV heads (a group of 5, which
  ``reduced()`` loses), top-1 routing, one shared expert, a capacity that
  drops tokens;
* G, Gemma-7B: d_model 48 under 4 heads of 16 (a query width of 64 that
  differs from d_model, as Gemma's 4096 differs from its 3072), GeGLU, a
  tied embedding scaled by sqrt(d_model);
* N, TinyLlama-1.1B: 8 query heads over 1 KV head (a group of 8, which
  ``reduced()`` loses), an untied head.

Each is checked for (a) the prefill's logits and every state leaf, (b) the
export frontend's sites, (c) the forced all-kernel substituted program
(the wrappers take their plain versions on the CPU) against the
reference's forward, and (d) ``Server.generate``'s greedy tokens against
the reference's ``Server``, patch features included.  Apart from the
fixture, the scaled embedding in bf16 is held to the reference's bit for
bit at d 48 and at Gemma's 3072, where sqrt(d) is not a bf16 value.  Run:

    PYTHONPATH=src python -m pytest tests/test_torch_zoo_paths.py -q
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import plan as jplan  # noqa: E402
from repro.runtime.serve import Server as JServer  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core.offload import OffloadConfig, Offloader  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import OFFLOAD_PLAN, REFERENCE_PLAN, build_model  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.convert import model_from_jax  # noqa: E402
from repro_torch.models.moe import Router  # noqa: E402
from repro_torch.runtime.serve import Server  # noqa: E402

#: ``tests/test_torch_models.py``'s small offload plan and tolerance
SMALL = dict(attn_q_chunk=16, attn_kv_chunk=16, rglru_chunk=16,
             wkv_chunk=16, loss_vocab_chunk=64)
TOL = 1e-4
#: each path's plan, f32: the reference plan, and for A the production
#: MoE (capacity-limited dispatch), as ``chip_smoke.py`` plans them
PATH_PLAN = {"L": {}, "B": {}, "A": {"moe_impl": "scatter_ep"}, "G": {},
             "N": {}}
PLANS = {"reference": (REFERENCE_PLAN, jplan.REFERENCE_PLAN),
         "offload": (OFFLOAD_PLAN.replace(**SMALL),
                     jplan.OFFLOAD_PLAN.replace(**SMALL))}
#: text tokens of a prompt (a VLM's patches come before them)
TEXT = 24


def _small(base, label: str):
    """Path ``label``'s config at small widths."""
    if label == "L":
        cfg = base.get_config("llava_next_mistral_7b").reduced()
        return dataclasses.replace(cfg, n_heads=8, n_kv_heads=2,
                                   vision_patches=16, vision_dim=32)
    if label == "B":
        return base.get_config("qwen1_5_4b").reduced()
    if label == "G":
        return dataclasses.replace(base.get_config("gemma_7b").reduced(),
                                   d_model=48)
    if label == "N":
        return dataclasses.replace(
            base.get_config("tinyllama_1_1b").reduced(), n_heads=8,
            n_kv_heads=1)
    cfg = base.get_config("llama4_scout_17b_a16e").reduced()
    return dataclasses.replace(cfg, n_heads=10, n_kv_heads=2,
                               moe=dataclasses.replace(cfg.moe,
                                                       capacity_factor=0.5))


def _nonzero(tree, seed: int):
    """Every all-zero leaf of the reference's parameter tree redrawn
    N(0, 0.1); the others as they are.  Returns the paths redrawn."""
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    redrawn, out = [], []
    for path, x in flat:
        x = np.asarray(x)
        if x.dtype.kind == "f" and not x.any():
            redrawn.append(jax.tree_util.keystr(path))
            x = (rng.normal(size=x.shape) * 0.1).astype(x.dtype)
        out.append(x)
    return jax.tree_util.tree_unflatten(treedef, out), redrawn


@pytest.fixture(scope="module", params=["L", "B", "A", "G", "N"])
def zoo(request):
    label = request.param
    jcfg, cfg = _small(jbase, label), _small(tbase, label)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jm, model = jbuild_model(jcfg), build_model(cfg)
    tree, redrawn = _nonzero(jm.init(jax.random.key(0)), 7)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    params = model_from_jax(tree, cfg, device="cpu")
    batch = jm.demo_batch(jax.random.key(1), 2,
                          TEXT + (cfg.vision_patches or 0))
    inputs = {k: np.asarray(v, np.float32) if v.dtype == jnp.bfloat16
              else np.asarray(v) for k, v in batch.items() if k != "labels"}
    return label, cfg, model, params, jm, jparams, inputs, redrawn


def _t(inputs: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in inputs.items()}


def _j(inputs: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in inputs.items()}


def _close(got, want) -> None:
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=TOL,
                               rtol=0)


def _kv_pairs(state, jstate):
    """(port leaf, reference leaf) for every KV-cache leaf and the cache
    length."""
    assert sorted(state) == sorted(jstate) == ["cache_len", "kv"]
    for i, kv in enumerate(state["kv"]):
        yield kv.k, jstate["kv"]["k"][i]
        yield kv.v, jstate["kv"]["v"][i]
    yield state["cache_len"], jstate["cache_len"]


def test_zero_initialised_leaves_are_drawn_nonzero(zoo):
    """The leaves the reference starts at zero are the ones each config
    makes distinct (and every norm scale): all redrawn, none left zero in
    the port's parameters.  G's head is the tied table: no ``lm_head``."""
    label, cfg, _, params, _, _, _, redrawn = zoo
    names = {r.split("'")[-2] for r in redrawn}
    want = {"ln1", "ln2", "final_norm"}
    want |= {"bq", "bk", "bv"} if label == "B" else set()
    want |= {"vis_b1", "vis_b2"} if label == "L" else set()
    assert want <= names, (want, names)
    assert all(p.detach().abs().sum() > 0 for p in params.parameters())
    assert (params.lm_head is None) == cfg.tie_embeddings == (label == "G")


@pytest.mark.parametrize("d", [48, 3072])
def test_scaled_embedding_in_bf16_equals_the_reference_bit_for_bit(d):
    """``embed_tokens`` in bf16 with Gemma's scale: the lookup cast to
    bf16, times sqrt(d) rounded to bf16 first (at d 48 6.9375 for
    6.9282, at 3072 55.5 for 55.4256), bit for bit as the reference
    computes it.  The unrounded f32 scale gives other values here."""
    rng = np.random.default_rng(d)
    table = rng.normal(size=(16, d)).astype(np.float32)
    tokens = rng.integers(0, 16, size=(2, 24)).astype(np.int32)
    plan = REFERENCE_PLAN.replace(compute_dtype="bfloat16")
    got = layers.embed_tokens(torch.from_numpy(tokens),
                              torch.from_numpy(table), plan, True)
    want = jlayers.embed_tokens(
        jnp.asarray(tokens), jnp.asarray(table),
        jplan.REFERENCE_PLAN.replace(compute_dtype="bfloat16"), True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    looked = torch.from_numpy(table)[torch.from_numpy(tokens).long()]
    unrounded = (looked.to(torch.bfloat16) * np.sqrt(d)).float().numpy()
    assert (unrounded != np.asarray(want, np.float32)).any()


@pytest.mark.parametrize("which", ["reference", "offload"])
def test_prefill_matches_the_reference(zoo, which):
    """(a) Last-token logits and every KV-cache leaf of the prefill (a
    VLM's 16 patch positions included) against the reference's, under
    the path's f32 plan."""
    label, cfg, model, params, jm, jparams, inputs, _ = zoo
    plan, jp = PLANS[which]
    over = dict(compute_dtype="float32", **PATH_PLAN[label])
    plan, jp = plan.replace(**over), jp.replace(**over)
    with torch.no_grad():
        logits, state = model.prefill(params, _t(inputs), plan,
                                      cache_capacity=40 + TEXT)
    jlogits, jstate = jm.prefill(jparams, _j(inputs), jp,
                                 cache_capacity=40 + TEXT)
    _close(logits, jlogits)
    pairs = list(_kv_pairs(state, jstate))
    assert len(pairs) == 2 * cfg.n_layers + 1
    assert int(state["cache_len"]) == TEXT + (cfg.vision_patches or 0)
    for got, want in pairs:
        _close(got, want)


def test_top1_capacity_drops_tokens_and_a_shared_expert_is_kept():
    """A's router sends every token to one expert, and at capacity factor
    0.5 some expert gets more tokens than its slots (a dropped token keeps
    the shared expert's update), in every layer."""
    cfg = _small(tbase, "A")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    inputs = {"tokens": torch.randint(0, cfg.vocab, (2, TEXT),
                                      generator=torch.Generator()
                                      .manual_seed(1))}
    picks = []
    hooks = [m.register_forward_hook(lambda m, a, out: picks.append(out[1]))
             for m in params.modules() if isinstance(m, Router)]
    plan = REFERENCE_PLAN.replace(compute_dtype="float32",
                                  moe_impl="scatter_ep")
    with torch.no_grad():
        model.prefill(params, inputs, plan)
    for h in hooks:
        h.remove()
    assert len(picks) == cfg.n_layers
    t = inputs["tokens"].numel()
    cap = int(max(1, t * cfg.moe.top_k / cfg.moe.n_experts
                  * cfg.moe.capacity_factor))
    for idx in picks:
        assert idx.shape == (t, 1)
        assert int(torch.bincount(idx.flatten(),
                                  minlength=cfg.moe.n_experts).max()) > cap
    assert cfg.moe.top_k == 1 and cfg.moe.n_shared_experts == 1
    assert all(blk.moe.shared is not None for blk in params.blocks)


def _prepare(zoo):
    label, cfg, model, params, _, _, inputs, _ = zoo
    plan = REFERENCE_PLAN.replace(compute_dtype="float32", **PATH_PLAN[label])
    keys = list(inputs)
    args = tuple(_t(inputs)[k] for k in keys)
    ctx = Offloader(OffloadConfig(device="cpu", options={
        "example_args": args})).prepare(
            lambda *xs: model.prefill(params, dict(zip(keys, xs)), plan))
    return ctx, args


def test_export_frontend_finds_an_attention_and_two_norms_a_layer(zoo):
    """(b) One attention site and two RMSNorm sites a layer and the final
    norm (no q/k norms in these configs); the projector, the router, the
    experts and the shared expert match nothing."""
    _, cfg, _, _, _, _, _, _ = zoo
    ctx, _ = _prepare(zoo)
    matched = {}
    for s in ctx.coding.sites:
        r = ctx.graph.by_name(s.region)
        if r.meta.get("pattern"):
            matched[r.meta["module"]] = r.meta["pattern"]
    want = {"params.final_norm": "rmsnorm"}
    for i in range(cfg.n_layers):
        want.update({f"params.blocks.{i}.attn": "softmax_attention",
                     f"params.blocks.{i}.ln1": "rmsnorm",
                     f"params.blocks.{i}.ln2": "rmsnorm"})
    assert matched == want
    assert not any(r.meta.get("pattern") and any(
        k in r.meta.get("module", "") for k in (".moe", "projector"))
        for r in ctx.graph.regions)


def test_forced_all_kernel_program_matches_the_reference_forward(zoo):
    """(c) Every matched site on ``cuda``: all bind, no kernel launches on
    the CPU, and the substituted program's logits and caches match the
    reference's prefill."""
    label, cfg, _, _, jm, jparams, inputs, _ = zoo
    ctx, args = _prepare(zoo)
    engine = ctx.bundle.context["engine"]
    bits = tuple(2 if ctx.graph.by_name(s.region).meta.get("pattern") else 0
                 for s in ctx.coding.sites)
    sub = engine.substitute(ctx.coding.decode(bits))
    chosen = sorted((c.pattern, c.chosen) for c in sub.report.choices
                    if c.pattern)
    assert chosen == sorted([("rmsnorm", "cuda")] * (2 * cfg.n_layers + 1)
                            + [("softmax_attention", "cuda")] * cfg.n_layers)
    ops.reset_launch_counts()
    logits, state = sub(*args)
    assert sum(ops.launch_counts().values()) == 0
    jp = jplan.REFERENCE_PLAN.replace(compute_dtype="float32",
                                      **PATH_PLAN[label])
    jlogits, jstate = jm.prefill(jparams, _j(inputs), jp)
    _close(logits, jlogits)
    for got, want in _kv_pairs(state, jstate):
        _close(got, want)


@pytest.mark.parametrize("max_new", [1, 6])
def test_server_tokens_equal_the_reference_server(zoo, max_new):
    """(d) Greedy tokens of ``Server.generate`` (a VLM's prompts with their
    patch features) against the reference ``Server``'s, under the path's
    f32 plan."""
    label, _, model, params, jm, jparams, inputs, _ = zoo
    plan = REFERENCE_PLAN.replace(compute_dtype="float32", **PATH_PLAN[label])
    jp = jplan.REFERENCE_PLAN.replace(compute_dtype="float32",
                                      **PATH_PLAN[label])
    want = JServer(jm, jparams, jp).generate(_j(inputs), max_new)
    got = Server(model, params, plan).generate(_t(inputs), max_new)
    assert got.shape == (2, max_new)
    np.testing.assert_array_equal(got, np.asarray(want))
