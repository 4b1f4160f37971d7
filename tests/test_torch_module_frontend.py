"""The port's module frontend against the reference's on the CPU: region
graphs for all ten architectures, chromosome decoding, and the static-cost
search (same GA history and best chromosome from the same seed); plus the
export frontend over a whole reduced model's prefill, however the target
holds its modules (a lambda, a ``functools.partial``, a bound method), and
over the MoE (OLMoE), SSM (RWKV-6) and enc-dec (Whisper) prefills."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import functools  # noqa: E402

import numpy as np  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.frontends import module_frontend as jmf  # noqa: E402
from repro.core.ga import GAConfig as JGAConfig  # noqa: E402
from repro.core.genes import coding_from_graph as jcoding_from_graph  # noqa: E402
from repro.core.offload import OffloadConfig as JOffloadConfig  # noqa: E402
from repro.core.offload import Offloader as JOffloader  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.frontends import module_frontend as mf  # noqa: E402
from repro_torch.core.frontends.export_frontend import (  # noqa: E402
    annotate_variants, build_graph, target_modules)
from repro_torch.core.frontends.registry import detect_frontend  # noqa: E402
from repro_torch.core.ga import GAConfig  # noqa: E402
from repro_torch.core.genes import VARIANT_ALPHABET, coding_from_graph  # noqa: E402
from repro_torch.core.offload import OffloadConfig, Offloader  # noqa: E402
from repro_torch.core.pattern_db import default_db  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import REFERENCE_PLAN, build_model  # noqa: E402

F32 = REFERENCE_PLAN.replace(compute_dtype="float32")
#: a global module that a method reading ``self.p`` must not pick up (on
#: the meta device, so a device check that saw it would refuse the plan)
p = torch.nn.Linear(2, 2, device="meta")


def _region(r):
    return (r.name, r.kind, r.defs, r.uses, r.callees, r.offloadable,
            r.alternatives, r.meta)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_build_graph_matches_reference(arch):
    got, want = mf.build_graph(get_config(arch)), \
        jmf.build_graph(jget_config(arch))
    assert [_region(r) for r in got.regions] == \
        [_region(r) for r in want.regions]
    assert (got.frontend, got.source_name) == (want.frontend,
                                               want.source_name)
    assert got.fingerprint("x") == want.fingerprint("x")


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "recurrentgemma_2b",
                                  "olmoe_1b_7b", "rwkv6_3b"])
def test_plan_from_bits_and_coding_match_reference(arch):
    graph = mf.build_graph(get_config(arch))
    jgraph = jmf.build_graph(jget_config(arch))
    n = len(graph.offloadable())
    rng = np.random.default_rng(0)
    coding = coding_from_graph(graph, destinations=VARIANT_ALPHABET)
    jcoding = jcoding_from_graph(jgraph, destinations=("cpu", "gpu_fused",
                                                       "gpu_pallas"))
    for _ in range(8):
        bits = tuple(int(b) for b in rng.integers(0, 2, size=n))
        assert dataclasses.asdict(mf.plan_from_bits(graph, bits)) == \
            dataclasses.asdict(jmf.plan_from_bits(jgraph, bits))
        values = tuple(int(v) for v in rng.integers(0, 3, size=n))
        got = mf.plan_from_coding(graph, coding, values)
        want = jmf.plan_from_coding(jgraph, jcoding, values)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    # a block-pass claim leaves its site out of the chromosome
    claimed = tuple(r.name for r in graph.offloadable()[:1])
    bits = (1,) * (n - 1)
    got = mf.plan_from_bits(graph, bits, exclude=claimed)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jmf.plan_from_bits(jgraph, bits, exclude=claimed))
    field = graph.by_name(claimed[0]).meta["plan_field"]
    assert getattr(got, field) == getattr(mf.ExecPlan(), field)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_static_cost_search_matches_reference(arch):
    ga = dict(population=8, generations=4, seed=0)
    got = Offloader(OffloadConfig(ga=GAConfig(**ga))).plan(get_config(arch))
    want = JOffloader(JOffloadConfig(ga=JGAConfig(**ga))).plan(
        jget_config(arch))
    assert got.frontend == "module"
    assert got.ga.history == want.ga.history
    assert got.best.bits == want.best.bits
    assert got.best.time_s == want.best.time_s
    assert dataclasses.asdict(got.artifact) == dataclasses.asdict(want.artifact)
    assert got.block.claimed_regions == want.block.claimed_regions
    assert got.verification == {"mode": "static-cost", "verified": False}
    assert got.best.detail == {"static_cost": True}


def test_detect_frontend_and_lower_fn():
    """A ``lower_fn`` plans through the compiled cost model (a measured
    result: each chromosome is its lowered program's roofline)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import lower_cell

    cfg = get_config("qwen3_0_6b")
    assert detect_frontend(cfg, OffloadConfig()) == "module"
    assert detect_frontend(torch.nn.Linear(2, 2), OffloadConfig()) == "export"
    tiny = dataclasses.replace(cfg.reduced(), n_layers=1)
    shape = ShapeSpec("t", 16, 2, "train")
    res = Offloader(OffloadConfig(
        ga=GAConfig(population=2, generations=1, seed=0),
        options={"lower_fn": lambda p: lower_cell(tiny, shape, p,
                                                  "cpu")[0]})).plan(tiny)
    assert res.frontend == "module"
    assert res.verification == {"mode": "measured", "verified": True}
    assert set(res.best.detail) == {"roofline", "live_bytes"}


def test_base_plan_option_carries_into_the_artifact():
    cfg = get_config("tinyllama_1_1b")
    res = Offloader(OffloadConfig(
        ga=GAConfig(population=4, generations=1, seed=0),
        options={"base_plan": REFERENCE_PLAN.replace(microbatch=4)})).plan(
            cfg)
    assert res.artifact.microbatch == 4
    assert res.artifact.attn_impl == "chunked"      # block-pass claim


# ---------------------------------------------------------------------------
# the export frontend over a whole reduced model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def prefill_plan():
    cfg = get_config("qwen3_0_6b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(1))

    def prefill(tok):
        return model.prefill(params, {"tokens": tok}, F32)

    res = Offloader(OffloadConfig(
        device="cpu", repeats=1, ga=GAConfig(population=4, generations=1,
                                             seed=0),
        options={"example_args": (tokens,)})).plan(
            lambda tok: model.prefill(params, {"tokens": tok}, F32))
    return cfg, res, prefill, tokens


def test_prefill_plan_finds_five_sites_a_layer_and_the_final_norm(
        prefill_plan):
    cfg, res, _, _ = prefill_plan
    assert res.frontend == "export"
    assert res.verification == {"mode": "measured", "verified": True}
    sites = {res.graph.by_name(s.region).meta["module"]:
             res.graph.by_name(s.region).meta.get("pattern")
             for s in res.coding.sites}
    matched = {m: p for m, p in sites.items() if p}
    want = {"params.final_norm": "rmsnorm"}
    for i in range(cfg.n_layers):
        want[f"params.blocks.{i}.attn"] = "softmax_attention"
        for norm in ("ln1", "q_norm", "k_norm", "ln2"):
            want[f"params.blocks.{i}.{norm}"] = "rmsnorm"
    assert matched == want
    # the embedding lookup, positions, masks and the cache length live in
    # root or block regions, never in a matched one
    for r in res.graph.regions:
        if r.meta.get("pattern") == "rmsnorm":
            assert not any(n.startswith(("embedding", "arange", "full"))
                           for n in r.meta["nodes"])


@pytest.mark.parametrize("variant", [1, 2])
def test_forced_prefill_plan_binds_every_site_and_verifies(prefill_plan,
                                                           variant):
    """All matched sites on ``fused_torch`` (1) or ``cuda`` (2): every site
    binds, and the program matches the unsubstituted prefill (on the CPU
    the kernel wrappers take their plain versions and launch nothing)."""
    cfg, res, prefill, tokens = prefill_plan
    engine = res.details["engine"]
    bits = tuple(variant if res.graph.by_name(s.region).meta.get("pattern")
                 else 0 for s in res.coding.sites)
    sub = engine.substitute(res.coding.decode(bits))
    chosen = [c.chosen for c in sub.report.choices if c.pattern]
    assert chosen == [("fused_torch", "cuda")[variant - 1]] * \
        (5 * cfg.n_layers + 1)
    assert engine.verify(sub).ok
    ops.reset_launch_counts()
    logits, state = sub(tokens)
    assert sum(ops.launch_counts().values()) == 0
    with torch.no_grad():
        want_logits, want_state = prefill(tokens)
    torch.testing.assert_close(logits, want_logits, atol=1e-5, rtol=1e-5)
    for kv, want_kv in zip(state["kv"], want_state["kv"]):
        torch.testing.assert_close(kv.k, want_kv.k, atol=1e-5, rtol=1e-5)
    assert int(state["cache_len"]) == tokens.shape[1]


def test_planning_checks_the_devices_of_the_modules_a_function_reads():
    """A function's closure modules join the device check: parameters on
    the wrong device are refused before any export."""
    cfg = get_config("qwen3_0_6b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.zeros(1, 4, dtype=torch.int64)
    config = OffloadConfig(device="meta", options={"example_args": (tokens,)})
    with pytest.raises(ValueError, match="tensors live on"):
        Offloader(config).prepare(
            lambda tok: model.prefill(params, {"tokens": tok}, F32))


# ---------------------------------------------------------------------------
# the modules a target reaches, however it holds them
# ---------------------------------------------------------------------------


def _prefill(model, params, tok):
    return model.prefill(params, {"tokens": tok}, F32)


class _Holder:
    """A plain object holding the parameters; its method reads ``self.p``."""

    def __init__(self, model, params):
        self.model, self.p = model, params

    def run(self, tok):
        return self.model.prefill(self.p, {"tokens": tok}, F32)


@pytest.fixture(scope="module")
def reduced_prefill():
    cfg = get_config("qwen3_0_6b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    return cfg, model, params, tokens


@pytest.mark.parametrize("form", ["lambda", "partial", "method"])
def test_export_frontend_finds_the_same_sites_for_every_target_form(
        reduced_prefill, form):
    cfg, model, params, tokens = reduced_prefill
    target = {"lambda": lambda tok: model.prefill(params, {"tokens": tok},
                                                  F32),
              "partial": functools.partial(_prefill, model, params),
              "method": _Holder(model, params).run}[form]
    found = target_modules(target)
    assert list(found.values()) == [params]
    assert list(found) == [{"method": "p"}.get(form, "params")]
    graph = annotate_variants(build_graph(target, tokens), default_db())
    assert len(graph.offloadable()) == 17
    assert sorted(r.meta["pattern"] for r in graph.regions
                  if r.meta.get("pattern")) == \
        ["rmsnorm"] * (4 * cfg.n_layers + 1) + \
        ["softmax_attention"] * cfg.n_layers


def test_a_method_reading_an_attribute_does_not_pick_up_a_global(
        reduced_prefill):
    """``self.p`` names ``p`` in the method's ``co_names``: the module
    global ``p`` (on the meta device) stays out of the program and out of
    the device check."""
    _, model, params, tokens = reduced_prefill
    run = _Holder(model, params).run
    assert all(m is not p for m in target_modules(run).values())
    ctx = Offloader(OffloadConfig(device="cpu", options={
        "example_args": (tokens,)})).prepare(run)
    assert ctx.coding.length > 0


def test_a_module_reading_target_without_module_scopes_raises(
        reduced_prefill):
    """Parameters held in a dict are not reached: the exported graph would
    record no module scope, so planning refuses it, naming the target."""
    _, model, params, tokens = reduced_prefill
    box = {"params": params}

    def boxed(tok):
        return model.prefill(box["params"], {"tokens": tok}, F32)

    assert target_modules(boxed) == {}
    with pytest.raises(ValueError, match="boxed: calls modules"):
        build_graph(boxed, tokens)


# ---------------------------------------------------------------------------
# the MoE and SSM families' prefills
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["olmoe_1b_7b", "rwkv6_3b"])
def family_prefill(request):
    """The reduced prefill under the production MoE and the chunked WKV
    form, prepared for planning (graph, coding, substitution engine)."""
    cfg = get_config(request.param).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    plan = F32.replace(moe_impl="scatter_ep", wkv_impl="chunked",
                       wkv_chunk=8)
    ctx = Offloader(OffloadConfig(device="cpu", options={
        "example_args": (tokens,)})).prepare(
            lambda tok: model.prefill(params, {"tokens": tok}, plan))
    return cfg, ctx


def test_family_prefill_matches_its_norms_attention_and_scans(
        family_prefill):
    """OLMoE: 4 * n_layers + 1 ``rmsnorm`` and n_layers
    ``softmax_attention`` sites, and no router, expert or MoE region
    matches; RWKV-6: the embedding's and each layer's two LayerNorms and
    the final norm match ``rmsnorm`` by name, each layer's WKV scan
    ``wkv_recurrence``."""
    cfg, ctx = family_prefill
    matched = {}
    for s in ctx.coding.sites:
        r = ctx.graph.by_name(s.region)
        if r.meta.get("pattern"):
            matched[r.meta["module"]] = r.meta["pattern"]
    want = {"params.final_norm": "rmsnorm"}
    for i in range(cfg.n_layers):
        if cfg.family == "ssm":
            want.update({f"params.blocks.{i}.ln1": "rmsnorm",
                         f"params.blocks.{i}.ln2": "rmsnorm",
                         f"params.blocks.{i}.wkv": "wkv_recurrence"})
        else:
            want[f"params.blocks.{i}.attn"] = "softmax_attention"
            for norm in ("ln1", "q_norm", "k_norm", "ln2"):
                want[f"params.blocks.{i}.{norm}"] = "rmsnorm"
    if cfg.family == "ssm":
        want["params.embed_norm"] = "rmsnorm"
        assert all(ctx.graph.by_name(s.region).kind == "loop"
                   for s in ctx.coding.sites
                   if matched.get(ctx.graph.by_name(s.region).meta["module"])
                   == "wkv_recurrence")
    assert matched == want
    assert not any(".moe" in r.meta.get("module", "") and
                   r.meta.get("pattern") for r in ctx.graph.regions)


def test_forced_family_prefill_binds_what_the_kernels_take(family_prefill):
    """Every matched site on ``cuda``: OLMoE binds all of them; RWKV-6
    binds only the final norm -- a LayerNorm region has three inputs (x,
    scale, bias) and the multi-head WKV scan is not the kernel's
    single-head (S, D) form -- and both programs verify against the
    unsubstituted prefill."""
    cfg, ctx = family_prefill
    engine = ctx.bundle.context["engine"]
    bits = tuple(2 if ctx.graph.by_name(s.region).meta.get("pattern") else 0
                 for s in ctx.coding.sites)
    sub = engine.substitute(ctx.coding.decode(bits))
    chosen = sorted((c.pattern, c.chosen) for c in sub.report.choices
                    if c.pattern)
    n = cfg.n_layers
    if cfg.family == "ssm":
        assert chosen == sorted([("rmsnorm", "cuda")]
                                + [("rmsnorm", "ref")] * (1 + 2 * n)
                                + [("wkv_recurrence", "ref")] * n)
        why = {c.why for c in sub.report.choices if c.chosen == "ref"}
        assert any("exactly (x, scale)" in w for w in why)
    else:
        assert chosen == sorted([("rmsnorm", "cuda")] * (4 * n + 1)
                                + [("softmax_attention", "cuda")] * n)
    assert engine.verify(sub).ok


# ---------------------------------------------------------------------------
# the enc-dec family's prefill: non-causal attention sites
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def whisper_prefill():
    """The reduced Whisper prefill (2 + 2 layers, 16 frames, 12 tokens)
    in f32, prepared for planning, and the modules of its sites."""
    cfg = get_config("whisper_small").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 12), generator=gen)
    frames = torch.randn(2, cfg.encoder_seq, cfg.d_model, generator=gen)
    ctx = Offloader(OffloadConfig(device="cpu", options={
        "example_args": (tokens, frames)})).prepare(
            lambda tok, fr: model.prefill(params, {"tokens": tok,
                                                   "frames": fr}, F32))
    sites = [ctx.graph.by_name(s.region) for s in ctx.coding.sites]
    modules = {r.name: params.get_submodule(
        r.meta["module"].removeprefix("params."))
        for r in sites if r.meta.get("pattern")}
    return cfg, ctx, sites, modules


def test_whisper_prefill_finds_its_norms_and_attention_cores_in_order(
        whisper_prefill):
    """2 * L_enc + 1 + 3 * L_dec + 1 ``rmsnorm`` sites and L_enc + 2 *
    L_dec ``softmax_attention`` sites, in program order: each encoder
    layer's ln1, attention, ln2; the encoder's final norm; each decoder
    layer's ln1, self-attention, ln_x, cross-attention, ln2; the final
    norm.  No norm region holds a position, mask or embedding node."""
    cfg, _, sites, modules = whisper_prefill
    matched = [(r.meta["module"], r.meta["pattern"]) for r in sites
               if r.meta.get("pattern")]
    want = []
    for i in range(cfg.n_encoder_layers):
        want += [(f"params.enc_blocks.{i}.ln1", "rmsnorm"),
                 (f"params.enc_blocks.{i}.attn", "softmax_attention"),
                 (f"params.enc_blocks.{i}.ln2", "rmsnorm")]
    want.append(("params.enc_final_norm", "rmsnorm"))
    for i in range(cfg.n_layers):
        want += [(f"params.blocks.{i}.ln1", "rmsnorm"),
                 (f"params.blocks.{i}.attn", "softmax_attention"),
                 (f"params.blocks.{i}.ln_x", "rmsnorm"),
                 (f"params.blocks.{i}.cross", "softmax_attention"),
                 (f"params.blocks.{i}.ln2", "rmsnorm")]
    want.append(("params.final_norm", "rmsnorm"))
    assert matched == want
    n_norm = sum(p == "rmsnorm" for _, p in matched)
    assert n_norm == 2 * cfg.n_encoder_layers + 1 + 3 * cfg.n_layers + 1
    assert len(matched) - n_norm == cfg.n_encoder_layers + 2 * cfg.n_layers
    causal = [r.meta["module"] for r in sites
              if r.meta.get("pattern") == "softmax_attention"
              and modules[r.name].causal]
    assert causal == [f"params.blocks.{i}.attn" for i in range(cfg.n_layers)]
    for r in sites:
        if r.meta.get("pattern") == "rmsnorm":
            assert not any(n.startswith(("embedding", "arange", "full"))
                           for n in r.meta["nodes"])


def _whisper_bits(sites, pick) -> tuple:
    return tuple(pick(r) if r.meta.get("pattern") else 0 for r in sites)


@pytest.mark.parametrize("variant", [1, 2])
def test_whisper_plan_on_the_causal_sites_verifies(whisper_prefill, variant):
    """``fused_torch`` (1) or ``cuda`` (2) at every norm and every causal
    (decoder self-) attention, ``ref`` at the non-causal ones: every chosen
    site binds and the program verifies (on the CPU the kernel wrappers
    take their plain versions)."""
    cfg, ctx, sites, modules = whisper_prefill
    engine = ctx.bundle.context["engine"]

    def pick(r):
        m = modules[r.name]
        return variant if getattr(m, "causal", True) else 0

    sub = engine.substitute(ctx.coding.decode(_whisper_bits(sites, pick)))
    chosen = sorted(c.chosen for c in sub.report.choices if c.pattern)
    name = ("fused_torch", "cuda")[variant - 1]
    n_ref = cfg.n_encoder_layers + cfg.n_layers
    assert chosen == sorted([name] * (len(modules) - n_ref)
                            + ["ref"] * n_ref)
    assert engine.verify(sub).ok


@pytest.mark.parametrize("site", ["params.enc_blocks.0.attn",
                                  "params.blocks.1.cross"])
def test_whisper_fused_attention_at_a_non_causal_site_fails_verification(
        whisper_prefill, site):
    """Both packages' attention binders compute a causal attention
    whatever the region's mask: ``fused_torch`` alone at an encoder or a
    cross-attention site binds, runs, and fails verification (it does not
    raise)."""
    _, ctx, sites, _ = whisper_prefill
    engine = ctx.bundle.context["engine"]
    bits = _whisper_bits(sites,
                         lambda r: 1 if r.meta["module"] == site else 0)
    assert sum(bits) == 1
    sub = engine.substitute(ctx.coding.decode(bits))
    assert [c.chosen for c in sub.report.choices
            if c.chosen != "ref"] == ["fused_torch"]
    v = engine.verify(sub)
    assert not v.ok and v.max_abs > 1e-2
