"""The port's module frontend against the reference's on the CPU: region
graphs for all ten architectures, chromosome decoding, and the static-cost
search (same GA history and best chromosome from the same seed); plus the
export frontend over a whole reduced model's prefill."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

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
from repro_torch.core.frontends.registry import detect_frontend  # noqa: E402
from repro_torch.core.ga import GAConfig  # noqa: E402
from repro_torch.core.genes import VARIANT_ALPHABET, coding_from_graph  # noqa: E402
from repro_torch.core.offload import OffloadConfig, Offloader  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import REFERENCE_PLAN, build_model  # noqa: E402

F32 = REFERENCE_PLAN.replace(compute_dtype="float32")


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
    cfg = get_config("qwen3_0_6b")
    assert detect_frontend(cfg, OffloadConfig()) == "module"
    assert detect_frontend(torch.nn.Linear(2, 2), OffloadConfig()) == "export"
    with pytest.raises(NotImplementedError, match="CostModelFitness"):
        Offloader(OffloadConfig(options={"lower_fn": lambda p: p})).plan(cfg)


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
