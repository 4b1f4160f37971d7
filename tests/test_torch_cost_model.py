"""The port's compiled-artifact cost model on the CPU: ``CostModelFitness``
(its OOM and error rules), the module frontend's ``lower_fn`` path through
a GA, ``launch/plans.py`` and ``launch/report.py`` against the reference's,
``launch/dryrun.py``'s one-card lowering (the layer extrapolation against
a full trace, the record, the refusal without a card), and the analyzer
over exported and substituted programs (the kernel nodes costed by their
registry variants)."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import json  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs.base import ALL_SHAPES as JALL_SHAPES  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.launch import plans as jplans  # noqa: E402
from repro.launch import report as jreport  # noqa: E402
from repro_torch import hlo_analysis as ha  # noqa: E402
from repro_torch import roofline as rl  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import SHAPES_BY_NAME, ShapeSpec  # noqa: E402
from repro_torch.core.fitness import CostModelFitness  # noqa: E402
from repro_torch.core.ga import GAConfig  # noqa: E402
from repro_torch.core.offload import OffloadConfig, Offloader  # noqa: E402
from repro_torch.launch import dryrun, plans, report  # noqa: E402
from repro_torch.models import REFERENCE_PLAN, build_model  # noqa: E402

F32 = REFERENCE_PLAN.replace(compute_dtype="float32")
TRAIN = ShapeSpec("t", 32, 2, "train")


def _tiny(arch="qwen3_0_6b", n_layers=2):
    return dataclasses.replace(get_config(arch).reduced(), n_layers=n_layers)


# ---------------------------------------------------------------------------
# CostModelFitness
# ---------------------------------------------------------------------------


def test_cost_model_fitness_scores_the_roofline_and_keeps_the_summary():
    cfg = _tiny()
    fit = CostModelFitness(
        lower=lambda bits: dryrun.lower_cell(cfg, TRAIN, F32, "cpu")[0],
        n_devices=1, model_flops=1e6)
    ev = fit((0, 1))
    assert ev.valid and ev.bits == (0, 1)
    roof = ev.detail["roofline"]
    assert ev.time_s == roof["step_s"] > 0
    assert list(roof) == list(rl.Roofline(1, 1, 0, 1).summary())
    assert roof["model_flops"] == 1e6
    assert ev.detail["live_bytes"] > 0
    assert fit.hbm_budget == 80e9


def test_cost_model_fitness_oom_and_error_rules():
    cfg = _tiny()
    low = dryrun.lower_cell(cfg, TRAIN, F32, "cpu")[0]
    live = CostModelFitness(lambda b: low, 1)((1,)).detail["live_bytes"]
    ev = CostModelFitness(lambda b: low, 1, hbm_budget=live - 1)((1,))
    assert ev.time_s == float("inf") and not ev.valid
    assert ev.detail["error"] == \
        f"OOM: {live/1e9:.2f} GB > {(live - 1)/1e9:.0f} GB"
    assert ev.detail["live_bytes"] == live and "roofline" in ev.detail

    def broken(bits):
        raise ValueError("no lowering " + "x" * 400)

    ev = CostModelFitness(broken, 1)((0,))
    assert ev.time_s == float("inf") and not ev.valid
    assert ev.detail == {"error": f"ValueError: no lowering {'x' * 400}"[:300]}


# ---------------------------------------------------------------------------
# the module frontend's lower_fn path
# ---------------------------------------------------------------------------


def test_ga_plans_through_lower_fn_on_a_tiny_config():
    cfg = _tiny()
    lowered = []

    def lower_fn(plan):
        lowered.append(plan)
        return dryrun.lower_cell(cfg, TRAIN, plan, "cpu")[0]

    mf = rl.model_flops_train(cfg.param_count(active_only=True), TRAIN.tokens)
    res = Offloader(OffloadConfig(
        ga=GAConfig(population=4, generations=2, seed=0),
        options={"lower_fn": lower_fn, "model_flops": mf,
                 "base_plan": F32})).plan(cfg)
    assert res.frontend == "module"
    assert res.verification == {"mode": "measured", "verified": True}
    assert res.best.valid and res.best.time_s == \
        res.best.detail["roofline"]["step_s"]
    assert res.best.detail["roofline"]["model_flops"] == mf
    assert res.baseline.time_s >= res.best.time_s
    assert all(p.compute_dtype == "float32" for p in lowered)
    assert res.artifact.compute_dtype == "float32"


def test_lower_fn_path_marks_plans_that_do_not_fit_infinite():
    cfg = _tiny()
    sizes = {}

    def lower_fn(plan):
        low = dryrun.lower_cell(cfg, TRAIN, plan, "cpu")[0]
        m = low.compile().memory_analysis()
        sizes[plan.remat] = (m.argument_size_in_bytes
                             + m.output_size_in_bytes + m.temp_size_in_bytes)
        return low

    # between the smallest and the largest footprint the remat knob gives
    probe = {r: lower_fn(F32.replace(remat=r)) for r in ("none", "full")}
    del probe
    budget = (sizes["none"] + sizes["full"]) / 2
    assert sizes["full"] < budget < sizes["none"]
    res = Offloader(OffloadConfig(
        ga=GAConfig(population=6, generations=2, seed=0),
        options={"lower_fn": lower_fn, "hbm_budget": budget,
                 "base_plan": F32})).plan(cfg)
    assert res.best.valid and res.best.detail["live_bytes"] <= budget
    assert res.artifact.remat != "none"
    # the all-reference program keeps every activation: it does not fit
    assert res.baseline.time_s == float("inf")
    assert res.baseline.detail["error"].startswith("OOM: ")


# ---------------------------------------------------------------------------
# launch/plans.py and launch/report.py against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [s.name for s in JALL_SHAPES])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_production_and_tuned_plans_match_reference(arch, shape):
    cfg, jcfg = get_config(arch), jget_config(arch)
    s = SHAPES_BY_NAME[shape]
    js = next(x for x in JALL_SHAPES if x.name == shape)
    for mine, ref in ((plans.production_plan, jplans.production_plan),
                      (plans.tuned_plan, jplans.tuned_plan)):
        assert dataclasses.asdict(mine(cfg, s)) == \
            dataclasses.asdict(ref(jcfg, js))


def _records():
    roof = rl.Roofline(4.2e13, 1.1e12, 0.0, 1, model_flops=2.5e13,
                       flops_by_dtype={"f32": 4.2e13}).summary()
    base = {"mesh": "h100x1", "plan": "production", "roofline": roof}
    return [
        {**base, "arch": "qwen3_0_6b", "shape": "train_4k", "status": "ok",
         "memory": {"fits_80gb": True, "fits_16gb": False}},
        {**base, "arch": "qwen3_0_6b", "shape": "decode_32k", "status": "ok",
         "memory": {"fits_80gb": False, "fits_16gb": False}},
        {**base, "arch": "gemma_7b", "shape": "long_500k", "status": "skip"},
        {**base, "arch": "rwkv6_3b", "shape": "train_4k", "status": "error"},
        {**base, "arch": "tinyllama_1_1b", "shape": "train_4k",
         "mesh": "pod16x16", "status": "ok",
         "memory": {"fits_80gb": True, "fits_16gb": True}},
    ]


def test_report_rows_match_reference_but_the_hbm_column():
    recs = _records()

    def cut(table):
        return [row.split("|")[:3] + row.split("|")[4:]
                for row in table.splitlines()]

    mine = report.render(recs)
    ref = jreport.render(recs, mesh="h100x1")
    assert cut(mine) == cut(ref)
    assert mine.splitlines()[0].split("|")[3].strip() == "fits80G"
    # gemma's skip row, then qwen3's train_4k (fits) and decode_32k (not)
    assert [r.split("|")[3].strip() for r in mine.splitlines()[2:5]] == \
        ["—", "Y", "N"]
    assert report.summary(recs).startswith(
        "cells ok=3 skip=1 err=1; fits 80GB: 2/3;")


# ---------------------------------------------------------------------------
# launch/dryrun.py
# ---------------------------------------------------------------------------


def _totals(low):
    c = low.compile()
    m = c.memory_analysis()
    h = ha.analyze_hlo(c, 1)
    return (h.flops, h.bytes, m.argument_size_in_bytes,
            m.output_size_in_bytes, m.temp_size_in_bytes)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch,plan", [
    ("qwen3_0_6b", F32),
    ("qwen3_0_6b", F32.replace(attn_impl="chunked", remat="dots",
                               loss_impl="chunked_vocab")),
    ("olmoe_1b_7b", F32.replace(remat="full"))])
def test_layer_extrapolation_equals_a_full_trace(arch, plan, kind):
    """A stack traced at two and three layers and extrapolated to five
    gives the five-layer trace's FLOPs, bytes and memory exactly."""
    cfg = _tiny(arch, 5)
    shape = ShapeSpec("s", 32, 2, kind)
    assert dryrun._depths(cfg) == (2, 3, 3)
    low = dryrun.lower_cell(cfg, shape, plan, "cpu")[0]
    assert low.repeat is not None and low.repeat[1] == 3
    full = dryrun._lower_one(cfg, shape, plan, torch.device("cpu"), None)
    assert _totals(low) == _totals(full)


def test_hybrid_and_encdec_depths():
    rg = get_config("recurrentgemma_2b")
    assert dryrun._depths(rg) == (8, 11, 6)         # 2 + 8 x 3 sublayers
    assert dryrun._depths(get_config("whisper_small")) is None
    assert dryrun._depths(_tiny(n_layers=3)) is None


def test_lower_cell_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.lower_cell(_tiny(), TRAIN, F32)


def test_dryrun_cli_writes_the_reference_record(tmp_path):
    dryrun.main(["--arch", "qwen3_0_6b", "--shape", "decode_32k",
                 "--device", "cpu", "--out", str(tmp_path)])
    dryrun.main(["--arch", "qwen3_0_6b", "--shape", "long_500k",
                 "--device", "cpu", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "qwen3_0_6b__decode_32k__h100x1__production"
                      ".json").read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "h100x1"
    assert rec["reduced"].startswith("global batch 128 -> 1")
    mem = rec["memory"]
    assert mem["live_bytes"] == mem["argument_bytes"] + mem["output_bytes"] \
        + mem["temp_bytes"] + mem["code_bytes"]
    assert mem["fits_80gb"] is True
    assert list(rec["roofline"]) == list(rl.Roofline(1, 1, 0, 1).summary())
    # one token against a 32k cache reads the cache: memory-bound
    assert rec["roofline"]["dominant"] == "memory"
    skip = json.loads((tmp_path / "qwen3_0_6b__long_500k__h100x1__production"
                       ".json").read_text())
    assert skip["status"] == "skip" and skip["skip_reason"]
    table = report.render(report.load(str(tmp_path)))
    assert "| qwen3_0_6b | decode_32k | Y |" in table


# ---------------------------------------------------------------------------
# the analyzer over exported and substituted programs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def exported_prefill():
    cfg = get_config("qwen3_0_6b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    ctx = Offloader(OffloadConfig(
        device="cpu", repeats=1, ga=GAConfig(population=2, generations=1,
                                             seed=0),
        options={"example_args": (tokens,), "block_sites": False})).prepare(
            lambda tok: model.prefill(params, {"tokens": tok}, F32))
    return ctx, tokens


@pytest.mark.parametrize("variant", ["fused_torch", "cuda"])
def test_substituted_kernel_nodes_are_charged_their_variant_cost(
        exported_prefill, variant):
    ctx, tokens = exported_prefill
    engine = ctx.bundle.context["engine"]
    impl = {s.region: variant for s in engine.sites if s.pattern}
    sub = engine.substitute(impl)
    assert all(c.chosen == variant for c in sub.report.choices if c.pattern)
    ref = ha.analyze_hlo(engine.gm, 1)
    got = ha.analyze_hlo(sub, 1)
    assert ref.uncosted == [] and got.uncosted == []
    # the substituted program: the reference's ops outside the sites, and
    # each site's declared cost
    span_flops = 0.0
    for site in engine.sites:
        if site.pattern:
            for n in site.nodes:
                span_flops += ha._node_cost(engine.gm, n, 1)[0].flops
    adapters = [n.target.cost for n in sub.gm.graph.nodes
                if isinstance(getattr(n.target, "cost", None),
                              rl.KernelCost)]
    assert len(adapters) == sum(1 for s in engine.sites if s.pattern)
    assert got.flops == pytest.approx(
        ref.flops - span_flops + sum(c.flops for c in adapters), rel=1e-12)
    cfg = get_config("qwen3_0_6b").reduced()
    flash = rl.flash_cost(2, 16, 16, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, variant == "cuda", torch.float32)
    attn = [c for c in adapters if c.flops == flash.flops]
    assert len(attn) == cfg.n_layers
    mem = ha.memory_analysis(sub.gm)
    assert mem.temp_size_in_bytes > 0
    roof = rl.analyze(None, sub)
    assert roof.compute_s > 0 and roof.memory_s > 0
