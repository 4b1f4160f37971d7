"""The cross-frontend differential suite (``tests/test_frontend_differential.
py``) over the port's frontends (``frontend_names()``: ``python_ast``,
``export``, ``module``, ``ir``), on the CPU.

The same logical workloads (attention, rmsnorm, recurrence) planned through
the port's python_ast and export frontends give numerically equivalent
outputs per chosen variant and a uniform
:class:`~repro_torch.core.variants.SubstitutionReport`; every registered
frontend reports uniformly, plans the same search serially and with thread
workers, and plans function-block genes uniformly (the ``attention_stack``
block of the python_ast frontend and of the export frontend, against each
other and against a torch twin of the same block)."""
import pytest

torch = pytest.importorskip("torch")

import importlib.util  # noqa: E402
import math  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
from torch._higher_order_ops.scan import scan  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.frontends import ast_frontend as tast  # noqa: E402
from repro_torch.core.frontends.registry import (OffloadConfig,  # noqa: E402
                                                 frontend_names,
                                                 get_frontend)
from repro_torch.core.ga import Evaluation, GAConfig  # noqa: E402
from repro_torch.core.genes import VARIANT_ALPHABET, coding_from_graph  # noqa: E402
from repro_torch.core.ir import Region, RegionGraph  # noqa: E402
from repro_torch.core.offload import Offloader, plan  # noqa: E402
from repro_torch.core.variants import SubstitutionReport  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "_ref_diff_suite_workloads", ROOT / "tests" / "test_frontend_differential.py")
_DIFF = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_DIFF)

RTOL = ATOL = _DIFF.RTOL
PY_WORKLOADS = _DIFF.PY_WORKLOADS
CPU = {"device": "cpu"}


# --- export twins of the workloads: the same math, in torch ----------------


class Attention(torch.nn.Module):
    """Causal single-head attention; the class name is what the export
    frontend's name match keys on, as it does for the models'."""

    def forward(self, q, k, v):
        s = q @ k.T / math.sqrt(q.shape[-1])
        mask = torch.tril(torch.ones(q.shape[0], k.shape[0], dtype=torch.bool,
                                     device=q.device))
        return torch.softmax(torch.where(mask, s, -1e30), dim=-1) @ v


_ATTENTION = Attention()


def _tx_attn_app(q, k, v):
    return _ATTENTION(q, k, v)


def _tx_rms_app(x, scale):
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + 1e-6) * (1 + scale)


def _tx_rec_app(la, b):
    def step(h, ab):
        h = torch.exp(ab[0]) * h + ab[1]
        return h, h.clone()            # a scan's ys may not alias its carry
    _, hs = scan(step, torch.zeros(la.shape[-1], device=la.device), (la, b))
    return hs


def _f32(*arrays):
    return tuple(torch.tensor(a, dtype=torch.float32) for a in arrays)


def _ex_case(workload):
    if workload == "attention":
        i = _DIFF._attn_inputs()
        return _tx_attn_app, _f32(i["q"], i["k"], i["v"])
    if workload == "rmsnorm":
        i = _DIFF._rms_inputs()
        return _tx_rms_app, _f32(i["x"], i["scale"])
    i = _DIFF._rec_inputs()
    return _tx_rec_app, _f32(i["a"], i["b"])


# ---------------------------------------------------------------------------
# per-frontend plan bundles (cached: make_fitness interprets/measures)
# ---------------------------------------------------------------------------

_PY_BUNDLES: dict = {}
_EX_BUNDLES: dict = {}


def _py_bundle(workload, src=None):
    key = (workload, src)
    if key not in _PY_BUNDLES:
        wsrc, consts, inputs_fn, out_name, _ = PY_WORKLOADS[workload]
        inputs = inputs_fn()
        fe = get_frontend("python_ast")
        cfg = OffloadConfig(repeats=1, options={"consts": consts}, **CPU)
        program = fe.normalize_target(src or wsrc, inputs, cfg)
        graph = fe.build_graph(program, inputs, cfg)
        bundle = fe.make_fitness(graph, program, inputs, cfg)
        coding = coding_from_graph(graph, exclude=bundle.claimed,
                                   destinations=bundle.destinations
                                   or ("cpu", "gpu"))
        ref = tast.Executor(program, {}, hoist_transfers=False,
                            **CPU).run(**inputs)[out_name]
        _PY_BUNDLES[key] = (fe, graph, bundle, coding, inputs,
                            np.asarray(ref))
    return _PY_BUNDLES[key]


def _ex_bundle(workload):
    if workload not in _EX_BUNDLES:
        fn, args = _ex_case(workload)
        fe = get_frontend("export")
        cfg = OffloadConfig(repeats=1, options={"example_args": args}, **CPU)
        graph = fe.build_graph(fn, None, cfg)
        bundle = fe.make_fitness(graph, fn, None, cfg)
        coding = coding_from_graph(graph, exclude=bundle.claimed,
                                   destinations=bundle.destinations)
        with torch.no_grad():
            ref = fn(*args).numpy()
        _EX_BUNDLES[workload] = (fe, graph, bundle, coding, args, ref)
    return _EX_BUNDLES[workload]


def _values_for(coding, graph, pattern, gene_value):
    """All-reference chromosome with the matched site set to gene_value."""
    sites = [s.region for s in coding.sites
             if graph.by_name(s.region).meta.get("pattern") == pattern]
    assert sites, f"no gene site matched {pattern}"
    return tuple(gene_value if s.region == sites[0] else 0
                 for s in coding.sites), sites[0]


VARIANT_GENE = {"fused_torch": 1, "cuda": 2}    # VARIANT_ALPHABET positions


# ---------------------------------------------------------------------------
# contract 1: per-variant numeric equivalence, python_ast vs export
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("workload", sorted(PY_WORKLOADS))
@pytest.mark.parametrize("variant", sorted(VARIANT_GENE))
def test_python_and_export_variant_outputs_match(workload, variant):
    pattern = PY_WORKLOADS[workload][4]
    gene = VARIANT_GENE[variant]

    fe, graph, bundle, coding, inputs, py_ref = _py_bundle(workload)
    assert bundle.destinations == VARIANT_ALPHABET
    values, region = _values_for(coding, graph, pattern, gene)
    artifact = fe.apply_plan(graph, coding, values, bundle)
    assert artifact.report.substituted == {region: variant}, \
        artifact.report.fallbacks
    out_name = PY_WORKLOADS[workload][3]
    py_out = artifact.run(**inputs)[out_name]
    np.testing.assert_allclose(py_out, py_ref, rtol=RTOL, atol=ATOL)

    efe, egraph, ebundle, ecoding, args, ex_ref = _ex_bundle(workload)
    evalues, eregion = _values_for(ecoding, egraph, pattern, gene)
    sub = efe.apply_plan(egraph, ecoding, evalues, ebundle)
    assert sub.report.substituted == {eregion: variant}, sub.report.fallbacks
    with torch.no_grad():
        ex_out = sub(*args).numpy()
    np.testing.assert_allclose(ex_out, ex_ref, rtol=RTOL, atol=ATOL)

    # the differential claim: two frontends, one workload, one variant,
    # numerically the same artifact output
    np.testing.assert_allclose(py_out, ex_out, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("workload", sorted(PY_WORKLOADS))
def test_report_shapes_identical_across_executable_frontends(workload):
    pattern = PY_WORKLOADS[workload][4]
    fe, graph, bundle, coding, _, _ = _py_bundle(workload)
    efe, egraph, ebundle, ecoding, _, _ = _ex_bundle(workload)
    values, region = _values_for(coding, graph, pattern, 1)
    evalues, eregion = _values_for(ecoding, egraph, pattern, 1)
    r1 = fe.apply_plan(graph, coding, values, bundle).report
    r2 = efe.apply_plan(egraph, ecoding, evalues, ebundle).report
    for rep in (r1, r2):
        assert isinstance(rep, SubstitutionReport)
        assert set(rep.summary()) == {"substituted", "fallbacks"}
    c1 = next(c for c in r1.choices if c.region == region)
    c2 = next(c for c in r2.choices if c.region == eregion)
    # same fields, same pattern, same chosen variant — only region naming
    # is frontend-private
    assert (c1.pattern, c1.requested, c1.chosen) == \
        (c2.pattern, c2.requested, c2.chosen) == \
        (pattern, "fused_torch", "fused_torch")


def test_python_ast_roles_survive_swapped_operand_order():
    """Structural role inference: `k[j][t] * q[i][t]` (k textually first)
    must still bind (q, k, v) correctly, on the fused rewrite and on the
    kernel's plain version."""
    swapped = _DIFF.ATTN_SRC.replace("q[i][t] * k[j][t]", "k[j][t] * q[i][t]") \
                            .replace("q[i][u] * k[j][u]", "k[j][u] * q[i][u]")
    assert "k[j][t] * q[i][t]" in swapped
    fe, graph, bundle, coding, inputs, ref = _py_bundle("attention", swapped)
    for variant, gene in VARIANT_GENE.items():
        values, region = _values_for(coding, graph, "softmax_attention", gene)
        art = fe.apply_plan(graph, coding, values, bundle)
        assert art.report.substituted == {region: variant}
        np.testing.assert_allclose(art.run(**inputs)["out"], ref,
                                   rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# contract 2: module-frontend variant knobs (ExecPlan.SITE_VARIANTS)
# ---------------------------------------------------------------------------


def test_module_gene_selects_extra_variant():
    from repro_torch.core.pattern_db import PatternDB

    fe = get_frontend("module")
    # an empty DB: nothing is block-claimed, every knob stays in the gene
    cfg = OffloadConfig(db=PatternDB([]))
    target = get_config("recurrentgemma_2b")
    graph = fe.build_graph(target, None, cfg)
    bundle = fe.make_fitness(graph, target, None, cfg)
    assert bundle.destinations == VARIANT_ALPHABET
    coding = coding_from_graph(graph, exclude=bundle.claimed,
                               destinations=bundle.destinations)
    by_region = {s.region: i for i, s in enumerate(coding.sites)}
    assert "rglru_impl" in by_region, "recurrence knob must stay in the gene"
    for gene, expect in ((0, "step"), (1, "assoc"), (2, "chunked")):
        values = [0] * coding.length
        values[by_region["rglru_impl"]] = gene
        assert fe.apply_plan(graph, coding, tuple(values),
                             bundle).rglru_impl == expect
    # a binary site clamps: gene 2 selects its (only) offload impl
    values = [0] * coding.length
    values[by_region["norm_impl"]] = 2
    assert fe.apply_plan(graph, coding, tuple(values),
                         bundle).norm_impl == "fused"


# ---------------------------------------------------------------------------
# contract 3: a uniform report on EVERY registered frontend
# ---------------------------------------------------------------------------

_IR_GRAPH_REGIONS = _DIFF._IR_GRAPH_REGIONS


def _frontend_fixture(name):
    if name == "python_ast":
        src, consts, inputs_fn, _, _ = PY_WORKLOADS["rmsnorm"]
        return src, inputs_fn(), {"repeats": 1,
                                  "options": {"consts": consts}}
    if name == "export":
        fn, args = _ex_case("recurrence")
        return fn, None, {"options": {"example_args": args}}
    if name == "module":
        return get_config("recurrentgemma_2b"), None, {}
    if name == "ir":
        return RegionGraph([Region(r.name, r.kind, defs=r.defs, uses=r.uses,
                                   offloadable=r.offloadable,
                                   alternatives=r.alternatives,
                                   trip_count=r.trip_count)
                            for r in _IR_GRAPH_REGIONS], "ir", "diff-toy"), \
            None, {}
    raise AssertionError(
        f"frontend {name!r} is registered but has no differential-suite "
        f"fixture: add one to tests/test_torch_frontend_differential.py")


def _det_fitness(values) -> Evaluation:
    t = 1.0 + 0.05 * sum(int(v) * (i + 1) for i, v in enumerate(values))
    return Evaluation(tuple(values), t, True)


def _plan(name, workers=0, seed=5, log=None):
    target, inputs, kwargs = _frontend_fixture(name)
    cfg = OffloadConfig(ga=GAConfig(population=6, generations=2, seed=seed,
                                    workers=workers),
                        fitness_fn=_det_fitness, log=log, **CPU, **kwargs)
    return Offloader(cfg).plan(target, inputs)


def test_the_port_registers_four_frontends():
    assert frontend_names() == ("export", "ir", "module", "python_ast")


@pytest.mark.parametrize("name", sorted(frontend_names()))
def test_every_frontend_reports_uniformly(name):
    res = _plan(name)
    assert res.frontend == name
    rep = res.report
    assert isinstance(rep, SubstitutionReport)
    gene_sites = {s.region for s in res.coding.sites}
    regions = [c.region for c in rep.choices]
    assert len(regions) == len(set(regions)), "one choice per region"
    assert set(regions) >= gene_sites, "every gene site must be reported"
    for c in rep.choices:
        assert isinstance(c.requested, str) and isinstance(c.chosen, str)
        assert isinstance(c.why, str)
        assert c.pattern is None or isinstance(c.pattern, str)
    assert set(rep.summary()) == {"substituted", "fallbacks"}
    assert res.summary()["substituted"] == rep.substituted


@pytest.mark.parametrize("name", sorted(frontend_names()))
def test_every_frontend_serial_parallel_report_identical(name):
    """Thread workers (4) plan what the serial engine plans: the same best,
    report and history.  The measured frontends (export, python_ast) are
    serial-only: the pipeline forces their workers to 0, so for them this
    holds the forcing, not a thread pool."""
    logged: list = []
    r_ser = _plan(name, workers=0)
    r_par = _plan(name, workers=4, log=logged.append)
    forced = any("forcing serial evaluation" in m for m in logged)
    assert forced == (name in {"export", "python_ast"}), logged
    assert r_ser.best.bits == r_par.best.bits
    assert r_ser.report == r_par.report
    assert [h["best_time_s"] for h in r_ser.ga.history] == \
        [h["best_time_s"] for h in r_par.ga.history]


def test_export_static_cost_path_is_opt_in():
    """Twin of ``test_jaxpr_static_cost_path_is_opt_in``: the transfer-cost
    stub only on request, and its artifact is the impl map."""
    fn, args = _ex_case("attention")
    res = plan(fn, config=OffloadConfig(
        ga=GAConfig(population=6, generations=2, seed=0),
        options={"example_args": args, "static_cost": True}, **CPU))
    assert res.verification["mode"] == "static-cost"
    assert not res.verification["verified"]
    assert res.best.detail.get("static_cost")
    assert isinstance(res.artifact, dict)    # impl map, not a callable
    measured = plan(fn, config=OffloadConfig(
        ga=GAConfig(population=4, generations=1, seed=0), repeats=1,
        options={"example_args": args}, **CPU))
    assert measured.verification == {"mode": "measured", "verified": True}
    assert callable(measured.artifact)


# ---------------------------------------------------------------------------
# contract 4: function-block genes
# ---------------------------------------------------------------------------

#: frontends whose planning pipeline has no function-block pass — they must
#: still plan the absence uniformly (no member-carrying gene sites)
_BLOCK_FREE = {"module", "ir"}

_BLOCK_BUNDLES: dict = {}


class BlockStack(torch.nn.Module):
    """The export twin of ``BLOCK_SRC``: rmsnorm and causal attention as
    submodules (``RMSNorm``, ``Attention``), the q/k/v projections between
    them in the caller's module, as a model layer has them."""

    def __init__(self, scale):
        super().__init__()
        from repro_torch.models.layers import RMSNorm
        self.norm = RMSNorm(scale.shape[0])
        with torch.no_grad():
            self.norm.weight.copy_(scale)
        self.attn = Attention()

    def forward(self, x, wq, wk, wv):
        xn = self.norm(x)
        return self.attn(xn @ wq, xn @ wk, xn @ wv)


def _block_bundle(name):
    if name in _BLOCK_BUNDLES:
        return _BLOCK_BUNDLES[name]
    inputs = _DIFF._block_inputs()
    if name == "python_ast":
        fe = get_frontend("python_ast")
        cfg = OffloadConfig(repeats=1, **CPU)
        program = fe.normalize_target(_DIFF.BLOCK_SRC, inputs, cfg)
        graph = fe.build_graph(program, inputs, cfg)
        bundle = fe.make_fitness(graph, program, inputs, cfg)
        ref = np.asarray(tast.Executor(program, {}, hoist_transfers=False,
                                       **CPU).run(**inputs)["out"])
        runner = lambda art: np.asarray(  # noqa: E731
            art.run(**inputs)["out"])
    elif name == "export":
        x, scale, wq, wk, wv = _f32(*(inputs[n] for n in
                                      ("x", "scale", "wq", "wk", "wv")))
        model = BlockStack(scale)
        args = (x, wq, wk, wv)
        fe = get_frontend("export")
        cfg = OffloadConfig(repeats=1, options={"example_args": args}, **CPU)
        graph = fe.build_graph(model, None, cfg)
        bundle = fe.make_fitness(graph, model, None, cfg)
        with torch.no_grad():
            ref = model(*args).numpy()

        def runner(sub):
            with torch.no_grad():
                return sub(*args).numpy()
    else:
        raise AssertionError(
            f"frontend {name!r} is registered but has no function-block "
            f"fixture: add one (or list it in _BLOCK_FREE) in "
            f"tests/test_torch_frontend_differential.py")
    coding = coding_from_graph(graph, exclude=bundle.claimed,
                               destinations=bundle.destinations)
    _BLOCK_BUNDLES[name] = dict(fe=fe, graph=graph, bundle=bundle,
                                coding=coding, inputs=inputs, ref=ref,
                                runner=runner)
    return _BLOCK_BUNDLES[name]


def _tx_block(x, scale, wq, wk, wv):
    """The torch twin of ``BLOCK_SRC``: rmsnorm, q/k/v projections, causal
    attention."""
    xn = _tx_rms_app(x, scale)
    return _ATTENTION(xn @ wq, xn @ wk, xn @ wv)


def _block_values(coding, graph, gene):
    blocks = [r for r in graph.regions if r.meta.get("block_members")]
    assert blocks, "attention stack must yield a function-block region"
    fb = blocks[0]
    values = tuple(gene if s.region == fb.name else 0 for s in coding.sites)
    return values, fb


@pytest.mark.parametrize("name", sorted(frontend_names()))
def test_block_genes_uniform_across_frontends(name):
    if name in _BLOCK_FREE:
        res = _plan(name)
        assert all(not s.members for s in res.coding.sites)
        return
    b = _block_bundle(name)
    coding, graph = b["coding"], b["graph"]
    values, fb = _block_values(coding, graph, 1)
    site = next(s for s in coding.sites if s.region == fb.name)
    assert site.members == tuple(fb.meta["block_members"])
    assert len(site.members) >= 2, "a block spans several regions"
    # an active block gene claims its members
    assert coding.claimed_members(values) == frozenset(site.members)
    decoded = coding.decode(values)
    assert decoded[fb.name] != site.ref_impl
    for m in site.members:
        if m in decoded:
            assert decoded[m] == \
                next(s for s in coding.sites if s.region == m).ref_impl


@pytest.mark.parametrize("gene", [1, 2])
def test_block_variant_outputs_match_the_torch_twin(gene):
    b = _block_bundle("python_ast")
    values, fb = _block_values(b["coding"], b["graph"], gene)
    impl = b["coding"].decode(values)[fb.name]
    artifact = b["fe"].apply_plan(b["graph"], b["coding"], values,
                                  b["bundle"])
    assert artifact.report.substituted == {fb.name: impl}, \
        artifact.report.fallbacks
    out = artifact.run(**b["inputs"])["out"]
    np.testing.assert_allclose(out, b["ref"], rtol=RTOL, atol=ATOL)
    # the differential claim at block granularity: the block variant and
    # the same block written in torch compute the same numbers
    args = _f32(*(b["inputs"][n] for n in ("x", "scale", "wq", "wk", "wv")))
    with torch.no_grad():
        twin = _tx_block(*args).numpy()
    np.testing.assert_allclose(out, twin, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("gene", [1, 2])
def test_block_variant_outputs_match_python_vs_export(gene):
    """Twin of ``test_block_variant_outputs_match_python_vs_jaxpr``: both
    frontends bind the same block implementation for one gene value and
    compute the same numbers."""
    outs = {}
    for name in ("python_ast", "export"):
        b = _block_bundle(name)
        values, fb = _block_values(b["coding"], b["graph"], gene)
        impl = b["coding"].decode(values)[fb.name]
        artifact = b["fe"].apply_plan(b["graph"], b["coding"], values,
                                      b["bundle"])
        assert artifact.report.substituted.get(fb.name) == impl, \
            artifact.report.fallbacks
        out = b["runner"](artifact)
        np.testing.assert_allclose(out, b["ref"], rtol=RTOL, atol=ATOL)
        outs[name] = (impl, out)
    assert outs["python_ast"][0] == outs["export"][0]
    np.testing.assert_allclose(outs["python_ast"][1], outs["export"][1],
                               rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# contract 5: measured GA on the python_ast frontend picks a real variant
# ---------------------------------------------------------------------------


def test_python_ast_ga_selects_measured_variant():
    """Under measured wall-clock fitness the GA assigns a non-cpu variant
    destination (gpu_fused / gpu_kernel) to the matched site, the artifact
    verifies, and the report names the variant."""
    src, consts, inputs_fn, _, pattern = PY_WORKLOADS["rmsnorm"]
    res = plan(src, inputs_fn(), config=OffloadConfig(
        ga=GAConfig(population=6, generations=2, seed=0), repeats=1,
        options={"consts": consts}, **CPU))
    assert res.frontend == "python_ast"
    assert res.coding.destinations == VARIANT_ALPHABET
    assert any(d in ("gpu_fused", "gpu_kernel")
               for d in res.destinations.values()), res.destinations
    assert res.verification["verified"]
    assert any(c.chosen in ("fused_torch", "cuda") and c.pattern == pattern
               for c in res.report.choices), res.report.choices
    assert res.artifact.report is res.report
    # and the interpreted path really was slower: measured speedup > 1
    assert res.speedup > 1.0
