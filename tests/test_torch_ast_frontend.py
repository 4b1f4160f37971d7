"""The port's Python-``ast`` frontend against the reference's on the CPU
(``device="cpu"``): the same region graph, the same offloadable loops
(including one excluded for a data-dependent ``if`` and one for an unknown
numpy name), executor outputs within 1e-5 of the reference's f32 outputs
for every single-loop offload pattern with identical transfer counts and
bytes (hoisting on and off), the same variant menus under the port's
names, each variant's output against the reference's variant, and the
same GA history and winner from the same seed under a deterministic
fitness.  The programs are ``SRC`` of ``tests/test_ast_frontend.py``, the
three workloads and ``BLOCK_SRC`` of ``tests/test_frontend_differential.py``
and the ``app`` of ``examples/python_offload_demo.py``."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core.frontends import ast_frontend as jast  # noqa: E402
from repro_torch.core.frontends import ast_frontend as tast  # noqa: E402
from repro_torch.core.frontends.registry import (OffloadConfig,  # noqa: E402
                                                 detect_frontend,
                                                 get_frontend)
from repro_torch.core.ga import Evaluation, GAConfig  # noqa: E402
from repro_torch.core.genes import VARIANT_ALPHABET, coding_from_graph  # noqa: E402
from repro_torch.core.ir import Region, RegionGraph  # noqa: E402
from repro_torch.core.offload import Offloader  # noqa: E402
from repro_torch.core.transfer_planner import plan_transfers  # noqa: E402
from repro_torch.core.verifier import verify  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_AST = _load("_ref_ast_suite", ROOT / "tests" / "test_ast_frontend.py")
_DIFF = _load("_ref_diff_suite", ROOT / "tests" / "test_frontend_differential.py")
_DEMO = _load("_ref_py_demo", ROOT / "examples" / "python_offload_demo.py")

RTOL = ATOL = _DIFF.RTOL      # the suite's matched tolerances (2e-2)
F32_TOL = 1e-5                # where both packages compute in f32
#: the reference's variant names -> the port's
VARIANT_NAMES = {"fused_jnp": "fused_torch", "pallas": "cuda",
                 "block_chunked": "block_chunked",
                 "block_fused": "block_fused"}
DEMO_CONSTS = {"n": 8, "m": 8, "k": 8, "iters": 5, "fftn": 16}


def _src_inputs():
    rng = np.random.default_rng(0)
    return dict(a=rng.random((12, 12)), b=rng.random((12, 12)),
                x=rng.random(12))


def _demo_inputs():
    rng = np.random.default_rng(0)
    return dict(a=rng.random((8, 8)), b=rng.random((8, 8)), x=rng.random(8),
                sig_re=rng.random(16), sig_im=rng.random(16))


#: program -> (source, consts, inputs maker)
PROGRAMS = {
    "src": (_AST.SRC, _AST.CONSTS, _src_inputs),
    **{name: (w[0], w[1], w[2]) for name, w in _DIFF.PY_WORKLOADS.items()},
    "block": (_DIFF.BLOCK_SRC, None, _DIFF._block_inputs),
    "demo": (_DEMO.SRC, DEMO_CONSTS, _demo_inputs),
}

UNOFFLOADABLE_IF = """
def app(xs, n):
    out = np.zeros((n,))
    total = 0.0
    for i in range(n):
        if xs[i] > 0.5:      # data-dependent branch: untraceable
            total = total + xs[i]
        out[i] = total
    return out
"""

UNKNOWN_NAME = """
def app(xs, n):
    out = np.zeros((n,))
    for i in range(n):
        out[i] = np.real_if_close(xs[i])   # numpy has it; jnp does not
    acc = 0.0
    for i in range(n):
        acc = acc + np.abs(xs[i])
    return out, acc
"""


def _programs(name):
    src, consts, _ = PROGRAMS[name]
    return (jast.PyProgram(src, consts=consts),
            tast.PyProgram(src, consts=consts))


_CHECKED: dict = {}


def _checked(name):
    """Both packages' programs after ``check_offloadable`` (cached: the
    programs keep their compiled loops, which the reference builds with
    ``jax.jit``), the reference's offloadable loops and the inputs."""
    if name not in _CHECKED:
        jp, tp = _programs(name)
        inputs = PROGRAMS[name][2]()
        ok = jp.check_offloadable(inputs)
        assert tp.check_offloadable(inputs, device="cpu") == ok
        _CHECKED[name] = (jp, tp, ok, inputs)
    return _CHECKED[name]


def _region_key(r):
    return (r.name, r.kind, r.depth, r.parent, r.defs, r.uses, r.callees,
            r.feature_vector, r.alternatives, r.trip_count)


# ---------------------------------------------------------------------------
# analysis and feasibility
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_graph_matches_reference(name):
    jp, tp = _programs(name)
    assert tp.graph.frontend == jp.graph.frontend == "python_ast"
    assert tp.output_names == jp.output_names
    assert tp.arg_names == jp.arg_names
    assert [_region_key(r) for r in tp.graph.regions] == \
        [_region_key(r) for r in jp.graph.regions]


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_offloadable_set_matches_reference(name):
    jp, tp, ok, _ = _checked(name)
    assert [r.name for r in tp.graph.loops() if r.offloadable] == ok
    assert {r.name for r in tp.graph.loops() if "offload_error" in r.meta} \
        == {r.name for r in jp.graph.loops() if "offload_error" in r.meta}


def test_data_dependent_if_and_unknown_name_leave_the_gene():
    xs = np.asarray([0.1, 0.9, 0.2, 0.8])
    for src in (UNOFFLOADABLE_IF, UNKNOWN_NAME):
        jp = jast.PyProgram(src, consts={"n": 4})
        tp = tast.PyProgram(src, consts={"n": 4})
        ok = tp.check_offloadable({"xs": xs}, device="cpu")
        assert ok == jp.check_offloadable({"xs": xs})
    # the if-loop leaves on concretization, the name loop on the namespace
    tp = tast.PyProgram(UNOFFLOADABLE_IF, consts={"n": 4})
    assert tp.check_offloadable({"xs": xs}, device="cpu") == []
    assert "concretization" in tp.graph.loops()[0].meta["offload_error"]
    tp = tast.PyProgram(UNKNOWN_NAME, consts={"n": 4})
    assert tp.check_offloadable({"xs": xs}, device="cpu") == \
        [tp.graph.loops()[1].name]
    assert "real_if_close" in tp.graph.loops()[0].meta["offload_error"]


def test_namespace_makes_f32_on_its_device_and_refuses_unknown_names():
    ns = tast.TorchNumpy(torch.device("cpu"))
    z = ns.zeros((2, 3))
    assert z.dtype == torch.float32 and z.shape == (2, 3)
    assert ns.exp(1.0).dtype == torch.float32            # a Python scalar
    assert float(ns.sqrt(4)) == 2.0
    assert ns.fft.fft(torch.ones(4)).dtype == torch.complex64
    with pytest.raises(AttributeError):
        ns.not_a_numpy_function
    assert tast.device_value(np.zeros(3), torch.device("cpu")).dtype \
        == torch.float32
    assert tast.device_value(np.arange(3), torch.device("cpu")).dtype \
        == torch.int32


# ---------------------------------------------------------------------------
# the executor: outputs and transfer accounting
# ---------------------------------------------------------------------------


def _patterns(ok):
    return [{}] + [{k: "jit"} for k in ok]


def _reads_enclosing_target(program, impl) -> bool:
    """Whether a loop offloaded in ``impl`` reads the target of a loop
    around it (which then stays interpreted)."""
    g = program.graph
    for name in impl:
        r = g.by_name(name)
        p = r.parent
        while p is not None:
            target = program._find_loop(p).loop.target
            if getattr(target, "id", None) in r.uses:
                return True
            p = g.by_name(p).parent
    return False


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_executor_outputs_and_transfers_match_reference(name):
    """Every single-loop offload pattern (and none), hoisting on
    and off: the same ExecStats and outputs within 1e-5 of the
    reference's.  Two faults of the reference's executor are not copied:
    its hoisting reuses the first device copy of an enclosing interpreted
    loop's target, so a nested offloaded loop reads a stale index (there
    the port re-uploads the index: its unhoisted counts equal the
    reference's, hoisting still saves uploads, and its outputs are the
    interpreted program's); and ``np.asarray`` of a jax array is
    read-only, so an interpreted write after an offloaded loop raises
    (there the port gives the interpreted program's outputs)."""
    jp, tp, ok, inputs = _checked(name)
    names = jp.output_names
    interp = jast.Executor(jp, {}).outputs(
        jast.Executor(jp, {}).run(**inputs), names)
    matched = 0
    for impl in _patterns(ok):
        stale = _reads_enclosing_target(tp, impl)
        ports = {}
        for hoist in (False, True):
            tex = tast.Executor(tp, impl, hoist_transfers=hoist,
                                device="cpu")
            got = tex.outputs(tex.run(**inputs), names)
            ports[hoist] = tex.stats
            for n in names:
                np.testing.assert_allclose(got[n], interp[n], rtol=F32_TOL,
                                           atol=F32_TOL,
                                           err_msg=f"{impl} {n}")
            jex = jast.Executor(jp, impl, hoist_transfers=hoist)
            try:
                want = jex.outputs(jex.run(**inputs), names)
            except ValueError as e:          # the read-only host copy
                assert "read-only" in str(e)
                continue
            assert (tex.stats.d2h, tex.stats.d2h_bytes) == \
                (jex.stats.d2h, jex.stats.d2h_bytes), (impl, hoist)
            if hoist and stale:
                assert ports[True].h2d <= ports[False].h2d
                continue
            assert dataclasses.asdict(tex.stats) == \
                dataclasses.asdict(jex.stats), (impl, hoist)
            for n in names:
                np.testing.assert_allclose(got[n], want[n], rtol=F32_TOL,
                                           atol=F32_TOL,
                                           err_msg=f"{impl} {n}")
            matched += 1
    assert matched >= len(ok) + 1


def test_transfer_hoisting_and_planner_directions():
    tp = tast.PyProgram(_AST.SRC, consts=_AST.CONSTS)
    inputs = _src_inputs()
    ok = tp.check_offloadable(inputs, device="cpu")
    inner = [r for r in tp.graph.loops() if r.parent is not None][0].name
    hoisted = tast.Executor(tp, {inner: "jit"}, device="cpu")
    hoisted.run(**inputs)
    naive = tast.Executor(tp, {inner: "jit"}, hoist_transfers=False,
                          device="cpu")
    naive.run(**inputs)
    assert hoisted.stats.h2d <= naive.stats.h2d / 2
    impl = {k: "jit" for k in ok if tp.graph.by_name(k).parent is None}
    plan = plan_transfers(tp.graph, impl, hoist=True)
    assert {"a", "b", "x"} <= {t.var for t in plan.transfers
                               if t.direction == "h2d"}


def test_offloaded_loop_does_not_write_its_inputs():
    """REC_SRC writes into its input ``h``: the loop clones it, so the
    host input and the hoisted device copy keep their values."""
    src, consts, inputs_fn, _, _ = _DIFF.PY_WORKLOADS["recurrence"]
    tp = tast.PyProgram(src.replace("out[t][c] = h[c]", "out[t, c] = h[c]"),
                        consts=consts)
    inputs = inputs_fn()
    inputs["h"] = inputs["h"] + 0.5
    h_before = inputs["h"].copy()
    assert tp.check_offloadable(inputs, device="cpu") == ["loop_1", "loop_2"]
    ex = tast.Executor(tp, {"loop_1": "jit"}, device="cpu")
    env = ex.run(**inputs)
    np.testing.assert_array_equal(inputs["h"], h_before)
    want = tast.Executor(tp, {}, device="cpu").run(**inputs)
    np.testing.assert_allclose(ex.outputs(env, ["out"])["out"], want["out"],
                               rtol=F32_TOL, atol=F32_TOL)


# ---------------------------------------------------------------------------
# the frontend: variant menus, variants, GA history
# ---------------------------------------------------------------------------

_BUNDLES: dict = {}


def _bundles(name):
    if name in _BUNDLES:
        return _BUNDLES[name]
    src, consts, inputs_fn = PROGRAMS[name]
    inputs = inputs_fn()
    options = {"consts": consts} if consts else {}
    out = []
    for fe, cfg, coding_of in (
            (jcore.get_frontend("python_ast"),
             jcore.OffloadConfig(repeats=1, options=options),
             jcore.coding_from_graph),
            (get_frontend("python_ast"),
             OffloadConfig(repeats=1, device="cpu", options=options),
             coding_from_graph)):
        program = fe.normalize_target(src, inputs, cfg)
        graph = fe.build_graph(program, inputs, cfg)
        bundle = fe.make_fitness(graph, program, inputs, cfg)
        coding = coding_of(graph, exclude=bundle.claimed,
                           destinations=bundle.destinations or ("cpu", "gpu"))
        out.append((fe, graph, bundle, coding))
    _BUNDLES[name] = (out[0], out[1], inputs)
    return _BUNDLES[name]


def _mapped(names):
    return tuple(VARIANT_NAMES.get(n, n) for n in names)


VARIANT_PROGRAMS = ("attention", "block", "recurrence", "rmsnorm")


@pytest.mark.parametrize("name", VARIANT_PROGRAMS + ("src",))
def test_variant_menus_match_reference(name):
    (_, jg, jb, jc), (_, tg, tb, tc), _ = _bundles(name)
    if jb.destinations is None:
        assert tb.destinations is None
    else:
        assert tb.destinations == VARIANT_ALPHABET
    assert tb.claimed == jb.claimed
    assert tb.base_impl == jb.base_impl
    assert [(s.region, s.impls, s.members) for s in tc.sites] == \
        [(s.region, _mapped(s.impls), s.members) for s in jc.sites]
    for key in ("variant_sites", "block_sites"):
        assert {r: sorted(m if key == "variant_sites" else m["menu"])
                for r, m in tb.context[key].items()} == \
            {r: sorted(_mapped(m if key == "variant_sites" else m["menu"]))
             for r, m in jb.context[key].items()}
    assert {r: sorted(f) for r, f in tb.context["variant_fallbacks"].items()} \
        == {r: sorted(f) for r, f in jb.context["variant_fallbacks"].items()}
    assert sorted(tb.context["lib_calls"]) == sorted(jb.context["lib_calls"])


VARIANT_CASES = [(n, g) for n in VARIANT_PROGRAMS for g in (1, 2)]


@pytest.mark.parametrize("name,gene", VARIANT_CASES)
def test_each_variant_matches_the_reference_variant(name, gene):
    """Gene ``gene`` on the matched site (the function block where there is
    one), every other site on its reference: the same substitution under
    the mapped names, and outputs within the suite's tolerance of the
    reference program and within 1e-5 of the reference's variant (both
    compute in f32)."""
    (jfe, jg, jb, jc), (tfe, tg, tb, tc), inputs = _bundles(name)
    target = [s.region for s in tc.sites if s.members] or \
        [s.region for s in tc.sites if tg.by_name(s.region).meta.get("pattern")]
    values = tuple(gene if s.region == target[0] else 0 for s in tc.sites)
    jart = jfe.apply_plan(jg, jc, values, jb)
    tart = tfe.apply_plan(tg, tc, values, tb)
    assert tart.report.substituted == {
        r: VARIANT_NAMES[v] for r, v in jart.report.substituted.items()}
    assert len(tart.report.substituted) == 1
    want = jart.run(**inputs)
    got = tart.run(**inputs)
    ref = jast.Executor(jart.program, {}).run(**inputs)
    for n in want:
        np.testing.assert_allclose(got[n], np.asarray(ref[n]), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got[n], want[n], rtol=F32_TOL,
                                   atol=F32_TOL)


def test_library_adapters_match_reference():
    """The demo's matmul nest and DFT: the block pass claims both, and the
    torch.matmul / torch.fft adapters agree with the reference's."""
    (jfe, jg, jb, jc), (tfe, tg, tb, tc), inputs = _bundles("demo")
    jlib = {r: e["lib"] for r, e in jb.context["lib_calls"].items()
            if "lib" in e}
    tlib = {r: e["lib"] for r, e in tb.context["lib_calls"].items()
            if "lib" in e}
    assert [(bo.region, bo.pattern) for bo in tb.block.offloads] == \
        [(bo.region, bo.pattern) for bo in jb.block.offloads]
    libs = [bo for bo in tb.block.offloads if bo.pattern in tast._AST_ADAPTERS]
    assert sorted(bo.pattern for bo in libs) == ["fft", "matmul"]
    prog = tast.PyProgram(_DEMO.SRC, consts=DEMO_CONSTS)
    jprog = jast.PyProgram(_DEMO.SRC, consts=DEMO_CONSTS)
    snaps, jsnaps = {}, {}
    ex = tast.Executor(prog, {}, device="cpu")
    ex.pre_loop_hook = lambda n, env: snaps.setdefault(n, dict(env))
    ex.run(**inputs)
    jex = jast.Executor(jprog, {})
    jex.pre_loop_hook = lambda n, env: jsnaps.setdefault(n, dict(env))
    jex.run(**inputs)
    for bo in libs:
        region = bo.region
        fn, ins, outs = tast._AST_ADAPTERS[bo.pattern](
            prog.graph.by_name(region), snaps[region], prog.source)
        jfn, jins, jouts = jast._AST_ADAPTERS[bo.pattern](
            jprog.graph.by_name(region), jsnaps[region], jprog.source)
        assert (ins, outs) == (jins, jouts)
        got = fn(*[tast.device_value(snaps[region][v], torch.device("cpu"))
                   for v in ins])
        want = jfn(*[np.asarray(jsnaps[region][v], np.float32) for v in ins])
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=F32_TOL,
                                       atol=F32_TOL)
    assert sorted(tlib) == sorted(jlib)


def _det_fitness(evaluation, favour_offload: bool):
    """The suite's ``_det_fitness`` (``favour_offload=False``) and its
    mirror image, building ``evaluation`` records of either package."""
    sign = -1.0 if favour_offload else 1.0

    def fit(values):
        t = 1.5 + sign * 0.05 * sum(int(v) * (i + 1)
                                    for i, v in enumerate(values))
        return evaluation(tuple(values), t, True)
    return fit


def _search(offload, offloader_cls, cfg, planned, inputs):
    """One GA search over a prepared bundle (both packages' ``Offloader.
    search``), as ``Offloader.plan`` runs it after ``prepare``."""
    fe, graph, bundle, coding = planned
    ctx = offload.PlanContext(
        frontend="python_ast", target=bundle.context["program"],
        inputs=inputs, config=cfg, graph=graph, bundle=bundle, coding=coding,
        fingerprint=offload.search_fingerprint(graph, coding, bundle.claimed,
                                               bundle.cache_extra))
    return offloader_cls(cfg).search(ctx)


@pytest.mark.parametrize("favour", [False, True])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_ga_history_matches_reference(name, favour):
    import repro.core.offload as joffload
    import repro_torch.core.offload as toffload

    jplanned, tplanned, inputs = _bundles(name)
    jres = _search(joffload, jcore.Offloader, jcore.OffloadConfig(
        ga=jcore.GAConfig(population=6, generations=2, seed=5),
        fitness_fn=_det_fitness(jcore.Evaluation, favour), repeats=1),
        jplanned, inputs)
    tres = _search(toffload, Offloader, OffloadConfig(
        ga=GAConfig(population=6, generations=2, seed=5),
        fitness_fn=_det_fitness(Evaluation, favour), repeats=1,
        device="cpu"), tplanned, inputs)
    assert [(h["best_time_s"], h["mean_time_s"]) for h in tres.ga.history] \
        == [(h["best_time_s"], h["mean_time_s"]) for h in jres.ga.history]
    assert tuple(tres.best.bits) == tuple(jres.best.bits)
    assert tres.pattern == {r: VARIANT_NAMES.get(str(i), i)
                            for r, i in jres.pattern.items()}
    assert tres.report.substituted == {
        r: VARIANT_NAMES.get(v, v) for r, v in jres.report.substituted.items()}
    if favour and tplanned[3].length:
        assert any(tres.best.bits)


def test_plan_end_to_end_matches_reference():
    """``Offloader.plan`` on a source string, prepare included."""
    src, consts, inputs_fn = PROGRAMS["rmsnorm"]
    inputs = inputs_fn()
    jres = jcore.Offloader(jcore.OffloadConfig(
        ga=jcore.GAConfig(population=6, generations=2, seed=5),
        fitness_fn=_det_fitness(jcore.Evaluation, True), repeats=1,
        options={"consts": consts})).plan(src, inputs)
    tres = Offloader(OffloadConfig(
        ga=GAConfig(population=6, generations=2, seed=5),
        fitness_fn=_det_fitness(Evaluation, True), repeats=1, device="cpu",
        options={"consts": consts})).plan(src, inputs)
    assert tres.frontend == jres.frontend == "python_ast"
    assert [h["best_time_s"] for h in tres.ga.history] == \
        [h["best_time_s"] for h in jres.ga.history]
    assert tres.destinations == {r: {"gpu_pallas": "gpu_kernel"}.get(d, d)
                                 for r, d in jres.destinations.items()}


# ---------------------------------------------------------------------------
# the pipeline around it
# ---------------------------------------------------------------------------


def test_detect_frontend_routes_python_source_and_graphs():
    cfg = OffloadConfig()
    assert detect_frontend(_AST.SRC, cfg) == "python_ast"
    assert detect_frontend(tast.PyProgram(_AST.SRC), cfg) == "python_ast"
    assert detect_frontend(lambda x: x, cfg) == "python_ast"
    assert detect_frontend(lambda x: x, OffloadConfig(
        options={"example_args": (torch.zeros(1),)})) == "export"
    assert detect_frontend(RegionGraph([Region("r", "loop")], "ir"),
                           cfg) == "ir"
    with pytest.raises(TypeError, match="pass OffloadConfig.frontend"):
        detect_frontend(3, cfg)


def test_plan_runs_on_cuda_unless_asked_and_raises_without_it(monkeypatch):
    src, consts, inputs_fn, _, _ = _DIFF.PY_WORKLOADS["rmsnorm"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Offloader(OffloadConfig(options={"consts": consts})).plan(
            src, inputs_fn())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tast.Executor(tast.PyProgram(src, consts=consts), {})


def test_measured_plan_picks_a_variant_and_verifies():
    """The measured wall-clock GA on the CPU: the matched site leaves the
    interpreter, the artifact verifies and reproduces the program."""
    src, consts, inputs_fn, out, pattern = _DIFF.PY_WORKLOADS["rmsnorm"]
    inputs = inputs_fn()
    res = Offloader(OffloadConfig(
        ga=GAConfig(population=6, generations=2, seed=0), repeats=1,
        device="cpu", options={"consts": consts})).plan(src, inputs)
    assert res.coding.destinations == VARIANT_ALPHABET
    assert res.verification["verified"]
    assert any(d in ("gpu_fused", "gpu_kernel")
               for d in res.destinations.values()), res.destinations
    assert res.speedup > 1.0
    ref = tast.Executor(res.artifact.program, {}, device="cpu").run(**inputs)
    got = res.artifact.run(**inputs)
    assert isinstance(got[out], np.ndarray)
    np.testing.assert_allclose(got[out], ref[out], rtol=RTOL, atol=ATOL)
    # the verifier takes the numpy leaves this path returns, a 0-d one too
    assert verify({"o": ref[out], "s": np.float64(2.0)},
                  {"o": got[out], "s": np.asarray(2.0, np.float32)}).ok
    assert not verify({"o": ref[out]}, {"o": got[out] + 1.0}).ok


def test_apply_plan_is_a_pure_artifact(monkeypatch):
    (_, _, _, _), (tfe, tg, tb, tc), inputs = _bundles("rmsnorm")

    def refuse(*a, **k):
        raise AssertionError("apply_plan ran the program")

    monkeypatch.setattr(tast.Executor, "run", refuse)
    art = tfe.apply_plan(tg, tc, (2,) * tc.length, tb)
    assert art.impl == {tc.sites[0].region: "cuda"}
    assert art.device == torch.device("cpu")
