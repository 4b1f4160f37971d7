"""The port's journal-fitted surrogate (``repro_torch.core.surrogate``) and
compile-parallel / time-serial phase: twins of ``tests/test_surrogate.py``,
and the port against the reference on the same journal rows and twin
``ir`` graphs -- the same fitted coefficients and the same leave-one-out
and held-out rank correlations to 1e-9, the same ``ga_search`` choice of
surrogate."""
import pytest

pytest.importorskip("torch")

import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402

import numpy as np  # noqa: E402

from repro.core import evaluator as jev  # noqa: E402
from repro.core import ga as jga  # noqa: E402
from repro.core import genes as jgenes  # noqa: E402
from repro.core import ir as jir  # noqa: E402
from repro.core import offload as joff  # noqa: E402
from repro.core import surrogate as jsur  # noqa: E402
from repro_torch.core.evaluator import (Evaluator,  # noqa: E402
                                        transfer_cost_surrogate)
from repro_torch.core.ga import Evaluation, GAConfig, run_ga  # noqa: E402
from repro_torch.core.genes import coding_from_graph  # noqa: E402
from repro_torch.core.ir import Region, RegionGraph  # noqa: E402
from repro_torch.core.offload import (ga_search, phenotype_key,  # noqa: E402
                                      search_fingerprint)
from repro_torch.core.surrogate import (SURROGATE_FIT_FILE,  # noqa: E402
                                        FeatureExtractor, fit_surrogate,
                                        load_fit, spearman_rank_corr)


def _graph(n=5, mod=None):
    R, G = (mod.Region, mod.RegionGraph) if mod else (Region, RegionGraph)
    return G([
        R(f"r{i}", "loop", uses=frozenset({f"v{i}"}),
          defs=frozenset({f"v{i}"}), offloadable=True,
          alternatives=("ref", "kernel"), trip_count=2 + i)
        for i in range(n)], "ir", "surrogate-test")


#: per-site effects the hand formula cannot see: r1's offload is slow,
#: r3's is very fast — transfer counts alone misrank these patterns
_W = (0.05, 0.9, -0.1, -0.6, -0.05)


def _site_effect_fitness(bits, mod=None):
    t = 1.0 + sum(w * b for w, b in zip(_W, bits))
    return (mod.Evaluation if mod else Evaluation)(tuple(bits), t, True)


def _seed_journal(cache_dir, fingerprint="fp", n=40, seed=0):
    g = _graph()
    ev = Evaluator(_site_effect_fitness, cache_dir=str(cache_dir),
                   fingerprint=fingerprint)
    rng = np.random.default_rng(seed)
    ev.evaluate_batch([tuple(int(x) for x in rng.integers(0, 2, 5))
                       for _ in range(n)])
    return g


# ---------------------------------------------------------------------------
# spearman helper
# ---------------------------------------------------------------------------


def test_spearman_rank_corr_basics():
    assert spearman_rank_corr([1, 2, 3, 4], [10, 20, 30, 40]) \
        == pytest.approx(1.0)
    assert spearman_rank_corr([1, 2, 3, 4], [40, 30, 20, 10]) \
        == pytest.approx(-1.0)
    assert math.isnan(spearman_rank_corr([1, 2], [1, 2]))       # too few
    assert math.isnan(spearman_rank_corr([1, 1, 1], [1, 2, 3]))  # constant


def test_spearman_rank_corr_equals_the_reference_with_ties():
    r = np.random.default_rng(3)
    a = r.integers(0, 5, 40).astype(float)      # many ties
    b = r.normal(size=40)
    assert spearman_rank_corr(a, b) == jsur.spearman_rank_corr(a, b)


# ---------------------------------------------------------------------------
# the fit
# ---------------------------------------------------------------------------


def test_fitted_surrogate_outranks_static_on_synthetic_journal(tmp_path):
    g = _seed_journal(tmp_path)
    coding = coding_from_graph(g)
    static = transfer_cost_surrogate(g, coding)
    fit = fit_surrogate(g, coding, str(tmp_path), "fp", prior=static,
                        min_records=10)
    assert fit is not None
    assert math.isfinite(fit.rank_corr)
    assert fit.rank_corr > fit.static_rank_corr
    assert fit.beats_static
    scores = [fit(bits) for bits in
              [(0, 0, 0, 0, 0), (0, 1, 0, 0, 0), (0, 0, 0, 1, 0)]]
    assert scores[1] > scores[0] > scores[2]  # slow r1 last, fast r3 first


@pytest.mark.parametrize("n", [10, 40])
def test_fit_equals_the_reference_on_the_same_journal(tmp_path, n):
    """The reference's engine writes the journal; both packages fit it on
    twin graphs: the same rows, coefficients, intercept, standardization
    and rank correlations to 1e-9 relative (n = 10: leave-one-out; n = 40:
    every 4th row held out)."""
    jg = _graph(mod=jir)
    jcoding = jgenes.coding_from_graph(jg)
    ev = jev.Evaluator(lambda b: _site_effect_fitness(b, jga),
                       cache_dir=str(tmp_path), fingerprint="fp")
    rng = np.random.default_rng(1)
    ev.evaluate_batch([tuple(int(x) for x in rng.integers(0, 2, 5))
                       for _ in range(n)])
    ref = jsur.fit_surrogate(jg, jcoding, str(tmp_path), "fp",
                             min_records=5, persist=False)
    g = _graph()
    got = fit_surrogate(g, coding_from_graph(g), str(tmp_path), "fp",
                        min_records=5, persist=False)
    assert ref is not None and got is not None
    assert (got.n_records, got.n_val) == (ref.n_records, ref.n_val)
    assert got.extractor.feature_names == ref.extractor.feature_names
    for name in ("coef", "mean", "scale"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=1e-9, atol=0)
    assert got.intercept == pytest.approx(ref.intercept, rel=1e-9)
    for name in ("rank_corr", "static_rank_corr"):
        a, b = getattr(got, name), getattr(ref, name)
        assert (math.isnan(a) and math.isnan(b)) or \
            a == pytest.approx(b, rel=1e-9), name
    bits = (0, 1, 1, 0, 1)
    assert got(bits) == pytest.approx(ref(bits), rel=1e-9)


def test_fit_abstains_below_min_records(tmp_path):
    g = _seed_journal(tmp_path, n=4)
    coding = coding_from_graph(g)
    assert fit_surrogate(g, coding, str(tmp_path), "fp",
                         min_records=10) is None
    assert fit_surrogate(g, coding, str(tmp_path), "other",
                         min_records=10) is None


def test_fit_ignores_foreign_and_invalid_journal_rows(tmp_path):
    g = _seed_journal(tmp_path, n=20)
    coding = coding_from_graph(g)
    ev = Evaluator(lambda b: Evaluation(tuple(b), float("inf"), False),
                   cache_dir=str(tmp_path), fingerprint="fp2")
    ev.evaluate_batch([(1, 0, 0, 0, 0), (0, 1, 0, 0, 0), (0, 0, 1, 0, 0)])
    assert fit_surrogate(g, coding, str(tmp_path), "fp2",
                         min_records=3) is None   # invalid rows don't count


def test_coefficient_persistence_round_trip(tmp_path):
    g = _seed_journal(tmp_path)
    coding = coding_from_graph(g)
    fit = fit_surrogate(g, coding, str(tmp_path), "fp", min_records=10)
    assert os.path.exists(os.path.join(str(tmp_path), SURROGATE_FIT_FILE))
    rec = load_fit(str(tmp_path), "fp")
    assert rec is not None
    assert rec["n_records"] == fit.n_records
    assert rec["rank_corr"] == pytest.approx(fit.rank_corr)
    assert rec["static_rank_corr"] == pytest.approx(fit.static_rank_corr)
    assert rec["feature_names"] == list(fit.extractor.feature_names)
    assert rec["coefficients"] == pytest.approx(fit.coefficients())
    assert load_fit(str(tmp_path), "unknown") is None
    fit2 = fit_surrogate(g, coding, str(tmp_path), "fp", min_records=10)
    rec2 = load_fit(str(tmp_path), "fp")
    assert rec2["n_records"] == fit2.n_records
    # the reference reads the port's record: one file format
    assert jsur.load_fit(str(tmp_path), "fp")["coef"] == rec2["coef"]


def test_feature_extractor_names_align_with_vector(tmp_path):
    g = _graph()
    coding = coding_from_graph(g)
    fx = FeatureExtractor(g, coding, prior=lambda b: 0.0)
    vec = fx(coding.all_on())
    assert len(vec) == len(fx.feature_names)
    named = dict(zip(fx.feature_names, vec))
    assert named["offload_trips"] > 0          # all-on offloads everything
    assert named["dest1"] == coding.length
    assert named["site0@1"] == 1.0


def test_feature_extractor_equals_the_reference_on_a_block_site():
    """Block features (active blocks, claimed members) on twin graphs with
    one function-block site."""
    def graph(mod):
        rs = [mod.Region(f"r{i}", "loop", uses=frozenset({f"v{i}"}),
                         defs=frozenset({f"v{i}"}), offloadable=True,
                         alternatives=("ref", "kernel"), trip_count=3)
              for i in range(3)]
        rs.append(mod.Region("fnblock_0", "block", offloadable=True,
                             alternatives=("ref", "block_fused"),
                             meta={"block_members": ("r0", "r1")}))
        return mod.RegionGraph(rs, "ir", "blocks")
    jg, g = graph(jir), graph(__import__("repro_torch.core.ir",
                                         fromlist=["x"]))
    jc, c = jgenes.coding_from_graph(jg), coding_from_graph(g)
    jfx = jsur.FeatureExtractor(jg, jc, prior=lambda b: 0.0)
    fx = FeatureExtractor(g, c, prior=lambda b: 0.0)
    for bits in ((0, 0, 0, 0), (1, 1, 0, 1), (0, 1, 1, 0), (1, 1, 1, 1)):
        np.testing.assert_array_equal(fx(bits), jfx(bits))
    named = dict(zip(fx.feature_names, fx((1, 1, 0, 1))))
    assert named["block_active"] == 1.0 and named["block_claimed"] == 2.0


# ---------------------------------------------------------------------------
# ga_search selection: screening improves with every search
# ---------------------------------------------------------------------------


def test_ga_search_prefers_fitted_surrogate_when_it_ranks_better(tmp_path):
    g = _graph()
    cfg = dict(population=8, generations=5, cache_dir=str(tmp_path))
    _, ga1 = ga_search(g, _site_effect_fitness, GAConfig(seed=0, **cfg))
    assert ga1.surrogate_kind == "static"      # no journal yet at build time
    _, ga2 = ga_search(g, _site_effect_fitness, GAConfig(seed=1, **cfg))
    assert ga2.surrogate_kind == "fitted"
    assert ga2.surrogate_rank_corr > max(0.9, ga1.surrogate_rank_corr)
    fp = search_fingerprint(g, coding_from_graph(g))
    assert load_fit(str(tmp_path), fp) is not None
    with open(os.path.join(str(tmp_path), "search_meta.jsonl")) as f:
        kinds = [json.loads(line).get("kind") for line in f if line.strip()]
    assert "fitted" in kinds


def test_ga_search_surrogate_choice_equals_the_reference(tmp_path):
    """Two searches of one program, each package in its own directory:
    the same surrogate kind, rank correlation, best and history."""
    def runs(off, cfg_cls, g, fit, d):
        out = []
        for seed in (0, 1):
            _, ga = off.ga_search(g, fit, cfg_cls(
                population=8, generations=5, seed=seed, cache_dir=str(d)))
            out.append((ga.surrogate_kind, repr(ga.surrogate_rank_corr),
                        ga.best.bits, ga.evaluations,
                        [h["best_time_s"] for h in ga.history]))
        return out
    ref = runs(joff, jga.GAConfig, _graph(mod=jir),
               lambda b: _site_effect_fitness(b, jga), tmp_path / "ref")
    got = runs(__import__("repro_torch.core.offload", fromlist=["x"]),
               GAConfig, _graph(), _site_effect_fitness, tmp_path / "port")
    assert got == ref
    assert got[1][0] == "fitted"


def test_ga_search_fit_opt_out(tmp_path):
    g = _graph()
    cfg = dict(population=8, generations=5, cache_dir=str(tmp_path),
               fit_surrogate=False)
    ga_search(g, _site_effect_fitness, GAConfig(seed=0, **cfg))
    _, ga2 = ga_search(g, _site_effect_fitness, GAConfig(seed=1, **cfg))
    assert ga2.surrogate_kind == "static"


# ---------------------------------------------------------------------------
# compile-parallel / time-serial phase
# ---------------------------------------------------------------------------


class _DeterministicTwoPhase:
    """prepare/measure fitness with exact, timing-free Evaluations."""

    def __init__(self, delay=0.0):
        import time
        self._sleep = (lambda: time.sleep(delay)) if delay else (lambda: None)
        self.prepared: list[tuple] = []

    def prepare(self, bits):
        self._sleep()                 # stands in for the warm-up
        self.prepared.append(tuple(bits))
        return ("prepared", tuple(bits))

    def measure(self, prep):
        tag, bits = prep
        assert tag == "prepared"
        return Evaluation(bits, 1.0 + 0.1 * sum(bits), True,
                          {"phase": "two"})

    def __call__(self, bits):
        return self.measure(self.prepare(bits))


def test_overlapped_equals_serial_fitness_values():
    pop = [(i % 2, (i // 2) % 2, (i // 4) % 2) for i in range(8)]
    serial = Evaluator(_DeterministicTwoPhase(),
                       compile_workers=0).evaluate_batch(pop)
    ev = Evaluator(_DeterministicTwoPhase(delay=0.01), compile_workers=4)
    overlapped = ev.evaluate_batch(pop)
    assert [(r.bits, r.time_s, r.valid, r.detail) for r in serial] \
        == [(r.bits, r.time_s, r.valid, r.detail) for r in overlapped]
    assert ev.stats.overlapped_compiles == 8
    assert ev.stats.compile_serial_s > 0
    assert ev.stats.compile_wall_s > 0
    assert "compile_overlap_saved_s" in ev.stats.as_dict()


@pytest.mark.parametrize("workers", [0, 4])
def test_overlapped_ga_identical_to_serial_at_fixed_seed(workers):
    """run_ga with overlapped prepares, serially or with the thread pool,
    is the reference's serial search."""
    cfg = dict(population=10, generations=5, seed=3)

    class _Ref(_DeterministicTwoPhase):
        def measure(self, prep):
            _, bits = prep
            return jga.Evaluation(bits, 1.0 + 0.1 * sum(bits), True,
                                  {"phase": "two"})

    r_ref = jga.run_ga(4, _Ref(), jga.GAConfig(**cfg, compile_workers=0))
    r_ser = run_ga(4, _DeterministicTwoPhase(),
                   GAConfig(**cfg, compile_workers=0))
    r_ovl = run_ga(4, _DeterministicTwoPhase(delay=0.002),
                   GAConfig(**cfg, compile_workers=4, workers=workers))
    for r in (r_ser, r_ovl):
        assert r.best.bits == r_ref.best.bits
        assert r.best.time_s == r_ref.best.time_s
        assert [h["best_time_s"] for h in r.history] \
            == [h["best_time_s"] for h in r_ref.history]
        assert r.evaluations == r_ref.evaluations
    assert r_ovl.compile_overlap_saved_s >= 0.0


def test_overlap_prepare_failures_match_serial():
    class Flaky(_DeterministicTwoPhase):
        def prepare(self, bits):
            if sum(bits) == 2:        # deterministic "build error"
                return ("prepared", tuple(bits))
            return super().prepare(bits)

        def measure(self, prep):
            tag, bits = prep
            if sum(bits) == 2:
                return Evaluation(bits, float("inf"), False,
                                  {"error": "boom"})
            return super().measure(prep)

    pop = [(0, 0), (1, 0), (1, 1), (0, 1)]
    serial = Evaluator(Flaky(), compile_workers=0).evaluate_batch(pop)
    overlapped = Evaluator(Flaky(), compile_workers=4).evaluate_batch(pop)
    assert [(r.bits, r.time_s, r.valid) for r in serial] \
        == [(r.bits, r.time_s, r.valid) for r in overlapped]
    bad = next(r for r in overlapped if r.bits == (1, 1))
    assert not bad.valid and bad.detail["error"] == "boom"


def test_wallclock_two_phase_matches_call_semantics():
    from repro_torch.core.fitness import WallClockFitness

    calls = []

    def build(bits):
        calls.append(tuple(bits))
        if sum(bits) > 1:
            raise RuntimeError("no such kernel")
        return lambda: {"y": np.asarray([float(sum(bits))])}

    ref = {"y": np.asarray([0.0])}
    fit = WallClockFitness(build, reference_output=ref, repeats=1)
    direct = fit((1, 1))
    phased = fit.measure(fit.prepare((1, 1)))
    assert (direct.bits, direct.valid, direct.detail) \
        == (phased.bits, phased.valid, phased.detail)
    direct = fit((1, 0))
    phased = fit.measure(fit.prepare((1, 0)))
    assert not direct.valid and not phased.valid
    assert "verify" in direct.detail and "verify" in phased.detail
    ok = fit.measure(fit.prepare((0, 0)))
    assert ok.valid and math.isfinite(ok.time_s)


def test_serial_only_wallclock_overlap_keeps_workers_serial():
    """compile_workers must not activate the thread-parallel *timing* path:
    only prepare overlaps, measure order is batch order."""
    order = []

    class Ordered(_DeterministicTwoPhase):
        def measure(self, prep):
            order.append(prep[1])
            return super().measure(prep)

    pop = [(1, 0), (0, 1), (1, 1), (0, 0)]
    Evaluator(Ordered(), compile_workers=4).evaluate_batch(pop)
    assert order == pop               # strictly serial, in batch order


# ---------------------------------------------------------------------------
# resolution fallbacks fold into the phenotype key
# ---------------------------------------------------------------------------


def test_phenotype_key_folds_resolver_fallbacks():
    from repro_torch.core.genes import VARIANT_ALPHABET

    g = RegionGraph([
        Region("site", "loop", uses=frozenset({"a"}), defs=frozenset({"a"}),
               offloadable=True,
               alternatives=("ref", "fused_torch", "cuda"), trip_count=4),
    ], "ir", "resolve")
    coding = coding_from_graph(g, destinations=VARIANT_ALPHABET)

    def resolver(region, impl):       # both variants fall back to ref
        return "ref" if str(impl) in ("fused_torch", "cuda") else impl

    calls = []

    def fit(bits):
        calls.append(tuple(bits))
        return Evaluation(tuple(bits), 1.0, True)

    ev = Evaluator(fit, phenotype_key=phenotype_key(coding,
                                                    resolver=resolver))
    out = ev.evaluate_batch([(0,), (1,), (2,)])
    assert len(calls) == 1, "all three decode to the ref program"
    assert [r.bits for r in out] == [(0,), (1,), (2,)]
    calls2 = []

    def fit2(bits):
        calls2.append(tuple(bits))
        return Evaluation(tuple(bits), 1.0, True)

    Evaluator(fit2, phenotype_key=phenotype_key(coding)).evaluate_batch(
        [(0,), (1,), (2,)])
    assert len(calls2) == 3


def test_phenotype_key_resolver_errors_are_harmless():
    g = _graph(2)
    coding = coding_from_graph(g)

    def broken(region, impl):
        raise RuntimeError("resolver exploded")

    key = phenotype_key(coding, resolver=broken)
    assert key((0, 1)) == phenotype_key(coding)((0, 1))


def test_export_engine_resolved_impl_dedups_fallback_variants():
    """End to end on the export engine: a carry-only scan binds no variant,
    so every gene value resolves to ref; unmatched regions' genes are
    phenotype-inert."""
    import torch
    from torch._higher_order_ops.scan import scan

    from repro_torch.core.frontends.registry import (OffloadConfig,
                                                     get_frontend)

    def app(xs, w):
        def body(c, x):
            c = torch.tanh(c @ w) + x
            return c, c.clone()
        c, _ = scan(body, xs[0], xs)
        return c

    xs = torch.ones(3, 8, 8) * 0.5
    w = torch.ones(8, 8) * 0.1
    fe = get_frontend("export")
    cfg = OffloadConfig(device="cpu", repeats=1,
                        options={"example_args": (xs, w)})
    graph = fe.build_graph(app, None, cfg)
    bundle = fe.make_fitness(graph, app, None, cfg)
    assert bundle.impl_resolver is not None
    assert bundle.serial_only and bundle.overlap_compiles
    for region in graph.offloadable():
        chosen1 = bundle.impl_resolver(region.name, "fused_torch")
        chosen2 = bundle.impl_resolver(region.name, "cuda")
        assert isinstance(chosen1, str) and isinstance(chosen2, str)
        if not region.meta.get("pattern"):
            assert bundle.impl_resolver(region.name, "kernel") == "ref"
