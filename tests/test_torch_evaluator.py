"""The port's evaluation engine (``repro_torch.core.evaluator``): twins of
``tests/test_evaluator.py`` -- batched dispatch, the persistent measurement
cache, in-flight dedup under concurrency, duplicate-avoiding offspring,
surrogate pre-screening, search-meta decay, the compile-overlap backoff and
the measurement-journal bound -- plus the port against the reference: the
same ``run_ga`` and ``ga_search`` histories from the same seed and fitness,
serial against workers and with overlap against without, and the spawn
``ProcessPool``."""
import pytest

pytest.importorskip("torch")

import threading  # noqa: E402
import time  # noqa: E402
import types  # noqa: E402

from repro.core import evaluator as jev  # noqa: E402
from repro.core import ga as jga  # noqa: E402
from repro.core import ir as jir  # noqa: E402
from repro.core import offload as joff  # noqa: E402
from repro_torch.core import evaluator as tev  # noqa: E402
from repro_torch.core.evaluator import (Evaluator,  # noqa: E402
                                        transfer_cost_surrogate)
from repro_torch.core.ga import Evaluation, GAConfig, run_ga  # noqa: E402
from repro_torch.core.genes import coding_from_graph  # noqa: E402
from repro_torch.core.ir import Region, RegionGraph  # noqa: E402


def _counting_fitness(calls, cost=None, delay=0.0):
    def fit(bits):
        calls.append(bits)
        if delay:
            time.sleep(delay)
        t = cost(bits) if cost else 1.0 + 0.1 * sum(bits)
        return Evaluation(bits, t, True)
    return fit


# ---------------------------------------------------------------------------
# batching + dedup
# ---------------------------------------------------------------------------


def test_batch_dedups_within_population():
    calls = []
    ev = Evaluator(_counting_fitness(calls))
    res = ev.evaluate_batch([(0, 1), (1, 0), (0, 1), (0, 1)])
    assert len(calls) == 2
    assert [r.bits for r in res] == [(0, 1), (1, 0), (0, 1), (0, 1)]
    assert res[0].time_s == res[2].time_s == res[3].time_s
    assert ev.stats.measurements == 2
    assert ev.stats.measurements_saved == 2        # two in-batch duplicates


def test_batch_hits_memory_cache_across_generations():
    calls = []
    ev = Evaluator(_counting_fitness(calls))
    ev.evaluate_batch([(0, 0), (1, 1)])
    ev.evaluate_batch([(0, 0), (1, 0)])
    assert len(calls) == 3
    assert ev.stats.cache_hits == 1


def test_parallel_results_match_serial_order():
    calls_s, calls_p = [], []
    pop = [(i % 2, (i // 2) % 2, (i // 4) % 2) for i in range(8)]
    serial = Evaluator(_counting_fitness(calls_s)).evaluate_batch(pop)
    parallel = Evaluator(_counting_fitness(calls_p, delay=0.01),
                         workers=4).evaluate_batch(pop)
    assert [r.bits for r in serial] == [r.bits for r in parallel]
    assert [r.time_s for r in serial] == [r.time_s for r in parallel]
    assert sorted(calls_s) == sorted(calls_p)      # same unique measurements


# ---------------------------------------------------------------------------
# persistent cache
# ---------------------------------------------------------------------------


def test_cache_persists_across_engine_instances(tmp_path):
    calls = []
    fit = _counting_fitness(calls)
    e1 = Evaluator(fit, cache_dir=str(tmp_path), fingerprint="prog-a")
    e1.evaluate_batch([(0, 1), (1, 1)])
    assert len(calls) == 2

    e2 = Evaluator(fit, cache_dir=str(tmp_path), fingerprint="prog-a")
    res = e2.evaluate_batch([(0, 1), (1, 1), (1, 0)])
    assert len(calls) == 3                         # only (1,0) re-measured
    assert e2.stats.persistent_hits == 2
    assert res[0].time_s == pytest.approx(1.1)

    # a different program fingerprint must NOT see prog-a's measurements
    e3 = Evaluator(fit, cache_dir=str(tmp_path), fingerprint="prog-b")
    e3.evaluate_batch([(0, 1)])
    assert len(calls) == 4


def test_worker_failure_is_transient_not_cached(tmp_path):
    """A dead worker / broken pool must not poison the measurement cache."""
    from concurrent.futures import Future

    class FailingExecutor:
        def submit(self, fn, *a):
            fut = Future()
            fut.set_exception(RuntimeError("worker killed"))
            return fut

    ev = Evaluator(None, executor=FailingExecutor(), dispatch_fn=lambda b: b,
                   cache_dir=str(tmp_path), fingerprint="p")
    res = ev.evaluate((1, 0))
    assert not res.valid and res.detail.get("transient")
    assert ev.stats.measurements == 0
    assert not ev.is_measured((1, 0))               # retry stays possible

    calls = []
    ev2 = Evaluator(_counting_fitness(calls),
                    cache_dir=str(tmp_path), fingerprint="p")
    assert ev2.evaluate((1, 0)).valid and len(calls) == 1


def test_persistent_cache_preserves_invalid_results(tmp_path):
    def fit(bits):
        return Evaluation(bits, float("inf"), False, {"error": "OOM"})
    e1 = Evaluator(fit, cache_dir=str(tmp_path), fingerprint="p")
    e1.evaluate((1,))
    e2 = Evaluator(lambda b: pytest.fail("must not re-measure"),
                   cache_dir=str(tmp_path), fingerprint="p")
    res = e2.evaluate((1,))
    assert not res.valid and res.time_s == float("inf")
    assert res.detail["error"] == "OOM"


def test_journal_written_by_the_reference_is_read_by_the_port(tmp_path):
    """One journal format: the port's engine serves the reference's
    measurements as persistent hits."""
    jfit = jev._smoke_fitness_factory()
    je = jev.Evaluator(jfit, cache_dir=str(tmp_path), fingerprint="shared")
    je.evaluate_batch([(0, 1, 1), (1, 0, 0)])
    te = Evaluator(lambda b: pytest.fail("must not re-measure"),
                   cache_dir=str(tmp_path), fingerprint="shared")
    out = te.evaluate_batch([(0, 1, 1), (1, 0, 0)])
    assert [r.time_s for r in out] == [jfit((0, 1, 1)).time_s,
                                       jfit((1, 0, 0)).time_s]
    assert te.stats.persistent_hits == 2


# ---------------------------------------------------------------------------
# in-flight dedup under concurrency
# ---------------------------------------------------------------------------


def test_inflight_dedup_under_concurrency():
    calls = []
    started = threading.Event()
    release = threading.Event()

    def fit(bits):
        calls.append(bits)
        started.set()
        release.wait(timeout=5)
        return Evaluation(bits, 1.0, True)

    ev = Evaluator(fit, workers=2)
    out = {}

    def first():
        out["a"] = ev.evaluate((1, 0))

    def second():
        out["b"] = ev.evaluate((1, 0))

    t1 = threading.Thread(target=first)
    t1.start()
    assert started.wait(timeout=5)                 # measurement in flight
    t2 = threading.Thread(target=second)
    t2.start()
    # t2 joins the in-flight measurement once it is announced
    deadline = time.monotonic() + 5
    while ev.stats.inflight_hits == 0 and time.monotonic() < deadline:
        time.sleep(0.005)
    release.set()
    t1.join(timeout=5)
    t2.join(timeout=5)
    assert len(calls) == 1                         # measured exactly once
    assert out["a"].time_s == out["b"].time_s == 1.0
    assert ev.stats.inflight_hits == 1
    ev.close()


# ---------------------------------------------------------------------------
# surrogate pre-screening
# ---------------------------------------------------------------------------


def test_surrogate_screens_but_never_scores():
    calls = []
    ev = Evaluator(_counting_fitness(calls),
                   surrogate=lambda b: -sum(b),    # rank: more offload first
                   screen_top_k=2)
    pop = [(0, 0, 1), (1, 1, 1), (1, 0, 0), (0, 1, 1)]
    res = ev.evaluate_batch(pop)
    assert len(calls) == 2 and ev.stats.screened_out == 2
    assert set(calls) == {(1, 1, 1), (0, 1, 1)}
    screened = [r for r in res if r.detail.get("screened")]
    assert all(not r.valid and r.fitness == 0.0 for r in screened)
    res2 = ev.evaluate((0, 0, 1))
    assert res2.valid and len(calls) == 3


def test_screen_top_k_needs_a_surrogate():
    with pytest.raises(ValueError, match="surrogate"):
        Evaluator(_counting_fitness([]), screen_top_k=2)


def test_transfer_cost_surrogate_prefers_fewer_transfers():
    regions = [
        Region("outer", "loop", trip_count=100, offloadable=False),
        Region("hot", "loop", parent="outer", depth=1, uses=frozenset({"a"}),
               defs=frozenset({"a"}), offloadable=True,
               alternatives=("interp", "jit"), trip_count=10),
        Region("cold", "loop", uses=frozenset({"b"}), defs=frozenset({"b"}),
               offloadable=True, alternatives=("interp", "jit"), trip_count=2),
    ]
    g = RegionGraph(regions, "python_ast", "t")
    coding = coding_from_graph(g)
    cost = transfer_cost_surrogate(g, coding)
    assert cost(coding.all_on()) <= cost(coding.all_off()) + 1e6
    assert cost(coding.all_on()) == cost(coding.all_on())  # memoized, stable


# ---------------------------------------------------------------------------
# GA integration: duplicate avoidance, reproducibility, cache reuse
# ---------------------------------------------------------------------------


def test_ga_duplicate_avoiding_offspring_explores_more():
    calls_on, calls_off = [], []
    res_on = run_ga(3, _counting_fitness(calls_on),
                    GAConfig(population=8, generations=6, seed=5,
                             dup_retries=3))
    res_off = run_ga(3, _counting_fitness(calls_off),
                     GAConfig(population=8, generations=6, seed=5,
                              dup_retries=0))
    assert len(set(calls_on)) >= len(set(calls_off))
    assert len(set(calls_on)) == 8                 # full coverage
    assert res_on.duplicates_avoided > 0
    assert res_off.duplicates_avoided == 0
    assert res_on.best.time_s <= res_off.best.time_s


def _mod_fit(mod):
    def fit(bits):
        return mod.Evaluation(bits, 1.0 + 0.07 * sum(
            b * (i + 1) for i, b in enumerate(bits)) % 0.9, True)
    return fit


@pytest.mark.parametrize("workers", [0, 4])
def test_run_ga_serial_and_workers_equal_the_reference(workers):
    """The port's run_ga with the thread pool (workers 4) or serial gives
    the reference's serial search: best, history and measurement count."""
    cfg = dict(population=10, generations=6, seed=7)
    ref = jga.run_ga(6, _mod_fit(jga), jga.GAConfig(**cfg, workers=0))
    got = run_ga(6, _mod_fit(tev), GAConfig(**cfg, workers=workers))
    assert got.best.bits == ref.best.bits
    assert got.best.time_s == ref.best.time_s
    assert [h["best_time_s"] for h in got.history] == \
        [h["best_time_s"] for h in ref.history]
    assert [h["mean_time_s"] for h in got.history] == \
        [h["mean_time_s"] for h in ref.history]
    assert got.evaluations == ref.evaluations


def test_run_ga_refuses_pool_and_an_unusable_screen():
    with pytest.raises(ValueError, match="pool"):
        run_ga(3, _mod_fit(tev), GAConfig(pool="smoke"))
    with pytest.raises(ValueError, match="surrogate"):
        run_ga(3, _mod_fit(tev), GAConfig(screen_top_k=2))


def test_ga_persistent_cache_reduces_measurements(tmp_path):
    calls = []
    fit = _counting_fitness(calls)

    def run(seed):
        ev = Evaluator(fit, cache_dir=str(tmp_path), fingerprint="ga-prog")
        try:
            return run_ga(3, fit, GAConfig(population=8, generations=5,
                                           seed=seed), evaluator=ev)
        finally:
            ev.close()

    r1 = run(0)
    n1 = len(calls)
    assert n1 == r1.evaluations > 0
    r2 = run(0)
    assert len(calls) - n1 < n1                    # warm start: fewer new
    assert r2.persistent_hits > 0
    assert r2.best.time_s <= r1.best.time_s
    assert r2.measurements_saved > 0


def test_ga_reports_search_wall_clock():
    res = run_ga(4, lambda b: Evaluation(b, 1.0 + sum(b), True),
                 GAConfig(population=6, generations=3, seed=0))
    assert res.wall_s > 0
    assert 0 < res.eval_wall_s <= res.wall_s


# ---------------------------------------------------------------------------
# phenotype dedup: decode-equivalent chromosomes share one measurement
# ---------------------------------------------------------------------------


def _variant_graph():
    return RegionGraph([
        Region("matched", "loop", uses=frozenset({"a"}),
               defs=frozenset({"a"}), offloadable=True,
               alternatives=("ref", "fused_torch", "cuda"), trip_count=4),
        Region("plain", "loop", uses=frozenset({"b"}), defs=frozenset({"b"}),
               offloadable=True, alternatives=("ref", "kernel"),
               trip_count=2),
    ], "ir", "pheno")


def test_phenotype_dedup_measures_decode_equivalent_once():
    from repro_torch.core.genes import VARIANT_ALPHABET
    from repro_torch.core.offload import phenotype_key

    g = _variant_graph()
    coding = coding_from_graph(g, destinations=VARIANT_ALPHABET)
    calls = []
    ev = Evaluator(_counting_fitness(calls),
                   phenotype_key=phenotype_key(coding))
    out = ev.evaluate_batch([(0, 1), (0, 2), (0, 0)])
    assert len(calls) == 2, "decode-equivalent chromosomes measured once"
    assert out[0].time_s == out[1].time_s
    assert out[0].bits == (0, 1) and out[1].bits == (0, 2)
    assert ev.stats.measurements == 2
    assert ev.stats.measurements_saved >= 1
    assert ev.is_measured((0, 2)) and ev.is_measured((0, 1))
    ev.close()


def test_phenotype_dedup_reaches_persistent_cache(tmp_path):
    from repro_torch.core.genes import VARIANT_ALPHABET
    from repro_torch.core.offload import phenotype_key

    g = _variant_graph()
    coding = coding_from_graph(g, destinations=VARIANT_ALPHABET)
    key = phenotype_key(coding)
    calls = []
    ev1 = Evaluator(_counting_fitness(calls), cache_dir=str(tmp_path),
                    fingerprint="pheno", phenotype_key=key)
    ev1.evaluate((0, 1))
    ev1.close()
    ev2 = Evaluator(_counting_fitness(calls), cache_dir=str(tmp_path),
                    fingerprint="pheno", phenotype_key=key)
    out = ev2.evaluate((0, 2))
    assert len(calls) == 1
    assert out.bits == (0, 2)
    assert ev2.stats.persistent_hits == 1
    ev2.close()


def test_ga_search_dedups_phenotypes_end_to_end():
    from repro_torch.core.genes import VARIANT_ALPHABET
    from repro_torch.core.offload import ga_search

    g = _variant_graph()
    coding = coding_from_graph(g, destinations=VARIANT_ALPHABET)
    calls = []
    ga_search(g, _counting_fitness(calls), GAConfig(
        population=8, generations=6, seed=3), coding=coding)
    decoded = {tuple(sorted(coding.decode(b).items())) for b in calls}
    assert len(decoded) == len(calls), \
        "every verification measurement must buy a distinct program"


# ---------------------------------------------------------------------------
# search-meta staleness decay
# ---------------------------------------------------------------------------


def test_search_meta_decay_boundary(tmp_path):
    from repro_torch.core.evaluator import (_SEARCH_META_HORIZON_S,
                                            last_rank_corr, record_search_meta)

    d = str(tmp_path)
    record_search_meta(d, "fp", 0.9, now=1_000.0)
    assert last_rank_corr(d, "fp", max_age_s=100.0, now=1_099.9) == 0.9
    assert last_rank_corr(d, "fp", max_age_s=100.0, now=1_100.1) is None
    assert last_rank_corr(d, "fp", now=1_000.0 + _SEARCH_META_HORIZON_S - 1) \
        == 0.9
    assert last_rank_corr(d, "fp", now=1_000.0 + _SEARCH_META_HORIZON_S + 1) \
        is None


def test_search_meta_stale_records_compact_away(tmp_path):
    import json
    import os

    from repro_torch.core.evaluator import (_SEARCH_META_FILE, last_rank_corr,
                                            record_search_meta)

    d = str(tmp_path)
    record_search_meta(d, "old", 0.8, now=1_000.0, horizon_s=50.0)
    record_search_meta(d, "new", 0.7, now=2_000.0, horizon_s=50.0)
    path = os.path.join(d, _SEARCH_META_FILE)
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    assert [r["fingerprint"] for r in recs] == ["new"], \
        "expired records must be compacted away, not just ignored"
    assert last_rank_corr(d, "old", now=2_000.0) is None


def test_search_meta_legacy_records_without_ts_are_stale(tmp_path):
    import json
    import os

    from repro_torch.core.evaluator import _SEARCH_META_FILE, last_rank_corr

    path = os.path.join(str(tmp_path), _SEARCH_META_FILE)
    with open(path, "w") as f:
        f.write(json.dumps({"fingerprint": "fp", "rank_corr": 0.9}) + "\n")
    assert last_rank_corr(str(tmp_path), "fp") is None


def _stale_graph(mod):
    return mod.RegionGraph([
        mod.Region(f"r{i}", "loop", uses=frozenset({f"v{i}"}),
                   defs=frozenset({f"v{i}"}), offloadable=True,
                   alternatives=("ref", "kernel"), trip_count=2 + i)
        for i in range(6)], "ir", "stale")


def _sum_fit(mod):
    def fit(values):
        return mod.Evaluation(tuple(values),
                              1.0 + sum(int(v) * (i + 1)
                                        for i, v in enumerate(values)), True)
    return fit


def test_auto_screen_ignores_stale_rank_corr(tmp_path):
    import json
    import os

    from repro_torch.core.evaluator import _SEARCH_META_FILE
    from repro_torch.core.offload import ga_search

    g = _stale_graph(types.SimpleNamespace(RegionGraph=RegionGraph,
                                           Region=Region))
    fit = _sum_fit(tev)
    cfg = GAConfig(population=8, generations=4, seed=1,
                   cache_dir=str(tmp_path))
    _, ga1 = ga_search(g, fit, cfg)
    assert ga1.surrogate_rank_corr >= cfg.auto_screen_corr

    path = os.path.join(str(tmp_path), _SEARCH_META_FILE)
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    for rec in recs:
        rec["ts"] = rec["ts"] - cfg.auto_screen_horizon_s - 10.0
    with open(path, "w") as f:
        for rec in recs:
            f.write(json.dumps(rec) + "\n")

    _, ga2 = ga_search(g, fit, GAConfig(population=8, generations=4, seed=2,
                                        cache_dir=str(tmp_path)))
    assert ga2.screened_out == 0, "stale evidence must not justify screening"


def test_ga_search_auto_screen_equals_the_reference(tmp_path):
    """Two searches of one program in one cache directory, both packages:
    the second auto-screens on the first's recorded rank correlation, and
    every reported number of both searches is the reference's."""
    from repro_torch.core import offload as toff

    tg = _stale_graph(types.SimpleNamespace(RegionGraph=RegionGraph,
                                            Region=Region))
    jg = _stale_graph(jir)
    out = {}
    for name, mod, off, g, fit in (
            ("ref", jga, joff, jg, _sum_fit(jga)),
            ("port", None, toff, tg, _sum_fit(tev))):
        d = tmp_path / name
        cfg_cls = jga.GAConfig if name == "ref" else GAConfig
        runs = []
        for seed in (1, 2):
            _, ga = off.ga_search(g, fit, cfg_cls(
                population=8, generations=4, seed=seed, cache_dir=str(d)))
            runs.append((ga.best.bits, ga.evaluations, ga.screened_out,
                         ga.surrogate_kind, repr(ga.surrogate_rank_corr),
                         [h["best_time_s"] for h in ga.history]))
        out[name] = runs
    assert out["port"] == out["ref"]
    assert out["port"][1][2] > 0, "the second search screens"


# ---------------------------------------------------------------------------
# compile-overlap adaptive backoff
# ---------------------------------------------------------------------------


class _Clock:
    """The evaluator's clock in these tests: it moves only when a prepare
    charges it, so the overlap estimate does not depend on the host's
    load (the tests may run beside five other pytest workers)."""

    def __init__(self):
        self._t = 0.0
        self._lock = threading.Lock()

    def perf_counter(self) -> float:
        with self._lock:
            return self._t

    def advance(self, dt: float) -> None:
        with self._lock:
            self._t += dt


class _TwoPhaseFitness:
    """prepare/measure fitness on a :class:`_Clock`.  A parallel prepare
    charges its cost only while no other prepare has charged it meanwhile
    (the wall of overlapped prepares is the longest one); a contended one
    is lock-serialized, and a prepare that had to queue behind another
    charges 5x its solo cost (serialized plus contention overhead)."""

    def __init__(self, clock, prep_s=0.02, contended=False):
        self.clock = clock
        self.prep_s = prep_s
        self.contended = contended
        self._lock = threading.Lock()

    def prepare(self, bits):
        if not self.contended:
            start = self.clock.perf_counter()
            time.sleep(0.05)                   # let siblings start too
            with self._lock:                   # overlapped: wall = max
                end = start + self.prep_s
                now = self.clock.perf_counter()
                if end > now:
                    self.clock.advance(end - now)
        elif self._lock.acquire(blocking=False):
            time.sleep(0.1)                    # hold it: siblings queue
            self.clock.advance(self.prep_s)    # ran alone: the solo cost
            self._lock.release()
        else:
            with self._lock:                   # queued behind another
                self.clock.advance(5 * self.prep_s)
        return tuple(bits)

    def measure(self, prep):
        return Evaluation(tuple(prep), 1.0 + 0.1 * sum(prep), True)

    def __call__(self, bits):
        return self.measure(self.prepare(bits))


def _distinct_pop(n, length=8):
    return [tuple(1 if j == i else 0 for j in range(length))
            for i in range(n)]


def test_overlap_estimates_savings_when_compiles_parallelize(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(tev, "time", types.SimpleNamespace(
        perf_counter=clock.perf_counter))
    eng = Evaluator(_TwoPhaseFitness(clock, contended=False),
                    compile_workers=4)
    for lo in range(0, 8, 4):
        eng.evaluate_batch(_distinct_pop(8)[lo:lo + 4])
    assert eng.stats.overlapped_compiles == 8
    assert not eng.stats.overlap_disabled
    assert eng.stats.overlap_est_saved_s > 0.0
    assert eng.stats.compile_overlap_saved_s > 0.0


def test_overlap_disables_itself_under_contention(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(tev, "time", types.SimpleNamespace(
        perf_counter=clock.perf_counter))
    eng = Evaluator(_TwoPhaseFitness(clock, contended=True),
                    compile_workers=4)
    pop = _distinct_pop(12)
    for lo in range(0, 8, 4):
        eng.evaluate_batch(pop[lo:lo + 4])
    # two probed batches with a negative cumulative estimate trip the
    # backoff for the evaluator's lifetime
    assert eng.stats.overlap_disabled
    assert eng.stats.overlap_est_saved_s < 0.0
    overlapped_before = eng.stats.overlapped_compiles
    eng.evaluate_batch(pop[8:12])
    assert eng.stats.overlapped_compiles == overlapped_before, \
        "post-backoff batches must warm up serially"


def test_overlapped_prepares_finish_before_the_first_timing():
    """The serial timing loop starts only after every prepare returned,
    and it runs in batch order."""
    events = []

    class Ordered:
        def prepare(self, bits):
            time.sleep(0.002)
            events.append(("prepare", bits))
            return bits

        def measure(self, prep):
            events.append(("measure", prep))
            return Evaluation(prep, 1.0, True)

    pop = _distinct_pop(4)
    Evaluator(Ordered(), compile_workers=4).evaluate_batch(pop)
    kinds = [k for k, _ in events]
    assert kinds == ["prepare"] * 4 + ["measure"] * 4
    assert [b for k, b in events if k == "measure"] == pop


# ---------------------------------------------------------------------------
# measurement-journal bounding
# ---------------------------------------------------------------------------


def test_measurement_journal_stays_bounded_and_keeps_newest(tmp_path):
    from repro_torch.core.evaluator import MeasurementCache

    def bits(i, length=5):
        return tuple((i >> j) & 1 for j in range(length))

    cache = MeasurementCache(str(tmp_path), "fp", max_records=4)
    for i in range(12):
        cache.store(Evaluation(bits(i), 1.0 + i, True))
        with open(cache.path) as f:
            lines = sum(1 for line in f if line.strip())
        assert lines <= 2 * cache.max_records

    loaded = cache.load()
    assert cache.max_records <= len(loaded) <= 2 * cache.max_records
    for i in range(12 - cache.max_records, 12):
        assert bits(i) in loaded and loaded[bits(i)].time_s == 1.0 + i
    cache.store(Evaluation(bits(11), 0.25, True))
    assert cache.load()[bits(11)].time_s == 0.25


def test_measurement_journal_compaction_preserves_reload_fidelity(tmp_path):
    from repro_torch.core.evaluator import MeasurementCache

    cache = MeasurementCache(str(tmp_path), "fp", max_records=2)
    cache.store(Evaluation((0, 0), float("inf"), False, {"err": "oom"}))
    cache.store(Evaluation((0, 1), 2.0, True, {"n": 3}))
    for i in range(6):
        cache.store(Evaluation((1, i % 2), 3.0 + i, True))
    loaded = cache.load()
    assert set(loaded) <= {(0, 0), (0, 1), (1, 0), (1, 1)}
    assert loaded[(1, 1)].time_s == 8.0 and loaded[(1, 0)].time_s == 7.0
    again = MeasurementCache(str(tmp_path), "fp", max_records=2).load()
    assert again == loaded


# ---------------------------------------------------------------------------
# the process pool
# ---------------------------------------------------------------------------


def test_fitness_factory_registry():
    assert "smoke" in tev.fitness_factory_names()
    with pytest.raises(ValueError, match="already registered"):
        tev.register_fitness_factory("smoke", tev._smoke_fitness_factory)
    with pytest.raises(KeyError, match="unknown fitness factory"):
        tev.fitness_factory("no-such-factory")


def test_process_pool_ga_search_equals_the_serial_search():
    """Two spawn workers built from the registered ``smoke`` factory give
    the serial search's history (the pooled search has 120 s)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.core.offload import ga_search

    g = RegionGraph([
        Region(f"r{i}", "loop", uses=frozenset({f"v{i}"}),
               defs=frozenset({f"v{i}"}), offloadable=True,
               alternatives=("ref", "kernel"), trip_count=2)
        for i in range(5)], "ir", "pool")
    fit = tev._smoke_fitness_factory()
    cfg = dict(population=6, generations=3, seed=4)
    _, serial = ga_search(g, fit, GAConfig(**cfg))
    with ThreadPoolExecutor(1) as runner:
        _, pooled = runner.submit(
            ga_search, g, fit,
            GAConfig(**cfg, pool="smoke", workers=2)).result(timeout=120)
    assert pooled.best.bits == serial.best.bits
    assert [h["best_time_s"] for h in pooled.history] == \
        [h["best_time_s"] for h in serial.history]
    assert pooled.evaluations == serial.evaluations


def test_concurrent_batches_measure_each_chromosome_once():
    """Eight callers evaluating overlapping populations on one engine with
    a pool wider than the host's cores: every chromosome is measured once
    (no lost update of the cache, the in-flight table or the counts)."""
    import sys

    calls = []
    lock = threading.Lock()

    def fit(bits):
        with lock:
            calls.append(bits)
        time.sleep(0.001)
        return Evaluation(bits, 1.0 + 0.1 * sum(bits), True)

    ev = Evaluator(fit, workers=16)
    pops = [[tuple((i >> j) & 1 for j in range(6))
             for i in range(k, k + 24)] for k in range(0, 40, 5)]
    errors = []

    def caller(pop):
        try:
            out = ev.evaluate_batch(pop)
            assert [r.bits for r in out] == pop
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=caller, args=(p,)) for p in pops]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
        ev.close()
    assert not any(t.is_alive() for t in threads) and not errors
    unique = {b for p in pops for b in p}
    assert sorted(calls) == sorted(unique)
    assert ev.stats.measurements == len(unique) == ev.unique_measured
