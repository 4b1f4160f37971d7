"""Port of ``repro/core/ga.py``: the same numpy RNG stream, the same
``history`` and the same evaluator knobs (thread pool, process pool,
compile overlap, surrogate screening), so one seed and one deterministic
fitness run the same search in both packages.

Genetic-algorithm engine for offload-pattern search (paper §3.2.1, §4.2.2).

Faithful to the paper's loop:
  * initial population: random 0/1 chromosomes (the all-off and all-on
    patterns are seeded so the baseline and full-offload are always tried),
  * fitness from *measured* performance (wall clock or compiled cost model),
  * invalid results (PCAST-style verification failure, compile error) get
    processing time infinity -> fitness 0,
  * roulette selection scaled by fitness, single-point crossover, bit-flip
    mutation, elite copy,
  * per-chromosome measurement cache (a pattern is never re-measured),
  * fixed generation count, best chromosome wins.

Measurement scheduling (dedup, parallel dispatch, the persistent on-disk
cache and the optional surrogate pre-screen) lives in
:mod:`repro_torch.core.evaluator`; `run_ga` drives it one *generation batch* at a
time, and generates **duplicate-avoiding offspring** (arXiv:2002.12115):
children that decode to an already-measured pattern are re-mutated so each
verification measurement buys new information.  With a deterministic fitness
function the search trajectory is byte-identical in serial and parallel
evaluation modes.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


@dataclass
class GAConfig:
    population: int = 12
    generations: int = 8
    crossover_rate: float = 0.9
    mutation_rate: float = 0.05
    elite: int = 2
    seed: int = 0
    patience: Optional[int] = None    # stop after N generations w/o improvement
    # --- evaluation-engine knobs (repro_torch.core.evaluator) -------------
    workers: int = 0                  # 0/1 serial; N>1 thread pool (compile-
                                      # bound fitness only — keep wall-clock
                                      # fitness serial for timing fidelity)
    compile_workers: Optional[int] = None
                                      # compile-parallel/time-serial phase for
                                      # two-phase fitness (WallClockFitness
                                      # prepare/measure): warm-up compiles of
                                      # different chromosomes overlap on this
                                      # many threads ahead of the strictly
                                      # serial timing loop.  None = the
                                      # frontend decides — Offloader.plan
                                      # auto-enables it where the bundle
                                      # asks (FitnessBundle.
                                      # overlap_compiles: the export and
                                      # python_ast measured paths); bare
                                      # run_ga/ga_search keep warm-ups serial.
                                      # 0/1 = explicitly serial.  Safe with
                                      # serial_only fitness: timing never
                                      # interleaves with compilation
    pool: Optional[str] = None        # registered fitness-factory name: run
                                      # measurements in an evaluator.
                                      # ProcessPool of `workers` spawn
                                      # processes built from that factory
                                      # (a GIL-bound fitness only scales
                                      # across processes).  Takes
                                      # effect via ga_search, whose
                                      # caller owns
                                      # keeping the factory's fitness in sync
                                      # with the searched coding; bare run_ga
                                      # and Offloader.plan (which composes a
                                      # fitness workers can't rebuild) raise
    screen_top_k: Optional[int] = None  # surrogate pre-screen: measure at
                                        # most k new offspring per generation.
                                        # Needs a surrogate ranking fn, so it
                                        # only takes effect via
                                        # ga_search (or a hand-built
                                        # Evaluator); bare run_ga raises
    cache_dir: Optional[str] = None   # persistent measurement cache location.
                                      # Needs a program fingerprint, so it
                                      # only takes effect via
                                      # ga_search (or a hand-built
                                      # Evaluator); bare run_ga raises
    auto_screen: bool = True          # when screen_top_k is unset and a prior
                                      # search of the same fingerprint (in
                                      # cache_dir) recorded a surrogate rank
                                      # correlation >= auto_screen_corr,
                                      # ga_search sets screen_top_k to
                                      # population // 2 by itself
    auto_screen_corr: float = 0.6     # evidence bar for auto-screening
    auto_screen_horizon_s: float = 7 * 24 * 3600.0
                                      # staleness horizon for that evidence:
                                      # rank-corr records older than this are
                                      # ignored (and compacted away), so
                                      # auto-screening never acts on a stale
                                      # fingerprint
    fit_surrogate: bool = True        # fit a regression surrogate against the
                                      # fingerprint's measurement journal
                                      # (repro_torch.core.surrogate) and prefer it
                                      # over the static transfer-cost formula
                                      # when its journal rank correlation is
                                      # strictly better.  Takes effect via
                                      # ga_search with a cache_dir
    surrogate_min_records: int = 10   # journal rows below which the fit
                                      # abstains and the hand formula stays
    dup_retries: int = 3              # re-mutation attempts per duplicate child
    objectives: tuple = ("latency",)  # objective axes for selection.  The
                                      # default single axis keeps the paper's
                                      # fitness-proportional roulette path
                                      # byte-identical; a multi-axis tuple
                                      # (e.g. repro_torch.core.objectives.OBJECTIVES
                                      # = latency/energy/transfer) makes
                                      # ga_search build an objective vector fn
                                      # and run_ga switch to NSGA-style
                                      # non-dominated + crowding selection,
                                      # reporting the Pareto front in
                                      # GAResult.front


@dataclass
class Evaluation:
    bits: tuple
    time_s: float                     # inf if invalid
    valid: bool
    detail: dict = field(default_factory=dict)

    @property
    def fitness(self) -> float:
        return 0.0 if not self.valid or not math.isfinite(self.time_s) \
            else 1.0 / max(self.time_s, 1e-12)


@dataclass
class GAResult:
    best: Evaluation
    history: list[dict]               # per generation: best/mean time
    evaluations: int                  # fitness_fn invocations (new measurements)
    cache_hits: int                   # in-memory + in-flight dedup hits
    baseline: Optional[Evaluation] = None   # all-off pattern
    persistent_hits: int = 0          # measurements served by the disk cache
    screened_out: int = 0             # offspring deferred by the surrogate
    duplicates_avoided: int = 0       # dup children re-mutated to fresh ones
    wall_s: float = 0.0               # total search wall-clock
    eval_wall_s: float = 0.0          # wall-clock inside measurement batches
    surrogate_rank_corr: float = float("nan")  # Spearman corr of the
                                      # surrogate's ranking vs measured
                                      # fitness (nan when no surrogate or
                                      # too few finite measurements) — the
                                      # number that justifies screen_top_k
    surrogate_kind: str = "static"    # which surrogate ranked offspring:
                                      # the hand transfer-cost formula or a
                                      # journal-fitted regression ("fitted",
                                      # repro_torch.core.surrogate) — set by
                                      # ga_search when the fitted model's
                                      # journal rank corr beats the static
    compile_overlap_saved_s: float = 0.0  # wall-clock saved by overlapping
                                      # warm-up compiles ahead of the serial
                                      # timing loop (EvalStats)
    overlap_est_saved_s: float = 0.0  # the overlap phase's probe-
                                      # calibrated estimate of that saving
                                      # and whether its backoff turned it
    overlap_disabled: bool = False    # off (EvalStats; reported by the
                                      # port beside the reference's field)
    front: list = field(default_factory=list)  # Pareto-optimal Evaluations
                                      # (multi-objective search: every
                                      # non-dominated measured pattern,
                                      # sorted fastest-first; single-
                                      # objective: just [best])

    @property
    def speedup_vs_baseline(self) -> float:
        if self.baseline is None or not self.baseline.valid:
            return float("nan")
        return self.baseline.time_s / self.best.time_s

    @property
    def measurements_saved(self) -> int:
        """Verification measurements avoided by cache + dedup + screening."""
        return self.cache_hits + self.persistent_hits + self.screened_out


FitnessFn = Callable[[tuple], Evaluation]
ObjectiveFn = Callable[[Evaluation], tuple]


# ---------------------------------------------------------------------------
# NSGA-style multi-objective selection primitives (Deb et al. 2002)
# ---------------------------------------------------------------------------


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """Pareto dominance, all axes minimized: ``a`` dominates ``b`` iff it is
    no worse everywhere and strictly better somewhere.  Totality note: for
    any pair exactly one of {a dom b, b dom a, neither} holds — equal
    vectors (and all-inf invalid points) are mutually non-dominating."""
    assert len(a) == len(b), (len(a), len(b))
    better = False
    for x, y in zip(a, b):
        if x > y:
            return False
        if x < y:
            better = True
    return better


def non_dominated_sort(points: Sequence[Sequence[float]]) -> list[list[int]]:
    """Fast-ish O(n²) non-dominated sort: index lists per front, front 0
    first.  Every input index appears in exactly one front."""
    n = len(points)
    dominated_by: list[list[int]] = [[] for _ in range(n)]
    dom_count = [0] * n
    for i in range(n):
        for j in range(i + 1, n):
            if dominates(points[i], points[j]):
                dominated_by[i].append(j)
                dom_count[j] += 1
            elif dominates(points[j], points[i]):
                dominated_by[j].append(i)
                dom_count[i] += 1
    fronts: list[list[int]] = []
    current = [i for i in range(n) if dom_count[i] == 0]
    while current:
        fronts.append(current)
        nxt = []
        for i in current:
            for j in dominated_by[i]:
                dom_count[j] -= 1
                if dom_count[j] == 0:
                    nxt.append(j)
        current = nxt
    return fronts


def crowding_distances(points: Sequence[Sequence[float]]) -> list[float]:
    """Crowding distance within one front: boundary points (per-axis min or
    max) get ``inf`` so selection always preserves the extremes; interior
    points sum normalized neighbor gaps per axis."""
    n = len(points)
    if n == 0:
        return []
    if n <= 2:
        return [float("inf")] * n
    m = len(points[0])
    dist = [0.0] * n
    for ax in range(m):
        order = sorted(range(n), key=lambda i: points[i][ax])
        lo, hi = points[order[0]][ax], points[order[-1]][ax]
        dist[order[0]] = dist[order[-1]] = float("inf")
        span = hi - lo
        if span <= 0 or not math.isfinite(span):
            continue
        for k in range(1, n - 1):
            gap = (points[order[k + 1]][ax] - points[order[k - 1]][ax]) / span
            if math.isfinite(dist[order[k]]):
                dist[order[k]] += gap
    return dist


def pareto_front(points: Sequence[Sequence[float]]) -> list[int]:
    """Indices of the non-dominated points (first front), input order kept."""
    if not points:
        return []
    return sorted(non_dominated_sort(points)[0])


def run_ga(length: int, fitness_fn: FitnessFn, cfg: GAConfig,
           log: Optional[Callable[[str], None]] = None,
           evaluator=None, arity: int = 2,
           seeds: Sequence[Sequence[int]] = (),
           objective_fn: Optional[ObjectiveFn] = None) -> GAResult:
    """Search chromosomes of `length`; returns the fastest valid one.

    Genes range over ``{0 .. arity-1}`` (2 = the paper's binary CPU/GPU
    encoding; larger alphabets come from multi-destination gene codings —
    see :mod:`repro_torch.core.genes`).  ``seeds`` are extra chromosomes injected
    into the initial population after the always-seeded all-off / all-on
    patterns — the pattern-DB and similarity-neighbor warm starts.

    ``evaluator`` is an optional pre-built :class:`repro_torch.core.evaluator.
    Evaluator` (callers that want a persistent cache keyed to a program
    fingerprint, or a surrogate pre-screen, construct it themselves — see
    ``ga_search``).  When omitted, one is built from the GAConfig
    knobs (`workers`, `cache_dir`, `screen_top_k`).  The GAResult measurement
    counters are the evaluator's lifetime totals, so pass a fresh evaluator
    per search if you want per-search numbers.

    ``objective_fn`` switches selection to NSGA-style multi-objective mode:
    it maps each :class:`Evaluation` to a smaller-is-better float tuple
    (see :func:`repro_torch.core.objectives.make_objective_fn`), parents are
    chosen by binary tournament on (non-domination rank, crowding distance)
    and elites are the rank/crowding-best individuals.  ``best``, patience
    and the history stay latency-first (objective 0 is latency by
    convention) so tier-1 semantics are untouched, and
    :attr:`GAResult.front` reports every non-dominated measured pattern.
    When ``objective_fn`` is None (the default) the paper's roulette path
    runs byte-identically to before.
    """
    from repro_torch.core.evaluator import Evaluator  # deferred: avoids import cycle

    assert arity >= 2, arity
    t_start = time.perf_counter()
    rng = np.random.default_rng(cfg.seed)
    owns_evaluator = evaluator is None
    if evaluator is None:
        if cfg.cache_dir is not None:
            # a persistent cache needs a program identity; bare run_ga has
            # none, and an anonymous key would serve one program's timings
            # to every other program sharing the cache_dir
            raise ValueError(
                "GAConfig.cache_dir requires a program fingerprint; call "
                "ga_search (which keys the cache by the region "
                "graph) or pass a pre-built Evaluator")
        if cfg.pool is not None:
            raise ValueError(
                "GAConfig.pool requires a fitness-factory ProcessPool; call "
                "ga_search / Offloader.plan (which own the pool "
                "lifecycle) or pass a pre-built Evaluator")
        evaluator = Evaluator(fitness_fn, workers=cfg.workers,
                              screen_top_k=cfg.screen_top_k,
                              compile_workers=cfg.compile_workers)

    multi = objective_fn is not None
    archive: dict[tuple, Evaluation] = {}   # every measured pattern (multi)

    def _front_of_archive() -> list[Evaluation]:
        """Non-dominated subset of every pattern seen, fastest-first."""
        evs = [e for e in archive.values()
               if e.valid and math.isfinite(e.time_s)]
        pts = [objective_fn(e) for e in evs]
        keep = [k for k in pareto_front(pts)
                if all(math.isfinite(v) for v in pts[k])]
        return sorted((evs[k] for k in keep), key=lambda e: e.time_s)

    def finish(best, history, baseline) -> GAResult:
        st = evaluator.stats
        corr = getattr(evaluator, "surrogate_rank_correlation",
                       lambda: float("nan"))()
        if owns_evaluator:
            evaluator.close()
        if multi:
            front = _front_of_archive()
        else:
            front = [best] if best.valid and math.isfinite(best.time_s) \
                else []
        return GAResult(
            best, history, evaluations=st.measurements,
            cache_hits=st.cache_hits + st.inflight_hits,
            baseline=baseline, persistent_hits=st.persistent_hits,
            screened_out=st.screened_out,
            duplicates_avoided=dup_avoided,
            wall_s=time.perf_counter() - t_start,
            eval_wall_s=st.eval_wall_s,
            surrogate_rank_corr=corr,
            compile_overlap_saved_s=getattr(st, "compile_overlap_saved_s",
                                            0.0),
            overlap_est_saved_s=getattr(st, "overlap_est_saved_s", 0.0),
            overlap_disabled=getattr(st, "overlap_disabled", False),
            front=front)

    dup_avoided = 0
    if length == 0:
        ev = evaluator.evaluate(())
        if multi:
            archive[ev.bits] = ev
        return finish(ev, [], ev)

    def _remutate(chromo: list, pos: int) -> None:
        """Reassign one gene: bit flip for binary, random *other* value else
        (binary keeps the historical rng stream byte-identical)."""
        if arity == 2:
            chromo[pos] ^= 1
        else:
            chromo[pos] = int((chromo[pos] + 1 + rng.integers(0, arity - 1))
                              % arity)

    # --- population init: all-off / all-on, warm-start seeds, random -------
    pop: list[tuple] = [tuple([0] * length), tuple([1] * length)]
    for s in seeds:
        s = tuple(int(v) for v in s)
        if len(s) == length and all(0 <= v < arity for v in s) \
                and s not in pop:
            pop.append(s)
    while len(pop) < cfg.population:
        pop.append(tuple(int(b) for b in rng.integers(0, arity, length)))
    pop = pop[: cfg.population]

    baseline = evaluator.evaluate(tuple([0] * length))
    history: list[dict] = []
    best: Optional[Evaluation] = None
    stale = 0

    for gen in range(cfg.generations):
        # whole-generation batch: dedup + (optionally) parallel measurement
        with obs_trace.span("ga.generation", generation=gen) as gspan:
            evals = evaluator.evaluate_batch(pop)
            gen_best = min(evals, key=lambda e: e.time_s)
            if best is None or gen_best.time_s < best.time_s:
                best = gen_best
                stale = 0
            else:
                stale += 1
            finite = [e.time_s for e in evals
                      if math.isfinite(e.time_s)]
            entry = {
                "generation": gen,
                "best_time_s": best.time_s,
                "gen_best_time_s": gen_best.time_s,
                "mean_time_s": float(np.mean(finite)) if finite
                else float("inf"),
                "n_invalid": sum(1 for e in evals if not e.valid),
            }
            if multi:
                for p, e in zip(pop, evals):
                    archive[p] = e
                entry["front_size"] = len(_front_of_archive())
                obs_metrics.gauge("ga.front_size").set(entry["front_size"])
            history.append(entry)
            gspan.set(**history[-1])
        obs_metrics.counter("ga.generations").inc()
        obs_metrics.gauge("ga.best_time_s").set(best.time_s)
        obs_metrics.gauge("ga.gen_mean_time_s").set(
            history[-1]["mean_time_s"]
            if math.isfinite(history[-1]["mean_time_s"]) else -1.0)
        obs_metrics.counter("ga.invalid").inc(history[-1]["n_invalid"])
        if log:
            log(f"gen {gen}: best={best.time_s:.6g}s "
                f"mean={history[-1]['mean_time_s']:.6g}s "
                f"invalid={history[-1]['n_invalid']}")
        if cfg.patience is not None and stale >= cfg.patience:
            break

        if not multi:
            # --- selection: fitness-proportional (roulette) ----------------
            fits = np.array([e.fitness for e in evals])
            if fits.sum() <= 0:
                probs = np.full(len(pop), 1.0 / len(pop))
            else:
                probs = fits / fits.sum()

            ranked = sorted(zip(pop, evals), key=lambda pe: pe[1].time_s)
            next_pop: list[tuple] = [p for p, _ in ranked[: cfg.elite]]
            proposed = set(next_pop)                              # elite copy

            def draw_parents() -> tuple[int, int]:
                i, j = rng.choice(len(pop), size=2, p=probs)
                return int(i), int(j)
        else:
            # --- NSGA selection: non-domination rank + crowding ------------
            pts = [objective_fn(e) for e in evals]
            rank = [0] * len(pop)
            crowd = [0.0] * len(pop)
            for r, fr in enumerate(non_dominated_sort(pts)):
                fr_dist = crowding_distances([pts[i] for i in fr])
                for i, d in zip(fr, fr_dist):
                    rank[i] = r
                    crowd[i] = d
            order = sorted(range(len(pop)),
                           key=lambda i: (rank[i], -crowd[i]))
            next_pop = []
            for i in order:           # elites: best by (rank, crowding),
                if pop[i] not in next_pop:          # distinct patterns only
                    next_pop.append(pop[i])
                if len(next_pop) >= cfg.elite:
                    break
            proposed = set(next_pop)

            def _tourney() -> int:
                """Binary tournament: lower rank wins, crowding breaks ties
                (prefer the less crowded — keeps front spread)."""
                i, j = (int(v) for v in rng.integers(0, len(pop), size=2))
                return i if (rank[i], -crowd[i]) <= (rank[j], -crowd[j]) \
                    else j

            def draw_parents() -> tuple[int, int]:
                return _tourney(), _tourney()

        while len(next_pop) < cfg.population:
            i, j = draw_parents()
            a, b = list(pop[i]), list(pop[j])
            if rng.random() < cfg.crossover_rate and length > 1:
                cut = int(rng.integers(1, length))
                a = a[:cut] + b[cut:]
            for t in range(length):                       # gene mutation
                if rng.random() < cfg.mutation_rate:
                    _remutate(a, t)
            # duplicate-avoiding offspring (arXiv:2002.12115): a child whose
            # pattern is already measured (or already in this generation)
            # wastes its measurement slot — re-mutate it a bounded number of
            # times; an unresolvable duplicate is kept (cache hit, harmless)
            retries = 0
            while (retries < cfg.dup_retries
                   and (tuple(a) in proposed
                        or evaluator.is_measured(tuple(a)))):
                _remutate(a, int(rng.integers(0, length)))
                retries += 1
            child = tuple(a)
            if retries and child not in proposed \
                    and not evaluator.is_measured(child):
                dup_avoided += 1
            next_pop.append(child)
            proposed.add(child)
        pop = next_pop

    assert best is not None
    return finish(best, history, baseline)
