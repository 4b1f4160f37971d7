"""Port of ``repro/core/offload.py``: ``Offloader``, ``plan``,
``ga_search`` (with its surrogate, auto-screening and process pool),
``OffloadResult`` and the ``SeedBank``.

The unified offload pipeline: one entry point for every frontend.

The paper's claim is a *common* automatic offloading method across source
languages (§3.3).  :meth:`Offloader.plan` takes a target — numeric Python
source (a string, a ``PyProgram``, or a function without
``options["example_args"]``), an ``nn.Module`` or a callable with
``options["example_args"]`` (exported with ``torch.export``), an
architecture config, or a bare ``RegionGraph`` — resolves the registered
frontend for it, and drives the pipeline:

  normalize -> build RegionGraph -> function-block pass (pattern DB)
     -> gene coding over a destination alphabet (ref / fused / kernel)
     -> seed the GA population (pattern-DB hits + similarity neighbors)
     -> evaluate through the batching engine (cache, dedup, screening,
        workers / process pool, compile overlap) -> verify
     -> one unified OffloadResult whose ``artifact`` runs.

The one-liner path is :func:`plan`.
"""
from __future__ import annotations

import dataclasses
import math
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

from repro_torch.core import similarity as sim
from repro_torch.core.evaluator import (Evaluator, ProcessPool,
                                        last_rank_corr, record_search_meta,
                                        transfer_cost_surrogate)
from repro_torch.core.journal import Journal
import repro_torch.core.frontends  # noqa: F401 — registers the frontends
from repro_torch.core.frontends.registry import (FitnessBundle, OffloadConfig,
                                                 decoded_pattern, detect_frontend,
                                                 get_frontend, resolve_alphabet)
from repro_torch.core.ga import Evaluation, GAConfig, GAResult, run_ga
from repro_torch.core.genes import (GeneCoding, coding_from_graph,
                                    get_destination, modeled_cost_s)
from repro_torch.core.ir import RegionGraph
from repro_torch.core.transfer_planner import TransferPlan, plan_transfers
from repro_torch.core.variants import generic_plan_report
from repro_torch.obs import trace as obs_trace

__all__ = ["OffloadConfig", "OffloadResult", "Offloader", "PlanContext",
           "SeedBank", "ga_search", "phenotype_key", "plan",
           "resolve_alphabet", "search_fingerprint"]


def search_fingerprint(graph: RegionGraph, coding: Optional[GeneCoding] = None,
                       exclude: Sequence[str] = (),
                       cache_extra: str = "") -> str:
    """The persistent-cache fingerprint ``ga_search`` keys a search by —
    exposed so tools can open the measurement journal and fitted-surrogate
    records a search wrote."""
    if coding is None:
        coding = coding_from_graph(graph, exclude=exclude)
    return graph.fingerprint(f"{cache_extra}|exclude={sorted(exclude)}"
                             f"|dest={coding.destinations}")


# ---------------------------------------------------------------------------
# GA search stage
# ---------------------------------------------------------------------------


def phenotype_key(coding: GeneCoding,
                  resolver: Optional[Callable[[str, Any], Any]] = None
                  ) -> Callable[[tuple], Any]:
    """Canonicalize a chromosome to its *phenotype*: the decoded
    region -> implementation map plus any placement-tagged destination
    assignment (``Destination.placement_tag``).

    Chromosomes that decode to the same program (clamped ``impl_index`` on
    regions with short implementation menus, alphabet entries aliasing the
    same impl) are measured once per *program*, not once per bit string —
    the ROADMAP's phenotype-dedup.  Destinations whose assignment changes
    the phenotype beyond the decoded impl map carry a placement tag:
    cost-only stubs (reference impl + a modeled charge) and mesh
    destinations (reference impl, but sharded execution or a modeled mesh
    charge), so parking a gene there is a different phenotype than leaving
    it on the reference path.

    ``resolver`` folds the frontend's *bind results* into the key
    (ROADMAP's resolution-fallback slice): ``resolver(region, impl_id)``
    returns the implementation that would actually run — e.g. the export
    engine's eager variant resolution, where two variants that both fall
    back to ref at a site are the same program and share one measurement.
    Resolution must be static per (region, impl) for the search's lifetime
    (true of eager binds over fixed avals); a resolver error keeps the
    decoded id, never loses a measurement.
    """
    dests = [get_destination(d) for d in coding.destinations]

    def resolve(region: str, impl_id: Any) -> Any:
        if resolver is None:
            return impl_id
        try:
            out = resolver(region, impl_id)
        except Exception:  # noqa: BLE001 — a broken resolver only weakens
            return impl_id  # dedup, it must never lose a measurement
        return impl_id if out is None else out

    def key(bits: tuple) -> Any:
        bits = tuple(bits)
        if len(bits) != coding.length:     # foreign bits (stale cache line)
            return ("raw", bits)
        impl = coding.decode(bits)
        # regions claimed by an active block gene are inert: their decoded
        # impl is already forced to ref by decode(), and a stub destination
        # parked on them charges nothing (modeled_cost_s skips them), so
        # they must not split phenotypes either
        claimed = coding.claimed_members(bits)
        tags = tuple((s.region, dests[int(v)].placement_tag)
                     for s, v in zip(coding.sites, bits)
                     if dests[int(v)].placement_tag is not None
                     and s.region not in claimed)
        return (tuple((s.region, str(resolve(s.region, impl[s.region])))
                      for s in coding.sites),
                tags)

    return key


def ga_search(graph: RegionGraph, fitness_fn: Callable[[tuple], Evaluation],
              ga_cfg: Optional[GAConfig] = None,
              *, coding: Optional[GeneCoding] = None,
              exclude: Sequence[str] = (),
              log: Optional[Callable[[str], None]] = None,
              cache_extra: str = "",
              evaluator: Optional[Evaluator] = None,
              seeds: Sequence[Sequence[int]] = (),
              impl_resolver: Optional[Callable[[str, Any], Any]] = None,
              objective_fn: Optional[Callable[[Evaluation], tuple]] = None
              ) -> tuple[GeneCoding, GAResult]:
    """Run the GA over a graph's unclaimed offloadable regions.

    Owns the evaluation engine unless one is passed in: persistent cache
    keyed by the graph's content fingerprint (plus ``cache_extra`` for
    measurement context the graph can't see), a screening surrogate
    (always attached, so every search reports its surrogate rank
    correlation; screening additionally requires ``screen_top_k``), and —
    when ``ga_cfg.pool`` names a registered fitness factory — a spawn
    :class:`ProcessPool` for cross-process measurement.

    The surrogate is *learned where the evidence allows*: with a
    ``cache_dir``, the fingerprint's measurement journal is fitted
    (:func:`repro_torch.core.surrogate.fit_surrogate`, hand formula as prior)
    and the fitted model replaces the static transfer-cost formula
    whenever its journal rank correlation is strictly better — so
    screening improves with every search instead of merely being measured.
    ``GAResult.surrogate_kind`` records which model ranked the offspring.

    ``impl_resolver`` (usually ``FitnessBundle.impl_resolver``) folds the
    frontend's bind results into the phenotype key, so chromosomes whose
    variants fall back to the same implementation share one measurement.

    A multi-axis ``cfg.objectives`` tuple (e.g.
    :data:`repro_torch.core.objectives.OBJECTIVES`) switches ``run_ga`` to
    NSGA-style Pareto selection: an objective-vector function is built from
    the graph/coding (or taken from ``objective_fn``), every new
    measurement is annotated with per-objective detail fields so the
    journal learns them, and — with a ``cache_dir`` — one ridge surrogate
    per extra objective is fitted and persisted after the search (screening
    itself stays latency-ranked).
    """
    from repro_torch.core import objectives as objmod

    cfg = ga_cfg or GAConfig()
    if coding is None:
        # bare ga_search has no config/frontend in scope: the precedence
        # helper resolves to the default alphabet (one rule everywhere)
        coding = coding_from_graph(graph, exclude=exclude,
                                   destinations=resolve_alphabet(None))
    multi = len(tuple(cfg.objectives)) > 1 or objective_fn is not None
    if multi and objective_fn is None:
        objective_fn = objmod.make_objective_fn(graph, coding,
                                                cfg.objectives)
    owns = evaluator is None
    pool: Optional[ProcessPool] = None
    fingerprint = ""
    surrogate_kind = "static"
    if evaluator is None:
        surrogate = transfer_cost_surrogate(graph, coding)
        fingerprint = search_fingerprint(graph, coding, exclude, cache_extra)
        if cfg.cache_dir and cfg.fit_surrogate:
            # journal-fitted surrogate (ROADMAP: *fit* the surrogate
            # against measurement journals): prefer the regression over
            # the hand formula only when the journal proves it ranks this
            # program's patterns strictly better
            from repro_torch.core.surrogate import fit_surrogate
            fitted = fit_surrogate(graph, coding, cfg.cache_dir,
                                   fingerprint, prior=surrogate,
                                   min_records=cfg.surrogate_min_records)
            if fitted is not None and fitted.beats_static:
                surrogate = fitted
                surrogate_kind = "fitted"
                if log:
                    log(f"surrogate: journal fit over {fitted.n_records} "
                        f"records (rank corr {fitted.rank_corr:.2f} > "
                        f"static {fitted.static_rank_corr:.2f}) replaces "
                        f"the hand formula")
        top_k = cfg.screen_top_k
        if top_k is None and cfg.auto_screen and cfg.cache_dir:
            # surrogate auto-screening (ROADMAP): a prior search of this
            # exact program recorded how well the surrogate ranked its
            # offspring — when that correlation clears the bar (and is
            # fresh enough to trust), screening is evidence-backed and
            # switches itself on
            corr = last_rank_corr(cfg.cache_dir, fingerprint,
                                  max_age_s=cfg.auto_screen_horizon_s)
            if corr is not None and corr >= cfg.auto_screen_corr:
                top_k = max(2, cfg.population // 2)
                if log:
                    log(f"auto-screen: prior surrogate rank corr "
                        f"{corr:.2f} >= {cfg.auto_screen_corr:.2f} -> "
                        f"screen_top_k={top_k}")
        common = dict(cache_dir=cfg.cache_dir, fingerprint=fingerprint,
                      surrogate=surrogate, screen_top_k=top_k,
                      phenotype_key=phenotype_key(coding,
                                                  resolver=impl_resolver),
                      compile_workers=cfg.compile_workers,
                      annotate=objmod.annotate_objectives(graph, coding)
                      if multi else None)
        if cfg.pool is not None:
            pool = ProcessPool(cfg.pool, workers=cfg.workers or None)
            evaluator = Evaluator(None, **pool.evaluator_kwargs(), **common)
        else:
            evaluator = Evaluator(fitness_fn, workers=cfg.workers, **common)
    try:
        ga = run_ga(coding.length, fitness_fn, cfg, log=log,
                    evaluator=evaluator, arity=coding.arity, seeds=seeds,
                    objective_fn=objective_fn if multi else None)
        ga = dataclasses.replace(ga, surrogate_kind=surrogate_kind)
        if owns and cfg.cache_dir and ga.screened_out == 0:
            # only unscreened searches are evidence: a screened search
            # measures the correlation on surrogate-selected survivors
            # (range-restricted), which would let auto-screening justify
            # itself with its own output
            record_search_meta(cfg.cache_dir, fingerprint,
                               ga.surrogate_rank_corr,
                               horizon_s=cfg.auto_screen_horizon_s,
                               kind=surrogate_kind)
        if owns and multi and cfg.cache_dir and cfg.fit_surrogate:
            # per-objective ridge fits from the (now annotated) journal —
            # persisted for inspection/screening evidence, one model per
            # extra objective from the same measurement rows
            from repro_torch.core.surrogate import fit_surrogate
            for obj in tuple(cfg.objectives):
                if obj != "latency":
                    fit_surrogate(graph, coding, cfg.cache_dir, fingerprint,
                                  min_records=cfg.surrogate_min_records,
                                  objective=obj)
    finally:
        if owns:
            evaluator.close()
            if pool is not None:
                pool.close()
    return coding, ga


# ---------------------------------------------------------------------------
# seed bank: similarity-based warm starts across programs
# ---------------------------------------------------------------------------


def _map_destination_value(value: int, rec_destinations: Sequence[str],
                           coding: GeneCoding) -> int:
    """Translate one recorded gene value into the current alphabet.

    Cross-destination mapping (ROADMAP): a neighbor searched over a
    *different* alphabet (a GPU gene seeding an FPGA search, a binary gene
    seeding a variant search).  The recorded *destination name* is looked up
    in the current alphabet; a name the alphabet lacks maps by intent —
    reference stays reference, anything offloaded maps to the current
    primary accelerator (index 1) so the warm start preserves the on/off
    shape of the neighbor's pattern.  Legacy records without destination
    names clamp, preserving historical behavior.
    """
    value = int(value)
    if not rec_destinations:
        return min(max(value, 0), coding.arity - 1)
    if not (0 <= value < len(rec_destinations)):
        return 0
    name = rec_destinations[value]
    if name in coding.destinations:
        return coding.destinations.index(name)
    if value == 0:
        return 0
    return 1 if coding.arity > 1 else 0


class SeedBank:
    """Persistent (frontend, graph-vector) -> best-pattern store.

    The measurement cache only helps the *same* program; the seed bank helps
    a *near*-identical one (ROADMAP: similarity-based reuse): after every
    search the winning pattern is recorded with the program's Deckard-style
    characteristic vector, and a new search seeds its GA population from the
    best patterns of its nearest neighbors (mapped by region name and by
    destination *name* across alphabets, unknown regions defaulting to the
    reference destination).

    Hygiene: the journal is append-only (concurrent writers share it), with
    line order as the recency order.  A record that contributes a seed is
    re-appended ("touched"), and when the file outgrows ``2 * max_records``
    lines it is compacted — duplicates collapse to their most recent
    occurrence and only the newest ``max_records`` survive — an LRU bound
    instead of unbounded growth.  Writes (appends and the
    read-rewrite-replace compaction) serialize on a sidecar lock file so a
    concurrent writer's append can't vanish mid-compaction; reads stay
    lock-free (torn trailing lines are skipped by the loader).
    """

    def __init__(self, cache_dir: str, max_records: int = 128):
        os.makedirs(cache_dir, exist_ok=True)
        self.path = os.path.join(cache_dir, "seed_bank.jsonl")
        self._journal = Journal(self.path)
        self.max_records = max(1, int(max_records))

    @staticmethod
    def _key(rec: dict) -> tuple:
        return (rec.get("frontend"), rec.get("source"),
                tuple(rec.get("sites", ())), tuple(rec.get("values", ())),
                tuple(rec.get("destinations", ())))

    def _live(self) -> list[dict]:
        """Journal collapsed to unique records, oldest -> newest, bounded."""
        by_key: dict[tuple, dict] = {}
        for rec in self._journal.records():
            by_key.pop(self._key(rec), None)
            by_key[self._key(rec)] = rec      # reinsert: moves to the tail
        live = list(by_key.values())
        return live[-self.max_records:]

    def _append(self, recs: list[dict]) -> None:
        self._journal.append(recs)

    def _maybe_compact(self) -> None:
        # re-reads under the lock (Journal.compact), so a concurrent
        # writer's append can't land between read and replace
        self._journal.compact(lambda _recs: self._live(),
                              threshold=2 * self.max_records)

    def record(self, graph: RegionGraph, coding: GeneCoding,
               values: Sequence[int]) -> None:
        rec = {
            "frontend": graph.frontend,
            "source": graph.source_name,
            "vector": sim.graph_vector(graph),
            "sites": [s.region for s in coding.sites],
            "values": [int(v) for v in values],
            "destinations": list(coding.destinations),
        }
        self._append([rec])
        self._maybe_compact()

    def neighbor_seeds(self, graph: RegionGraph, coding: GeneCoding,
                       min_similarity: float = 0.75,
                       limit: int = 3) -> list[tuple]:
        vec = sim.graph_vector(graph)
        scored: list[tuple[float, dict]] = []
        for rec in self._live():
            if rec.get("frontend") != graph.frontend:
                continue
            s = sim.similarity(vec, rec.get("vector") or {})
            if s >= min_similarity:
                scored.append((s, rec))
        scored.sort(key=lambda sr: -sr[0])
        seeds: list[tuple] = []
        seen: set = set()
        used: list[dict] = []
        for _, rec in scored:
            site_vals = dict(zip(rec.get("sites", ()), rec.get("values", ())))
            dests = list(rec.get("destinations", ()))
            seed = tuple(
                _map_destination_value(site_vals.get(s.region, 0), dests,
                                       coding)
                for s in coding.sites)
            if seed not in seen:
                seeds.append(seed)
                seen.add(seed)
                used.append(rec)
            if len(seeds) >= limit:
                break
        if used:
            self._append(used)            # LRU touch: contributors stay fresh
            self._maybe_compact()
        return seeds


def _pattern_db_seed(graph: RegionGraph, coding: GeneCoding,
                     db) -> list[tuple]:
    """One warm-start chromosome: every gene whose region name-matches a
    pattern-DB record starts on the primary accelerator."""
    values = []
    any_hit = False
    for site in coding.sites:
        region = graph.by_name(site.region)
        hit = any(m.how == "name"
                  for m in db.match_region(region, graph.frontend))
        values.append(1 if hit else 0)
        any_hit |= hit
    return [tuple(values)] if any_hit else []


# ---------------------------------------------------------------------------
# the unified result
# ---------------------------------------------------------------------------


@dataclass
class OffloadResult:
    """What every frontend's planning run returns."""

    frontend: str
    graph: RegionGraph
    coding: GeneCoding
    block: Any                        # BlockOffloadResult
    ga: GAResult
    pattern: dict                     # region -> implementation (incl. blocks)
    destinations: dict                # gene region -> destination name
    baseline: Evaluation              # the all-reference program
    best: Evaluation
    transfer_plan: TransferPlan
    artifact: Any                     # frontend deliverable (impl map,
                                      # PyOffloadArtifact, ExecPlan, ...)
    verification: dict                # {"mode": ..., "verified": bool}
    report: Any = None                # SubstitutionReport — the uniform
                                      # what-runs-where record every
                                      # frontend produces (ground truth for
                                      # fallbacks; see repro_torch.core.variants)
    details: dict = field(default_factory=dict)  # frontend-private extras

    @property
    def speedup(self) -> float:
        if not self.baseline.valid or not math.isfinite(self.best.time_s) \
                or self.best.time_s <= 0:
            return float("nan")
        return self.baseline.time_s / self.best.time_s

    @property
    def savings(self) -> dict:
        """The measurement-economy report (arXiv:2002.12115 accounting)."""
        g = self.ga
        return {
            "measurements": g.evaluations,
            "cache_hits": g.cache_hits,
            "persistent_hits": g.persistent_hits,
            "screened_out": g.screened_out,
            "duplicates_avoided": g.duplicates_avoided,
            "measurements_saved": g.measurements_saved,
            "surrogate_rank_corr": g.surrogate_rank_corr,
            "surrogate_kind": g.surrogate_kind,
            "wall_s": g.wall_s,
            "eval_wall_s": g.eval_wall_s,
            "compile_overlap_saved_s": g.compile_overlap_saved_s,
        }

    @property
    def front(self) -> list[Evaluation]:
        """The search's Pareto-optimal Evaluations (multi-objective mode;
        single-objective searches report just the best)."""
        return self.ga.front

    def front_summary(self) -> list[dict]:
        """JSON-safe Pareto front: one dict per non-dominated pattern with
        its bits and per-objective values (persisted into PlanRecord so a
        service can swap operating points without a new search).  Latency
        comes from the measurement; energy/transfer prefer the annotated
        detail fields and fall back to the objective models."""
        from repro_torch.core import objectives as objmod

        out = []
        for ev in self.ga.front:
            vals = objmod.objective_values(ev, self.graph, self.coding)
            out.append({
                "bits": [int(v) for v in ev.bits],
                "latency_s": float(vals[0]),
                "energy_j": float(vals[1]),
                "transfer_bytes": float(vals[2]),
            })
        return out

    def operating_point(self, objective: str = "latency") -> Evaluation:
        """The front point optimal on one axis (an operating point a
        service picks per traffic level: ``latency`` under load,
        ``energy`` when idle).  Ties break toward lower latency; an empty
        front (single-objective search) returns ``best``."""
        from repro_torch.core import objectives as objmod

        if not self.ga.front:
            return self.best
        try:
            ax = objmod.OBJECTIVES.index(objective)
        except ValueError:
            raise ValueError(f"unknown objective {objective!r}; known: "
                             f"{objmod.OBJECTIVES}") from None
        key = {}
        for ev in self.ga.front:
            key[id(ev)] = objmod.objective_values(ev, self.graph,
                                                  self.coding)
        return min(self.ga.front,
                   key=lambda e: (key[id(e)][ax], key[id(e)][0]))

    def summary(self) -> dict:
        return {
            "frontend": self.frontend,
            "gene_length": self.coding.length,
            "destinations": self.coding.destinations,
            "best": "".join(str(int(v)) for v in self.best.bits),
            "speedup": self.speedup,
            "verified": self.verification.get("verified", False),
            "substituted": dict(self.report.substituted) if self.report
            else {},
            "front_size": len(self.ga.front),
            **self.savings,
        }


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


class _DestinationCostFitness:
    """Charge cost-only destinations' modeled time on top of measurements,
    preserving the inner fitness's two-phase (prepare/measure) protocol so
    the compile-overlap path still applies."""

    def __init__(self, graph: RegionGraph, coding: GeneCoding,
                 inner: Callable, mesh_executed: bool = False):
        self._graph, self._coding, self._inner = graph, coding, inner
        self._mesh_executed = mesh_executed

    def _charge(self, ev: Evaluation) -> Evaluation:
        pen = modeled_cost_s(self._graph, self._coding, ev.bits,
                             mesh_executed=self._mesh_executed)
        if pen > 0 and math.isfinite(ev.time_s):
            ev = Evaluation(ev.bits, ev.time_s + pen, ev.valid,
                            {**ev.detail, "modeled_cost_s": pen})
        return ev

    def __call__(self, values: tuple) -> Evaluation:
        return self._charge(self._inner(tuple(values)))


class _TwoPhaseDestinationCostFitness(_DestinationCostFitness):
    def prepare(self, values: tuple):
        return self._inner.prepare(tuple(values))

    def measure(self, prepared) -> Evaluation:
        return self._charge(self._inner.measure(prepared))


def _with_destination_costs(graph: RegionGraph, coding: GeneCoding,
                            fitness_fn: Callable,
                            mesh_executed: bool = False) -> Callable:
    """Charge modeled destination time on top of measurements: cost-only
    stubs always, mesh genes unless the frontend's measured path genuinely
    executes them on a mesh (``mesh_executed``, from
    :attr:`FitnessBundle.mesh_executed`)."""
    dests = [get_destination(d) for d in coding.destinations]

    def may_charge(d) -> bool:
        if d.placement_tag is None:
            return False               # plain executable device: measured
        return not (mesh_executed and not d.is_cost_only)

    if not any(may_charge(d) for d in dests):
        return fitness_fn
    cls = _TwoPhaseDestinationCostFitness \
        if hasattr(fitness_fn, "prepare") and hasattr(fitness_fn, "measure") \
        else _DestinationCostFitness
    return cls(graph, coding, fitness_fn, mesh_executed=mesh_executed)


@dataclass
class PlanContext:
    """The search-free front half of a planning run.

    ``Offloader.prepare`` normalizes a target through its frontend — graph,
    fitness bundle, gene coding, and the persistent-cache ``fingerprint``
    the search would key its journals by — **without running any search**.
    The context is everything the execution side needs: ``Offloader.apply``
    decodes stored winner bits into the frontend artifact (a pure artifact
    load), and ``Offloader.search`` runs the GA over it.  The plan service
    uses prepare for request admission (fingerprint lookup / coalescing)
    and apply for warm plan-store hits.
    """

    frontend: str
    target: Any
    inputs: Optional[dict]
    config: OffloadConfig
    graph: RegionGraph
    bundle: FitnessBundle
    coding: GeneCoding
    fingerprint: str

    @property
    def sites(self) -> tuple[str, ...]:
        """Gene-site region names, in gene order — the plan-store
        compatibility check (bits only make sense against these)."""
        return tuple(s.region for s in self.coding.sites)


@dataclass
class Offloader:
    """The unified multi-frontend offload planner.

    ``plan`` is the one-shot pipeline; it is literally
    ``search(prepare(target))``.  The halves are public because the
    persistent planning service needs them apart: ``prepare`` admits a
    request (fingerprint, no search), ``apply`` loads a stored plan's
    artifact (no search), ``search`` is the only place measurements run.
    """

    config: OffloadConfig = field(default_factory=OffloadConfig)

    def prepare(self, target: Any, inputs: Optional[dict] = None,
                config: Optional[OffloadConfig] = None) -> PlanContext:
        """Frontend half of planning: normalize -> graph -> fitness bundle
        -> gene coding -> search fingerprint.  Runs no search and takes no
        measurement (frontends may run the *reference* program once to have
        something to verify against)."""
        cfg = config or self.config
        log = cfg.log or (lambda s: None)
        name = cfg.frontend or detect_frontend(target, cfg)
        fe = get_frontend(name)
        log(f"frontend: {name}")

        with obs_trace.maybe_tracing(cfg.trace), \
                obs_trace.span("plan.prepare", frontend=name) as sp:
            if hasattr(fe, "normalize_target"):
                target = fe.normalize_target(target, inputs, cfg)
            with obs_trace.span("prepare.build_graph"):
                graph = fe.build_graph(target, inputs, cfg)
            with obs_trace.span("prepare.make_fitness"):
                bundle: FitnessBundle = fe.make_fitness(graph, target,
                                                        inputs, cfg)
            destinations = resolve_alphabet(cfg, bundle.destinations)
            coding = coding_from_graph(graph, exclude=bundle.claimed,
                                       destinations=destinations)
            log(f"graph: {graph.summary()} gene_length={coding.length} "
                f"alphabet={coding.destinations}")
            fingerprint = search_fingerprint(graph, coding, bundle.claimed,
                                             bundle.cache_extra)
            sp.set(fingerprint=fingerprint, gene_length=coding.length,
                   regions=len(graph.regions))
        return PlanContext(frontend=name, target=target, inputs=inputs,
                           config=cfg, graph=graph, bundle=bundle,
                           coding=coding, fingerprint=fingerprint)

    def apply(self, ctx: PlanContext, values: Sequence[int]) -> Any:
        """Pure artifact loader: decode ``values`` (a stored winner
        chromosome) into the frontend deliverable — ``SubstitutedCallable``,
        ``PyOffloadArtifact``, ``ExecPlan``, or an impl map.  No search, no
        measurement: this is the execution side of the split, what a warm
        plan-store hit runs instead of a GA."""
        values = tuple(int(v) for v in values)
        if len(values) != ctx.coding.length:
            raise ValueError(
                f"plan has {len(values)} genes but the program codes "
                f"{ctx.coding.length} — stored plan does not fit this target")
        fe = get_frontend(ctx.frontend)
        with obs_trace.maybe_tracing(ctx.config.trace), \
                obs_trace.span("plan.apply", frontend=ctx.frontend,
                               bits="".join(str(v) for v in values)):
            return fe.apply_plan(ctx.graph, ctx.coding, values, ctx.bundle)

    def plan(self, target: Any, inputs: Optional[dict] = None,
             config: Optional[OffloadConfig] = None) -> OffloadResult:
        """Plan offloading for any supported target; see module docstring."""
        cfg = config or self.config
        with obs_trace.maybe_tracing(cfg.trace), \
                obs_trace.span("offload.plan") as sp:
            ctx = self.prepare(target, inputs, config)
            sp.set(frontend=ctx.frontend, fingerprint=ctx.fingerprint)
            return self.search(ctx)

    def search(self, ctx: PlanContext,
               ga: Optional[GAConfig] = None,
               extra_seeds: Sequence[Sequence[int]] = ()) -> OffloadResult:
        """Measurement half of planning: compose the fitness, warm-start the
        population, run the GA, and assemble the unified result.

        ``ga`` overrides ``ctx.config.ga`` (the refinement loop bumps seed /
        generations); ``extra_seeds`` are prepended warm starts (the
        refinement loop seeds with the deployed plan's chromosome).
        """
        with obs_trace.maybe_tracing(ctx.config.trace), \
                obs_trace.span("plan.search", frontend=ctx.frontend,
                               fingerprint=ctx.fingerprint) as sp:
            res = self._search(ctx, ga, extra_seeds)
            sp.set(best_time_s=res.best.time_s,
                   evaluations=res.ga.evaluations,
                   generations=len(res.ga.history),
                   front_size=len(res.ga.front))
            return res

    def _search(self, ctx: PlanContext, ga: Optional[GAConfig],
                extra_seeds: Sequence[Sequence[int]]) -> OffloadResult:
        from repro_torch.core.pattern_db import default_db

        cfg = ctx.config
        log = cfg.log or (lambda s: None)
        graph, bundle, coding = ctx.graph, ctx.bundle, ctx.coding

        fitness = cfg.fitness_fn or bundle.fitness_factory(coding)
        fitness = _with_destination_costs(graph, coding, fitness,
                                          mesh_executed=bundle.mesh_executed)

        ga_cfg = ga or cfg.ga
        if bundle.serial_only and (ga_cfg.workers > 1
                                   or ga_cfg.pool is not None):
            # wall-clock measurements interleave on shared hardware —
            # parallel timing is meaningless
            log("wall-clock fitness: forcing serial evaluation (workers=0)")
            ga_cfg = dataclasses.replace(ga_cfg, workers=0, pool=None)
        if ga_cfg.compile_workers is None and bundle.overlap_compiles:
            # the frontend asks for overlapped prepares ahead of the (still
            # strictly serial) timing loop; the evaluator's backoff turns
            # them off where they contend
            cw = min(4, os.cpu_count() or 1)
            if cw > 1:
                log(f"compile-parallel/time-serial warm-ups: "
                    f"compile_workers={cw}")
                ga_cfg = dataclasses.replace(ga_cfg, compile_workers=cw)
        if ga_cfg.pool is not None:
            # pool workers rebuild their fitness from the registered factory
            # and cannot see the fitness this pipeline just composed (block
            # claims folded into base_impl, gene exclusions, destination
            # costs, cfg.fitness_fn) — measuring one function while planning
            # another would silently corrupt the result
            raise ValueError(
                "GAConfig.pool cannot be used through Offloader.plan: the "
                "factory-built worker fitness cannot match the pipeline-"
                "composed fitness. Drive ga_search directly with a factory "
                "that reproduces your fitness, or use thread workers "
                "(GAConfig.workers) here")

        # --- GA population warm starts ---------------------------------
        seeds: list[tuple] = [tuple(int(v) for v in s) for s in extra_seeds]
        if cfg.seed_from_db and coding.length:
            seeds += _pattern_db_seed(graph, coding, cfg.db or default_db())
        bank: Optional[SeedBank] = None
        if cfg.seed_from_neighbors and ga_cfg.cache_dir:
            bank = SeedBank(ga_cfg.cache_dir)
            if coding.length:
                neigh = bank.neighbor_seeds(graph, coding)
                if neigh:
                    log(f"seed bank: {len(neigh)} neighbor seed(s)")
                seeds += neigh

        coding, ga_res = ga_search(
            graph, fitness, ga_cfg, coding=coding, exclude=bundle.claimed,
            log=log, cache_extra=bundle.cache_extra, seeds=seeds,
            impl_resolver=bundle.impl_resolver)

        best = ga_res.best
        artifact = self.apply(ctx, best.bits)
        if bank is not None and coding.length:
            bank.record(graph, coding, best.bits)
        return self._assemble(ctx, ga_res, artifact)

    def _assemble(self, ctx: PlanContext, ga_res: GAResult,
                  artifact: Any) -> OffloadResult:
        """Package search output (or a loaded plan) as the unified result."""
        cfg, graph, bundle, coding = (ctx.config, ctx.graph, ctx.bundle,
                                      ctx.coding)
        best = ga_res.best
        pattern = decoded_pattern(coding, best.bits, bundle.base_impl)
        # the uniform substitution report: frontends with a real resolution
        # step supply one (the export engine); everyone
        # else gets the generic decode-level record — same shape either way
        report = bundle.context.get("substitution_report") \
            or getattr(artifact, "report", None)
        if report is None:
            patterns = {o.region: o.pattern
                        for o in (bundle.block.offloads if bundle.block
                                  else ())}
            for r in graph.offloadable():
                if r.meta.get("pattern"):
                    patterns.setdefault(r.name, r.meta["pattern"])
            report = generic_plan_report(coding, best.bits,
                                         base_impl=bundle.base_impl,
                                         patterns=patterns)
        tp = plan_transfers(graph, pattern, hoist=cfg.hoist_transfers)

        baseline = bundle.context.get("baseline") or ga_res.baseline or best
        verification = {
            "mode": "measured" if bundle.measured else "static-cost",
            "verified": bool(best.valid) and bundle.measured,
        }
        return OffloadResult(
            frontend=ctx.frontend, graph=graph, coding=coding,
            block=bundle.block, ga=ga_res, pattern=pattern,
            destinations=coding.destinations_of(best.bits),
            baseline=baseline, best=best, transfer_plan=tp,
            artifact=artifact, verification=verification,
            report=report, details=dict(bundle.context))


def plan(target: Any, inputs: Optional[dict] = None,
         config: Optional[OffloadConfig] = None,
         **config_kwargs) -> OffloadResult:
    """The module-level one-liner: ``plan(src, inputs, ga=GAConfig(...))``.

    Builds an :class:`Offloader` around an :class:`OffloadConfig` (either
    passed whole via ``config=`` or assembled from keyword fields) and runs
    the full pipeline — the convenience path that replaced the retired
    ``plan_python_offload`` / ``plan_module_offload`` shims.  Frontend
    detection, alphabet resolution (:func:`resolve_alphabet`), seeding,
    search, and verification all behave exactly as :meth:`Offloader.plan`.
    """
    if config is not None and config_kwargs:
        raise ValueError("pass either config= or keyword fields, not both")
    cfg = config or OffloadConfig(**config_kwargs)
    return Offloader(cfg).plan(target, inputs)

