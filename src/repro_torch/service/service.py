"""Port of ``repro/service/service.py``: PlanService, the persistent
offload-planning daemon.

The library call ``Offloader.plan`` is one-shot: search, return, forget.
The paper's deployment story needs the opposite shape — many clients, one
long-lived planner whose plans persist and keep improving while serving.
This module is that daemon, three layers on top of the search stack:

**Admission + coalescing.**  ``submit(target)`` runs only the search-free
half of the pipeline (``Offloader.prepare``) to learn the request's
``search_fingerprint``, then routes: an already-deployed fingerprint is
served instantly; a fingerprint with a search in flight *joins* that search
(one future fans out to every waiter — the Evaluator's in-flight dedup
lifted a layer, from chromosomes to whole programs); a cold fingerprint is
admitted to the worker pool, where a plan-store hit becomes a warm artifact
load (no GA) and only a genuinely unknown program pays for a search.
Distinct fingerprints plan concurrently under the worker budget.

**Persistence.**  Every search's winner is written to the
:class:`~repro_torch.service.store.PlanStore` under the service directory;
the GA's measurement journals, surrogate fits and seed bank live in a cache
directory beside it (the service forces ``GAConfig.cache_dir`` there), so a
restarted service warm-loads yesterday's plans and a refinement search
re-reads yesterday's measurements.

**Background refinement + hot-swap.**  ``refine_once(fingerprint)`` resumes
the GA on a deployed program — seeded with the deployed chromosome, keyed to
the same measurement journal (persisted measurements replay for free, the
journal-fitted surrogate screens) — and, only when the new winner measures
*strictly* better than the deployed plan's recorded time, atomically
hot-swaps it: the served plan is one immutable :class:`ServedPlan` published
by a single reference assignment, so a concurrent reader sees the old plan
or the new plan, never a torn mix, and the previous plan is retained for
:meth:`PlanService.rollback`.  ``start_refinement`` runs that loop on a
daemon thread across all deployed fingerprints.

Besides, a :class:`ServedPlan` that a search produced keeps that search's
:class:`~repro_torch.core.offload.OffloadResult` in memory
(``ServedPlan.search``), for callers that report its GA accounting.

Three differences from the reference, in scheduling and cost, not in
results:

* **Measured searches take the card one at a time.**  A search whose
  bundle is ``serial_only`` (the export and python_ast frontends' measured
  bundles: wall-clock timing on the card) holds a process-wide lock for
  the whole ``Offloader.search`` — its prepares and verifications launch
  work on the card too, not only its timed calls — so two such searches
  never time each other.  Searches whose bundles are not ``serial_only``
  (``ir``, the module frontend's static-cost and ``lower_fn`` bundles, the
  export frontend's ``static_cost``) still run concurrently under
  ``ServiceConfig.workers``, as in the reference.
* **The caller's thread-local torch state travels with the request.**
  Grad mode, inference mode and the current CUDA device are thread-local
  in PyTorch; the search runs on a pool thread (or the refinement
  thread) under the state of the thread that submitted it, so it
  measures the program the caller would have measured with
  ``Offloader.plan``.
* **One pattern DB for the service's life.**  The port's
  ``default_db()`` exports its records (seconds of host time a request,
  where the reference traces them in milliseconds), so the service builds
  it once and passes it to every request that brings none
  (``OffloadConfig.db``).

Tracing (``torch.export``, ``make_fx``) is not thread-safe in PyTorch; the
port takes :data:`repro_torch.core.trace_lock.TRACE_LOCK` around every
trace, so concurrent admissions are safe.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from repro_torch.core.frontends.registry import OffloadConfig
from repro_torch.core.offload import OffloadResult, Offloader, PlanContext
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.service.store import (PlanRecord, PlanStore, _json_safe,
                                       env_matches, exec_plan_payload,
                                       record_from_result)

__all__ = ["PlanService", "ServedPlan", "ServiceConfig", "ServiceStats"]

#: held for the whole of a ``serial_only`` (measured) search: one at a
#: time on the card, across every service in the process
_MEASURED_SEARCH_LOCK = threading.Lock()


@dataclass
class ServiceConfig:
    """Service-level knobs (per-request planning knobs stay in
    :class:`OffloadConfig`)."""

    workers: int = 2                  # concurrent searches, distinct
                                      # fingerprints only — same-fingerprint
                                      # requests always coalesce; measured
                                      # (serial_only) searches take the card
                                      # one at a time
    history_depth: int = 8            # store versions kept per fingerprint
    refine_interval_s: float = 30.0   # background loop sleep between sweeps
    refine_generations: Optional[int] = None   # GA generations per
                                      # refinement round (None = request's)
    refine_population: Optional[int] = None    # population override, ditto
    plan_ttl_s: Optional[float] = None  # plan-store TTL: the refinement
                                      # loop sweeps evict_stale(plan_ttl_s)
                                      # once per round (deployed/in-flight
                                      # fingerprints always spared); None
                                      # disables the sweep
    busy_hz: float = 1.0              # traffic threshold for
                                      # select_for_traffic: at/above it the
                                      # latency-optimal operating point is
                                      # deployed, below it energy-optimal


@dataclass
class ServiceStats:
    """Request accounting: how much planning work the service avoided."""

    requests: int = 0        # submit() calls
    live_hits: int = 0       # served from the in-memory deployed table
    coalesced: int = 0       # joined another request's in-flight admission
    warm_loads: int = 0      # plan-store hit: artifact load, no GA search
    searches: int = 0        # full GA searches actually run
    refinements: int = 0     # refinement rounds completed
    swaps: int = 0           # refinements that hot-swapped a better plan
    rollbacks: int = 0
    evictions: int = 0       # fingerprints dropped by the TTL sweep
    env_mismatches: int = 0  # warm loads refused because the stored plan
                             # was measured on different hardware (the
                             # cross-host reuse fix: re-measured instead)
    repoints: int = 0        # operating-point swaps served straight from
                             # the stored Pareto front (no search)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclass(frozen=True)
class ServedPlan:
    """One immutable deployed plan.  Hot-swap publishes a *new* instance by
    a single reference assignment — readers that grabbed this one keep a
    consistent (record, artifact) pair forever, which is the no-torn-plan
    guarantee."""

    fingerprint: str
    record: PlanRecord               # the persisted version backing this
    artifact: Any                    # frontend deliverable, ready to run
    warm: bool                       # True = loaded from store, no search
    search: Optional[OffloadResult] = field(
        default=None, compare=False, repr=False)
                                     # the search that produced this plan,
                                     # in memory only (None for a warm
                                     # load, a repoint or a rollback): its
                                     # GA accounting, graph and coding

    @property
    def version(self) -> int:
        return self.record.version

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        a = self.artifact
        if callable(a):
            return a(*args, **kwargs)
        if hasattr(a, "run"):
            return a.run(*args, **kwargs)
        raise TypeError(
            f"artifact {type(a).__name__} is not directly runnable; read "
            f".artifact (e.g. hand an ExecPlan to runtime.serve.Server)")


@dataclass(frozen=True)
class _ThreadState:
    """The thread-local torch state of the thread that submitted a
    request, re-entered on the thread that plans it."""

    grad: bool
    inference: bool
    cuda_device: Optional[int]

    @classmethod
    def capture(cls) -> "_ThreadState":
        dev = torch.cuda.current_device() \
            if torch.cuda.is_available() and torch.cuda.is_initialized() \
            else None
        return cls(torch.is_grad_enabled(),
                   torch.is_inference_mode_enabled(), dev)

    @contextlib.contextmanager
    def entered(self):
        with contextlib.ExitStack() as stack:
            if self.cuda_device is not None:
                stack.enter_context(torch.cuda.device(self.cuda_device))
            stack.enter_context(torch.inference_mode(self.inference))
            stack.enter_context(torch.set_grad_enabled(self.grad))
            yield


@dataclass
class _Entry:
    """Mutable service-side state for one deployed fingerprint.  Only
    ``current`` is read on the hot path (single reference, atomically
    swapped); everything else is refinement bookkeeping."""

    current: ServedPlan
    ctx: PlanContext
    offloader: Offloader
    state: _ThreadState                      # the admitting caller's
    previous: Optional[ServedPlan] = None    # rollback target
    rounds: int = 0                          # refinement rounds run


def _search(off: Offloader, ctx: PlanContext, **kwargs: Any
            ) -> OffloadResult:
    """``off.search(ctx, **kwargs)``, one measured search on the card at a
    time (see the module docstring)."""
    lock = _MEASURED_SEARCH_LOCK if ctx.bundle.serial_only \
        else contextlib.nullcontext()
    with lock:
        return off.search(ctx, **kwargs)


class PlanService:
    """The planning daemon.  See module docstring for the three layers."""

    def __init__(self, store_dir: str,
                 config: Optional[OffloadConfig] = None,
                 service: Optional[ServiceConfig] = None):
        self.service_config = service or ServiceConfig()
        self.store = PlanStore(store_dir,
                               history_depth=self.service_config.history_depth)
        self.cache_dir = os.path.join(store_dir, "cache")
        self.config = self._with_cache(config or OffloadConfig())
        self.stats = ServiceStats()
        self._lock = threading.Lock()
        self._inflight: dict[str, Future] = {}
        self._entries: dict[str, _Entry] = {}
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, int(self.service_config.workers)),
            thread_name_prefix="plan-service")
        self._refine_stop = threading.Event()
        self._refine_thread: Optional[threading.Thread] = None
        self._db: Any = None
        self._db_lock = threading.Lock()

    def _with_cache(self, cfg: OffloadConfig) -> OffloadConfig:
        """Pin the GA's journals under the service directory so measurement
        history, surrogate fits, the seed bank and the plan store share one
        persistent home (a request's explicit cache_dir wins)."""
        if cfg.ga.cache_dir:
            return cfg
        return dataclasses.replace(
            cfg, ga=dataclasses.replace(cfg.ga, cache_dir=self.cache_dir))

    def _with_db(self, cfg: OffloadConfig) -> OffloadConfig:
        """Every request without a pattern DB of its own shares one
        ``default_db()``, built at the first request (a request's explicit
        ``db`` wins).  The port's ``default_db()`` exports each pattern
        record (~1-2 s of host time, twice a prepare and once a search);
        its records are the same at every build, so plans are too."""
        if cfg.db is not None:
            return cfg
        with self._db_lock:
            if self._db is None:
                from repro_torch.core.pattern_db import default_db
                self._db = default_db()
        return dataclasses.replace(cfg, db=self._db)

    # -- admission + coalescing ----------------------------------------------

    def submit(self, target: Any, inputs: Optional[dict] = None,
               config: Optional[OffloadConfig] = None) -> "Future[ServedPlan]":
        """Admit a planning request; returns a future resolving to the
        deployed plan.  Prepare (no search) runs inline to fingerprint the
        request; the expensive path runs on the worker pool at most once per
        fingerprint regardless of how many clients ask."""
        cfg = self._with_db(self._with_cache(config) if config is not None
                            else self.config)
        off = Offloader(cfg)
        ctx = off.prepare(target, inputs)
        with self._lock:
            self.stats.requests += 1
            entry = self._entries.get(ctx.fingerprint)
            if entry is not None:
                self.stats.live_hits += 1
                fut: Future = Future()
                fut.set_result(entry.current)
                outcome = "live-hit"
            else:
                pending = self._inflight.get(ctx.fingerprint)
                if pending is not None:
                    self.stats.coalesced += 1
                    fut = pending
                    outcome = "coalesced"
                else:
                    fut = Future()
                    self._inflight[ctx.fingerprint] = fut
                    outcome = "cold"
        obs_metrics.counter("service.admission", outcome=outcome).inc()
        if outcome == "cold":
            self._pool.submit(self._admit, off, ctx, fut,
                              _ThreadState.capture())
        return fut

    def plan(self, target: Any, inputs: Optional[dict] = None,
             config: Optional[OffloadConfig] = None) -> ServedPlan:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(target, inputs, config).result()

    def _admit(self, off: Offloader, ctx: PlanContext, fut: Future,
               state: _ThreadState) -> None:
        try:
            with state.entered():
                plan = self._load_or_search(off, ctx)
        except BaseException as e:  # noqa: BLE001 — fan the failure out to
            with self._lock:        # every coalesced waiter, then forget the
                self._inflight.pop(ctx.fingerprint, None)   # fingerprint so
            fut.set_exception(e)    # a later request can retry
            return
        with self._lock:
            self._entries[ctx.fingerprint] = _Entry(
                current=plan, ctx=ctx, offloader=off, state=state)
            self._inflight.pop(ctx.fingerprint, None)
        fut.set_result(plan)

    def _load_or_search(self, off: Offloader, ctx: PlanContext) -> ServedPlan:
        with obs_trace.maybe_tracing(ctx.config.trace), \
                obs_trace.span("service.admit", frontend=ctx.frontend,
                               fingerprint=ctx.fingerprint) as sp:
            rec = self.store.load(ctx.fingerprint)
            fits = (rec is not None and rec.sites == ctx.sites
                    and rec.destinations == ctx.coding.destinations)
            if fits and env_matches(rec.env):
                # warm path: stored plan fits this program AND was measured
                # on this hardware — pure artifact load
                if "exec_plan" in rec.payload:
                    artifact = self.store.rehydrate(rec)
                else:
                    artifact = off.apply(ctx, rec.bits)
                with self._lock:
                    self.stats.warm_loads += 1
                obs_metrics.counter("service.warm_loads").inc()
                sp.set(path="warm-load", version=rec.version)
                return ServedPlan(ctx.fingerprint, rec, artifact, warm=True)
            seeds: list[tuple] = []
            origin = "cold-search"
            if fits:
                # cross-host reuse fix: the chromosome fits but the record's
                # measurements came from different hardware (or an unknown
                # one) — its times are not evidence here.  Re-verify by
                # re-measuring, seeded with the foreign winner so a plan
                # that *does* transfer is found in generation 0
                with self._lock:
                    self.stats.env_mismatches += 1
                obs_metrics.counter("service.env_mismatch").inc()
                sp.set(env_mismatch=True)
                origin = "env-remeasure"
                seeds = [rec.bits]
            res = _search(off, ctx, extra_seeds=seeds)
            with self._lock:
                self.stats.searches += 1
            obs_metrics.counter("service.searches").inc()
            stored = self.store.put(record_from_result(
                res, ctx.fingerprint,
                meta={"origin": origin,
                      "evaluations": res.ga.evaluations}))
            sp.set(path=origin, version=stored.version)
            return ServedPlan(ctx.fingerprint, stored, res.artifact,
                              warm=False, search=res)

    # -- serving -------------------------------------------------------------

    def current(self, fingerprint: str) -> ServedPlan:
        """The deployed plan (an immutable snapshot — safe to use across a
        concurrent hot-swap)."""
        with self._lock:
            entry = self._entries.get(fingerprint)
        if entry is None:
            raise LookupError(f"fingerprint {fingerprint!r} is not deployed "
                              f"in this service (submit a target first)")
        return entry.current

    def endpoint(self, fingerprint: str) -> Callable[..., Any]:
        """A callable bound to the fingerprint, not the plan: every call
        snapshots ``current`` once, so calls always run a complete plan and
        pick up a hot-swap on their next invocation."""
        self.current(fingerprint)          # fail fast on unknown fingerprint

        def call(*args: Any, **kwargs: Any) -> Any:
            return self.current(fingerprint)(*args, **kwargs)

        return call

    def fingerprints(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(self._entries)

    # -- operating points (the Pareto front, served) -------------------------

    #: objective name -> per-point field in PlanRecord.front
    _FRONT_FIELDS = {"latency": "latency_s", "energy": "energy_j",
                     "transfer": "transfer_bytes"}

    def select_operating_point(self, fingerprint: str,
                               objective: str = "latency") -> ServedPlan:
        """Deploy the stored Pareto-front point optimal on one axis —
        **without a new search**: the front was measured when the plan was,
        so swapping between its points is a pure artifact re-apply plus a
        store append (ties break toward lower latency; a record with no
        front, e.g. from a single-objective search, keeps the current
        plan).  The swap publishes like a refinement hot-swap: immutable
        plan, single reference assignment, previous retained for rollback.
        """
        with self._lock:
            entry = self._entries.get(fingerprint)
        if entry is None:
            raise LookupError(f"fingerprint {fingerprint!r} is not deployed")
        try:
            axis = self._FRONT_FIELDS[objective]
        except KeyError:
            raise ValueError(
                f"unknown objective {objective!r}; known: "
                f"{tuple(self._FRONT_FIELDS)}") from None
        rec = entry.current.record
        front = [p for p in rec.front if p.get("bits")]
        if not front:
            return entry.current
        inf = float("inf")
        point = min(front, key=lambda p: (float(p.get(axis, inf)),
                                          float(p.get("latency_s", inf))))
        bits = tuple(int(v) for v in point["bits"])
        if bits == tuple(rec.bits):
            return entry.current           # already at that operating point
        artifact = entry.offloader.apply(entry.ctx, bits)
        pattern = {str(k): _json_safe(v)
                   for k, v in entry.ctx.coding.decode(bits).items()}
        stored = self.store.put(dataclasses.replace(
            rec, bits=bits, pattern=pattern,
            payload=exec_plan_payload(artifact),
            best_time_s=float(point.get("latency_s", inf)),
            meta={**rec.meta, "origin": "operating-point",
                  "objective": objective, "repointed_from": rec.version}))
        new_plan = ServedPlan(fingerprint, stored, artifact, warm=True)
        with self._lock:
            entry.previous = entry.current
            entry.current = new_plan
            self.stats.repoints += 1
        obs_metrics.counter("service.repoints", objective=objective).inc()
        return new_plan

    def select_for_traffic(self, fingerprint: str, traffic_hz: float,
                           busy_hz: Optional[float] = None) -> ServedPlan:
        """Traffic-level policy over :meth:`select_operating_point`: under
        load (>= ``busy_hz`` requests/s, default from ServiceConfig) serve
        the latency-optimal front point; idle, the energy-optimal one.
        Feed it :meth:`repro_torch.runtime.serve.Server.traffic_hz`."""
        thr = self.service_config.busy_hz if busy_hz is None \
            else float(busy_hz)
        objective = "latency" if float(traffic_hz) >= thr else "energy"
        return self.select_operating_point(fingerprint, objective)

    # -- store hygiene -------------------------------------------------------

    def evict_stale(self, max_age_s: float,
                    now: Optional[float] = None) -> tuple[str, ...]:
        """TTL sweep over the plan store: drop every fingerprint whose
        newest stored version is older than ``max_age_s`` seconds.  Plans
        that are currently deployed or mid-admission are never evicted
        (they are the ``keep`` set) — the sweep retires fingerprints no
        live client can be holding.  Returns the evicted fingerprints."""
        with self._lock:
            keep = set(self._entries) | set(self._inflight)
        evicted = self.store.evict_stale(max_age_s, now=now, keep=keep)
        if evicted:
            with self._lock:
                self.stats.evictions += len(evicted)
            obs_metrics.counter("service.evictions").inc(len(evicted))
        return evicted

    # -- background refinement + hot-swap ------------------------------------

    def refine_once(self, fingerprint: str) -> bool:
        """Resume the GA on a deployed fingerprint and hot-swap the result
        iff it measured strictly better than the deployed plan.

        The search is seeded with the deployed chromosome and keyed to the
        same measurement journal (``cache_dir`` is pinned), so persisted
        measurements replay for free and the journal-fitted surrogate can
        screen.  Returns True when a swap happened.
        """
        with self._lock:
            entry = self._entries.get(fingerprint)
        if entry is None:
            raise LookupError(f"fingerprint {fingerprint!r} is not deployed")
        svc = self.service_config
        entry.rounds += 1
        ga = entry.ctx.config.ga
        overrides: dict = {
            # a fresh seed per round: refinement explores, it doesn't replay
            "seed": ga.seed + entry.rounds,
        }
        if svc.refine_generations is not None:
            overrides["generations"] = int(svc.refine_generations)
        if svc.refine_population is not None:
            overrides["population"] = int(svc.refine_population)
        with entry.state.entered():
            res = _search(entry.offloader, entry.ctx,
                          ga=dataclasses.replace(ga, **overrides),
                          extra_seeds=[entry.current.record.bits])
        with self._lock:
            self.stats.refinements += 1
        obs_metrics.counter("service.refinements").inc()
        deployed = entry.current.record
        better = (res.best.valid
                  and res.best.time_s < deployed.best_time_s
                  and tuple(int(v) for v in res.best.bits) != deployed.bits)
        if not better:
            return False
        stored = self.store.put(record_from_result(
            res, fingerprint,
            meta={"origin": "refinement", "round": entry.rounds,
                  "replaced_version": deployed.version,
                  "evaluations": res.ga.evaluations}))
        new_plan = ServedPlan(fingerprint, stored, res.artifact, warm=False,
                              search=res)
        with self._lock:
            entry.previous = entry.current
            entry.current = new_plan       # the atomic hot-swap: one
            self.stats.swaps += 1          # reference assignment publishes
        obs_metrics.counter("service.swaps").inc()
        return True                        # a complete immutable plan

    def rollback(self, fingerprint: str) -> ServedPlan:
        """Re-deploy the plan the last hot-swap replaced (and append it to
        the store as the new head version, so restarts agree)."""
        with self._lock:
            entry = self._entries.get(fingerprint)
            prev = entry.previous if entry is not None else None
        if entry is None:
            raise LookupError(f"fingerprint {fingerprint!r} is not deployed")
        if prev is None:
            raise LookupError(f"no previous plan retained for "
                              f"{fingerprint!r} — nothing to roll back to")
        stored = self.store.put(dataclasses.replace(
            prev.record,
            meta={**prev.record.meta,
                  "rolled_back_from": entry.current.version}))
        restored = ServedPlan(fingerprint, stored, prev.artifact,
                              warm=prev.warm)
        with self._lock:
            entry.previous = entry.current
            entry.current = restored
            self.stats.rollbacks += 1
        obs_metrics.counter("service.rollbacks").inc()
        return restored

    def start_refinement(self, interval_s: Optional[float] = None) -> None:
        """Run :meth:`refine_once` over all deployed fingerprints on a
        daemon thread, sleeping ``interval_s`` between sweeps."""
        sleep_s = self.service_config.refine_interval_s \
            if interval_s is None else float(interval_s)
        if self._refine_thread is not None and self._refine_thread.is_alive():
            return
        self._refine_stop.clear()

        def loop() -> None:
            while not self._refine_stop.is_set():
                for fp in self.fingerprints():
                    if self._refine_stop.is_set():
                        return
                    try:
                        self.refine_once(fp)
                    except Exception:  # noqa: BLE001 — one fingerprint's
                        continue       # bad round must not kill the loop
                if self.service_config.plan_ttl_s is not None:
                    # periodic TTL sweep (the evict_stale wiring): deployed
                    # and in-flight fingerprints are spared by the method
                    try:
                        self.evict_stale(self.service_config.plan_ttl_s)
                    except Exception:  # noqa: BLE001 — hygiene must not
                        pass           # kill refinement
                self._refine_stop.wait(sleep_s)

        self._refine_thread = threading.Thread(
            target=loop, name="plan-refine", daemon=True)
        self._refine_thread.start()

    def stop_refinement(self, timeout_s: float = 10.0) -> None:
        self._refine_stop.set()
        t = self._refine_thread
        if t is not None:
            t.join(timeout=timeout_s)
        self._refine_thread = None

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        self.stop_refinement()
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "PlanService":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
