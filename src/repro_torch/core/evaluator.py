"""Port of ``repro/core/evaluator.py``: the serial path — :class:`Evaluator`
and the persistent :class:`MeasurementCache` keyed by program fingerprint.

The measured export path is serial by nature (wall-clock timings must not
interleave), as the reference's measured jaxpr path is (``serial_only``).
The reference's thread pool, process pool, compile-overlap phase and
surrogate pre-screen are not ported yet; its static
:func:`transfer_cost_surrogate` is (the static-cost fitness ranks by it).

The paper measures every offload pattern in a real verification environment
(run + verify), which makes measurement the search bottleneck.  This module
reduces the *number* of measurements (arXiv:2002.12115): a whole generation
is deduped against the in-memory cache (phenotype-keyed, so chromosomes that
decode to the same program share one measurement) and against an on-disk
journal so re-planning the same program never re-measures a known pattern.
Results come back in population order.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

from repro_torch.core.ga import Evaluation
from repro_torch.core.journal import Journal, newest_per_key
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

__all__ = ["EvalStats", "Evaluator", "MeasurementCache"]


# ---------------------------------------------------------------------------
# persistent measurement cache
# ---------------------------------------------------------------------------


def _bits_key(bits: Sequence[int]) -> str:
    return "".join(str(int(b)) for b in bits) or "-"


#: default per-fingerprint measurement-journal bound (newest-per-bits
#: compaction past 2x this bound keeps journals finite).
_MEASUREMENTS_MAX_RECORDS = 2048


class MeasurementCache:
    """On-disk (fingerprint, bits) -> Evaluation store, one JSONL per program,
    on the shared :class:`~repro_torch.core.journal.Journal`."""

    def __init__(self, cache_dir: str, fingerprint: str,
                 max_records: int = _MEASUREMENTS_MAX_RECORDS):
        self.dir = cache_dir
        self.fingerprint = fingerprint
        self.max_records = max(1, int(max_records))
        os.makedirs(cache_dir, exist_ok=True)
        self.path = os.path.join(cache_dir, f"measurements_{fingerprint}.jsonl")
        self._journal = Journal(self.path)

    def load(self) -> dict[tuple, Evaluation]:
        out: dict[tuple, Evaluation] = {}
        for rec in self._journal.records():
            if rec.get("fingerprint") != self.fingerprint:
                continue
            try:
                bits = tuple(int(c) for c in rec["bits"]) \
                    if rec["bits"] != "-" else ()
                t = rec["time_s"]
                out[bits] = Evaluation(
                    bits, float("inf") if t is None else float(t),
                    bool(rec["valid"]), dict(rec.get("detail") or {}))
            except (KeyError, TypeError, ValueError):
                continue  # foreign/legacy line
        return out

    def store(self, ev: Evaluation) -> None:
        rec = {
            "fingerprint": self.fingerprint,
            "bits": _bits_key(ev.bits),
            "time_s": ev.time_s if math.isfinite(ev.time_s) else None,
            "valid": ev.valid,
            "detail": {k: v for k, v in ev.detail.items()
                       if isinstance(v, (str, int, float, bool))},
        }
        self._journal.append([rec])
        self._journal.compact(
            lambda recs: newest_per_key(
                recs, key=lambda r: (r.get("fingerprint"), r.get("bits")),
                max_records=self.max_records),
            threshold=2 * self.max_records)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@dataclass
class EvalStats:
    """Measurement accounting: how much verification work the engine avoided."""

    measurements: int = 0        # fitness_fn actually invoked
    cache_hits: int = 0          # served from the in-memory cache
    persistent_hits: int = 0     # served from the on-disk cache at first touch
    eval_wall_s: float = 0.0     # wall-clock spent inside evaluate_batch

    @property
    def measurements_saved(self) -> int:
        return self.cache_hits + self.persistent_hits

    def as_dict(self) -> dict:
        return {"measurements": self.measurements,
                "cache_hits": self.cache_hits,
                "persistent_hits": self.persistent_hits,
                "measurements_saved": self.measurements_saved,
                "eval_wall_s": self.eval_wall_s}


class Evaluator:
    """Serial measurement scheduler for the GA: dedup -> measure -> record.

    ``phenotype_key`` canonicalizes chromosomes (``bits -> hashable``):
    chromosomes with equal keys decode to the same program and share one
    measurement; results are re-labelled with the requesting chromosome's
    bits.  ``cache_dir`` + ``fingerprint`` persist measurements across
    processes.  ``annotate`` enriches each new Evaluation before it is
    cached (the multi-objective detail fields).
    """

    def __init__(self, fitness_fn: Callable[[tuple], Evaluation],
                 cache_dir: Optional[str] = None,
                 fingerprint: str = "",
                 phenotype_key: Optional[Callable[[tuple], Any]] = None,
                 annotate: Optional[Callable[[Evaluation], Evaluation]]
                 = None):
        self.fitness_fn = fitness_fn
        self.annotate = annotate
        self._key = phenotype_key or (lambda bits: bits)
        self.stats = EvalStats()
        self._cache: dict[Any, Evaluation] = {}
        self._store: Optional[MeasurementCache] = None
        if cache_dir:
            self._store = MeasurementCache(cache_dir, fingerprint or "anon")
            for bits, ev in self._store.load().items():
                self._cache[self._key(bits)] = ev
        self._persisted_unseen = set(self._cache)

    def is_measured(self, bits: Sequence[int]) -> bool:
        """True if this chromosome (or a phenotype-equivalent one) already
        has a measurement (memory or disk)."""
        return self._key(tuple(bits)) in self._cache

    @property
    def unique_measured(self) -> int:
        return len(self._cache)

    def _lookup(self, key) -> Optional[Evaluation]:
        ev = self._cache.get(key)
        if ev is None:
            return None
        if key in self._persisted_unseen:
            self._persisted_unseen.discard(key)
            self.stats.persistent_hits += 1
        else:
            self.stats.cache_hits += 1
        return ev

    def _measure(self, bits: tuple) -> Evaluation:
        fn = self.fitness_fn
        key = _bits_key(bits)
        if hasattr(fn, "prepare") and hasattr(fn, "measure"):
            with obs_trace.span("eval.prepare", bits=key):
                prep = fn.prepare(bits)
            with obs_trace.span("eval.measure", bits=key):
                ev = fn.measure(prep)
        else:
            with obs_trace.span("eval.measure", bits=key):
                ev = fn(bits)
        if self.annotate is not None:
            ev = self.annotate(ev)
        self.stats.measurements += 1
        self._cache[self._key(bits)] = ev
        if self._store is not None:
            self._store.store(ev)
        return ev

    def evaluate(self, bits: Sequence[int]) -> Evaluation:
        """Evaluate one chromosome (cache -> measure)."""
        return self.evaluate_batch([tuple(bits)])[0]

    def evaluate_batch(self, population: Sequence[Sequence[int]]
                       ) -> list[Evaluation]:
        """Evaluate a whole population; results in population order.
        Duplicates within the batch and chromosomes already measured (this
        run or a persisted one) are served without a new measurement."""
        before = dataclasses.replace(self.stats)
        with obs_trace.span("eval.batch", size=len(population)) as sp:
            t0 = time.perf_counter()
            out: list[Evaluation] = []
            for p in population:
                bits = tuple(int(b) for b in p)
                ev = self._lookup(self._key(bits))
                if ev is None:
                    ev = self._measure(bits)
                out.append(ev if tuple(ev.bits) == bits
                           else dataclasses.replace(ev, bits=bits))
            self.stats.eval_wall_s += time.perf_counter() - t0
            for f in ("measurements", "cache_hits", "persistent_hits"):
                d = getattr(self.stats, f) - getattr(before, f)
                if d:
                    obs_metrics.counter(f"eval.{f}").inc(d)
                sp.set(**{f: d})
            return out

    def close(self) -> None:
        """Nothing to release in the serial engine (kept for the GA's
        evaluator protocol)."""

    def __enter__(self) -> "Evaluator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# static surrogate: transfer-cost ranking (pre-screen only, never a score)
# ---------------------------------------------------------------------------
# static surrogate: transfer-cost ranking (pre-screen only, never a score)
# ---------------------------------------------------------------------------


def transfer_cost_surrogate(graph, coding, var_bytes: Optional[dict] = None,
                            base_impl: Optional[dict] = None
                            ) -> Callable[[tuple], float]:
    """Rank chromosomes by estimated dynamic transfer volume.

    Decodes ``bits`` through ``coding``, runs the (pure-IR) transfer planner
    and weights the resulting transfer count by per-variable byte sizes when
    known.  Patterns that offload more while transferring less rank first —
    a roofline-style prior, used *only* to order offspring for measurement.

    Destination-aware: genes on cost-only destinations decode to the
    reference path (zero transfers), so their modeled device cost is folded
    into the rank instead — otherwise stub-parked chromosomes would rank
    *best* while the fitness charges them the stub's modeled latency, and
    screening would invert.  Only genes on executable accelerator
    destinations count as "more offloaded work" for the tiebreak.
    """
    from repro_torch.core.genes import get_destination, modeled_cost_s
    from repro_torch.core.transfer_planner import plan_transfers

    var_bytes = var_bytes or {}
    dests = [get_destination(d) for d in coding.destinations]
    # any placement that charges a model (stub devices, mesh genes) folds
    # its modeled seconds into the rank so screening can't invert
    any_charged = any(d.placement_tag is not None for d in dests)
    #: rank-units per modeled second — arbitrary but monotone: it only has
    #: to make stub-parked genes rank behind the free reference path
    _COST_ONLY_SCALE = 1e6
    memo: dict[tuple, float] = {}

    def cost(bits: tuple) -> float:
        bits = tuple(bits)
        if bits in memo:
            return memo[bits]
        impl = dict(base_impl or {})
        impl.update(coding.decode(bits))
        plan = plan_transfers(graph, impl, hoist=True,
                              destinations=coding.destinations_of(bits))
        total = 0.0
        for t in plan.transfers:
            trips = 1
            if t.per_iteration:
                r = graph.by_name(t.at_region)
                while r is not None:
                    trips *= (r.trip_count or 1) if r.kind == "loop" else 1
                    r = graph.by_name(r.parent) if r.parent else None
            total += (trips * float(var_bytes.get(t.var, 1.0))
                      / max(t.shards, 1))
        if any_charged:
            total += _COST_ONLY_SCALE * modeled_cost_s(graph, coding, bits)
        # prefer more offloaded work at equal transfer cost (paper intuition:
        # offload wins when transfers are amortized); for the binary alphabet
        # this is exactly the historical sum(bits)
        offloaded = sum(1 for v in bits
                        if not dests[int(v)].is_cost_only and int(v) != 0)
        memo[bits] = total - 1e-9 * offloaded
        return memo[bits]

    return cost


# ---------------------------------------------------------------------------
# the shipped deterministic fitness (the reference also registers it by name
# for its process pool, which is not ported)
# ---------------------------------------------------------------------------


def _smoke_fitness_factory(scale: float = 0.1) -> Callable[[tuple], Evaluation]:
    """Shipped example factory: a deterministic synthetic fitness with no
    heavy dependencies (the GA parity tests' fixture)."""
    def fit(bits: tuple) -> Evaluation:
        return Evaluation(tuple(bits), 1.0 + scale * sum(bits), True)
    return fit

