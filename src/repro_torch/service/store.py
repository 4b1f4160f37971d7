"""Port of ``repro/service/store.py``: PlanStore, versioned, persistent
offload-plan artifacts keyed by ``search_fingerprint``.

The paper's environment-adaptive framing is that code is committed once and
the *environment* keeps adapting it — so a winning offload pattern must
outlive the process that searched for it.  The store is a single
``plan_store.jsonl`` journal (the shared flock/fsync code path from
:mod:`repro_torch.core.journal` — the same one the measurement journals
use), one record per deployed plan *version*:

* the **chromosome** (``bits``) plus the gene-site region names and the
  destination alphabet it was coded against — enough to re-apply the plan
  through any frontend, and enough to *refuse* to (a stored plan only fits
  a program whose coding matches);
* the **measured evidence** (best / baseline seconds, verified flag) the
  refinement loop compares against before hot-swapping;
* an optional self-contained **payload** — for the module frontend the
  whole :class:`~repro_torch.models.plan.ExecPlan` as plain JSON, so
  ``rehydrate`` (and ``Server.from_store``) can reconstruct the artifact
  with *zero* frontend work: no graph build, no search, no measurement.

Versions only grow: ``put`` assigns ``head_version + 1`` under the journal
lock, rollback re-appends an older version's content as a *new* version
(history is never rewritten), and compaction keeps the newest
``history_depth`` versions per fingerprint.  Appends are fsync'd — losing a
measurement re-measures, but losing a deployed plan would re-search, so the
store alone pays for durability.

The JSONL schema is the reference's, field for field, so either package
reads the other's store.  The environment fingerprint differs: the port
runs on PyTorch, so a record carries ``torch_version`` and
``cuda_version`` where the reference's carries ``jax_version``, and a
record written by the reference never matches here (its measurements came
from another runtime).
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from repro_torch.core.journal import Journal, newest_per_key
from repro_torch.core.offload import OffloadResult, Offloader, PlanContext

__all__ = ["PlanRecord", "PlanStore", "PlanMismatchError",
           "environment_fingerprint", "env_matches", "record_from_result"]

PLAN_STORE_FILE = "plan_store.jsonl"

#: the keys a stored plan's environment must match on
ENV_KEYS = ("device_kind", "device_count", "cpu_count", "torch_version",
            "cuda_version")


def environment_fingerprint() -> dict:
    """The hardware/runtime identity a plan's measurements are valid on:
    the card's name and count, the host's cpu count, and the torch and
    CUDA versions.  Plans embed measured times from one machine; a warm
    load elsewhere must re-verify instead of blindly serving them.
    Without a card the device is ``"cpu"``, its count 0 and the CUDA
    version ``None``: a known environment, so a CPU warm load works as
    the reference's does on its CPU backend."""
    import torch

    if torch.cuda.is_available():
        kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
        cuda = torch.version.cuda
    else:
        kind, count, cuda = "cpu", 0, None
    return {
        "device_kind": kind,
        "device_count": int(count),
        "cpu_count": int(os.cpu_count() or 0),
        "torch_version": torch.__version__,
        "cuda_version": cuda,
    }


def env_matches(recorded: dict, current: Optional[dict] = None) -> bool:
    """True when a stored plan's environment fingerprint matches the host we
    are about to serve it on.  A record with no env (captured where the
    runtime was unknown) never matches — those are the blind-reuse records
    this check exists to catch — and neither does one without the port's
    keys (a record the reference wrote)."""
    if not recorded:
        return False
    cur = environment_fingerprint() if current is None else current
    if not cur:
        return False
    return all(k in recorded and recorded.get(k) == cur.get(k)
               for k in ENV_KEYS)


class PlanMismatchError(ValueError):
    """A stored plan does not fit the program it was asked to drive: the
    fingerprint, gene sites, or destination alphabet disagree."""


@dataclass(frozen=True)
class PlanRecord:
    """One deployed plan version — the store's JSONL schema, 1:1."""

    fingerprint: str                  # search_fingerprint of the program
    frontend: str
    version: int                      # 1-based, monotone per fingerprint
    bits: tuple                       # winning chromosome
    sites: tuple                      # gene region names, gene order
    destinations: tuple               # alphabet the bits index into
    pattern: dict                     # region -> implementation (decoded)
    best_time_s: float                # measured winner (inf if unmeasured)
    baseline_time_s: float            # measured all-reference program
    verified: bool                    # measured + output-verified search
    source: str = ""                  # graph.source_name, for humans
    payload: dict = field(default_factory=dict)   # self-contained artifact
                                      # bits, e.g. {"exec_plan": {...}}
    meta: dict = field(default_factory=dict)      # provenance (free-form)
    ts: float = 0.0                   # append time (epoch seconds)
    env: dict = field(default_factory=dict)       # environment fingerprint
                                      # the measurements were taken on
                                      # (environment_fingerprint()); empty
                                      # = unknown host, treated as mismatch
    front: tuple = ()                 # Pareto front of the producing search:
                                      # dicts of {bits, latency_s, energy_j,
                                      # transfer_bytes} per non-dominated
                                      # pattern — lets the service swap
                                      # operating points without a search

    @property
    def speedup(self) -> float:
        if not (math.isfinite(self.best_time_s) and self.best_time_s > 0
                and math.isfinite(self.baseline_time_s)):
            return float("nan")
        return self.baseline_time_s / self.best_time_s

    def mesh_destinations(self) -> dict:
        """region -> :class:`~repro_torch.core.genes.MeshDestination` for
        every gene the stored winner placed on a mesh.  Destinations are
        wire names, so mesh placements round-trip through the JSONL schema
        with no extra fields — this just parses them back."""
        from repro_torch.core.genes import MeshDestination, get_destination

        out = {}
        for region, v in zip(self.sites, self.bits):
            idx = int(v)
            if 0 <= idx < len(self.destinations):
                dest = get_destination(self.destinations[idx])
                if isinstance(dest, MeshDestination):
                    out[region] = dest
        return out

    def to_json(self) -> dict:
        rec = dataclasses.asdict(self)
        rec["bits"] = [int(v) for v in self.bits]
        rec["sites"] = list(self.sites)
        rec["destinations"] = list(self.destinations)
        rec["best_time_s"] = self.best_time_s \
            if math.isfinite(self.best_time_s) else None
        rec["baseline_time_s"] = self.baseline_time_s \
            if math.isfinite(self.baseline_time_s) else None
        rec["front"] = [dict(p, bits=[int(v) for v in p.get("bits", ())])
                        for p in self.front]
        return rec

    @classmethod
    def from_json(cls, rec: dict) -> "PlanRecord":
        def _t(v):
            return float("inf") if v is None else float(v)
        return cls(
            fingerprint=str(rec["fingerprint"]),
            frontend=str(rec.get("frontend", "")),
            version=int(rec.get("version", 1)),
            bits=tuple(int(v) for v in rec.get("bits", ())),
            sites=tuple(rec.get("sites", ())),
            destinations=tuple(rec.get("destinations", ())),
            pattern=dict(rec.get("pattern") or {}),
            best_time_s=_t(rec.get("best_time_s")),
            baseline_time_s=_t(rec.get("baseline_time_s")),
            verified=bool(rec.get("verified", False)),
            source=str(rec.get("source", "")),
            payload=dict(rec.get("payload") or {}),
            meta=dict(rec.get("meta") or {}),
            ts=float(rec.get("ts") or 0.0),
            env=dict(rec.get("env") or {}),
            front=tuple(dict(p, bits=tuple(int(v)
                                           for v in p.get("bits", ())))
                        for p in rec.get("front") or ()))


def _json_safe(value: Any) -> Any:
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    return str(value)


def exec_plan_payload(artifact: Any) -> dict:
    """``{"exec_plan": {...}}`` for a module-frontend ``ExecPlan``, else
    ``{}``.  Only the primitive knobs travel; structural class constants
    that leak in as annotated fields (the ``OFFLOAD_SITES`` table) are part
    of the code's ABI and must come from the class on rehydration."""
    from repro_torch.models.plan import ExecPlan

    if not isinstance(artifact, ExecPlan):
        return {}
    return {"exec_plan": {
        k: v for k, v in dataclasses.asdict(artifact).items()
        if isinstance(v, (str, int, float, bool)) or v is None}}


def record_from_result(res: OffloadResult, fingerprint: str,
                       meta: Optional[dict] = None) -> PlanRecord:
    """Distill an :class:`OffloadResult` into a storable plan record.

    The artifact itself is only embedded when it is self-contained plain
    data (the module frontend's :class:`ExecPlan`); live artifacts
    (``SubstitutedCallable``, ``PyOffloadArtifact``) hold built programs
    and kernels and are re-derived from the bits on load instead.
    """
    return PlanRecord(
        fingerprint=fingerprint,
        frontend=res.frontend,
        version=0,                      # assigned by PlanStore.put
        bits=tuple(int(v) for v in res.best.bits),
        sites=tuple(s.region for s in res.coding.sites),
        destinations=tuple(res.coding.destinations),
        pattern={str(k): _json_safe(v) for k, v in res.pattern.items()},
        best_time_s=float(res.best.time_s),
        baseline_time_s=float(res.baseline.time_s),
        verified=bool(res.verification.get("verified", False)),
        source=res.graph.source_name,
        payload=exec_plan_payload(res.artifact),
        meta=dict(meta or {}),
        env=environment_fingerprint(),
        front=tuple(res.front_summary()))


class PlanStore:
    """Versioned plan persistence over one fsync'd journal."""

    def __init__(self, store_dir: str, history_depth: int = 8,
                 max_records: int = 512):
        os.makedirs(store_dir, exist_ok=True)
        self.dir = store_dir
        self.history_depth = max(1, int(history_depth))
        self.max_records = max(1, int(max_records))
        self._journal = Journal(os.path.join(store_dir, PLAN_STORE_FILE),
                                fsync=True)

    # -- reads ---------------------------------------------------------------

    def _records(self) -> list[PlanRecord]:
        out = []
        for rec in self._journal.records():
            try:
                out.append(PlanRecord.from_json(rec))
            except (KeyError, TypeError, ValueError):
                continue  # foreign line
        return out

    def fingerprints(self) -> tuple[str, ...]:
        seen: dict[str, None] = {}
        for rec in self._records():
            seen.setdefault(rec.fingerprint, None)
        return tuple(seen)

    def history(self, fingerprint: str) -> list[PlanRecord]:
        """Every surviving version for a fingerprint, oldest -> newest."""
        recs = [r for r in self._records() if r.fingerprint == fingerprint]
        recs.sort(key=lambda r: r.version)
        return recs

    def load(self, fingerprint: str) -> Optional[PlanRecord]:
        """Newest stored version for a fingerprint, or None (cold)."""
        hist = self.history(fingerprint)
        return hist[-1] if hist else None

    # -- writes --------------------------------------------------------------

    def put(self, record: PlanRecord) -> PlanRecord:
        """Append as a new version (``head + 1``, assigned under the journal
        lock so concurrent writers can't mint the same version)."""
        with self._journal.lock():
            head = 0
            for rec in self._journal.records():
                if rec.get("fingerprint") == record.fingerprint:
                    head = max(head, int(rec.get("version", 0)))
            record = dataclasses.replace(record, version=head + 1,
                                         ts=time.time())
            self._journal.append([record.to_json()], locked=False)
        self._journal.compact(
            lambda recs: newest_per_key(
                recs, key=lambda r: r.get("fingerprint"),
                per_key=self.history_depth, max_records=self.max_records),
            threshold=2 * self.max_records)
        return record

    def evict_stale(self, max_age_s: float, now: Optional[float] = None,
                    keep: Any = ()) -> tuple[str, ...]:
        """TTL sweep: drop every fingerprint whose *newest* stored version
        is older than ``now - max_age_s`` (the whole history goes with it —
        a retired program's stale v1 is as dead as its stale v5).
        Fingerprints in ``keep`` (the service passes its deployed and
        in-flight ones) are never evicted.  Runs read + rewrite under the
        journal lock so a concurrent ``put`` can't vanish mid-sweep.
        Returns the evicted fingerprints."""
        now = time.time() if now is None else float(now)
        cutoff = now - float(max_age_s)
        keep = set(keep)
        with self._journal.lock():
            recs = self._journal.records()
            newest: dict[str, float] = {}
            for rec in recs:
                fp = rec.get("fingerprint")
                if fp:
                    newest[fp] = max(newest.get(fp, 0.0),
                                     float(rec.get("ts") or 0.0))
            stale = {fp for fp, ts in newest.items()
                     if fp not in keep and ts < cutoff}
            if not stale:
                return ()
            self._journal.rewrite(
                [r for r in recs if r.get("fingerprint") not in stale],
                locked=False)
        return tuple(sorted(stale))

    def rollback(self, fingerprint: str) -> PlanRecord:
        """Re-deploy the previous surviving version by appending its content
        as a *new* head version (history is append-only — rolling back is a
        forward move)."""
        hist = self.history(fingerprint)
        if len(hist) < 2:
            raise LookupError(
                f"no earlier version to roll back to for {fingerprint!r}")
        prev = hist[-2]
        return self.put(dataclasses.replace(
            prev, meta={**prev.meta, "rolled_back_from": hist[-1].version}))

    # -- artifact rehydration (the thin fast path) ---------------------------

    def check(self, record: PlanRecord, ctx: PlanContext) -> None:
        """A stored plan only fits a program whose search coding matches."""
        if record.fingerprint != ctx.fingerprint:
            raise PlanMismatchError(
                f"stored plan is for fingerprint {record.fingerprint!r}, "
                f"target prepared as {ctx.fingerprint!r}")
        if record.sites != ctx.sites \
                or record.destinations != ctx.coding.destinations:
            raise PlanMismatchError(
                "stored plan's gene sites/destinations do not match the "
                "prepared target (same fingerprint but incompatible coding "
                "— stale store?)")

    def rehydrate(self, record: PlanRecord, target: Any = None,
                  inputs: Optional[dict] = None,
                  config: Any = None) -> Any:
        """Reconstruct the plan's artifact without any search.

        Self-contained payloads (``exec_plan``) come straight off the JSON —
        zero frontend work.  Everything else replays the search-free half of
        the pipeline: ``Offloader.prepare(target)`` (which must fingerprint
        identically, checked) then ``Offloader.apply`` with the stored bits.
        """
        from repro_torch.models.plan import ExecPlan

        if "exec_plan" in record.payload:
            return ExecPlan(**record.payload["exec_plan"])
        if target is None:
            raise ValueError(
                "stored plan has no self-contained payload; pass the "
                "original target (and inputs/config) to rebuild its artifact")
        off = Offloader(config) if config is not None else Offloader()
        ctx = off.prepare(target, inputs)
        self.check(record, ctx)
        return off.apply(ctx, record.bits)
