"""Port of ``repro/core/surrogate.py`` (numpy only): the journal-fitted
surrogate cost model, :func:`spearman_rank_corr`, and the
``surrogate_fit.jsonl`` persistence -- the same features, the same ridge
fit and the same leave-one-out correlation, so one journal gives the same
coefficients in both packages.

Journal-fitted surrogate cost model: screening that *learns* from the
measurement journals instead of merely being measured.

The paper spends nearly all of its search budget on verification-environment
measurements; Yamato's mixed-destination follow-up (arXiv:2011.12431) shows
the search only scales to many destinations when cheap predicted costs can
stand in for most measurements, and the function-block work (arXiv:2004.09883)
argues offload decisions should be driven by *recorded performance evidence*,
not static heuristics.  This module is that evidence loop closed:

* :class:`FeatureExtractor` — per-chromosome features from the same pure-IR
  machinery the hand formula uses (the transfer planner), but kept separate
  per signal instead of collapsed into one number: per-destination gene
  counts, H2D/D2H transfer counts, byte volume, round-trip products of
  per-iteration transfers, offloaded-region trip products, modeled stub
  cost — plus the hand formula's own score as the *prior feature*.
* :func:`fit_surrogate` — ridge / least-squares regression of those features
  against the persisted measurement journal
  (``measurements_{fingerprint}.jsonl``, written by
  :class:`repro_torch.core.evaluator.MeasurementCache`).  With fewer than
  ``min_records`` journal rows the fit abstains and the caller keeps the
  hand formula (the prior *is* the fallback); with enough rows the fitted
  model can only lean away from the prior where the data supports it.
* :class:`FittedSurrogate` — the resulting ``bits -> score`` ranking
  callable, carrying its *leave-one-out* journal rank correlation next to
  the static formula's on the same rows, so ``ga_search`` can prefer
  whichever model demonstrably ranks this program's offspring better
  (LOO, so an overfit of journal noise cannot win the comparison).
* coefficient persistence — fits journal to ``surrogate_fit.jsonl`` beside
  ``search_meta.jsonl`` (newest-per-fingerprint compaction under the same
  flock idiom), so fitted models are inspectable and survive the process.

Like the static formula, a fitted surrogate only ever *ranks* offspring for
the pre-screen — measurement stays the final arbiter (the paper's
anti-static-prediction stance).
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core.genes import (GeneCoding, MeshDestination, _trip_product,
                              get_destination, modeled_cost_s)
from repro_torch.core.ir import RegionGraph
from repro_torch.core.transfer_planner import plan_transfers

__all__ = ["FeatureExtractor", "FittedSurrogate", "fit_surrogate",
           "load_fit", "spearman_rank_corr", "SURROGATE_FIT_FILE"]

SURROGATE_FIT_FILE = "surrogate_fit.jsonl"
_FIT_MAX_LINES = 256


# ---------------------------------------------------------------------------
# rank correlation (shared with the evaluator's calibration report)
# ---------------------------------------------------------------------------


def _rank(x: np.ndarray) -> np.ndarray:
    order = np.argsort(x, kind="stable")
    r = np.empty(len(x))
    r[order] = np.arange(len(x), dtype=float)
    # average ties so equal scores can't fake correlation
    for v in np.unique(x):
        m = x == v
        r[m] = r[m].mean()
    return r


def spearman_rank_corr(score: Sequence[float], t: Sequence[float]) -> float:
    """Spearman rank correlation between a surrogate's scores and measured
    times.  +1 = the surrogate orders exactly as measurement would; ~0 =
    screening is a coin flip.  nan with fewer than 3 points or a constant
    ranking."""
    score = np.asarray(score, dtype=float)
    t = np.asarray(t, dtype=float)
    if len(score) < 3 or np.ptp(score) == 0 or np.ptp(t) == 0:
        return float("nan")
    rs, rt = _rank(score), _rank(t)
    rs -= rs.mean()
    rt -= rt.mean()
    denom = float(np.sqrt((rs ** 2).sum() * (rt ** 2).sum()))
    return float((rs * rt).sum() / denom) if denom else float("nan")


# ---------------------------------------------------------------------------
# feature extraction
# ---------------------------------------------------------------------------


class FeatureExtractor:
    """chromosome -> feature vector, from the same pure-IR signals the hand
    formula collapses into one score.

    Features (``feature_names`` gives the fitted-coefficient labels):

    * ``prior``          — the static transfer-cost surrogate's score (the
      hand formula as a regression prior: a fit on few records shrinks to
      it, a fit on many can overrule it where the journal disagrees)
    * ``h2d`` / ``d2h``  — static transfer counts from the planner
    * ``bytes``          — transfer volume, per-variable bytes × trip products
    * ``round_trips``    — dynamic trip product summed over per-iteration
      transfers (the paper's CPU↔accelerator round-trip penalty)
    * ``hoisted``        — transfers the planner pulled out of loops
    * ``offload_trips``  — trip products of regions placed on an executable
      accelerator destination (how much work the pattern offloads)
    * ``stub_cost``      — modeled seconds charged by cost-only destinations
    * ``block_active``   — function-block genes on an accelerated variant
      (each replaces its whole member span with one library call)
    * ``block_claimed``  — regions claimed by active block genes: their own
      genes are inert, so the effective search space is smaller than the
      chromosome length suggests
    * ``mesh_genes``     — genes placed on a mesh destination
    * ``mesh_devices``   — total devices those mesh genes span (Σ n)
    * ``mesh_model_axis``— mesh genes on the ``model`` axis (whose doubled
      collective makes them systematically dearer than ``data`` placements)
    * ``dest{k}``        — genes per non-reference alphabet value (variant
      impl-index counts: how many sites run alphabet entry k)
    * ``site{i}@{k}``    — per-site one-hot: site i on alphabet value k
      (what lets the fit learn that one region's variant is slow even when
      the aggregates look identical)
    """

    def __init__(self, graph: RegionGraph, coding: GeneCoding,
                 prior: Callable[[tuple], float],
                 var_bytes: Optional[dict] = None,
                 base_impl: Optional[dict] = None):
        self.graph = graph
        self.coding = coding
        self.prior = prior       # bound here: the memo below caches whole
        self.var_bytes = dict(var_bytes or {})  # vectors, prior score incl.
        self.base_impl = dict(base_impl or {})
        self._dests = [get_destination(d) for d in coding.destinations]
        self._trip = {s.region: _trip_product(graph, graph.by_name(s.region))
                      for s in coding.sites}
        self.feature_names: tuple[str, ...] = tuple(
            ["prior", "h2d", "d2h", "bytes", "round_trips", "hoisted",
             "offload_trips", "stub_cost", "block_active", "block_claimed",
             "mesh_genes", "mesh_devices", "mesh_model_axis"]
            + [f"dest{k}" for k in range(1, coding.arity)]
            + [f"site{i}@{k}" for i in range(coding.length)
               for k in range(1, coding.arity)])
        self._memo: dict[tuple, np.ndarray] = {}

    def __call__(self, bits: Sequence[int]) -> np.ndarray:
        bits = tuple(int(b) for b in bits)
        hit = self._memo.get(bits)
        if hit is not None:
            return hit
        coding, graph = self.coding, self.graph
        impl = dict(self.base_impl)
        impl.update(coding.decode(bits))
        plan = plan_transfers(graph, impl, hoist=True,
                              destinations=coding.destinations_of(bits))
        n_h2d = n_d2h = n_hoist = 0
        total_bytes = 0.0
        round_trips = 0.0
        for t in plan.transfers:
            if t.direction == "h2d":
                n_h2d += 1
            else:
                n_d2h += 1
            if t.hoisted_from:
                n_hoist += 1
            trips = 1
            if t.per_iteration:
                trips = _trip_product(graph, graph.by_name(t.at_region))
                round_trips += trips
            total_bytes += (trips * float(self.var_bytes.get(t.var, 1.0))
                            / max(t.shards, 1))
        claimed = coding.claimed_members(bits)
        offload_trips = sum(
            self._trip[s.region] for s, v in zip(coding.sites, bits)
            if int(v) != 0 and not self._dests[int(v)].is_cost_only
            and s.region not in claimed)
        n_block = sum(1 for s in coding.sites
                      if s.members and impl.get(s.region) != s.ref_impl)
        stub = modeled_cost_s(graph, coding, bits) \
            if any(d.placement_tag is not None for d in self._dests) else 0.0
        mesh_genes = mesh_devices = mesh_model = 0.0
        for s, v in zip(coding.sites, bits):
            d = self._dests[int(v)]
            if isinstance(d, MeshDestination) and s.region not in claimed:
                mesh_genes += 1.0
                mesh_devices += float(d.n)
                mesh_model += 1.0 if d.axis == "model" else 0.0
        dest_counts = [sum(1 for v in bits if int(v) == k)
                       for k in range(1, coding.arity)]
        onehot = [1.0 if int(v) == k else 0.0
                  for v in bits for k in range(1, coding.arity)]
        vec = np.asarray(
            [float(self.prior(bits)), float(n_h2d), float(n_d2h),
             total_bytes,
             round_trips, float(n_hoist), float(offload_trips), stub,
             float(n_block), float(len(claimed)),
             mesh_genes, mesh_devices, mesh_model]
            + [float(c) for c in dest_counts] + onehot)
        self._memo[bits] = vec
        return vec


# ---------------------------------------------------------------------------
# the fitted model
# ---------------------------------------------------------------------------


@dataclass
class FittedSurrogate:
    """A ``bits -> score`` ranking callable fitted to this fingerprint's
    measurement journal, carrying the evidence for preferring it."""

    extractor: FeatureExtractor           # holds the bound prior
    coef: np.ndarray                      # feature weights
    intercept: float
    mean: np.ndarray                      # feature standardization
    scale: np.ndarray
    n_records: int
    rank_corr: float                      # out-of-sample journal Spearman:
                                          # held-out validation rows when
                                          # the journal is big enough,
                                          # leave-one-out otherwise — an
                                          # honest generalization estimate,
                                          # never the training fit
    static_rank_corr: float               # same rows, hand formula
    n_val: int = 0                        # held-out rows (0 = LOO was used)
    fingerprint: str = ""
    kind: str = "fitted"
    objective: str = "latency"            # which journal column the fit
                                          # predicts: measured seconds
                                          # ("latency") or a per-objective
                                          # detail field ("energy",
                                          # "transfer") — one ridge model
                                          # per objective, same journal

    def __call__(self, bits: tuple) -> float:
        x = (self.extractor(bits) - self.mean) / self.scale
        return float(self.intercept + x @ self.coef)

    @property
    def beats_static(self) -> bool:
        """True when the journal says this fit ranks strictly better than
        the hand formula — the activation rule ``ga_search`` applies.
        ``rank_corr`` is leave-one-out, so a fit that merely interpolates
        journal noise cannot clear the bar; and it must be positively
        correlated at all — an inverted ranker never activates, even
        against a static formula with no measurable correlation."""
        return (math.isfinite(self.rank_corr) and self.rank_corr > 0
                and (not math.isfinite(self.static_rank_corr)
                     or self.rank_corr > self.static_rank_corr))

    def coefficients(self) -> dict[str, float]:
        """feature name -> fitted weight (standardized space) — the
        inspection surface."""
        return {n: float(c)
                for n, c in zip(self.extractor.feature_names, self.coef)}


#: objective name -> journal detail field holding its measured value
#: (``None`` = the row's ``time_s`` itself).  Rows of single-objective
#: searches carry no per-objective fields; they simply drop out of non-latency
#: fits (graceful latency-only degradation) instead of poisoning them.
_OBJECTIVE_FIELDS: dict[str, Optional[str]] = {
    "latency": None, "energy": "energy_j", "transfer": "transfer_bytes",
}


def _journal_rows(cache_dir: str, fingerprint: str, coding: GeneCoding,
                  objective: str = "latency") -> list[tuple[tuple, float]]:
    """(bits, measured objective value) for every finite valid measurement
    of this fingerprint whose chromosome fits the current coding.  Unknown
    objective names read the detail field of that name directly."""
    from repro_torch.core.evaluator import MeasurementCache

    field_name = _OBJECTIVE_FIELDS.get(objective, objective)
    rows: list[tuple[tuple, float]] = []
    for bits, ev in MeasurementCache(cache_dir, fingerprint).load().items():
        if not (ev.valid and math.isfinite(ev.time_s)
                and len(bits) == coding.length
                and all(0 <= int(v) < coding.arity for v in bits)):
            continue
        y = ev.time_s if field_name is None else ev.detail.get(field_name)
        if isinstance(y, (int, float)) and math.isfinite(y):
            rows.append((bits, float(y)))
    return rows


def fit_surrogate(graph: RegionGraph, coding: GeneCoding, cache_dir: str,
                  fingerprint: str,
                  prior: Optional[Callable[[tuple], float]] = None,
                  min_records: int = 10, ridge: float = 1e-2,
                  var_bytes: Optional[dict] = None,
                  base_impl: Optional[dict] = None,
                  persist: bool = True,
                  objective: str = "latency") -> Optional[FittedSurrogate]:
    """Fit a ridge regression of chromosome features against the persisted
    measurement journal for ``fingerprint``.

    Returns ``None`` (caller keeps the hand formula) when the journal has
    fewer than ``min_records`` usable rows or the measured times carry no
    ranking signal.  Otherwise the fit is journaled to
    ``{cache_dir}/surrogate_fit.jsonl`` (beside ``search_meta.jsonl``) and
    returned with both models' journal rank correlations attached.

    ``objective`` selects the journal column predicted: the default
    ``"latency"`` fits measured seconds (the historical behavior); the
    multi-objective search additionally fits ``"energy"`` / ``"transfer"``
    against the per-objective detail fields the annotate hook journals —
    one ridge model per objective from the same measurement rows.
    """
    from repro_torch.core.evaluator import transfer_cost_surrogate

    if prior is None:
        prior = transfer_cost_surrogate(graph, coding,
                                        var_bytes=var_bytes,
                                        base_impl=base_impl)
    rows = _journal_rows(cache_dir, fingerprint, coding, objective)
    if len(rows) < max(3, int(min_records)):
        return None
    extractor = FeatureExtractor(graph, coding, prior,
                                 var_bytes=var_bytes,
                                 base_impl=base_impl)
    X = np.stack([extractor(bits) for bits, _ in rows])
    y = np.asarray([t for _, t in rows])
    if np.ptp(y) == 0:
        return None                     # constant journal: nothing to rank
    # out-of-sample guard: with enough journal, hold out every 4th row as a
    # validation set the fit never sees — rank_corr is then a true held-out
    # comparison against the hand formula.  Smaller journals keep the
    # closed-form leave-one-out estimate instead of wasting rows.
    val = np.zeros(len(rows), dtype=bool)
    if len(rows) >= 12:
        val[3::4] = True
    tr = ~val
    n_tr = int(tr.sum())
    mean = X[tr].mean(axis=0)
    scale = X[tr].std(axis=0)
    scale[scale == 0] = 1.0             # constant features drop out cleanly
    Xs = (X - mean) / scale
    y_mean = float(y[tr].mean())
    # ridge on the standardized features; the intercept is the journal mean
    # and stays unpenalized.  lam scales with n so more data loosens the
    # shrinkage toward the prior-feature direction.
    lam = float(ridge) * n_tr
    p = Xs.shape[1]
    A = Xs[tr].T @ Xs[tr] + lam * np.eye(p)
    b = Xs[tr].T @ (y[tr] - y_mean)
    try:
        inv_A = np.linalg.inv(A)
    except np.linalg.LinAlgError:       # pragma: no cover — lam>0 makes A PD
        inv_A = np.linalg.pinv(A)
    coef = inv_A @ b
    pred = y_mean + Xs @ coef
    n_val = int(val.sum())
    if n_val >= 3 and np.ptp(y[val]) > 0:
        idx = np.where(val)[0]
        rank_corr = spearman_rank_corr(pred[val], y[val])
        static_rank_corr = spearman_rank_corr(
            [prior(rows[i][0]) for i in idx], y[val])
    else:
        # leave-one-out predictions, closed form for ridge: the honest fit
        # quality.  With per-site one-hot features p can approach (or
        # exceed) the journal size, where the training fit near-
        # interpolates noise and its in-sample Spearman would "beat" the
        # static formula every time — LOO residuals e_i / (1 - h_i) are
        # what the activation rule may trust.
        n_val = 0
        Xt = Xs[tr]
        leverage = np.einsum("ij,jk,ik->i", Xt, inv_A, Xt) + 1.0 / n_tr
        leverage = np.clip(leverage, 0.0, 1.0 - 1e-6)
        loo_pred = y[tr] - (y[tr] - pred[tr]) / (1.0 - leverage)
        rank_corr = spearman_rank_corr(loo_pred, y[tr])
        static_rank_corr = spearman_rank_corr(
            [prior(bits) for bits, _ in rows], y)
    fitted = FittedSurrogate(
        extractor=extractor, coef=coef, intercept=y_mean,
        mean=mean, scale=scale, n_records=len(rows),
        rank_corr=rank_corr, static_rank_corr=static_rank_corr,
        n_val=n_val, fingerprint=fingerprint, objective=objective)
    if persist:
        _save_fit(cache_dir, fitted)
    return fitted


# ---------------------------------------------------------------------------
# coefficient persistence (same journal idiom as search_meta.jsonl)
# ---------------------------------------------------------------------------


def _save_fit(cache_dir: str, fit: FittedSurrogate) -> None:
    from repro_torch.core.journal import Journal, newest_per_key

    os.makedirs(cache_dir, exist_ok=True)
    journal = Journal(os.path.join(cache_dir, SURROGATE_FIT_FILE))
    rec = {
        "fingerprint": fit.fingerprint,
        "objective": fit.objective,
        "n_records": fit.n_records,
        "n_val": fit.n_val,
        "rank_corr": fit.rank_corr if math.isfinite(fit.rank_corr) else None,
        "static_rank_corr": fit.static_rank_corr
        if math.isfinite(fit.static_rank_corr) else None,
        "intercept": fit.intercept,
        "feature_names": list(fit.extractor.feature_names),
        "coef": [float(c) for c in fit.coef],
        "mean": [float(m) for m in fit.mean],
        "scale": [float(s) for s in fit.scale],
    }
    with journal.lock():
        journal.append([rec], locked=False)
        if journal.line_count() <= _FIT_MAX_LINES:
            return
        journal.rewrite(
            newest_per_key(journal.records(),
                           key=lambda r: (r.get("fingerprint"),
                                          r.get("objective", "latency")),
                           max_records=_FIT_MAX_LINES),
            locked=False)


def load_fit(cache_dir: str, fingerprint: str,
             objective: str = "latency") -> Optional[dict]:
    """Most recent persisted fit record for a (fingerprint, objective)
    (coefficients by feature name, journal size, both rank correlations) —
    the inspection entry point; returns None when nothing was ever fitted.
    Records from before per-objective fits count as latency fits."""
    from repro_torch.core.journal import Journal

    out: Optional[dict] = None
    for rec in Journal(os.path.join(cache_dir, SURROGATE_FIT_FILE)).records():
        if rec.get("fingerprint") == fingerprint \
                and rec.get("objective", "latency") == objective:
            out = rec
    if out is not None:
        out = dict(out)
        out["coefficients"] = dict(zip(out.get("feature_names", ()),
                                       out.get("coef", ())))
    return out
