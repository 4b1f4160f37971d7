"""Port of ``repro/core/pattern_db.py`` for the ``softmax_attention``,
``rmsnorm``, ``linear_recurrence``, ``wkv_recurrence`` and ``matmul``
records (thresholds and callee names unchanged).  Each record's
``"export"`` vector is traced with ``torch.export`` from a torch twin of
the reference's ``_jx_*`` comparison code — for the scan records, the
vector of the twin's ``scan`` node (body ops plus one ``scan``, as the
export frontend vectorizes a scan region); the ``python_ast`` vectors carry
over unchanged.  The block and fft records come with their slices.

Code-pattern DB for function-block offload (paper §3.2.2, §4.1: 照合に
用いるコードパターン DB は、MySQL8 を用いる。ライブラリ等を類似性検出技術で
検出するための、比較用コードとの対応関係等が保持される).

Each record holds:
  * ``callee_names`` — library-call names for exact name matching,
  * per-frontend *comparison code* characteristic vectors (the 比較用コード)
    for Deckard/CloneDigger-style similarity matching,
  * the replacement implementation id (our "CUDA library": a Pallas kernel
    wrapper or a fused rewrite) and the ExecPlan field it drives,
  * an interface note — when the replacement's interface differs from the
    matched block the result is flagged ``needs_confirmation`` (the paper
    asks the user before changing interfaces).

The DB persists as JSON (the MySQL stand-in); ``default_db()`` builds the
shipped patterns by tracing canonical reference implementations.
"""
from __future__ import annotations

import ast as pyast
import dataclasses
import json
import os
import textwrap
import time
from dataclasses import dataclass, field
from typing import Optional

import torch
from torch._higher_order_ops.scan import scan

from repro_torch.core import similarity as sim
from repro_torch.core.ir import Region
from repro_torch.core.journal import Journal
from repro_torch.obs import metrics as obs_metrics

# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------


@dataclass
class PatternRecord:
    name: str
    callee_names: tuple = ()
    vectors: dict = field(default_factory=dict)   # frontend -> char. vector
    replacement: str = ""                         # implementation id
    plan_field: Optional[tuple] = None            # (ExecPlan field, value)
    threshold: float = 0.85
    interface_note: str = ""
    interface_changes: bool = False
    #: block records describe a whole function block (several adjacent
    #: regions merged); they are matched by :meth:`PatternDB.match_block`
    #: over merged windows and never by per-region ``match_region``.
    block: bool = False

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["callee_names"] = list(self.callee_names)
        d["plan_field"] = list(self.plan_field) if self.plan_field else None
        return d

    @classmethod
    def from_json(cls, d: dict) -> "PatternRecord":
        d = dict(d)
        d["callee_names"] = tuple(d.get("callee_names", ()))
        pf = d.get("plan_field")
        d["plan_field"] = tuple(pf) if pf else None
        return cls(**d)


@dataclass
class Match:
    record: PatternRecord
    how: str         # "name" | "similarity"
    score: float
    region: str
    needs_confirmation: bool = False


# ---------------------------------------------------------------------------
# per-pattern verifier-outcome journal (ROADMAP: match precision from
# verifier outcomes — a pattern whose substitutions keep failing
# verification should raise its own threshold)
# ---------------------------------------------------------------------------

PRECISION_FILE = "pattern_precision.jsonl"
_PRECISION_MAX_LINES = 4096

#: outcome vocabulary.  ``ok`` / ``verify_fail`` / ``error`` are verifier
#: verdicts on a substitution that ran; ``bind_fail`` means the matched
#: variant refused to bind (predicate/aval rejection) so nothing ran —
#: recorded, but excluded from the precision denominator by default.
PRECISION_OUTCOMES = ("ok", "verify_fail", "error", "bind_fail")


def record_pattern_outcome(cache_dir: Optional[str], pattern: Optional[str],
                           variant: str, outcome: str,
                           region: str = "") -> None:
    """Journal one verifier outcome for a (pattern, variant) substitution
    into ``{cache_dir}/pattern_precision.jsonl`` and mirror it into the
    process metrics registry (``patterns.outcomes``).  ``cache_dir=None``
    keeps the metrics side only; records without a pattern are dropped."""
    if not pattern:
        return
    obs_metrics.counter("patterns.outcomes", pattern=pattern,
                        variant=variant, outcome=outcome).inc()
    if not cache_dir:
        return
    journal = Journal(os.path.join(cache_dir, PRECISION_FILE))
    journal.append([{"pattern": pattern, "variant": str(variant),
                     "outcome": str(outcome), "region": region,
                     "ts": time.time()}])
    journal.compact(lambda recs: recs[-_PRECISION_MAX_LINES:],
                    threshold=2 * _PRECISION_MAX_LINES)


def load_pattern_precision(cache_dir: str) -> dict[str, dict[str, int]]:
    """The journal aggregated: ``pattern -> {outcome: count}``."""
    out: dict[str, dict[str, int]] = {}
    journal = Journal(os.path.join(cache_dir, PRECISION_FILE))
    for rec in journal.records():
        pattern, outcome = rec.get("pattern"), rec.get("outcome")
        if not pattern or not outcome:
            continue
        counts = out.setdefault(pattern, {})
        counts[outcome] = counts.get(outcome, 0) + 1
    return out


class PatternDB:
    def __init__(self, records: list[PatternRecord],
                 precision_dir: Optional[str] = None):
        self.records = records
        #: where this DB reads verifier-outcome journals from
        #: (:func:`record_pattern_outcome` writers pass their own cache_dir)
        self.precision_dir = precision_dir

    # --- match precision from verifier outcomes -----------------------------
    def precision_evidence(self, pattern: str,
                           cache_dir: Optional[str] = None
                           ) -> tuple[Optional[float], int]:
        """(precision, ran-outcome count) for a pattern — the precision is
        the fraction of *ran* substitutions the verifier accepted,
        ``ok / (ok + verify_fail + error)``; ``bind_fail`` records (the
        variant never ran, so the verifier said nothing) don't enter the
        denominator.  ``(None, 0)`` when no journal directory is configured
        or the pattern has no ran outcomes yet — "no evidence", distinct
        from 0.0 ("all failed")."""
        d = cache_dir or self.precision_dir
        if not d:
            return None, 0
        counts = load_pattern_precision(d).get(pattern)
        if not counts:
            return None, 0
        ran = sum(counts.get(o, 0) for o in ("ok", "verify_fail", "error"))
        if ran == 0:
            return None, 0
        return counts.get("ok", 0) / ran, ran

    def precision(self, pattern: str,
                  cache_dir: Optional[str] = None) -> Optional[float]:
        """Precision alone; see :meth:`precision_evidence`."""
        return self.precision_evidence(pattern, cache_dir)[0]

    #: ran outcomes a pattern needs before precision feedback touches its
    #: threshold — the flakiness floor: one bad measurement (or two) can
    #: never blacklist a pattern by itself.
    PRECISION_MIN_EVIDENCE = 3
    #: how much a fully-failing pattern's threshold tightens: effective
    #: threshold = threshold + (1 - precision) * PRECISION_TIGHTEN ...
    PRECISION_TIGHTEN = 0.12
    #: ... capped here, so a pattern stays matchable by a near-perfect
    #: similarity score even when every recorded substitution failed
    #: (measurement remains the final arbiter; feedback only raises the
    #: evidence bar, it never hard-blacklists).
    PRECISION_CEILING = 0.98

    def effective_threshold(self, rec: PatternRecord) -> float:
        """The record's similarity threshold with precision feedback: a
        pattern whose substitutions keep failing verification demands a
        stricter match (低精度パターンは厳しめに).  No journal, no
        evidence, or fewer than :data:`PRECISION_MIN_EVIDENCE` ran
        outcomes → the static threshold, unchanged."""
        p, ran = self.precision_evidence(rec.name)
        if p is None or ran < self.PRECISION_MIN_EVIDENCE or p >= 1.0:
            return rec.threshold
        return min(self.PRECISION_CEILING,
                   rec.threshold + (1.0 - p) * self.PRECISION_TIGHTEN)

    #: a similarity match must beat the runner-up pattern by this margin,
    #: otherwise it is ambiguous (generic loop scaffolding looks like every
    #: pattern) and is surfaced as needs_confirmation.
    AMBIGUITY_MARGIN = 0.012

    # --- matching (paper: name match first, then similarity detection) -----
    def match_region(self, region: Region, frontend: str,
                     min_similarity: Optional[float] = None) -> list[Match]:
        out: list[Match] = []
        scores: list[tuple[float, PatternRecord]] = []
        callee_set = {c.lower().split(".")[-1] for c in region.callees}
        for rec in self.records:
            if rec.block:
                continue          # block records match windows, not regions
            names = {n.lower() for n in rec.callee_names}
            if callee_set & names:
                out.append(Match(rec, "name", 1.0, region.name,
                                 needs_confirmation=rec.interface_changes))
                continue
            vec = rec.vectors.get(frontend)
            if vec and region.feature_vector:
                scores.append((sim.similarity(region.feature_vector, vec), rec))
        scores.sort(key=lambda sr: -sr[0])
        for i, (score, rec) in enumerate(scores):
            # precision feedback: an explicit caller override always wins;
            # otherwise low-precision patterns demand a stricter score
            thr = min_similarity if min_similarity is not None \
                else self.effective_threshold(rec)
            if score < thr:
                continue
            runner_up = scores[i + 1][0] if i + 1 < len(scores) else 0.0
            ambiguous = (score - runner_up) < self.AMBIGUITY_MARGIN and i == 0
            out.append(Match(rec, "similarity", score, region.name,
                             needs_confirmation=rec.interface_changes or ambiguous))
            break  # only the best similarity match is a candidate
        out.sort(key=lambda m: -m.score)
        return out

    # --- block matching: merged windows of adjacent regions -----------------
    #: a merged window may only match a block record when its total feature
    #: mass is within this factor of the record's — a lone matmul summed
    #: with glue must not pass for a whole attention stack.
    BLOCK_SIZE_GUARD = 2.0

    def match_block(self, regions: list, frontend: str,
                    min_similarity: Optional[float] = None) -> Optional[Match]:
        """Match a window of >= 2 adjacent regions, merged, against the
        ``block`` records: name-first over the union of callees, then
        cosine similarity of the summed feature vectors with a size guard.
        Returns the best match or None."""
        if len(regions) < 2:
            return None
        callee_set = {c.lower().split(".")[-1]
                      for r in regions for c in r.callees}
        merged: dict = {}
        for r in regions:
            for k, v in (r.feature_vector or {}).items():
                merged[k] = merged.get(k, 0) + v
        total = sum(merged.values())
        best: Optional[Match] = None
        for rec in self.records:
            if not rec.block:
                continue
            names = {n.lower() for n in rec.callee_names}
            if callee_set & names:
                return Match(rec, "name", 1.0, regions[0].name,
                             needs_confirmation=rec.interface_changes)
            vec = rec.vectors.get(frontend)
            if not vec or not merged:
                continue
            rtotal = sum(vec.values())
            if rtotal and total and not (
                    1.0 / self.BLOCK_SIZE_GUARD
                    <= total / rtotal <= self.BLOCK_SIZE_GUARD):
                continue
            score = sim.similarity(merged, vec)
            thr = (min_similarity if min_similarity is not None
                   else self.effective_threshold(rec))
            if score >= thr and (best is None or score > best.score):
                best = Match(rec, "similarity", score, regions[0].name,
                             needs_confirmation=rec.interface_changes)
        return best

    # --- persistence --------------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump([r.to_json() for r in self.records], f, indent=1)

    @classmethod
    def load(cls, path: str) -> "PatternDB":
        with open(path) as f:
            return cls([PatternRecord.from_json(d) for d in json.load(f)])


# ---------------------------------------------------------------------------
# shipped comparison code (the 比較用コード) — naive Python forms
# ---------------------------------------------------------------------------

_PY_COMPARISON_CODE = {
    "matmul": """
def matmul(a, b, c, n, m, k):
    for i in range(n):
        for j in range(m):
            acc = 0.0
            for t in range(k):
                acc = acc + a[i][t] * b[t][j]
            c[i][j] = acc
""",
    "softmax_attention": """
def attention(q, k, v, out, n, d):
    for i in range(n):
        m = -1e30
        for j in range(n):
            s = 0.0
            for t in range(d):
                s = s + q[i][t] * k[j][t]
            if s > m:
                m = s
        z = 0.0
        for j in range(n):
            z = z + exp(dot(q[i], k[j]) - m)
        for t in range(d):
            acc = 0.0
            for j in range(n):
                acc = acc + exp(dot(q[i], k[j]) - m) / z * v[j][t]
            out[i][t] = acc
""",
    "linear_recurrence": """
def recurrence(a, b, h, out, n, d):
    for t in range(n):
        for c in range(d):
            h[c] = a[t][c] * h[c] + b[t][c]
            out[t][c] = h[c]
""",
    "rmsnorm": """
def rmsnorm(x, scale, out, n, d):
    for i in range(n):
        ss = 0.0
        for t in range(d):
            ss = ss + x[i][t] * x[i][t]
        inv = 1.0 / sqrt(ss / d + 1e-6)
        for t in range(d):
            out[i][t] = x[i][t] * inv * (1.0 + scale[t])
""",
}


def _py_vector(code: str) -> dict:
    tree = pyast.parse(textwrap.dedent(code))
    return sim.ast_vector(tree)


# --- canonical torch reference blocks (exported -> export vectors) ----------


def _tx_attention(q, k, v):
    s = torch.einsum("qd,kd->qk", q, k) / (q.shape[-1] ** 0.5)
    mask = torch.arange(k.shape[0])[None, :] <= torch.arange(q.shape[0])[:, None]
    s = torch.where(mask, s, -1e30)
    return torch.softmax(s, dim=-1) @ v


def _tx_rmsnorm(x, scale):
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + 1e-6) * (1 + scale)


def _tx_recurrence(la, b):
    def step(h, ab):
        h = torch.exp(ab[0]) * h + ab[1]
        return h, h.clone()            # a scan's ys may not alias its carry
    _, hs = scan(step, torch.zeros(la.shape[-1]), (la, b))
    return hs


def _tx_wkv(r, k, v, lw, u):
    def step(s, rkvw):
        rt, kt, vt, lwt = rkvw
        kv = kt[:, None] * vt[None, :]
        y = rt @ (s + u[:, None] * kv)
        return torch.exp(lwt)[:, None] * s + kv, y
    _, ys = scan(step, torch.zeros(r.shape[-1], v.shape[-1]), (r, k, v, lw))
    return ys


def _tx_matmul(a, b):
    return a @ b


def _scan_region_vector(fn, *example_args) -> dict:
    """Characteristic vector of a canonical *scan region*: export the
    reference implementation, find its ``scan`` node, and count the body's
    ops plus the ``scan`` itself — exactly how the export frontend
    vectorizes a scan region, so scan-shaped comparison code matches
    scan-shaped user regions instead of whole-program traces."""
    ep = torch.export.export(sim._fn_module(fn), tuple(example_args))
    for n in ep.graph_module.graph.nodes:
        if sim.is_scan(n):
            return sim.export_vector([n])
    return sim.export_vector(ep.graph_module)


def default_db() -> PatternDB:
    f32 = torch.float32
    q = torch.zeros((8, 4), dtype=f32)
    la = torch.zeros((8, 4), dtype=f32)
    recs = [
        PatternRecord(
            name="softmax_attention",
            callee_names=("attention", "sdpa", "scaled_dot_product_attention",
                          "flash_attention", "multi_head_attention"),
            vectors={"python_ast": _py_vector(_PY_COMPARISON_CODE["softmax_attention"]),
                     "export": sim.vector_of_callable(_tx_attention, q, q, q)},
            replacement="repro_torch.kernels.ops.flash_attention",
            plan_field=("attn_impl", "chunked"),
            threshold=0.80,
            interface_note="(B,S,H,D) q/kv layout; GQA via head count ratio",
        ),
        PatternRecord(
            name="rmsnorm",
            callee_names=("rmsnorm", "rms_norm", "layer_norm", "layernorm"),
            vectors={"python_ast": _py_vector(_PY_COMPARISON_CODE["rmsnorm"]),
                     "export": sim.vector_of_callable(
                         _tx_rmsnorm, q, torch.zeros((4,), dtype=f32))},
            replacement="repro_torch.kernels.ops.rmsnorm",
            plan_field=("norm_impl", "fused"),
            threshold=0.90,
        ),
        PatternRecord(
            name="linear_recurrence",
            callee_names=("rglru", "lru", "linear_recurrence", "ssm_scan",
                          "selective_scan"),
            vectors={"python_ast": _py_vector(_PY_COMPARISON_CODE["linear_recurrence"]),
                     "export": _scan_region_vector(_tx_recurrence, la, la)},
            replacement="repro_torch.kernels.ops.rglru_scan",
            plan_field=("rglru_impl", "chunked"),
            threshold=0.85,
        ),
        PatternRecord(
            name="wkv_recurrence",
            callee_names=("wkv", "wkv6", "rwkv", "time_mix"),
            vectors={"export": _scan_region_vector(
                _tx_wkv, q, q, q, la, torch.zeros((4,), dtype=f32))},
            replacement="repro_torch.kernels.ops.wkv6",
            plan_field=("wkv_impl", "chunked"),
            threshold=0.85,
        ),
        PatternRecord(
            name="matmul",
            callee_names=("matmul", "dot", "gemm", "mm", "bmm", "einsum"),
            vectors={"python_ast": _py_vector(_PY_COMPARISON_CODE["matmul"]),
                     "export": sim.vector_of_callable(_tx_matmul, q, q.T)},
            replacement="torch.matmul",
            plan_field=None,
            threshold=0.88,
        ),
    ]
    return PatternDB(recs)
