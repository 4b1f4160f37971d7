"""Port of ``repro/obs/trace.py`` (framework-free copy).

Thread-safe context-manager spans with a near-zero-cost disabled path.

One process-global :class:`Tracer` (installed with :func:`enable` /
:func:`maybe_tracing`) assigns every span an id + parent and persists it
as one JSONL record through the shared :class:`repro_torch.core.journal.Journal`
flock helper — the same storage cell every other on-disk record stream in
the system uses, so a trace file tolerates concurrent writers and torn
tails like the measurement journals do.

Design points the hot paths rely on:

* **disabled path**: :func:`span` reads one module global and returns the
  shared :data:`NULL_SPAN` singleton — no allocation, no clock read, no
  branch in the instrumented code.  ``benchmarks/bench_obs.py`` measures
  this cost and CI gates it (``obs.trace_overhead_pct``).
* **per-thread nesting**: each thread keeps its own span stack
  (``threading.local``), so concurrently-planning threads don't parent
  into each other.  Cross-thread work (the Evaluator's compile pool)
  passes ``parent=`` explicitly — the dispatching thread captures its
  span id and hands it to the worker.
* **buffered writes**: finished spans accumulate in memory and flush to
  the journal every ``flush_every`` records (and on :meth:`Tracer.close`),
  so tracing a thousand-chromosome search doesn't pay a thousand flock
  round-trips.
* **metrics ride along**: :meth:`Tracer.close` appends one
  ``{"kind": "metrics", "snapshot": ...}`` record with the process
  metrics registry, so ``launch/obsreport.py`` renders timeline *and*
  counters from a single file.

Span record schema (``kind == "span"``)::

    {"kind": "span", "trace": "t-...", "id": 3, "parent": 1,
     "name": "plan.search", "t0": <perf_counter at entry>,
     "dur_s": 0.42, "ts": <epoch at entry>, "attrs": {...}}

``t0`` is ``time.perf_counter()`` — comparable only within the process
that wrote the trace; renderers use offsets from the root span.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
import uuid
from typing import Any, Dict, Iterator, Optional, Union

from repro_torch.core.journal import Journal
from repro_torch.obs import metrics as _metrics

__all__ = ["Span", "NullSpan", "NULL_SPAN", "Tracer", "span",
           "current_span_id", "enable", "disable", "active_tracer",
           "maybe_tracing", "read_trace"]


class Span:
    """A live span; use as a context manager.  ``set(**attrs)`` attaches
    structured attributes (JSON-serializable values) at any point before
    exit."""

    __slots__ = ("tracer", "name", "id", "parent", "t0", "ts",
                 "dur_s", "attrs")

    def __init__(self, tracer: "Tracer", name: str, span_id: int,
                 parent: Optional[int], attrs: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.id = span_id
        self.parent = parent
        self.attrs = attrs
        self.dur_s: Optional[float] = None
        self.ts = time.time()
        self.t0 = time.perf_counter()

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.dur_s = time.perf_counter() - self.t0
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self.tracer._finish(self)
        return False


class NullSpan:
    """The disabled-path stand-in: every operation is a no-op.  A single
    shared instance (:data:`NULL_SPAN`) is returned by :func:`span` when
    no tracer is installed, so the instrumented code allocates nothing."""

    __slots__ = ()
    id = None
    parent = None
    name = ""
    dur_s = None

    def set(self, **attrs: Any) -> "NullSpan":
        return self

    def __enter__(self) -> "NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NULL_SPAN = NullSpan()


class Tracer:
    """Span factory + JSONL sink for one trace file.

    Thread-safe: span ids come from one atomic counter, each thread nests
    on its own stack, and the flush buffer is guarded by a lock.  A tracer
    must be :meth:`close`\\ d (or used via :func:`maybe_tracing`) to
    guarantee the tail of the buffer reaches disk.
    """

    def __init__(self, path: str, trace_id: Optional[str] = None,
                 flush_every: int = 64):
        self.path = path
        self.trace_id = trace_id or f"t-{uuid.uuid4().hex[:12]}"
        self.flush_every = max(1, int(flush_every))
        self._journal = Journal(path)
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._buf: list = []
        self._buf_lock = threading.Lock()
        self._closed = False
        self.span_count = 0

    # -- span lifecycle -----------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, parent: Optional[int] = None,
             **attrs: Any) -> Span:
        stack = self._stack()
        if parent is None and stack:
            parent = stack[-1].id
        s = Span(self, name, next(self._ids), parent, attrs)
        stack.append(s)
        return s

    def current_span_id(self) -> Optional[int]:
        stack = getattr(self._local, "stack", None)
        return stack[-1].id if stack else None

    def _finish(self, s: Span) -> None:
        stack = getattr(self._local, "stack", None)
        if stack and s in stack:       # tolerate exits out of LIFO order
            stack.remove(s)
        rec = {"kind": "span", "trace": self.trace_id, "id": s.id,
               "parent": s.parent, "name": s.name, "t0": s.t0,
               "dur_s": s.dur_s, "ts": s.ts, "attrs": s.attrs}
        with self._buf_lock:
            self.span_count += 1
            self._buf.append(rec)
            full = len(self._buf) >= self.flush_every
        if full:
            self.flush()

    # -- persistence --------------------------------------------------------

    def flush(self) -> None:
        with self._buf_lock:
            buf, self._buf = self._buf, []
        if buf:
            self._journal.append(buf)

    def close(self) -> None:
        """Flush the buffer and append the process metrics snapshot so a
        single trace file carries timeline + counters.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        self.flush()
        self._journal.append([{"kind": "metrics", "trace": self.trace_id,
                               "ts": time.time(),
                               "snapshot": _metrics.snapshot()}])


# ---------------------------------------------------------------------------
# the module-global tracer (the disabled path is one global read)
# ---------------------------------------------------------------------------

_TRACER: Optional[Tracer] = None


def span(name: str, parent: Optional[int] = None,
         **attrs: Any) -> Union[Span, NullSpan]:
    """A span under the installed tracer, or :data:`NULL_SPAN` when
    tracing is disabled — the only call instrumented code makes."""
    t = _TRACER
    if t is None:
        return NULL_SPAN
    return t.span(name, parent=parent, **attrs)


def current_span_id() -> Optional[int]:
    """This thread's innermost live span id (None when disabled or at the
    root) — pass it as ``parent=`` when handing work to another thread."""
    t = _TRACER
    return None if t is None else t.current_span_id()


def active_tracer() -> Optional[Tracer]:
    return _TRACER


def enable(path: str, trace_id: Optional[str] = None,
           flush_every: int = 64) -> Tracer:
    """Install a process-global tracer writing to ``path``.  Replaces (and
    closes) any previously installed tracer."""
    global _TRACER
    old, _TRACER = _TRACER, None
    if old is not None:
        old.close()
    t = Tracer(path, trace_id=trace_id, flush_every=flush_every)
    _TRACER = t
    return t


def disable() -> None:
    """Close and uninstall the global tracer (no-op when none)."""
    global _TRACER
    old, _TRACER = _TRACER, None
    if old is not None:
        old.close()


@contextlib.contextmanager
def maybe_tracing(path: Optional[str]) -> Iterator[Optional[Tracer]]:
    """Install a tracer for the duration iff ``path`` is set and no tracer
    is already active — the idempotent guard every `Offloader` phase uses,
    so ``plan`` (which calls ``prepare`` and ``search``, each also
    guarded) opens exactly one trace file per top-level call."""
    if not path or _TRACER is not None:
        yield _TRACER
        return
    t = enable(path)
    try:
        yield t
    finally:
        if _TRACER is t:
            disable()
        else:                          # someone re-enabled underneath us
            t.close()


def read_trace(path: str) -> tuple:
    """Load a trace file: ``(spans, metrics_snapshot_or_None)``.  Tolerant
    of torn lines (journal semantics) and foreign records."""
    spans: list = []
    snap = None
    for rec in Journal(path).records():
        kind = rec.get("kind")
        if kind == "span":
            spans.append(rec)
        elif kind == "metrics":
            snap = rec.get("snapshot", snap)
    return spans, snap
