"""Port of ``repro/obs/metrics.py`` (framework-free copy).

Process-wide metrics registry: counters, gauges, histograms.

Zero-dependency (stdlib only).  One module-level :data:`REGISTRY` holds
every metric family; call sites grab a handle once and mutate it —
handles are cheap to re-resolve, so hot paths may also call
``counter(...)`` per event without setup.

Naming convention (see docs/api.md): dotted lowercase families
(``eval.cache_hits``, ``service.admission``), labels for the dimensions
a single family fans out over (``counter("service.admission",
outcome="live-hit")``).  Histograms record seconds unless the name says
otherwise.

Two export formats:

* :func:`snapshot` — a plain-JSON dict (round-trips through
  ``json.dumps``), embedded in trace files by ``obs.trace.Tracer.close``
  and dumped by ``launch/obsreport.py`` and the bench ``--metrics``
  artifact.
* :func:`render_prometheus` — Prometheus text exposition (``# TYPE``
  lines, ``name{label="v"} value``, histogram ``_bucket``/``_sum``/
  ``_count`` series) for scraping a long-lived service.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterator, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "counter", "gauge", "histogram", "snapshot", "render_prometheus",
           "reset"]

#: default histogram buckets (seconds): 100us .. 30s covers everything from
#: a null-span probe to a cold GA search.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically increasing value."""

    __slots__ = ("value", "_lock")
    kind = "counter"

    def __init__(self) -> None:
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def as_dict(self) -> dict:
        return {"value": self.value}


class Gauge:
    """Point-in-time value (set/inc/dec)."""

    __slots__ = ("value", "_lock")
    kind = "gauge"

    def __init__(self) -> None:
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value -= amount

    def as_dict(self) -> dict:
        return {"value": self.value}


class Histogram:
    """Bucketed distribution with sum/count/min/max.

    Buckets are cumulative upper bounds (Prometheus ``le`` semantics);
    observations above the last bound land only in the implicit +Inf
    bucket (= ``count``).
    """

    __slots__ = ("buckets", "bucket_counts", "count", "sum",
                 "min", "max", "_lock")
    kind = "histogram"

    def __init__(self, buckets: Optional[Tuple[float, ...]] = None) -> None:
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))
        self.bucket_counts = [0] * len(self.buckets)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            for i, bound in enumerate(self.buckets):
                if v <= bound:
                    self.bucket_counts[i] += 1

    def as_dict(self) -> dict:
        d = {"count": self.count, "sum": self.sum,
             "buckets": {f"{b:g}": c for b, c
                         in zip(self.buckets, self.bucket_counts)}}
        if self.count:
            d["min"] = self.min
            d["max"] = self.max
            d["mean"] = self.sum / self.count
        return d


class MetricsRegistry:
    """Thread-safe family store: ``(name, sorted-label-tuple) -> metric``.

    A family name is bound to one metric kind on first use; asking for the
    same name with a different kind raises — mixed-kind families cannot be
    rendered in either export format.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, LabelKey], object] = {}
        self._kinds: Dict[str, str] = {}

    def _get(self, cls, name: str, labels: Dict[str, str], **kw):
        key = (name, _label_key(labels))
        with self._lock:
            kind = self._kinds.setdefault(name, cls.kind)
            if kind != cls.kind:
                raise ValueError(
                    f"metric {name!r} already registered as {kind}, "
                    f"requested {cls.kind}")
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(**kw)
            return m

    def counter(self, name: str, **labels: str) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str,
                  buckets: Optional[Tuple[float, ...]] = None,
                  **labels: str) -> Histogram:
        return self._get(Histogram, name, labels, buckets=buckets)

    def _families(self) -> Iterator[Tuple[str, str, list]]:
        with self._lock:
            items = sorted(self._metrics.items())
            kinds = dict(self._kinds)
        by_name: Dict[str, list] = {}
        for (name, lk), metric in items:
            by_name.setdefault(name, []).append((lk, metric))
        for name in sorted(by_name):
            yield name, kinds[name], by_name[name]

    def snapshot(self) -> dict:
        """Plain-JSON dump: ``{name: {"kind":..., "series":[...]}}``."""
        out: Dict[str, dict] = {}
        for name, kind, series in self._families():
            out[name] = {"kind": kind, "series": [
                {"labels": dict(lk), **metric.as_dict()}
                for lk, metric in series]}
        return out

    def render_prometheus(self) -> str:
        lines: list = []

        def fmt(name: str, lk: LabelKey, value: float,
                extra: Optional[Tuple[str, str]] = None) -> str:
            pairs = list(lk) + ([extra] if extra else [])
            labels = ",".join(f'{k}="{v}"' for k, v in pairs)
            body = f"{{{labels}}}" if labels else ""
            return f"{name}{body} {value:g}"

        for name, kind, series in self._families():
            pname = name.replace(".", "_").replace("-", "_")
            lines.append(f"# TYPE {pname} {kind}")
            for lk, metric in series:
                if kind == "histogram":
                    cum = 0
                    for bound, c in zip(metric.buckets,
                                        metric.bucket_counts):
                        cum = c
                        lines.append(fmt(f"{pname}_bucket", lk, cum,
                                         ("le", f"{bound:g}")))
                    lines.append(fmt(f"{pname}_bucket", lk, metric.count,
                                     ("le", "+Inf")))
                    lines.append(fmt(f"{pname}_sum", lk, metric.sum))
                    lines.append(fmt(f"{pname}_count", lk, metric.count))
                else:
                    lines.append(fmt(pname, lk, metric.value))
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()
            self._kinds.clear()


#: the process-wide registry every instrumented module writes to.
REGISTRY = MetricsRegistry()


def counter(name: str, **labels: str) -> Counter:
    return REGISTRY.counter(name, **labels)


def gauge(name: str, **labels: str) -> Gauge:
    return REGISTRY.gauge(name, **labels)


def histogram(name: str, buckets: Optional[Tuple[float, ...]] = None,
              **labels: str) -> Histogram:
    return REGISTRY.histogram(name, buckets=buckets, **labels)


def snapshot() -> dict:
    return REGISTRY.snapshot()


def render_prometheus() -> str:
    return REGISTRY.render_prometheus()


def reset() -> None:
    REGISTRY.reset()
