"""Port of ``repro/core/journal.py`` (framework-free copy).

Shared JSONL-journal primitives: ONE flock/fsync code path for every
on-disk record stream in the system.

Every persistent artifact the search stack writes is the same shape — an
append-only JSONL file that concurrent writers (threads *and* processes)
share, readers load tolerantly (torn trailing lines are skipped), and a
bounded compaction rewrites atomically so a long-lived service can't grow
it without limit.  That idiom grew up independently in the seed bank,
``search_meta.jsonl``, ``surrogate_fit.jsonl`` and the measurement cache;
this module hoists it so all of them — and the plan-service's
:class:`~repro.service.store.PlanStore` — serialize on the identical
sidecar-flock/fsync path instead of five hand-rolled copies.

Invariants every user relies on:

* **appends are atomic-enough**: writers serialize on the ``.lock``
  sidecar (advisory ``flock``; in-process threads serialize on it too
  because each acquisition opens its own descriptor), so a line is never
  interleaved with another writer's;
* **reads never lock**: a reader may observe a torn trailing line from a
  concurrent append — :meth:`Journal.records` skips it;
* **compaction is atomic**: rewrite to ``.tmp`` + ``fsync`` +
  ``os.replace`` under the lock, so a concurrent append can't vanish
  mid-compaction and a crash can't leave a half-written journal;
* **durability is opt-in**: ``fsync=True`` (the plan store) forces every
  append to disk before returning; the measurement journals keep the OS
  page cache's timing (losing a measurement re-measures, losing a
  deployed plan re-searches — only the latter justifies the fsync cost).
"""
from __future__ import annotations

import contextlib
import json
import os
from typing import Any, Callable, Iterable, Optional, Sequence

__all__ = ["file_lock", "Journal", "newest_per_key"]


@contextlib.contextmanager
def file_lock(lock_path: str):
    """Exclusive advisory lock on a sidecar file; no-op where fcntl is
    unavailable.  Not reentrant — never nest acquisitions of the same
    sidecar (two descriptors of one process conflict under ``flock``)."""
    try:
        import fcntl
    except ImportError:
        yield
        return
    with open(lock_path, "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lf, fcntl.LOCK_UN)


class Journal:
    """One append-only JSONL file with locked writes, tolerant reads, and
    atomic bounded compaction — the storage cell every persistent record
    stream (seed bank, search meta, surrogate fits, measurements, plan
    store) is built from."""

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.lock_path = path + ".lock"
        self.fsync = bool(fsync)
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)

    def lock(self):
        """The journal's write lock (see :func:`file_lock`; not reentrant —
        use the ``locked=False`` method variants inside)."""
        return file_lock(self.lock_path)

    # -- writes -------------------------------------------------------------

    def append(self, recs: Sequence[dict], locked: bool = True) -> None:
        ctx = self.lock() if locked else contextlib.nullcontext()
        with ctx:
            with open(self.path, "a", encoding="utf-8") as f:
                for rec in recs:
                    f.write(json.dumps(rec) + "\n")
                if self.fsync:
                    f.flush()
                    os.fsync(f.fileno())

    def rewrite(self, recs: Iterable[dict], locked: bool = True) -> None:
        """Atomically replace the journal's contents (tmp + fsync +
        ``os.replace``).  Callers already holding :meth:`lock` must pass
        ``locked=False``."""
        ctx = self.lock() if locked else contextlib.nullcontext()
        with ctx:
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                for rec in recs:
                    f.write(json.dumps(rec) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)

    # -- reads (lock-free) --------------------------------------------------

    def records(self) -> list[dict]:
        """Every parseable record, file order.  Torn trailing lines from a
        concurrent append and non-dict lines are skipped."""
        out: list[dict] = []
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn concurrent write; journal append-only
                    if isinstance(rec, dict):
                        out.append(rec)
        except FileNotFoundError:
            pass
        return out

    def line_count(self) -> int:
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                return sum(1 for _ in f)
        except FileNotFoundError:
            return 0

    # -- bounded compaction --------------------------------------------------

    def compact(self, keep: Callable[[list[dict]], list[dict]],
                threshold: Optional[int] = None) -> bool:
        """Rewrite the journal to ``keep(records)`` when it has outgrown
        ``threshold`` lines (always, when ``threshold`` is None).  The
        records are re-read *under the lock* so a concurrent append can't
        land between read and replace.  Returns True when a rewrite
        happened."""
        if threshold is not None and self.line_count() <= threshold:
            return False
        with self.lock():
            self.rewrite(keep(self.records()), locked=False)
        return True


def newest_per_key(recs: Sequence[dict], key: Callable[[dict], Any],
                   max_records: Optional[int] = None,
                   per_key: int = 1) -> list[dict]:
    """The shared compaction policy: collapse to the newest ``per_key``
    records per key (line order = recency order), keep the overall newest
    ``max_records``, preserving last-occurrence order.  Records whose key
    is falsy are dropped (unparseable/foreign lines)."""
    by_key: dict[Any, list[dict]] = {}
    for rec in recs:
        k = key(rec)
        if not k:
            continue
        kept = by_key.pop(k, [])
        kept.append(rec)
        by_key[k] = kept[-max(1, int(per_key)):]  # reinsert: recency order
    out = [rec for kept in by_key.values() for rec in kept]
    if max_records is not None:
        out = out[-int(max_records):]
    return out
