"""Port of ``repro/core/ir.py`` (framework-free copy).

Region IR: the language-independent program representation.

The paper's common core manages "loops and variables" and "function blocks"
abstractly, independent of the source language (§3.3: ループと変数の把握に
ついては…言語に非依存に抽象的に管理できる).  Every frontend (in this
port: the ``torch.export`` graph) lowers to this IR; the GA, the pattern DB, and the
transfer planner operate only on it.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Region:
    """One offload candidate: a loop statement, a call, or a function block."""

    name: str                          # unique within the graph
    kind: str                          # "loop" | "call" | "block" | "stmt"
    depth: int = 0                     # loop-nest depth (0 = top level)
    parent: Optional[str] = None
    defs: frozenset = frozenset()      # variables written
    uses: frozenset = frozenset()      # variables read
    callees: tuple = ()                # called function/library names
    feature_vector: dict = field(default_factory=dict)  # Deckard char. vector
    offloadable: bool = False          # has an accelerated alternative
    alternatives: tuple = ()           # implementation ids; [0] is the ref
    trip_count: Optional[int] = None   # static trip count if known
    meta: dict = field(default_factory=dict)

    @property
    def live_in(self) -> frozenset:
        return self.uses

    @property
    def live_out(self) -> frozenset:
        return self.defs


@dataclass
class RegionGraph:
    """Ordered list of regions (program order) + frontend identity."""

    regions: list[Region]
    frontend: str                      # "export" (the port's frontend)
    source_name: str = ""
    meta: dict = field(default_factory=dict)

    def __iter__(self):
        return iter(self.regions)

    def by_name(self, name: str) -> Region:
        for r in self.regions:
            if r.name == name:
                return r
        raise KeyError(name)

    def offloadable(self) -> list[Region]:
        return [r for r in self.regions if r.offloadable]

    def loops(self) -> list[Region]:
        return [r for r in self.regions if r.kind == "loop"]

    def blocks(self) -> list[Region]:
        return [r for r in self.regions if r.kind in ("block", "call")]

    def children(self, name: str) -> list[Region]:
        return [r for r in self.regions if r.parent == name]

    def summary(self) -> dict:
        return {
            "frontend": self.frontend,
            "n_regions": len(self.regions),
            "n_loops": len(self.loops()),
            "n_offloadable": len(self.offloadable()),
        }

    def fingerprint(self, extra: str = "") -> str:
        """Stable content hash of the graph structure — the persistent
        measurement cache's program key: same program (same regions, same
        def/use sets, same offloadable alternatives) -> same fingerprint, so
        measurements recorded by one process are valid for another.  `extra`
        folds in caller context the graph can't see (e.g. input shapes,
        mesh/device count) that changes what a measurement means."""
        h = hashlib.sha256()
        h.update(f"{self.frontend}|{self.source_name}|{extra}".encode())
        for r in self.regions:
            h.update((
                f"{r.name}|{r.kind}|{r.depth}|{r.parent}|"
                f"{sorted(r.defs)}|{sorted(r.uses)}|{r.callees}|"
                f"{r.offloadable}|{r.alternatives}|{r.trip_count}"
            ).encode())
        return h.hexdigest()[:16]
