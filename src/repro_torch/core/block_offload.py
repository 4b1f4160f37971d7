"""Port of ``repro/core/block_offload.py`` (framework-free copy).

Function-block offload pass (paper §3.2.2 / §4.2.1).

Step 1  parse: the frontend already produced the RegionGraph.
Step 2  search the code-pattern DB: name matching on callees first, then
        Deckard/CloneDigger-style similarity on characteristic vectors.
Step 3  substitute: return the replacement bindings — ExecPlan field updates
        for the module frontend, library-call adapters for the ast frontend.
        When the replacement's interface differs the match is surfaced as
        ``needs_confirmation`` (the paper asks the user before changing
        interfaces); ``confirm`` decides (default: accept and log).

The planner then measures each replacement on/off, and combinations when
multiple blocks matched (paper: 置換機能ブロック一つずつに対してオフロード
するしないを性能測定し…複数ある場合はその組み合わせ対しても検証).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.core.ir import RegionGraph
from repro_torch.core.pattern_db import Match, PatternDB


@dataclass
class BlockOffload:
    region: str
    pattern: str
    how: str                  # "name" | "similarity"
    score: float
    replacement: str
    plan_field: Optional[tuple]
    confirmed: bool
    interface_note: str = ""


@dataclass
class BlockOffloadResult:
    offloads: list[BlockOffload] = field(default_factory=list)
    rejected: list[BlockOffload] = field(default_factory=list)

    @property
    def claimed_regions(self) -> tuple:
        return tuple(o.region for o in self.offloads)

    @property
    def plan_updates(self) -> dict:
        return {o.plan_field[0]: o.plan_field[1]
                for o in self.offloads if o.plan_field}


def block_offload_pass(
        graph: RegionGraph, db: PatternDB,
        confirm: Callable[[Match], bool] | bool = True,
        min_similarity: Optional[float] = None) -> BlockOffloadResult:
    result = BlockOffloadResult()
    claimed_parents: set = set()
    for region in graph.regions:
        if region.kind == "stmt":
            continue
        # skip regions nested inside an already-claimed block
        p = region.parent
        nested = False
        while p is not None:
            if p in claimed_parents:
                nested = True
                break
            p = graph.by_name(p).parent
        if nested:
            continue
        matches = db.match_region(region, graph.frontend,
                                  min_similarity=min_similarity)
        if not matches:
            continue
        m = matches[0]
        ok = True
        if m.needs_confirmation:
            ok = confirm(m) if callable(confirm) else bool(confirm)
        bo = BlockOffload(
            region=region.name, pattern=m.record.name, how=m.how,
            score=m.score, replacement=m.record.replacement,
            plan_field=m.record.plan_field, confirmed=ok,
            interface_note=m.record.interface_note)
        if ok:
            result.offloads.append(bo)
            claimed_parents.add(region.name)
        else:
            result.rejected.append(bo)
    return result
