"""Port of ``repro/core/frontends/module_frontend.py``: architecture configs
-> Region IR, on the static-cost path.

The third "source language" (the declarative one, playing Java's role in
the paper's trio): a model described by an :class:`ArchConfig` lowers to
regions named after its offloadable sites — the ExecPlan knobs applicable to
that architecture family.  Gene bit k toggles site k between its reference
and offloaded implementation, exactly as the paper toggles loop statements;
sites with more than two shipped implementations (``ExecPlan.SITE_VARIANTS``,
e.g. the rg-LRU step/assoc/chunked scans) expose the full menu, so a gene
over the variant alphabet selects *which* implementation runs.

Only the static-cost fitness is ported: a ``lower_fn`` option (the
reference's compiled cost model) raises until ``CostModelFitness``,
``roofline.py`` and ``hlo_analysis.py`` are ported.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.core.ir import Region, RegionGraph
from repro_torch.models.plan import ExecPlan

__all__ = ["ModuleFrontend", "build_graph", "plan_from_bits",
           "plan_from_coding"]

# site -> (applicability predicate, callees exposed for DB name-matching)
_SITE_DEFS = [
    ("attn_impl", lambda c: c.attn_kind != "none",
     ("attention", "softmax", "sdpa")),
    ("norm_impl", lambda c: True, ("rmsnorm", "layer_norm")),
    ("mlp_impl", lambda c: True, ("mlp", "ffn", "geglu", "swiglu")),
    ("qkv_fused", lambda c: c.attn_kind != "none", ("qkv_proj", "matmul")),
    ("rglru_impl", lambda c: bool(c.block_pattern), ("rglru", "linear_recurrence")),
    ("wkv_impl", lambda c: c.family == "ssm", ("wkv", "rwkv", "time_mix")),
    ("moe_impl", lambda c: c.moe is not None, ("moe", "top_k", "dispatch")),
    ("loss_impl", lambda c: True, ("cross_entropy", "softmax", "logsumexp")),
    ("remat", lambda c: True, ("checkpoint", "remat")),
    ("gather_mode", lambda c: True, ("all_gather", "fsdp")),
]

_REF_OFFLOAD = {f: (r, o) for f, r, o in ExecPlan.OFFLOAD_SITES}


def build_graph(cfg: ArchConfig) -> RegionGraph:
    regions: list[Region] = []
    for field, applicable, callees in _SITE_DEFS:
        if not applicable(cfg):
            continue
        # full implementation menu where the executors ship one (ExecPlan.
        # SITE_VARIANTS, e.g. rglru step/assoc/chunked): genes then select
        # WHICH implementation runs; binary sites clamp at their pair
        alternatives = ExecPlan.SITE_VARIANTS.get(field) \
            or _REF_OFFLOAD[field]
        meta = {"plan_field": field}
        if field in ("remat", "gather_mode"):
            # schedule knobs move recomputation/gather placement, not data
            # onto a device: the transfer planner must not read their
            # non-reference menu positions as accelerator placements
            meta["schedule_knob"] = True
        regions.append(Region(
            name=field,
            kind="loop" if field in ("attn_impl", "rglru_impl", "wkv_impl",
                                     "loss_impl") else "block",
            defs=frozenset({f"{field}_out"}),
            uses=frozenset({f"{field}_in", "params"}),
            callees=callees,
            feature_vector={},
            offloadable=True,
            alternatives=tuple(alternatives),
            meta=meta,
        ))
    return RegionGraph(regions, "module", cfg.arch_id)


def plan_from_bits(graph: RegionGraph, bits, base: Optional[ExecPlan] = None,
                   exclude: tuple = ()) -> ExecPlan:
    """Decode a chromosome into an ExecPlan (respecting block-pass claims).

    Multi-destination genes are welcome: value 1 is the primary accelerator
    (the offloaded plan value); any other value — 0 (CPU) or a cost-only
    stub destination — keeps the reference value, since only executable
    destinations change what actually runs.
    """
    plan = base or ExecPlan()
    sites = [r for r in graph.offloadable() if r.name not in exclude]
    assert len(bits) == len(sites), (len(bits), len(sites))
    kw = {}
    for r, b in zip(sites, bits):
        field = r.meta["plan_field"]
        ref, off = _REF_OFFLOAD[field]
        kw[field] = off if int(b) == 1 else ref
    return plan.replace(**kw)


def plan_from_coding(graph: RegionGraph, coding, values,
                     base: Optional[ExecPlan] = None) -> ExecPlan:
    """Destination-aware decode: the coding's alphabet picks each site's
    implementation (cost-only destinations resolve to the reference value)."""
    impl = coding.decode(values)
    plan = base or ExecPlan()
    kw = {graph.by_name(region).meta["plan_field"]: value
          for region, value in impl.items()}
    return plan.replace(**kw)


# ---------------------------------------------------------------------------
# the Frontend adapter (repro_torch.core.frontends.registry protocol)
# ---------------------------------------------------------------------------


class ModuleFrontend:
    """Model-config frontend for the unified pipeline: sites are ExecPlan
    knobs; the fitness is the static-cost stub (options: ``base_plan``).

    The static fallback carries only structural signal for module graphs:
    accelerated ExecPlan *compute* values count as device placements in the
    IR transfer planner (their position >= 1 in the region's own
    ``alternatives`` menu), so the static cost charges each offloaded
    compute site its parameter/input uploads and those genes stay
    conservative.  Schedule knobs (remat / gather_mode) are deliberately
    transfer-free there (``meta["schedule_knob"]``), so they decay to the
    surrogate's more-offload tiebreak and converge to their non-reference
    values.  It is a fast structural path (graph/coding/pipeline
    round-trips with no model built); the result is tagged
    ``static-cost``, never a measurement."""

    name = "module"

    def build_graph(self, cfg: ArchConfig, inputs, config) -> RegionGraph:
        return build_graph(cfg)

    def make_fitness(self, graph: RegionGraph, cfg: ArchConfig, inputs,
                     config):
        from repro_torch.core.block_offload import block_offload_pass
        from repro_torch.core.frontends.registry import (
            FitnessBundle, static_cost_fitness_factory)
        from repro_torch.core.genes import VARIANT_ALPHABET
        from repro_torch.core.pattern_db import default_db

        opts = config.options
        if opts.get("lower_fn") is not None:
            raise NotImplementedError(
                "module frontend: the compiled cost model (lower_fn) waits "
                "for CostModelFitness, roofline.py and hlo_analysis.py "
                "(ROADMAP.md queue 1 item 9)")
        block = block_offload_pass(graph, config.db or default_db(),
                                   confirm=config.confirm)
        base = (opts.get("base_plan") or ExecPlan()).replace(
            **block.plan_updates)
        return FitnessBundle(
            fitness_factory=static_cost_fitness_factory(graph),
            block=block, claimed=block.claimed_regions,
            cache_extra=f"arch={cfg.arch_id}|staticcost",
            measured=False, destinations=VARIANT_ALPHABET,
            context={"base_plan": base})

    def apply_plan(self, graph: RegionGraph, coding, values, bundle
                   ) -> ExecPlan:
        return plan_from_coding(graph, coding, values,
                                bundle.context["base_plan"])
