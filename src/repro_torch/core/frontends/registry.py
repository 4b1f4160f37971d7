"""Port of ``repro/core/frontends/registry.py``: the frontend protocol,
``OffloadConfig`` (with a ``device`` field: plans run on ``cuda`` unless the
caller asks for the CPU), the registry, the static-cost fitness
(:func:`static_cost_fitness_factory`) and the generic ``ir`` frontend
(:class:`IRFrontend`).  :func:`detect_frontend` routes a ``RegionGraph``
to ``ir``, Python source (a string, a parsed ``PyProgram``, or a callable
without ``example_args``) to ``python_ast``, an architecture config to
``module``, and an ``nn.Module``, or a callable with torch
``example_args``, to ``export``.

Frontend protocol + registry: the "common method" switchboard.

The paper's central claim is one offloading method across source languages:
every language parses into the common Region IR, and one GA-based search
runs over it.  A :class:`Frontend` is the per-language adapter that

  * ``build_graph``    — lowers a target (source string, callable, model
    config, …) to a :class:`~repro_torch.core.ir.RegionGraph`,
  * ``make_fitness``   — builds the verification-environment measurement for
    that language (wall-clock interpreter for Python source, AOT cost model
    for module graphs, static transfer cost for graphs with no execution
    path yet), bundled with the function-block pass results, and
  * ``apply_plan``     — decodes the winning chromosome into the language's
    deliverable artifact (an implementation map, an ExecPlan, …).

Frontends register under names (``register_frontend``); the unified
pipeline (:mod:`repro_torch.core.offload`) resolves one per target — explicitly
via ``OffloadConfig.frontend`` or by :func:`detect_frontend` — and drives
the same seed → evaluate → verify loop for all of them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Protocol, runtime_checkable

from repro_torch.core.evaluator import transfer_cost_surrogate
from repro_torch.core.ga import Evaluation, GAConfig
from repro_torch.core.genes import GeneCoding
from repro_torch.core.ir import RegionGraph

__all__ = [
    "Frontend", "FitnessBundle", "IRFrontend", "OffloadConfig",
    "register_frontend", "get_frontend", "frontend_names", "detect_frontend",
    "decoded_pattern", "resolve_alphabet", "static_cost_fitness_factory",
]


def decoded_pattern(coding: "GeneCoding", values, base_impl: Optional[dict]
                    = None) -> dict:
    """The one decode-merge rule: block-pass claims (``base_impl``) first,
    gene decode overrides — every frontend's final region -> impl map."""
    impl = dict(base_impl or {})
    impl.update(coding.decode(values))
    return impl


def resolve_alphabet(config: Optional["OffloadConfig"],
                     proposed: Optional[tuple] = None) -> tuple:
    """THE destination-alphabet precedence rule, in one place:

    1. an explicit ``OffloadConfig.destinations`` always wins (the caller
       knows the hardware they are planning for),
    2. else the frontend's proposal (``FitnessBundle.destinations`` — e.g.
       the export frontend's variant alphabet),
    3. else :data:`~repro_torch.core.genes.DEFAULT_ALPHABET` (the paper's binary
       cpu/gpu chromosome).

    Every entry is validated against the destination registry (mesh wire
    strings parse on demand), so a typo fails here — before a search — with
    the registry's own error."""
    from repro_torch.core.genes import DEFAULT_ALPHABET, get_destination

    if config is not None and config.destinations is not None:
        alphabet = tuple(config.destinations)
    elif proposed:
        alphabet = tuple(proposed)
    else:
        alphabet = DEFAULT_ALPHABET
    for name in alphabet:
        get_destination(name)        # fail fast on unknown alphabet entries
    return alphabet


# ---------------------------------------------------------------------------
# pipeline configuration (lives here so frontends can type against it
# without importing the pipeline module)
# ---------------------------------------------------------------------------


@dataclass
class OffloadConfig:
    """One knob surface for every frontend's planning run."""

    frontend: Optional[str] = None            # None = detect from the target
    device: Optional[str] = None              # where the plan runs and is
                                              # measured: None = cuda (raises
                                              # without CUDA); "cpu" only when
                                              # asked for
    destinations: Optional[tuple] = None      # gene alphabet; None = the
                                              # frontend's proposed alphabet
                                              # (FitnessBundle.destinations)
                                              # or DEFAULT_ALPHABET — an
                                              # explicit value always wins
    ga: GAConfig = field(default_factory=GAConfig)
    db: Optional[Any] = None                  # PatternDB; default_db() if None
    confirm: Callable | bool = True           # interface-change confirmation
    repeats: int = 3                          # wall-clock timing repeats
    hoist_transfers: bool = True
    seed_from_db: bool = True                 # pattern-DB warm-start chromosome
    seed_from_neighbors: bool = True          # similarity-neighbor warm starts
    fitness_fn: Optional[Callable[[tuple], Evaluation]] = None
                                              # override: bypass the frontend's
                                              # fitness (custom verification
                                              # environments, deterministic
                                              # test harnesses)
    log: Optional[Callable[[str], None]] = None
    trace: Optional[str] = None               # JSONL trace file: Offloader
                                              # phases (prepare/search/apply),
                                              # evaluator batches and per-
                                              # chromosome prepare/measure
                                              # spans are recorded there (see
                                              # repro_torch.obs.trace); None =
                                              # tracing disabled (near-zero
                                              # cost)
    options: dict = field(default_factory=dict)   # frontend-specific knobs
                                              # (export: example_args, name,
                                              #  registry; python_ast:
                                              #  consts, registry,
                                              #  block_sites; module:
                                              #  lower_fn, n_devices,
                                              #  model_flops, hbm_budget,
                                              #  base_plan)


@dataclass
class FitnessBundle:
    """What a frontend hands the pipeline: measurement + block-pass context.

    ``fitness_factory`` is deferred on the gene coding because the coding is
    derived *after* the block pass claims regions (and carries the
    destination alphabet); the pipeline builds it exactly once.
    """

    fitness_factory: Callable[[GeneCoding], Callable[[tuple], Evaluation]]
    block: Any = None                         # BlockOffloadResult
    claimed: tuple = ()                       # regions excluded from the gene
    base_impl: dict = field(default_factory=dict)  # block-claim impl bindings
    cache_extra: str = ""                     # measurement-context cache key
    serial_only: bool = False                 # wall-clock: timings don't
                                              # interleave; force workers=0
    overlap_compiles: bool = False            # Offloader.plan enables the
                                              # compile-parallel/time-serial
                                              # phase when GAConfig.
                                              # compile_workers is unset: a
                                              # chromosome's prepare (build,
                                              # warm-up, verify) overlaps
                                              # other chromosomes' prepares
                                              # ahead of the serial timing
                                              # loop.  The evaluator's
                                              # backoff turns it off where
                                              # prepares contend instead
    measured: bool = True                     # False = static-cost stub (no
                                              # real execution behind fitness)
    destinations: Optional[tuple] = None      # frontend-proposed gene
                                              # alphabet (e.g. the export
                                              # variant alphabet); used when
                                              # the config left the default
    mesh_executed: bool = False               # False: this fitness never
                                              # executes mesh genes, so the
                                              # mesh cost model is charged
                                              # on top of measurements even
                                              # when the host has the devices
    impl_resolver: Optional[Callable[[str, Any], Any]] = None
                                              # (region, decoded impl) -> the
                                              # impl that actually runs after
                                              # the frontend's bind/fallback
                                              # rule — folded into the
                                              # phenotype key so chromosomes
                                              # whose variants fall back to
                                              # the same implementation share
                                              # one measurement.  Must be
                                              # static per (region, impl)
                                              # for the search's lifetime

    context: dict = field(default_factory=dict)    # frontend-private state,
                                              # consumed by apply_plan / shims


@runtime_checkable
class Frontend(Protocol):
    """Per-language adapter; see module docstring for the contract."""

    name: str

    def build_graph(self, target: Any, inputs: Optional[dict],
                    config: OffloadConfig) -> RegionGraph: ...

    def make_fitness(self, graph: RegionGraph, target: Any,
                     inputs: Optional[dict],
                     config: OffloadConfig) -> FitnessBundle: ...

    def apply_plan(self, graph: RegionGraph, coding: GeneCoding,
                   values: tuple, bundle: FitnessBundle) -> Any: ...


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Frontend] = {}


def register_frontend(frontend: Frontend, replace: bool = False) -> None:
    if frontend.name in _REGISTRY and not replace:
        raise ValueError(f"frontend {frontend.name!r} already registered")
    _REGISTRY[frontend.name] = frontend


def get_frontend(name: str) -> Frontend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown frontend {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def frontend_names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def detect_frontend(target: Any, config: OffloadConfig) -> str:
    """Map a target to a registered frontend name (duck-typed, so the
    registry never imports a concrete frontend module)."""
    import torch

    if isinstance(target, RegionGraph):
        return "ir"
    if isinstance(target, str):
        return "python_ast"
    if hasattr(target, "graph") and hasattr(target, "check_offloadable"):
        return "python_ast"                    # a parsed PyProgram
    if hasattr(target, "arch_id") and hasattr(target, "family"):
        return "module"                        # an ArchConfig
    if isinstance(target, torch.nn.Module):
        return "export"
    if callable(target):
        # a callable with example args is exported; otherwise its source is
        # parsed like any other Python program
        if "example_args" in config.options:
            return "export"
        return "python_ast"
    raise TypeError(f"cannot detect a frontend for target of type "
                    f"{type(target).__name__}; pass OffloadConfig.frontend")


# ---------------------------------------------------------------------------
# shared static-cost fitness (frontends without an execution path yet)
# ---------------------------------------------------------------------------


def static_cost_fitness_factory(graph: RegionGraph, unit_s: float = 1e-6
                                ) -> Callable[[GeneCoding], Callable]:
    """Deterministic fitness from the transfer planner's static cost.

    The stand-in verification environment for frontends whose offloaded
    implementations don't exist yet (jaxpr kernel substitution, bare region
    graphs): estimated transfer volume decides, more offloaded work breaks
    ties.  Deterministic, so fixed-seed searches reproduce exactly; every
    Evaluation is tagged ``static_cost`` so results are never mistaken for
    measurements.
    """
    def factory(coding: GeneCoding) -> Callable[[tuple], Evaluation]:
        cost = transfer_cost_surrogate(graph, coding)

        def fit(values: tuple) -> Evaluation:
            values = tuple(values)
            # the surrogate's more-offload tiebreak is a tiny negative term;
            # keep it (floor only guards against a pathological surrogate)
            t = unit_s * max(1.0 + cost(values), 1e-9)
            return Evaluation(values, t, True, {"static_cost": True})

        return fit

    return factory


# ---------------------------------------------------------------------------
# the generic IR frontend: plan a bare RegionGraph
# ---------------------------------------------------------------------------


class IRFrontend:
    """Plans any :class:`RegionGraph` directly — the degenerate frontend the
    other three lower into, useful for tests and for callers that built
    their graph elsewhere.  Fitness is the static-cost stub unless the
    config overrides it."""

    name = "ir"

    def build_graph(self, target: RegionGraph, inputs: Optional[dict],
                    config: OffloadConfig) -> RegionGraph:
        if not isinstance(target, RegionGraph):
            raise TypeError(f"ir frontend needs a RegionGraph, got "
                            f"{type(target).__name__}")
        return target

    def make_fitness(self, graph: RegionGraph, target: Any,
                     inputs: Optional[dict],
                     config: OffloadConfig) -> FitnessBundle:
        from repro_torch.core.block_offload import block_offload_pass
        from repro_torch.core.pattern_db import default_db

        block = block_offload_pass(graph, config.db or default_db(),
                                   confirm=config.confirm)
        return FitnessBundle(
            fitness_factory=static_cost_fitness_factory(graph),
            block=block, claimed=block.claimed_regions,
            cache_extra="ir|staticcost", measured=False)

    def apply_plan(self, graph: RegionGraph, coding: GeneCoding,
                   values: tuple, bundle: FitnessBundle) -> dict:
        return decoded_pattern(coding, values, bundle.base_impl)
