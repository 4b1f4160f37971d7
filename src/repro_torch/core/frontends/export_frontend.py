"""Port of ``repro/core/frontends/jaxpr_frontend.py``: ``torch.export``ed
programs -> Region IR -> substituted programs.

Graph form: the pre-decomposition ATen graph that ``torch.export.export``
returns (``aten.matmul``, ``aten.softmax.int``, ``aten.tril``, ...), taken
as the unlifted ``GraphModule`` of ``ep.module()`` — no
``run_decompositions()``.  The pattern DB's ``"export"`` vectors, the
registry's role inference and the substitution engine all read this one
form.

Regions.  ``torch.export`` flattens the program; the reference's regions
come from closed calls and control flow, and their counterpart here is the
innermost user module of each node (``node.meta["nn_module_stack"]``):
consecutive ``call_function`` nodes of the same module form one region, and
the module's class and attribute names join the region's ``callees`` — what
the pattern DB's name matching keys on (an ``RMSNorm`` submodule matches
``rmsnorm``, an ``Attention`` submodule ``softmax_attention``).  Nodes of
the root module are named by their ops only.  Nodes that derive from no
program input (mask builders such as ``ones`` -> ``tril``, ``arange``,
parameter casts) are glue: they never start or split a region, and join the
region of their first input-derived user (the counterpart of ``_is_glue``),
so a region's nodes need not be contiguous.  Regions of >= 5 nodes are
offloadable ``block`` regions.

Scan regions.  ``torch._higher_order_ops.scan`` exports as one ``scan``
node (PyTorch 2.11 and 2.13 alike) with ``args = (combine_graph, [init...],
[xs...], (additional_inputs...))``: ``combine_graph`` is a ``get_attr`` of
the body ``GraphModule``, and tensors the body closes over (WKV's ``u``)
land in ``additional_inputs``.  Its outputs are read through ``getitem``
nodes (carries first, then ys).  ``reverse=True`` exports as ``flip`` ->
``scan`` -> ``flip`` over dim 0, and the body may not return the carry
itself as a ys (it returns ``h.clone()``).  A ``scan`` node and its
``getitem`` nodes form a run of their own (glue such as a ``zeros`` initial
carry joins it), which becomes an offloadable region of kind ``"loop"``
whatever its node count — the counterpart of the reference's
``kind="loop"`` for scan equations.  Its ``meta["scan"]`` records the
structure (``num_consts``, ``num_carry``, ``num_xs``, ``length``, and
``reverse`` when every xs is a dim-0 ``flip``), its vector is the body's
ops plus one ``scan``, and the body's ``get_attr`` is never one of its
inputs.  Neighbouring nodes of the same module (a ``flip``, a ``permute``)
fall into the regions before and after it.

Every region records its node names (``meta["nodes"]``); matched regions
are annotated with their pattern and the kernel registry's variant
alphabet (:func:`annotate_variants`), which is what lets the substitution
engine turn a plan into a runnable program and
:meth:`ExportFrontend.make_fitness` measure real wall-clock time.

A plain function is exported as the forward of a wrapper that holds the
modules (``nn.Module``) the function reads by name (closure cells,
globals) as submodules under those names: without them ``torch.export``
records no module scopes for their calls, so ``lambda tok:
model.prefill(params, ...)`` would lose every region.

Not ported yet: block sites (``annotate_block_sites``).
"""
from __future__ import annotations

import operator
from typing import Any, Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import similarity as sim
from repro_torch.core.ir import Region, RegionGraph

__all__ = ["ExportFrontend", "annotate_variants", "build_graph",
           "resolve_device"]


def resolve_device(device: Any = None) -> torch.device:
    """The device a plan runs on: ``cuda`` unless the caller asks for the
    CPU.  Raises when CUDA is wanted and absent — never a silent CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "plan on the CPU")
    return dev


def _scope(node) -> tuple:
    """(attribute path, class name) of the node's innermost module."""
    stack = node.meta.get("nn_module_stack")
    if not stack:
        return ("", "")
    path, cls = list(stack.values())[-1]
    cls = cls if isinstance(cls, str) else getattr(cls, "__name__", str(cls))
    return (path, cls.rsplit(".", 1)[-1])


def _closure_modules(fn: Callable) -> dict:
    """The modules (``nn.Module``) a plain function reads by name: its closure
    cells and the globals its code names (``lambda t: model.prefill(params,
    ...)`` reads ``params``)."""
    code = getattr(fn, "__code__", None)
    if code is None:
        return {}
    found = dict(zip(code.co_freevars,
                     (c.cell_contents for c in fn.__closure__ or ())))
    scope = getattr(fn, "__globals__", {})
    found.update({n: scope[n] for n in code.co_names if n in scope})
    return {n: m for n, m in found.items()
            if isinstance(m, torch.nn.Module)}


def _as_module(fn: Callable) -> torch.nn.Module:
    """``fn`` as the root module to export.  A plain function becomes the
    forward of a wrapper that holds the modules it reads as submodules
    under their names, so their calls keep their module scopes (and thus
    their regions) in the exported graph."""
    if isinstance(fn, torch.nn.Module):
        return fn

    class _Program(torch.nn.Module):
        def forward(self, *args):
            return fn(*args)

    program = _Program()
    for name, module in _closure_modules(fn).items():
        program.add_module(name, module)
    return program


def _is_dim0_flip(node) -> bool:
    return getattr(node, "target", None) is torch.ops.aten.flip.default \
        and list(node.args[1]) in ([0], [-node.meta["val"].ndim])


def _scan_structure(scan) -> dict:
    """The structure of a ``scan`` node: operand counts (the reference's
    ``num_consts``/``num_carry`` plus ``num_xs``), the trip count, and
    ``reverse`` — every xs is a dim-0 ``flip``, the form ``reverse=True``
    exports as."""
    _, init, xs, consts = scan.args[:4]
    return {"num_consts": len(consts), "num_carry": len(init),
            "num_xs": len(xs),
            "length": int(xs[0].meta["val"].shape[0]) if xs else 0,
            "reverse": bool(xs) and all(_is_dim0_flip(x) for x in xs)}


def build_graph(fn: Callable, *example_args, name: str = "") -> RegionGraph:
    ep = torch.export.export(_as_module(fn), tuple(example_args))
    gm = ep.module()
    nodes = [n for n in gm.graph.nodes if n.op == "call_function"]

    # stable var naming by first appearance (the fingerprint hashes these)
    names: dict = {}

    def vname(n) -> str:
        return names.setdefault(n, f"v{len(names)}")

    for n in gm.graph.nodes:
        vname(n)

    # runs: consecutive input-derived nodes of one module (glue skipped);
    # a scan node and its getitems form a run of their own
    derived: set = {n for n in gm.graph.nodes if n.op == "placeholder"}
    runs: list[tuple[tuple, Any, list]] = []   # (scope, scan node, nodes)
    glue: list = []
    scan_run: dict = {}                    # scan node -> its run's index
    for n in nodes:
        if not any(a in derived for a in n.all_input_nodes):
            glue.append(n)                 # derives from no program input
            continue
        derived.add(n)
        if n.target is operator.getitem and n.args[0] in scan_run:
            runs[scan_run[n.args[0]]][2].append(n)
            continue
        sc = _scope(n)
        if sim.is_scan(n):
            scan_run[n] = len(runs)
            runs.append((sc, n, [n]))
            continue
        if not runs or runs[-1][0] != sc or runs[-1][1] is not None:
            runs.append((sc, None, []))
        runs[-1][2].append(n)
    # glue joins the run of its first input-derived user (dead glue: the
    # next run in graph order), so it never starts or splits a region
    run_of = {n: i for i, (_, _, run) in enumerate(runs) for n in run}
    order = {n: i for i, n in enumerate(nodes)}

    def home(n) -> int:
        users = sorted(n.users, key=lambda u: order.get(u, len(order)))
        for u in users:
            if u in run_of:
                return run_of[u]
            if u in order:
                return home(u)
        later = [run_of[m] for m in nodes[order[n]:] if m in run_of]
        return later[0] if later else len(runs) - 1

    for n in glue:
        runs[home(n)][2].append(n)
    runs = [(sc, scan, sorted(run, key=order.__getitem__))
            for sc, scan, run in runs]

    bodies = {n.args[0] for n in scan_run}    # never a region input
    regions: list[Region] = []
    for i, ((path, cls), scan, run) in enumerate(runs):
        kind = "loop" if scan is not None else \
            "block" if len(run) >= 5 else "stmt"
        module_names = (cls, path.rsplit(".", 1)[-1]) if path else ()
        meta = {"nodes": tuple(n.name for n in run), "module": path}
        if scan is not None:
            meta["scan"] = _scan_structure(scan)
        regions.append(Region(
            name=f"{kind}_{i}", kind=kind,
            defs=frozenset(vname(n) for n in run),
            uses=frozenset(vname(a) for n in run for a in n.all_input_nodes
                           if a not in bodies),
            callees=module_names + tuple(sim._op_name(n.target) for n in run),
            feature_vector=sim.export_vector([scan] if scan is not None
                                             else run),
            offloadable=kind != "stmt",
            alternatives=("ref", "kernel") if kind != "stmt" else (),
            trip_count=meta["scan"]["length"] if scan is not None else None,
            meta=meta))
    label = name or getattr(fn, "__name__", type(fn).__name__)
    g = RegionGraph(regions, "export", label)
    g.meta["whole_program_vector"] = sim.export_vector(gm)
    # the exported program the node spans name, for the substitution engine
    # (in-memory only; the fingerprint never hashes meta)
    g.meta["graph_module"] = gm
    return g


def annotate_variants(graph: RegionGraph, db, registry=None) -> RegionGraph:
    """Match offloadable regions against the pattern DB and widen their
    implementation alternatives to the registry's executable variants:
    a matched region gets ``meta["pattern"]`` and ``alternatives =
    ("ref",) + variant names``; unmatched regions keep ``("ref", "kernel")``.
    """
    from repro_torch.kernels.registry import default_registry

    registry = registry or default_registry()
    for region in graph.offloadable():
        matches = db.match_region(region, graph.frontend)
        if not matches:
            continue
        m = matches[0]
        names = registry.variant_names(m.record.name)
        if not names:
            continue
        region.meta["pattern"] = m.record.name
        region.meta["pattern_match"] = {"how": m.how,
                                        "score": round(m.score, 4)}
        region.alternatives = ("ref",) + names
    return graph


def _check_devices(target: Any, example_args: tuple,
                   device: torch.device) -> None:
    tensors = [l for l in pytree.tree_leaves(example_args)
               if isinstance(l, torch.Tensor)]
    modules = [target] if isinstance(target, torch.nn.Module) \
        else _closure_modules(target).values()
    for module in modules:
        tensors += list(module.parameters()) + list(module.buffers())
    wrong = {str(t.device) for t in tensors if t.device.type != device.type}
    if wrong:
        raise ValueError(f"planning on {device} but the program's tensors "
                         f"live on {sorted(wrong)}")


class ExportFrontend:
    """``torch.export`` frontend for the unified pipeline.

    ``options["example_args"]`` supplies the export arguments; they and the
    module's parameters must live on ``OffloadConfig.device`` (``cuda``
    unless the caller asks for the CPU).  The fitness is *measured*: every
    chromosome decodes to a substituted program (registry variants spliced
    in by the substitution engine), verified against the unsubstituted
    program and wall-clock timed.
    """

    name = "export"

    def build_graph(self, fn: Callable, inputs, config) -> RegionGraph:
        from repro_torch.core.pattern_db import default_db

        example_args = tuple(config.options.get("example_args", ()))
        _check_devices(fn, example_args, resolve_device(config.device))
        graph = build_graph(fn, *example_args,
                            name=config.options.get("name", ""))
        return annotate_variants(graph, config.db or default_db(),
                                 registry=config.options.get("registry"))

    def make_fitness(self, graph: RegionGraph, fn: Callable, inputs, config):
        from repro_torch.core.block_offload import block_offload_pass
        from repro_torch.core.fitness import WallClockFitness
        from repro_torch.core.frontends.registry import (FitnessBundle,
                                                         decoded_pattern)
        from repro_torch.core.genes import VARIANT_ALPHABET
        from repro_torch.core.pattern_db import (default_db,
                                                 record_pattern_outcome)
        from repro_torch.core.substitution import SubstitutionEngine

        device = resolve_device(config.device)
        block = block_offload_pass(graph, config.db or default_db(),
                                   confirm=config.confirm)
        example_args = tuple(config.options.get("example_args", ()))
        engine = SubstitutionEngine(graph.meta["graph_module"], example_args,
                                    graph,
                                    registry=config.options.get("registry"))
        # the reference once, as float64 host arrays (verify compares there)
        reference_output = pytree.tree_map(
            lambda x: x.detach().to("cpu", torch.float64).numpy()
            if isinstance(x, torch.Tensor) else x, engine.reference())
        args_sig = ",".join(
            f"{tuple(a.shape)}:{a.dtype}" if isinstance(a, torch.Tensor)
            else f"{np.shape(a)}:{type(a).__name__}"
            for a in pytree.tree_leaves(example_args))
        device_name = torch.cuda.get_device_name(device) \
            if device.type == "cuda" else "cpu"
        repeats = config.repeats
        precision_dir = config.ga.cache_dir

        def factory(coding):
            # bits -> SubstitutionReport of the program just built, so the
            # verifier outcome in prepare() can be attributed per (pattern,
            # variant)
            reports: dict = {}

            def build(values):
                values = tuple(values)
                impl = decoded_pattern(coding, values, {})
                sub = engine.substitute(
                    impl, destinations=coding.destinations_of(values))
                reports[values] = sub.report
                return lambda: sub(*example_args)

            class _RecordingFitness(WallClockFitness):
                """Classify each chromosome's verifier outcome and journal
                it per substituted (pattern, variant)."""

                def prepare(self, bits):
                    prep = super().prepare(tuple(bits))
                    report = reports.pop(tuple(bits), None)
                    if report is None:     # build itself failed: no program
                        return prep
                    if prep.failure is None:
                        outcome = "ok"
                    elif "verify" in prep.failure.detail:
                        outcome = "verify_fail"
                    else:
                        outcome = "error"
                    for c in report.choices:
                        if c.chosen != "ref":
                            record_pattern_outcome(
                                precision_dir, c.pattern, c.chosen,
                                outcome, region=c.region)
                        elif c.requested not in ("ref", "interp",
                                                 "host", "cpu"):
                            record_pattern_outcome(
                                precision_dir, c.pattern, c.requested,
                                "bind_fail", region=c.region)
                    return prep

            return _RecordingFitness(build, reference_output=reference_output,
                                     repeats=repeats)

        # block-pass matches are *not* claimed on the measured path: the
        # genes range over each matched region's variant set, so the GA
        # decides which implementation runs
        return FitnessBundle(
            fitness_factory=factory,
            block=block, claimed=(), base_impl={},
            cache_extra=(f"export={graph.source_name}|measured"
                         f"|args={args_sig}|device={device_name}"
                         f"|ndev={torch.cuda.device_count()}"),
            measured=True,
            destinations=VARIANT_ALPHABET,
            impl_resolver=engine.resolved_impl,
            context={"engine": engine, "example_args": example_args})

    def apply_plan(self, graph: RegionGraph, coding, values, bundle):
        from repro_torch.core.frontends.registry import decoded_pattern

        values = tuple(values)
        impl = decoded_pattern(coding, values, bundle.base_impl)
        return bundle.context["engine"].substitute(
            impl, destinations=coding.destinations_of(values))
