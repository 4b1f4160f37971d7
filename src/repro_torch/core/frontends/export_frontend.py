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

Function blocks (:func:`annotate_block_sites`, the counterpart of the
reference's jaxpr pass).  The reference joins only span-adjacent
offloadable regions; here a norm and an attention core are separated by
the projections between them, which run in the caller's module and make
short ``stmt`` regions.  So a *window* is a range of consecutive regions
(graph order) whose first and last regions are offloadable and which holds
at least two offloadable regions: the ``stmt`` regions inside it go with
its node range but carry no gene, and its offloadable regions are its
``block_members``.  Windows are tried widest-first and accepted greedily
when they do not overlap one already kept, and a window is kept only if
some registry variant binds its merged node range.  Each kept window
becomes a ``fnblock_*`` region (kind ``block``, empty def/use sets — the
block substitutes in place of its members — and ``meta["nodes"]``, every
node of the window).  A program that is one region (a function with no
submodules) has no window.

A target that is not a module -- a function, a ``functools.partial`` or a
bound method -- is exported as the forward of a wrapper that holds the
modules (``nn.Module``) it reaches (:func:`target_modules`: closure cells,
loaded globals, a partial's arguments, a method's ``self``) as submodules
under stable names: without them ``torch.export`` records no module scopes
for their calls, so ``lambda tok: model.prefill(params, ...)`` would lose
every region.  A program that calls modules yet records no module scope
is refused, never planned as one silent region.

"""
from __future__ import annotations

import dis
import functools
import inspect
import operator
import threading
import time
import types
from typing import Any, Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import similarity as sim
from repro_torch.core.ir import Region, RegionGraph
from repro_torch.core.trace_lock import TRACE_LOCK

__all__ = ["ExportFrontend", "annotate_block_sites", "annotate_variants",
           "build_graph", "resolve_device", "target_modules"]


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


def _loaded_globals(code) -> set:
    """The global names ``code`` loads (``LOAD_GLOBAL``/``LOAD_NAME``, in
    nested code objects too) -- not ``co_names``, which also lists
    attribute names (``s.p`` names ``p``)."""
    names = {ins.argval for ins in dis.get_instructions(code)
             if ins.opname in ("LOAD_GLOBAL", "LOAD_NAME")}
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            names |= _loaded_globals(const)
    return names


def target_modules(fn: Any) -> dict:
    """The modules (``nn.Module``) a target reaches, by stable names:

    - a module itself (a bound method's ``self``: ``"self"``);
    - through a ``functools.partial``: its ``func``, and its ``args`` and
      ``keywords`` under the names of the parameters they bind (``arg0``..
      where the signature cannot be read), recursively;
    - through a bound method: its function, and its ``__self__``, a module
      or a plain object whose attributes hold modules (under those
      attributes' names);
    - through a function's closure cells (under the free variables'
      names), recursively, and the globals its code loads.

    A module reached twice keeps its first name; names that collide get a
    ``_1``, ``_2``.. suffix."""
    found: dict = {}
    seen: set = set()

    def add(name: str, module: torch.nn.Module) -> None:
        if any(m is module for m in found.values()):
            return
        base, i = name, 0
        while name in found:
            i += 1
            name = f"{base}_{i}"
        found[name] = module

    def visit(name: str, value: Any) -> None:
        if id(value) in seen:
            return
        seen.add(id(value))
        if isinstance(value, torch.nn.Module):
            add(name, value)
        elif isinstance(value, functools.partial):
            visit(name, value.func)
            try:
                bound = inspect.signature(value.func).bind_partial(
                    *value.args, **value.keywords).arguments
            except (TypeError, ValueError):
                bound = {**{f"arg{i}": a for i, a in enumerate(value.args)},
                         **value.keywords}
            for n, a in bound.items():
                visit(n, a)
        elif inspect.ismethod(value):
            visit(name, value.__func__)
            owner = value.__self__
            if isinstance(owner, torch.nn.Module):
                add("self", owner)
            else:
                for n, a in getattr(owner, "__dict__", {}).items():
                    if isinstance(a, torch.nn.Module):
                        add(n, a)
        elif isinstance(value, types.FunctionType):
            code = value.__code__
            for n, cell in zip(code.co_freevars, value.__closure__ or ()):
                try:
                    visit(n, cell.cell_contents)
                except ValueError:          # an empty cell
                    pass
            scope = value.__globals__
            for n in sorted(_loaded_globals(code)):
                if isinstance(scope.get(n), torch.nn.Module):
                    add(n, scope[n])

    visit("target", fn)
    return found


def _as_module(fn: Callable) -> torch.nn.Module:
    """``fn`` as the root module to export.  Any other callable becomes the
    forward of a wrapper that holds the modules it reaches
    (:func:`target_modules`) as submodules under their names, so their
    calls keep their module scopes (and thus their regions) in the
    exported graph."""
    if isinstance(fn, torch.nn.Module):
        return fn

    class _Program(torch.nn.Module):
        def forward(self, *args):
            return fn(*args)

    program = _Program()
    for name, module in target_modules(fn).items():
        while hasattr(program, name):       # never shadow an attribute
            name += "_"
        program.add_module(name, module)
    return program


def _target_name(fn: Any) -> str:
    if isinstance(fn, functools.partial):
        return f"partial({_target_name(fn.func)})"
    return getattr(fn, "__name__", type(fn).__name__)


class _DynamoEntries:
    """What dynamo caches from here on, released on request.

    Exporting a ``scan`` compiles its body with ``torch.compile`` (torch's
    eager path for the operator), and dynamo keeps the compiled code in a
    cache entry of the code object it traced, and the backend in
    ``cached_backends``; the backend closes over the export's tracer, and
    through it the program, its modules and their weights.  ``release``
    resets the code objects whose cache entries changed since construction
    (``torch._dynamo.reset_code``: the code this export traced, whether or
    not dynamo had seen it before) and drops the backends added since;
    every other compiled code of the caller stays."""

    def __init__(self):
        from torch._dynamo import convert_frame, eval_frame

        self._seen = convert_frame.input_codes.seen
        self._entries = eval_frame._debug_get_cache_entry_list
        self._before = {code: len(self._entries(code))
                        for code in self._codes()}
        self._backends = eval_frame.cached_backends
        self._backend_ids = set(self._backends)

    def _codes(self) -> list:
        return [code for code in (ref() for ref in self._seen)
                if code is not None]

    def release(self) -> None:
        for code in self._codes():
            if len(self._entries(code)) != self._before.get(code, 0):
                torch._dynamo.reset_code(code)
        for key in set(self._backends) - self._backend_ids:
            del self._backends[key]


#: one call of an exported program's input guards at a time
#: (:class:`_SerialGuards`)
_GUARDS_LOCK = threading.RLock()


class _SerialGuards(torch.nn.Module):
    """An exported program's ``_guards_fn`` called under
    :data:`_GUARDS_LOCK`.  torch 2.11 runs the guards inside one
    ``torch._dynamo.config`` patch whose saved settings belong to the patch,
    not to the calling thread, so two threads inside it at once fail
    (``AssertionError: prior should be empty when entering ConfigPatch``)
    or restore each other's settings.  A program and every substitution of
    it share one guards module, and the planner's overlapped prepares and a
    served endpoint's clients call them from several threads."""

    def __init__(self, guards: torch.nn.Module):
        super().__init__()
        self.guards = guards

    def forward(self, *args):
        with _GUARDS_LOCK:
            return self.guards(*args)


def _export(root: torch.nn.Module, example_args: tuple, label: str):
    """``torch.export`` of ``root``, refusing a program that calls modules
    when none of its nodes records a module scope: its modules were not
    reached from the target, so it would be one silent region.

    The export runs without autograd: the planner plans forward programs
    (the fitness runs them under ``no_grad``), the graph is the same, and a
    ``scan`` whose inputs require grad (RWKV-6's bonus ``u`` is a
    parameter) is not traced into a joint forward and backward graph and
    partitioned, which costs seconds a layer.  What dynamo cached while
    exporting is released after (:class:`_DynamoEntries`), so the program
    does not outlive its caller's references.  The export and that release
    run under the process-wide :data:`TRACE_LOCK`, and the program's input
    guards run one call at a time (:class:`_SerialGuards`)."""
    called: list = []
    handle = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda m, _args: called.append(m) if m is not root else None)
    with TRACE_LOCK:
        traced = _DynamoEntries()
        try:
            with torch.no_grad():
                ep = torch.export.export(root, tuple(example_args))
        finally:
            handle.remove()
            traced.release()
    # export's own wrappers hold the root, and its graph modules (a scan's
    # body) come from torch; every other call is the program's
    read = sorted({type(m).__name__ for m in called
                   if not any(x is root for x in m.modules())
                   and (not type(m).__module__.startswith("torch.")
                        or type(m).__module__.startswith("torch.nn."))})
    gm = ep.module()
    if isinstance(getattr(gm, "_guards_fn", None), torch.nn.Module):
        gm._guards_fn = _SerialGuards(gm._guards_fn)
    if read and not any(_scope(n)[0] for n in gm.graph.nodes
                        if n.op == "call_function"):
        raise ValueError(
            f"{label}: calls modules ({', '.join(read)}) that the export "
            f"frontend did not find, so the exported graph records no "
            f"module scope and no site could match; reach them through a "
            f"closure cell, a loaded global, a functools.partial argument or "
            f"a bound method's self, or pass the module itself")
    return gm


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
    label = name or _target_name(fn)
    gm = _export(_as_module(fn), example_args, label)
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


def annotate_block_sites(graph: RegionGraph, db, registry=None
                         ) -> RegionGraph:
    """Detect *function-block* offload sites: windows of consecutive
    regions whose merged node range matches a ``block`` pattern-DB record
    (arXiv 2004.09883's function-block genes alongside loop genes) and
    binds a registry variant.  See the module docstring for the window
    rule.

    Each accepted window becomes a synthetic ``fnblock_*`` region appended
    to the graph: one extra gene whose accelerated alternatives are the
    registry's *block-level* variants.  While that gene is active it claims
    its ``meta["block_members"]`` (see :class:`repro_torch.core.genes.
    Site`), so the member regions' own genes go inert and the whole window
    runs through the block adapter.

    Every window is grown one region at a time from each offloadable
    start, so its merged callees, vector, free inputs and live outputs
    are kept incrementally (a whole model has O(regions²) windows); the
    windows that match and bind are then accepted widest-first, lowest
    start first, as the reference accepts them.
    """
    from repro_torch.core.substitution import _backend_of, is_subgraph
    from repro_torch.core.variants import resolve_variant
    from repro_torch.kernels.registry import Aval, CallSite, default_registry

    registry = registry or default_registry()
    gm = graph.meta.get("graph_module")
    if gm is None:
        return graph
    by_name = {n.name: n for n in gm.graph.nodes}
    order = {n: i for i, n in enumerate(gm.graph.nodes)}
    # the variants bind for where the program's inputs and weights live
    backend = _backend_of(tuple(n.meta.get("val") for n in gm.graph.nodes
                                if n.op in ("placeholder", "get_attr")))
    cands = [r for r in graph.regions
             if r.meta.get("nodes") and not r.meta.get("block_members")]
    spans = [tuple(by_name[nm] for nm in r.meta["nodes"]) for r in cands]
    span_sets = [frozenset(span) for span in spans]
    callees = [{c.lower().split(".")[-1] for c in r.callees} for r in cands]
    avals: dict = {}

    def aval(node) -> Aval:
        if node not in avals:
            avals[node] = Aval.of(node.meta["val"])
        return avals[node]

    bound: list[tuple] = []            # (lo, hi, match, bound names)
    for lo, first in enumerate(cands):
        if not first.offloadable:
            continue
        window: set = set()
        ins: dict = {}                 # free inputs, first-use order
        ext: dict = {}                 # window node -> users outside it
        names: set = set()
        merged: dict = {}
        n_members = 0
        for hi in range(lo, len(cands)):
            new = span_sets[hi]
            window.update(new)
            for node in spans[hi]:
                ins.pop(node, None)
                ext[node] = sum(1 for u in node.users if u not in window)
                for a in node.all_input_nodes:
                    if a not in window:
                        if not is_subgraph(a):
                            ins[a] = None
                    elif a in ext and a not in new:
                        ext[a] -= 1
            names |= callees[hi]
            for k, v in cands[hi].feature_vector.items():
                merged[k] = merged.get(k, 0) + v
            if not cands[hi].offloadable:
                continue
            n_members += 1
            if n_members < 2:
                continue
            m = db.match_merged(names, merged, first.name, graph.frontend)
            if m is None or not registry.variant_names(m.record.name):
                continue
            outs = sorted((n for n, c in ext.items() if c > 0),
                          key=order.__getitem__)
            site = CallSite(
                pattern=m.record.name, kind="block",
                in_avals=tuple(aval(n) for n in ins),
                out_avals=tuple(aval(n) for n in outs),
                out_used=(True,) * len(outs), params={}, backend=backend,
                nodes=tuple(n for span in spans[lo:hi + 1] for n in span),
                in_nodes=tuple(ins))
            ok = tuple(v for v in registry.variant_names(m.record.name)
                       if resolve_variant(site, v, registry=registry,
                                          backend=backend)[0] is not None)
            if ok:
                bound.append((lo, hi, m, ok))

    accepted: list[tuple[int, int]] = []
    blocks: list[Region] = []
    for lo, hi, m, ok in sorted(bound, key=lambda b: (b[0] - b[1], b[0])):
        if any(lo <= h and l <= hi for l, h in accepted):
            continue
        window = cands[lo:hi + 1]
        vec: dict = {}
        for r in window:
            for k, c in r.feature_vector.items():
                vec[k] = vec.get(k, 0) + c
        nodes = sorted((n for span in spans[lo:hi + 1] for n in span),
                       key=order.__getitem__)
        blocks.append(Region(
            name=f"fnblock_{len(blocks)}",
            kind="block",
            defs=frozenset(), uses=frozenset(),
            callees=tuple(dict.fromkeys(c for r in window
                                        for c in r.callees)),
            feature_vector=vec,
            offloadable=True,
            alternatives=("ref",) + ok,
            meta={"pattern": m.record.name,
                  "pattern_match": {"how": m.how,
                                    "score": round(m.score, 4)},
                  "nodes": tuple(n.name for n in nodes),
                  "module": "",
                  "block_members": tuple(r.name for r in window
                                         if r.offloadable)}))
        accepted.append((lo, hi))
    graph.regions.extend(blocks)
    return graph


def _check_devices(target: Any, example_args: tuple,
                   device: torch.device) -> None:
    tensors = [l for l in pytree.tree_leaves(example_args)
               if isinstance(l, torch.Tensor)]
    modules = [target] if isinstance(target, torch.nn.Module) \
        else target_modules(target).values()
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
    program and wall-clock timed.  Function-block genes
    (:func:`annotate_block_sites`) ride alongside unless
    ``options={"block_sites": False}``.  ``options={"static_cost": True}``
    keeps the deterministic transfer-cost stub instead (no execution; its
    results carry ``static_cost``).
    """

    name = "export"

    def build_graph(self, fn: Callable, inputs, config) -> RegionGraph:
        from repro_torch.core.pattern_db import default_db

        example_args = tuple(config.options.get("example_args", ()))
        # torch.export swaps a module's parameters for fake tensors while
        # it traces, so the device check, which reads them, takes the lock
        # that another thread's export of the same module holds
        with TRACE_LOCK:
            _check_devices(fn, example_args, resolve_device(config.device))
            graph = build_graph(fn, *example_args,
                                name=config.options.get("name", ""))
        db = config.db or default_db()
        graph = annotate_variants(graph, db,
                                  registry=config.options.get("registry"))
        # function-block genes (whole-window substitution) ride alongside
        # the loop/span genes unless explicitly disabled: the loop-only
        # comparison arm passes options={"block_sites": False}
        if config.options.get("block_sites", True):
            t0 = time.perf_counter()
            graph = annotate_block_sites(
                graph, db, registry=config.options.get("registry"))
            if config.log:
                n = sum(1 for r in graph.regions
                        if r.meta.get("block_members"))
                config.log(f"block sites: {n} fnblock region(s) in "
                           f"{time.perf_counter() - t0:.2f} s")
        return graph

    def make_fitness(self, graph: RegionGraph, fn: Callable, inputs, config):
        import threading

        from repro_torch.core.block_offload import block_offload_pass
        from repro_torch.core.device_program import GraphPool
        from repro_torch.core.fitness import WallClockFitness
        from repro_torch.core.frontends.registry import (
            FitnessBundle, decoded_pattern, static_cost_fitness_factory)
        from repro_torch.core.genes import (VARIANT_ALPHABET,
                                            probed_device_count,
                                            with_mesh_destinations)
        from repro_torch.core.pattern_db import (default_db,
                                                 record_pattern_outcome)
        from repro_torch.core.substitution import SubstitutionEngine

        block = block_offload_pass(graph, config.db or default_db(),
                                   confirm=config.confirm)
        if config.options.get("static_cost"):
            return FitnessBundle(
                fitness_factory=static_cost_fitness_factory(graph),
                block=block, claimed=block.claimed_regions,
                base_impl={r: "kernel" for r in block.claimed_regions},
                cache_extra=f"export={graph.source_name}|staticcost",
                measured=False)
        device = resolve_device(config.device)
        example_args = tuple(config.options.get("example_args", ()))
        engine = SubstitutionEngine(graph.meta["graph_module"], example_args,
                                    graph,
                                    registry=config.options.get("registry"))
        # the reference once, kept where it was computed and in its own
        # dtype: verify compares each tensor pair there, in float64
        reference_output = pytree.tree_map(
            lambda x: x.detach() if isinstance(x, torch.Tensor) else x,
            engine.reference())
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
            # variant).  Guarded: prepare may run on compile-pool threads.
            reports: dict = {}
            rlock = threading.Lock()
            # the search's captured programs share one memory pool: the GA
            # times them one by one, and a batch's prepared programs wait
            # for their timing side by side
            pool = GraphPool()

            def build(values):
                values = tuple(values)
                impl = decoded_pattern(coding, values, {})
                sub = engine.substitute(
                    impl, destinations=coding.destinations_of(values))
                with rlock:
                    reports[values] = sub.report
                # the runner the GA times is the captured program (the
                # reference's jax.jit(sub.fn)): its first call, in
                # prepare, captures it on the card
                sub.captured.pool = pool
                return lambda: sub(*example_args)

            class _RecordingFitness(WallClockFitness):
                """Classify each chromosome's verifier outcome and journal
                it per substituted (pattern, variant)."""

                def prepare(self, bits):
                    prep = super().prepare(tuple(bits))
                    with rlock:
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
            # the rank count joins the cache key: a mesh gene executed on
            # several ranks and the same bits cost-modeled on one are
            # different experiments
            cache_extra=(f"export={graph.source_name}|measured"
                         f"|args={args_sig}|device={device_name}"
                         f"|ndev={probed_device_count()}"),
            serial_only=True, measured=True, overlap_compiles=True,
            # the variant alphabet plus the meshes this host's ranks can
            # build (no extension on one rank)
            destinations=with_mesh_destinations(VARIANT_ALPHABET),
            # the engine executes an available mesh gene (its mesh
            # adapter), so such genes are measured, not modeled
            mesh_executed=True,
            impl_resolver=engine.resolved_impl,
            context={"engine": engine, "example_args": example_args})

    def apply_plan(self, graph: RegionGraph, coding, values, bundle):
        from repro_torch.core.frontends.registry import decoded_pattern

        values = tuple(values)
        impl = decoded_pattern(coding, values, bundle.base_impl)
        engine = bundle.context.get("engine")
        if engine is None:               # static-cost path: impl map only
            return impl
        return engine.substitute(impl,
                                 destinations=coding.destinations_of(values))
