"""Port of ``repro/core/substitution.py``: the substitution engine over
``torch.export`` graphs — plans become runnable programs.

Given the exported program's ``GraphModule``, its
:class:`~repro_torch.core.ir.RegionGraph` (whose regions carry their node
spans from :mod:`repro_torch.core.frontends.export_frontend`) and a
region -> implementation map decoded from a chromosome, the engine rewrites
a copy of the graph: each substituted span's nodes are replaced by one call
to the variant's bound adapter (fed the span's free inputs, first-use
order; placed at the first span node after every input — a span's glue
nodes may come earlier) and ``getitem`` nodes that take the place of the
span's outputs.
A scan region (``kind="loop"``, from a ``scan`` node) becomes a site of
kind ``"scan"``: its nodes are the ``scan`` node and its ``getitem`` nodes, its
inputs follow the scan's own operand order — ``(consts..., init...,
xs...)``, as the reference's ``(u, s0, r, k, v, log_w)`` — and its outputs
are the scan's (carries, then ys), each marked used when its ``getitem``
has a user.  A ``zeros`` initial carry stays in the graph as an input (the
site's ``params["zero_init"]`` says so); a ``flip`` or ``permute`` beside
the scan stays on the reference path.
A function-block region (``meta["block_members"]``, from the export
frontend's ``annotate_block_sites``) becomes a site of kind ``"block"``
over its whole node range, members and the statements between them:
:meth:`SubstitutionEngine.substitute` walks the sites widest-first, a block
that binds claims its members (their requests fall back to ``ref``,
``claimed by block <name>``), and a block whose variant does not bind
releases them.
Everything else runs the exported ATen ops unchanged.  The result,
:class:`SubstitutedCallable`, is captured as a CUDA graph on its first
call on the card and replayed after, as the reference's runs a cached
``jax.jit`` (:mod:`repro_torch.core.device_program`); on the CPU it runs
the graph module eagerly.

Variant binding happens *eagerly* against the graph's ``node.meta["val"]``
shapes and dtypes, so every fallback decision is recorded in the
:class:`SubstitutionReport` before anything runs — a variant whose
predicate rejects the site degrades to the reference nodes.

A site whose gene places it on a mesh destination (``mesh:data:4:batch``)
runs its own reference nodes on each rank's shards inside ``local_map``
over that many ranks (:meth:`SubstitutionEngine._mesh_adapter`, the
reference's ``shard_map`` span), its outputs gathered whole; on a host
with fewer ranks the gene is cost-only and the site takes its decoded
implementation.  PyTorch is multi-controller: on several ranks every rank
runs the same substitutions in the same order.
"""
from __future__ import annotations

import operator
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch
import torch.fx
from torch.utils import _pytree as pytree

from repro_torch.core import similarity as sim
from repro_torch.core.device_program import CapturedFunction
from repro_torch.core.ir import RegionGraph
from repro_torch.core.variants import (_REF_IMPLS, SubstitutionChoice,
                                       SubstitutionReport, resolve_variant)
from repro_torch.kernels.registry import (Aval, CallSite, KernelRegistry,
                                          default_registry)

__all__ = ["SiteBinding", "SubstitutionChoice", "SubstitutionReport",
           "SubstitutedCallable", "SubstitutionEngine", "span_io"]


class SubstitutedCallable:
    """A runnable substituted program: same signature as the exported
    source.  ``gm`` is the rewritten ``GraphModule`` (it shares the source's
    parameters); calling the object runs it under ``torch.no_grad``, on
    CUDA inputs as a graph captured on the first call for their signature
    (``captured``, a :class:`~repro_torch.core.device_program.
    CapturedFunction`) and replayed after.  ``report`` says which regions
    were substituted with which variant and why the rest fell back."""

    def __init__(self, gm: torch.fx.GraphModule, report: SubstitutionReport,
                 name: str = "substituted"):
        self.gm = gm
        self.report = report
        self.name = name
        self.captured = CapturedFunction(gm, name=name)

    def __call__(self, *args):
        with torch.no_grad():
            return self.captured(*args)

    def __repr__(self) -> str:
        return (f"SubstitutedCallable({self.name!r}, "
                f"substituted={self.report.substituted}, "
                f"fallbacks={list(self.report.fallbacks)})")


def is_subgraph(node) -> bool:
    """A ``get_attr`` of a subgraph (a ``scan``'s body): an operand of the
    node that reads it, never a value the span takes as input."""
    return node.op == "get_attr" and "val" not in node.meta


def span_io(nodes) -> tuple[tuple, tuple]:
    """Free inputs (first-use order) and live outputs (graph order) of a
    span of FX nodes: inputs are nodes the span reads but does not define
    (a ``scan``'s body excepted); outputs are span nodes read outside the
    span."""
    span = set(nodes)
    ins: list = []
    for n in nodes:
        for a in n.all_input_nodes:
            if a not in span and a not in ins and not is_subgraph(a):
                ins.append(a)
    outs = [n for n in nodes if any(u not in span for u in n.users)]
    return tuple(ins), tuple(outs)


@dataclass
class SiteBinding:
    """One substitutable region resolved to nodes of the engine's graph."""

    region: str
    pattern: Optional[str]
    nodes: tuple                       # the span, graph order (replaced)
    in_nodes: tuple                    # free inputs: first-use order for a
                                       # span, operand order for a scan
    out_nodes: tuple                   # outputs read after the span; for a
                                       # scan one getitem (or None) per output
    anchor: Any = None                 # where the adapter call goes: the
                                       # first span node after every input
    kind: str = "span"
    params: dict = field(default_factory=dict)   # scan: num_consts,
                                                 # num_carry, reverse, ...

    def out_avals(self) -> tuple:
        if self.kind == "scan":
            return tuple(Aval.of(v) for v in self.anchor.meta["val"])
        return tuple(Aval.of(n.meta["val"]) for n in self.out_nodes)

    def out_used(self) -> tuple:
        return tuple(n is not None and len(n.users) > 0
                     for n in self.out_nodes)

    def call_site(self, backend: str) -> CallSite:
        return CallSite(
            pattern=self.pattern or "",
            kind=self.kind,
            in_avals=tuple(Aval.of(n.meta["val"]) for n in self.in_nodes),
            out_avals=self.out_avals(),
            out_used=self.out_used(),
            params=dict(self.params),
            backend=backend,
            nodes=tuple(self.nodes),
            in_nodes=tuple(self.in_nodes))


#: ops whose output is all zeros: a scan's initial carry made by one of
#: these is known to be zero when the site binds
_ZEROS_OPS = (torch.ops.aten.zeros.default, torch.ops.aten.zeros_like.default,
              torch.ops.aten.new_zeros.default)


def _scan_binding(region, scan) -> SiteBinding:
    """The site of one ``scan`` node: operands in the scan's order
    (consts, init, xs), outputs one per scan result (carries, then ys)."""
    _, init, xs, consts = scan.args[:4]
    getitems = {u.args[1]: u for u in scan.users
                if u.target is operator.getitem}
    outs = tuple(getitems.get(i) for i in range(len(scan.meta["val"])))
    structure = region.meta["scan"]
    params = {"num_consts": structure["num_consts"],
              "num_carry": structure["num_carry"],
              "length": structure["length"],
              "reverse": structure["reverse"],
              "zero_init": all(getattr(n, "target", None) in _ZEROS_OPS
                               for n in init)}
    return SiteBinding(region.name, region.meta.get("pattern"),
                       (scan, *(o for o in outs if o is not None)),
                       (*consts, *init, *xs), outs, scan, "scan", params)


def _backend_of(example_args: tuple) -> str:
    devs = {l.device.type for l in pytree.tree_leaves(example_args)
            if isinstance(l, torch.Tensor)}
    return "cuda" if "cuda" in devs else "cpu"


class SubstitutionEngine:
    """Re-emit an exported program with matched regions routed to variants.

    ``gm`` is the exported program's ``GraphModule`` (``ep.module()``) the
    graph's ``meta["nodes"]`` spans name; ``graph.meta["graph_module"]``
    is used when ``gm`` is None.
    """

    def __init__(self, gm: Optional[torch.fx.GraphModule],
                 example_args: tuple, graph: RegionGraph,
                 registry: Optional[KernelRegistry] = None,
                 backend: Optional[str] = None):
        self.gm = gm if gm is not None else graph.meta["graph_module"]
        self.example_args = tuple(example_args)
        self.graph = graph
        self.registry = registry or default_registry()
        self.backend = backend or _backend_of(self.example_args)
        self._sites = self._resolve_sites()
        self._reference: Any = None
        self._resolved: dict = {}      # (region, requested) -> resolution
        self._mesh_resolved: dict = {}  # (region, mesh name) -> adapter, why

    # -- site resolution ----------------------------------------------------

    def _resolve_sites(self) -> list[SiteBinding]:
        by_name = {n.name: n for n in self.gm.graph.nodes}
        order = {n: i for i, n in enumerate(self.gm.graph.nodes)}
        sites: list[SiteBinding] = []
        for region in self.graph.offloadable():
            names = region.meta.get("nodes")
            if not names or any(nm not in by_name for nm in names):
                continue
            nodes = tuple(by_name[nm] for nm in names)
            if "scan" in region.meta:
                scan = next(n for n in nodes if sim.is_scan(n))
                sites.append(_scan_binding(region, scan))
                continue
            ins, outs = span_io(nodes)
            after = max((order[n] for n in ins), default=-1)
            anchor = next(n for n in nodes if order[n] > after)
            # fnblock regions (merged multi-region windows from the block
            # pass) bind block-level variants; plain spans stay spans
            kind = "block" if region.meta.get("block_members") else "span"
            sites.append(SiteBinding(region.name, region.meta.get("pattern"),
                                     nodes, ins, outs, anchor, kind))
        return sites

    @property
    def sites(self) -> tuple[SiteBinding, ...]:
        return tuple(self._sites)

    def _site(self, region: str) -> Optional[SiteBinding]:
        return next((s for s in self._sites if s.region == region), None)

    # -- variant resolution -------------------------------------------------

    def _resolve_variant(self, site: SiteBinding, requested: str
                         ) -> tuple[Optional[Callable], str, str]:
        """-> (adapter or None, chosen name, why); memoized per (region,
        requested) — the shapes never change for the engine's lifetime."""
        key = (site.region, requested)
        hit = self._resolved.get(key)
        if hit is None:
            hit = self._resolved[key] = resolve_variant(
                site.call_site(self.backend), requested,
                registry=self.registry, backend=self.backend)
        return hit

    # -- mesh destinations --------------------------------------------------

    def _mesh_adapter(self, site: SiteBinding, dest
                      ) -> tuple[Optional[Callable], str]:
        """-> (the site's span run on a mesh, or None; why).  Memoised: the
        decision depends only on (site, mesh destination) for the engine's
        lifetime (the shapes and the ranks are fixed)."""
        key = (site.region, dest.name)
        hit = self._mesh_resolved.get(key)
        if hit is None:
            hit = self._mesh_resolved[key] = self._mesh_adapter_uncached(
                site, dest)
        return hit

    def _mesh_adapter_uncached(self, site: SiteBinding, dest
                               ) -> tuple[Optional[Callable], str]:
        """The genuine mesh execution of a site: its own reference nodes
        interpreted on each rank's shards inside ``local_map`` over the
        destination's ``n``-rank mesh (``launch.mesh.
        make_destination_mesh``), the outputs gathered whole.

        The heuristic is the reference's, conservative and shape-checked:
        the destination's spec names a dimension (batch = leading, feature
        = trailing), every output must carry the same extent there (a
        reduction over the sharded dim cannot recombine by concatenation),
        inputs that carry it are sharded and the rest replicated.  What it
        cannot place, or what fails when the sharded span runs on meta
        shards (a node whose shape arguments are the whole extent's),
        falls back to the normal variant path with the reason reported; a
        placement that runs but computes wrong partials is caught by the
        search's verification."""
        from repro_torch.launch.mesh import make_destination_mesh
        from repro_torch.runtime.pspec import shard_map

        if site.kind != "span":
            return None, f"a {site.kind} site is not placed on a mesh"
        if any(n is None for n in site.out_nodes):
            return None, "site has dropped outputs"
        if not site.out_nodes:
            return None, "site has no outputs"
        out_vals = [n.meta["val"] for n in site.out_nodes]
        if not all(isinstance(v, torch.Tensor) for v in out_vals):
            return None, "site has a non-tensor output"
        out_shapes = [tuple(v.shape) for v in out_vals]
        dim = dest.shard_dim

        def dim_of(shape: tuple) -> Optional[int]:
            d = dim + len(shape) if dim < 0 else dim
            return d if 0 <= d < len(shape) else None

        d0 = dim_of(out_shapes[0])
        if d0 is None:
            return None, "output lacks the sharded dimension"
        extent = out_shapes[0][d0]
        if extent == 0 or extent % dest.n != 0:
            return None, (f"output dim {extent} not divisible by "
                          f"n={dest.n}")
        for shape in out_shapes:
            d = dim_of(shape)
            if d is None or shape[d] != extent:
                return None, "outputs disagree on the sharded dimension"

        def spec_for(shape: tuple) -> tuple:
            d = dim_of(shape)
            parts: list = [None] * len(shape)
            if d is not None and shape[d] == extent:
                parts[d] = dest.axis
            return tuple(parts)

        in_vals = [n.meta.get("val") for n in site.in_nodes]
        in_specs = tuple(spec_for(tuple(v.shape))
                         if isinstance(v, torch.Tensor) else None
                         for v in in_vals)
        out_specs = [spec_for(s) for s in out_shapes]
        if not any(s and any(p is not None for p in s) for s in in_specs):
            return None, "no input carries the sharded dimension"

        nodes, in_nodes = tuple(site.nodes), tuple(site.in_nodes)
        out_nodes = tuple(site.out_nodes)

        def span_fn(*ins):
            # the span's own nodes on this rank's shards
            env = dict(zip(in_nodes, ins))
            for node in nodes:
                args, kwargs = torch.fx.node.map_arg(
                    (node.args, node.kwargs), lambda a: env[a])
                env[node] = node.target(*args, **kwargs)
            return tuple(env[n] for n in out_nodes)

        dev = next(v.device for v in in_vals if isinstance(v, torch.Tensor))
        try:
            mesh = make_destination_mesh(dest.n, dest.axis, dev)
            sharded = shard_map(span_fn, mesh=mesh, in_specs=in_specs,
                                out_specs=out_specs)
            with torch.no_grad():
                got = sharded(*[torch.empty_strided(
                    v.shape, v.stride(), dtype=v.dtype, device="meta")
                    if isinstance(v, torch.Tensor) else v for v in in_vals])
        except Exception as e:  # noqa: BLE001 -- any build-time rejection
            return None, f"local_map build failed: {type(e).__name__}: {e}"
        for g, v in zip(got, out_vals):
            if tuple(g.shape) != tuple(v.shape) or g.dtype != v.dtype:
                return None, "sharded span changes output shape/dtype"

        def adapter(*ins):
            return tuple(o.full_tensor() for o in sharded(*ins))

        return adapter, (f"local_map over {dest.n}x{dest.axis} "
                         f"(spec {dest.spec})")

    # -- substitution -------------------------------------------------------

    def substitute(self, impl: dict,
                   destinations: Optional[dict] = None
                   ) -> SubstitutedCallable:
        """``impl``: region -> implementation id ("ref", a variant name, or
        the legacy "kernel" auto choice).  Returns the runnable program.

        ``destinations`` (region -> destination name, from
        :meth:`GeneCoding.destinations_of`) routes mesh-assigned sites
        through :meth:`_mesh_adapter`: when the host has the ranks the
        site's span genuinely runs on the mesh; otherwise, or when the
        heuristic rejects the shapes, the site takes the normal variant
        resolution with the reason reported.

        Sites are resolved widest-first: a block site that binds computes
        its whole node range, so a member site inside it is claimed and any
        variant requested on it falls back to ``ref`` (reported as such).
        The report lists the sites in graph order."""
        from repro_torch.core.genes import (get_destination,
                                            probed_device_count)

        choices: dict[str, SubstitutionChoice] = {}
        actions: list[tuple[SiteBinding, Callable]] = []
        accepted: list[tuple[frozenset, str]] = []
        for site in sorted(self._sites, key=lambda s: -len(s.nodes)):
            requested = str(impl.get(site.region, "ref"))
            span = frozenset(site.nodes)
            owner = next((r for nodes, r in accepted
                          if not span.isdisjoint(nodes)), None)
            if owner is not None:
                choices[site.region] = SubstitutionChoice(
                    site.region, site.pattern, requested, "ref",
                    f"claimed by block {owner}")
                continue
            dname = (destinations or {}).get(site.region)
            if dname and dname.startswith("mesh:"):
                mesh_dest = get_destination(dname)
                if mesh_dest.is_cost_only:
                    adapter, chosen, why = self._resolve_variant(site,
                                                                 requested)
                    why = (f"mesh {mesh_dest.name!r} unavailable "
                           f"({probed_device_count()} device(s) < "
                           f"{mesh_dest.n}): modeled cost charged; {why}")
                else:
                    adapter, mesh_why = self._mesh_adapter(site, mesh_dest)
                    if adapter is not None:
                        chosen, why = mesh_dest.name, mesh_why
                    else:
                        adapter, chosen, why = self._resolve_variant(
                            site, requested)
                        why = (f"mesh {mesh_dest.name!r} rejected "
                               f"({mesh_why}); {why}")
                requested = mesh_dest.name
            else:
                adapter, chosen, why = self._resolve_variant(site, requested)
            choices[site.region] = SubstitutionChoice(
                site.region, site.pattern, requested, chosen, why)
            if adapter is not None:
                actions.append((site, adapter))
                accepted.append((span, site.region))
        report = SubstitutionReport(
            [choices[s.region] for s in self._sites])

        g = torch.fx.Graph()
        val_map: dict = {}
        out = g.graph_copy(self.gm.graph, val_map)
        g.output(out)
        g._codegen = self.gm.graph._codegen    # same in/out pytree specs
        for site, adapter in actions:
            nodes = [val_map[n] for n in site.nodes]
            span = set(nodes)
            with g.inserting_before(val_map[site.anchor]):
                call = g.call_function(adapter,
                                       tuple(val_map[n] for n in site.in_nodes))
                outs = [g.call_function(operator.getitem, (call, i))
                        for i in range(len(site.out_nodes))]
            for old, new in zip(site.out_nodes, outs):
                if old is None:
                    continue
                # the output keeps its shape and dtype for the cost analyzer
                if "val" in old.meta:
                    new.meta["val"] = old.meta["val"]
                val_map[old].replace_all_uses_with(
                    new, delete_user_cb=lambda user: user not in span)
            for n in reversed(nodes):
                g.erase_node(n)
        gm = torch.fx.GraphModule(self.gm, g)
        return SubstitutedCallable(gm, report, self.graph.source_name)

    # -- convenience --------------------------------------------------------

    def resolved_impl(self, region: str, impl_id) -> str:
        """The implementation that would actually run at ``region`` under
        ``impl_id`` after the eager bind/fallback rule (``"ref"`` when the
        variant cannot bind or the region has no site) — the frontend's
        contribution to the phenotype key."""
        site = self._site(region)
        if site is None:
            return "ref"
        return self._resolve_variant(site, str(impl_id))[1]

    def reference(self) -> Any:
        """The unsubstituted program's outputs on the example arguments
        (computed once, then cached)."""
        if self._reference is None:
            with torch.no_grad():
                self._reference = self.gm(*self.example_args)
        return self._reference

    def verify(self, impl, rtol: float = 1e-2, atol: float = 1e-2):
        """Numeric equivalence of a substituted program vs the reference
        (:func:`repro_torch.core.verifier.verify`).  ``impl`` is a region ->
        impl map, or a :class:`SubstitutedCallable` built from one."""
        from repro_torch.core.verifier import verify as _verify

        sub = impl if isinstance(impl, SubstitutedCallable) \
            else self.substitute(impl)
        return _verify(self.reference(), sub(*self.example_args),
                       rtol=rtol, atol=atol)

    def verify_block(self, region: str, impl_id,
                     rtol: float = 1e-2, atol: float = 1e-2):
        """Span- or block-granularity verification: the bound adapter's
        outputs against the reference nodes' values over the site's span (a
        block site: its whole node range), on the example arguments.  Returns ``(VerifyResult, chosen_impl)``; a predicate
        rejection verifies trivially as the reference path."""
        from repro_torch.core.pattern_db import record_pattern_outcome
        from repro_torch.core.verifier import VerifyResult, verify as _verify

        site = self._site(region)
        if site is None:
            raise KeyError(f"no substitutable site for region {region!r}")
        adapter, chosen, why = self._resolve_variant(site, str(impl_id))
        if adapter is None:
            if chosen == "ref" and str(impl_id) not in _REF_IMPLS:
                record_pattern_outcome(None, site.pattern, str(impl_id),
                                       "bind_fail", region=region)
            return VerifyResult(True, 0.0, 0.0, why), chosen
        ins, ref_outs = self._site_values(site)
        with torch.no_grad():
            got = adapter(*ins)
        used = site.out_used()
        res = _verify([r for r, u in zip(ref_outs, used) if u],
                      [g for g, u in zip(got, used) if u],
                      rtol=rtol, atol=atol)
        record_pattern_outcome(None, site.pattern, chosen,
                               "ok" if res.ok else "verify_fail",
                               region=region)
        return res, chosen

    def _site_values(self, site: SiteBinding) -> tuple[list, list]:
        """Concrete values of a site's free inputs and outputs on the
        example arguments, from one interpretation of the reference graph."""
        wanted = set(site.in_nodes) | set(site.out_nodes) - {None}
        env: dict = {}

        class _Capture(torch.fx.Interpreter):
            def run_node(self, n):
                val = super().run_node(n)
                if n in wanted:
                    env[n] = val
                return val

        flat = pytree.tree_leaves(self.example_args)
        with torch.no_grad():
            _Capture(self.gm).run(*flat)
        return ([env[n] for n in site.in_nodes],
                [env.get(n) for n in site.out_nodes])
