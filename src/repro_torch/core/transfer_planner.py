"""Port of ``repro/core/transfer_planner.py`` (framework-free copy).

CPU↔accelerator transfer planning (paper §3.2.1 / §4.2.2).

Def/use rule, verbatim from the paper:
  * a variable set on the CPU side and referenced on the accelerator side
    needs an H2D transfer;
  * a variable set on the accelerator side and referenced/set on the CPU
    side needs a D2H transfer.

Hoisting rule: a transfer inside a loop nest moves to the outermost level at
which the variable is still loop-invariant on the producing side (上位で
まとめて転送).  The planner is pure IR analysis — the ast-frontend executor
realizes the schedule with its versioned device cache, and the module
frontend maps the same decision onto FSDP all-gather placement
(``gather_mode``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.ir import Region, RegionGraph


@dataclass
class Transfer:
    var: str
    direction: str          # "h2d" | "d2h"
    at_region: str          # program point (region whose entry hosts it)
    hoisted_from: Optional[str] = None   # loop it was pulled out of
    per_iteration: bool = False
    #: mesh fan-out: the transfer splits across this many parallel device
    #: links (1 = a scalar device).  Byte-volume consumers divide by it —
    #: each link carries 1/shards of the variable.
    shards: int = 1


@dataclass
class TransferPlan:
    transfers: list[Transfer] = field(default_factory=list)

    @property
    def n_hoisted(self) -> int:
        return sum(1 for t in self.transfers if t.hoisted_from)

    @property
    def n_per_iteration(self) -> int:
        return sum(1 for t in self.transfers if t.per_iteration)

    def estimated_count(self, graph: RegionGraph) -> int:
        """Total dynamic transfer count, using static trip counts."""
        total = 0
        for t in self.transfers:
            if not t.per_iteration:
                total += 1
                continue
            trips = 1
            r = graph.by_name(t.at_region)
            while r.parent is not None:
                p = graph.by_name(r.parent)
                trips *= (p.trip_count or 1)
                r = p
            trips *= (graph.by_name(t.at_region).trip_count or 1) \
                if graph.by_name(t.at_region).kind == "loop" else 1
            total += trips
        return total


#: fallback implementation ids that place a region's COMPUTE on the
#: accelerator side *when the impl does not appear in the region's own
#: implementation menu* (``region.alternatives``): the ast frontend's jit
#: path, a library substitution, the export frontend's legacy auto-kernel
#: choice, the kernel registry's named variants, and the module frontend's
#: accelerated *compute* plan values (repro_torch.models.plan — impl knobs incl.
#: the fused-QKV boolean).  Device-ness is decided **per site** first: an
#: impl's position in ``region.alternatives`` (index 0 = the reference =
#: host, 1+ = accelerated) — generic names like "chunked"/"fused" are
#: shared across frontend namespaces, so a global name set cannot tell one
#: region's accelerated variant from another region's reference value.
#: Schedule knobs (remat, gather_mode; ``region.meta["schedule_knob"]``)
#: deliberately stay host-side: they move recomputation/gather placement,
#: not data onto a device, so charging them transfers would distort the
#: static cost.
DEVICE_IMPLS = frozenset({
    "jit", "lib", "kernel", "fused_torch", "cuda",
    "chunked", "assoc", "fused", "scatter_ep", "chunked_vocab",
})


def _alt_index(alternatives: tuple, impl_id) -> Optional[int]:
    """Position of ``impl_id`` in a region's implementation menu, matched
    by identity or same-type equality — so the integer 1 can never alias
    the boolean True of a flag-valued knob like qkv_fused."""
    for i, alt in enumerate(alternatives):
        if alt is impl_id:
            return i
        if type(alt) is type(impl_id) and alt == impl_id:
            return i
    return None


def plan_transfers(graph: RegionGraph, impl: dict[str, str],
                   hoist: bool = True,
                   destinations: Optional[dict[str, str]] = None
                   ) -> TransferPlan:
    """impl: region -> an implementation id.  A region computes on the
    accelerator when its id sits at position >= 1 of the region's own
    ``alternatives`` menu (position 0 is the reference path); ids outside
    the menu fall back to the global :data:`DEVICE_IMPLS` name set, or the
    boolean True (a flag-valued knob on its accelerated setting — matched
    by identity so an integer impl id 1 can never alias it).  Regions
    marked ``meta["schedule_knob"]`` never count as device placements.

    ``destinations`` (region -> destination name, from
    :meth:`GeneCoding.destinations_of`) refines the per-site decision with
    the Destination API: a region assigned to a mesh destination counts as
    a device placement regardless of its decoded impl (mesh genes decode to
    the reference implementation), and its transfers carry
    ``shards = mesh.n`` — each of the n links moves one shard."""

    def _mesh_shards(r: Region) -> int:
        """0 = not mesh-assigned; otherwise the mesh's device count."""
        name = (destinations or {}).get(r.name)
        if not name or not name.startswith("mesh:"):
            return 0
        from repro_torch.core.genes import get_destination
        return get_destination(name).device_count

    def on_device(r: Region) -> bool:
        if r.meta.get("schedule_knob"):
            return False
        if _mesh_shards(r):
            return True
        impl_id = impl.get(r.name)
        if impl_id is None:
            return False
        idx = _alt_index(r.alternatives, impl_id)
        if idx is not None:
            return idx >= 1
        return impl_id is True or impl_id in DEVICE_IMPLS

    plan = TransferPlan()
    device_vars: dict = {}        # var -> shard count of its resident copy
    host_dirty: set = set()       # vars (re)written by host since last upload

    def walk(regions: list[Region]):
        for r in regions:
            if r.parent is not None:
                continue  # children handled through their parents below
            _visit(r)

    def _visit(r: Region):
        children = graph.children(r.name)
        if on_device(r):
            shards = _mesh_shards(r) or 1
            for v in sorted(r.uses):
                if v in device_vars and v not in host_dirty:
                    continue  # already resident — hoisted/cached
                target = _hoist_point(r, v) if hoist else r.name
                plan.transfers.append(Transfer(
                    v, "h2d", target,
                    hoisted_from=r.parent if (hoist and target != r.name) else None,
                    per_iteration=not (hoist and target != r.name) and r.parent is not None,
                    shards=shards))
                device_vars[v] = shards
                host_dirty.discard(v)
            for v in r.defs:
                device_vars[v] = shards
                host_dirty.discard(v)
        else:
            # host region: device-resident vars it reads must come back
            for v in sorted(r.uses & device_vars.keys()):
                plan.transfers.append(Transfer(
                    v, "d2h", r.name,
                    per_iteration=r.parent is not None,
                    shards=device_vars.get(v, 1)))
            host_dirty.update(r.defs)
            for v in r.defs:
                device_vars.pop(v, None)
            for c in children:
                _visit(c)

    def _hoist_point(r: Region, var: str) -> str:
        """Climb ancestors while no sibling (host side) writes `var`."""
        at = r.name
        node = r
        while node.parent is not None:
            parent = graph.by_name(node.parent)
            siblings = [s for s in graph.children(parent.name) if s.name != node.name]
            written = any(var in s.defs and not on_device(s) for s in siblings)
            if var in parent.defs and parent.kind == "loop":
                # loop target or header writes it each iteration
                written = written or (var in parent.defs - node.defs)
            if written:
                break
            at = parent.name
            node = parent
        return at

    walk([r for r in graph.regions])
    return plan


# ---------------------------------------------------------------------------
# mesh cost model (deterministic priors for MeshDestination genes)
# ---------------------------------------------------------------------------

#: per-link host<->device bandwidth prior (PCIe-class, bytes/s) — each of a
#: mesh's n links moves its own shard, so h2d/d2h volume divides by n.
MESH_LINK_BYTES_PER_S = 12e9
#: intra-mesh collective bandwidth prior (NVLink/ICI-class, bytes/s).
MESH_COLLECTIVE_BYTES_PER_S = 50e9
#: fixed per-launch mesh dispatch cost, charged once per device per trip.
MESH_LAUNCH_OVERHEAD_S = 5e-5


def collective_factor(axis: str, n: int) -> float:
    """Modeled collective volume as a multiple of the region's output bytes.

    The ring bound: an all-gather (data axis, assembling sharded outputs)
    moves (n-1)/n of the tensor per device; a model-axis placement pays a
    reduce-scatter *and* an all-gather to recombine partials — twice that.
    """
    if n <= 1:
        return 0.0
    base = (n - 1) / n
    return base * (2.0 if axis == "model" else 1.0)


def modeled_mesh_cost_s(h2d_bytes: float, d2h_bytes: float, trips: int,
                        axis: str, n: int) -> float:
    """Deterministic modeled seconds for running a region on an n-mesh.

    Per-shard transfers (volume / n over the per-link bandwidth) + the
    axis's collective term over output bytes + a per-device launch
    overhead, all scaled by the static trip estimate.  This is the mesh
    analogue of the fpga_stub launch/per-trip model: what
    :func:`repro_torch.core.genes.modeled_cost_s` charges when a mesh gene is
    not genuinely executed on this host."""
    if n <= 0:
        return 0.0
    per_trip = ((h2d_bytes + d2h_bytes) / max(n, 1) / MESH_LINK_BYTES_PER_S
                + collective_factor(axis, n) * d2h_bytes
                / MESH_COLLECTIVE_BYTES_PER_S)
    return trips * per_trip + n * MESH_LAUNCH_OVERHEAD_S
