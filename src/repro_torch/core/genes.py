"""Port of ``repro/core/genes.py``.  Slot 2 of the variant alphabet is
``gpu_kernel`` (the hand-written CUDA kernel) in place of ``gpu_pallas``;
``impl_index`` 0/1/2 keep their meaning, so chromosomes map 1:1 between
the packages.

Gene encoding of offload patterns (paper §3.2.1), generalized to a
multi-destination alphabet (arXiv:2011.12431 direction).

The paper's chromosome is a binary string, one gene per offloadable region:
``1`` = run the region on the accelerator, ``0`` = keep the reference path.
This module keeps that encoding as the default while letting a gene range
over a *destination alphabet* — an ordered tuple of :class:`Destination`
names such as ``("cpu", "gpu", "fpga_stub")``.  Gene value ``k`` assigns the
region to alphabet entry ``k``; value 0 is always the reference (CPU) path
and value 1 the primary accelerator, so binary chromosomes keep their exact
historical meaning.

Destinations are pluggable via :func:`register_destination`.  A destination
may be *cost-only* (``is_cost_only``): regions assigned to it execute
their reference implementation for correctness, and a deterministic modeled
cost (:func:`modeled_cost_s`) is charged on top of the measurement — so the
enlarged search space is real (the GA weighs it) before the hardware exists.
The encoding stays language/frontend-independent; frontends only contribute
the ordered site list.

Destination API v2 is a small frozen hierarchy: :class:`Device` is a single
physical device; :class:`MeshDestination` places a region on an ``n``-device
mesh along a named axis with a sharding spec (arXiv 2011.12431's mixed
offloading destinations, extended to placement × parallelism).  The wire
format IS the destination name (``mesh:data:4:batch``), so alphabets,
SeedBank records, phenotype keys, and PlanStore payloads — all of which
carry name strings — round-trip mesh specs with no schema change.  On hosts
with fewer than ``n`` ranks a mesh destination degrades to cost-only:
reference execution plus a modeled per-shard-transfer + collective cost
(:func:`repro_torch.core.transfer_planner.modeled_mesh_cost_s`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

from repro_torch.core.ir import Region, RegionGraph

# ---------------------------------------------------------------------------
# destination alphabet
# ---------------------------------------------------------------------------

#: modeled watt prior for destinations that declare no ``active_power_w``
#: (a conventional host CPU package) — the energy model's fallback.
DEFAULT_ACTIVE_POWER_W = 65.0
#: modeled per-device watt prior for mesh destinations (GPU-class devices).
MESH_DEVICE_POWER_W = 250.0

_PROBED_DEVICE_COUNT: Optional[int] = None


def probed_device_count() -> int:
    """How many ranks a mesh destination can span here: the world size of
    an initialised default process group, else the CUDA devices this
    process sees (cached, at least 1; a CPU-only host counts as one).

    Mesh destinations compare their ``n`` against this to decide between
    genuine execution (``local_map`` over ``n`` ranks, the substitution
    engine's mesh adapter) and cost-only modeling."""
    global _PROBED_DEVICE_COUNT
    import torch
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return max(1, dist.get_world_size())
    if _PROBED_DEVICE_COUNT is None:
        _PROBED_DEVICE_COUNT = max(1, int(torch.cuda.device_count()))
    return _PROBED_DEVICE_COUNT


@dataclass(frozen=True)
class Destination:
    """One place a region can run (Destination API v2 base).

    ``executable`` destinations map to a real implementation of the site
    (``impl_index`` selects it: 0 = reference, 1 = offloaded alternative).
    Cost-only destinations (``is_cost_only``) execute the reference
    implementation and charge a modeled time instead — a stand-in device
    whose cost model keeps the search space honest before hardware exists.

    The v2 surface every consumer goes through:

    * ``wire()`` / ``from_wire()`` — the one serialization (the name string)
      used by gene alphabets, SeedBank cross-alphabet mapping, phenotype
      keys, and PlanStore payloads.
    * ``watts()`` — modeled draw while executing (per-device prior ×
      ``device_count``), the energy objective's input.
    * ``is_cost_only`` — whether assignment charges a model instead of
      running offloaded code *on this host* (environment-dependent for
      meshes, static for stub devices).
    * ``placement_tag`` — non-None when the assignment changes the
      phenotype beyond the decoded impl map (stub parking, mesh placement),
      so the measurement cache never conflates such chromosomes.
    """

    name: str
    executable: bool = True
    impl_index: int = 0
    # cost model for cost-only destinations (seconds):
    launch_overhead_s: float = 0.0     # fixed per-region dispatch/transfer cost
    per_trip_s: float = 0.0            # modeled cost per (static) loop trip
    # energy model (repro_torch.core.objectives): watts this destination draws
    # while it executes a region's trips — the modeled prior behind the
    # ``energy`` objective on hosts with no power counters.  The shipped
    # values are deliberately *different* per destination so mixed-
    # destination Pareto fronts exist on CPU-only CI.
    active_power_w: float = 0.0

    # -- v2 API ------------------------------------------------------------
    @property
    def device_count(self) -> int:
        return 1

    @property
    def is_cost_only(self) -> bool:
        return not self.executable

    @property
    def placement_tag(self) -> Optional[str]:
        return self.name if self.is_cost_only else None

    def watts(self) -> float:
        per_device = (self.active_power_w if self.active_power_w > 0
                      else DEFAULT_ACTIVE_POWER_W)
        return per_device * self.device_count

    def wire(self) -> str:
        """Stable wire string: the name is the serialization."""
        return self.name

    @classmethod
    def from_wire(cls, wire: str) -> "Destination":
        return get_destination(wire)


@dataclass(frozen=True)
class Device(Destination):
    """A single physical (or stand-in) device — the scalar v1 alphabet."""


@dataclass(frozen=True)
class MeshDestination(Destination):
    """Place a region on an ``n``-device mesh along one named axis.

    ``axis`` is the mesh axis kind — ``"data"`` shards the batch (leading)
    dimension, ``"model"`` the feature (trailing) dimension.  ``spec``
    names the sharded dimension (``"batch"``, ``"feature"``, or ``"dimK"``
    for an explicit index) and defaults from the axis.  The canonical name
    doubles as the wire format: ``mesh:{axis}:{n}:{spec}``.

    Decoding keeps ``impl_index`` 0 (the reference implementation): the
    substitution engine replaces the site's span with a run of that same
    span on each rank's shards (``local_map``) when the host has >= ``n``
    ranks; otherwise the
    destination is cost-only and :func:`modeled_cost_s` charges per-shard
    transfers plus a modeled collective term."""

    name: str = ""
    axis: str = "data"
    n: int = 2
    spec: str = ""

    def __post_init__(self) -> None:
        if self.axis not in ("data", "model"):
            raise ValueError(f"mesh axis must be 'data' or 'model', "
                             f"got {self.axis!r}")
        if self.n < 1:
            raise ValueError(f"mesh size must be >= 1, got {self.n}")
        spec = self.spec or ("batch" if self.axis == "data" else "feature")
        if spec not in ("batch", "feature") and not (
                spec.startswith("dim") and spec[3:].isdigit()):
            raise ValueError(f"mesh spec must be 'batch', 'feature' or "
                             f"'dimN', got {spec!r}")
        object.__setattr__(self, "spec", spec)
        object.__setattr__(self, "name", f"mesh:{self.axis}:{self.n}:{spec}")
        if self.active_power_w <= 0:
            object.__setattr__(self, "active_power_w", MESH_DEVICE_POWER_W)

    @property
    def device_count(self) -> int:
        return self.n

    @property
    def shard_dim(self) -> int:
        """Which dimension the spec shards: 0 (batch), -1 (feature), or K."""
        if self.spec == "batch":
            return 0
        if self.spec == "feature":
            return -1
        return int(self.spec[3:])

    def available(self) -> bool:
        """Whether this host can genuinely build the mesh."""
        return probed_device_count() >= self.n

    @property
    def is_cost_only(self) -> bool:
        return not self.available()

    @property
    def placement_tag(self) -> Optional[str]:
        # mesh placement always changes the phenotype (sharded execution or
        # modeled charge), even when the decoded impl map is the reference
        return self.name

    @classmethod
    def from_wire(cls, wire: str) -> "MeshDestination":
        parts = wire.split(":")
        if len(parts) not in (3, 4) or parts[0] != "mesh":
            raise ValueError(f"not a mesh wire string: {wire!r} "
                             f"(want 'mesh:<axis>:<n>[:<spec>]')")
        try:
            n = int(parts[2])
        except ValueError:
            raise ValueError(f"mesh size not an int in {wire!r}") from None
        return cls(axis=parts[1], n=n, spec=parts[3] if len(parts) == 4 else "")


CPU = Device("cpu", executable=True, impl_index=0,
             active_power_w=65.0)
GPU = Device("gpu", executable=True, impl_index=1,
             active_power_w=250.0)
#: FPGA stub: no backend yet — reference execution plus a modeled cost of a
#: PCIe-attached reconfigurable card (fixed DMA/launch latency, cheap trips,
#: low board power: the paper's power-saving destination).
FPGA_STUB = Device("fpga_stub", executable=False, impl_index=0,
                   launch_overhead_s=2e-4, per_trip_s=5e-8,
                   active_power_w=30.0)
#: variant destinations: same accelerator, different *implementation* of the
#: site (the kernel-substitution alphabet — a gene picks which code runs).
GPU_FUSED = Device("gpu_fused", executable=True, impl_index=1,
                   active_power_w=250.0)
GPU_KERNEL = Device("gpu_kernel", executable=True, impl_index=2,
                    active_power_w=220.0)

_DESTINATIONS: dict[str, Destination] = {
    d.name: d for d in (CPU, GPU, FPGA_STUB, GPU_FUSED, GPU_KERNEL)
}

#: the paper's original binary CPU/GPU alphabet — the default everywhere.
DEFAULT_ALPHABET: tuple[str, ...] = ("cpu", "gpu")
#: the extended mixed-destination alphabet from the ROADMAP.
EXTENDED_ALPHABET: tuple[str, ...] = ("cpu", "gpu", "fpga_stub")
#: the implementation-variant alphabet the measured export frontend
#: proposes: gene k selects site implementation k — reference, the
#: fused-torch rewrite, or the hand-written CUDA kernel (see
#: repro_torch.kernels.registry).
VARIANT_ALPHABET: tuple[str, ...] = ("cpu", "gpu_fused", "gpu_kernel")


def register_destination(dest: Destination, replace: bool = False) -> None:
    """Add a destination to the alphabet registry (pluggable devices)."""
    if dest.name in _DESTINATIONS and not replace:
        raise ValueError(f"destination {dest.name!r} already registered")
    _DESTINATIONS[dest.name] = dest


def get_destination(name: str) -> Destination:
    dest = _DESTINATIONS.get(name)
    if dest is not None:
        return dest
    if name.startswith("mesh:"):
        # mesh wire strings are an open alphabet: parse and cache on demand
        # (under the canonical name AND the alias spelled without a spec)
        try:
            dest = MeshDestination.from_wire(name)
        except ValueError as e:
            raise KeyError(f"bad mesh destination {name!r}: {e}") from None
        _DESTINATIONS.setdefault(dest.name, dest)
        _DESTINATIONS.setdefault(name, dest)
        return dest
    raise KeyError(f"unknown destination {name!r}; registered: "
                   f"{sorted(_DESTINATIONS)}")


def destination_names() -> tuple[str, ...]:
    return tuple(sorted(_DESTINATIONS))


#: mesh sizes the frontends propose when the host has the ranks for them.
MESH_PROPOSAL_SIZES: tuple[int, ...] = (2, 4, 8)


def mesh_proposals(axes: Sequence[str] = ("data",),
                   sizes: Sequence[int] = MESH_PROPOSAL_SIZES,
                   device_count: Optional[int] = None) -> tuple[str, ...]:
    """Mesh destination names this host can genuinely execute (n <= ranks).

    Returns () on single-device hosts so alphabets, fingerprints and
    committed baselines stay byte-stable; explicit mesh names in
    ``OffloadConfig.destinations`` still work anywhere (executed when the
    host has the ranks, cost-modeled otherwise)."""
    ndev = probed_device_count() if device_count is None else device_count
    return tuple(MeshDestination(axis=axis, n=n).name
                 for axis in axes for n in sizes if 2 <= n <= ndev)


def with_mesh_destinations(base: Sequence[str],
                           axes: Sequence[str] = ("data",),
                           sizes: Sequence[int] = MESH_PROPOSAL_SIZES,
                           device_count: Optional[int] = None
                           ) -> tuple[str, ...]:
    """``base`` alphabet extended with this host's executable mesh genes."""
    base = tuple(base)
    return base + tuple(m for m in mesh_proposals(axes, sizes, device_count)
                        if m not in base)


# ---------------------------------------------------------------------------
# gene coding
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Site:
    """One gene position: a region plus its implementation menu.

    The first two implementations keep the paper's off/on pair; regions
    with more than one accelerated alternative (kernel-substitution
    variants) extend the menu via ``extra_impls``, indexed by
    ``Destination.impl_index`` (2 = the first extra, and so on).

    ``members`` marks a *function-block* site (arXiv 2004.09883): the named
    regions are the block's constituents.  While the block gene sits on an
    accelerated implementation it **claims** them — their own genes are
    inert and they decode to their reference path (the block adapter
    computes the whole span), so the loop-level search space shrinks to the
    unclaimed remainder.
    """

    region: str
    ref_impl: Any
    offload_impl: Any
    extra_impls: tuple = ()
    members: tuple = ()

    @property
    def impls(self) -> tuple:
        """Implementation by index — what ``Destination.impl_index`` selects."""
        return (self.ref_impl, self.offload_impl) + tuple(self.extra_impls)


@dataclass(frozen=True)
class GeneCoding:
    sites: tuple[Site, ...]
    destinations: tuple[str, ...] = DEFAULT_ALPHABET

    @property
    def length(self) -> int:
        return len(self.sites)

    @property
    def arity(self) -> int:
        """Alphabet size: how many values each gene ranges over."""
        return len(self.destinations)

    def decode(self, values: Sequence[int]) -> dict[str, Any]:
        """values -> {region name: chosen implementation}.

        A cost-only destination decodes to the site implementation its
        ``impl_index`` names (the reference path for the shipped stubs), so
        executors run correct code; the modeled cost is charged separately
        (:func:`modeled_cost_s`).
        """
        assert len(values) == self.length, (len(values), self.length)
        out: dict[str, Any] = {}
        for s, v in zip(self.sites, values):
            dest = get_destination(self.destinations[int(v)])
            impls = s.impls
            out[s.region] = impls[min(dest.impl_index, len(impls) - 1)]
        claimed = self.claimed_members(values)
        if claimed:
            for s in self.sites:
                if s.region in claimed:
                    out[s.region] = s.ref_impl
        return out

    def claimed_members(self, values: Sequence[int]) -> frozenset:
        """Regions claimed by active block genes: every member of a block
        site whose gene decodes to a non-reference implementation.  Claimed
        regions' own genes are inert for this chromosome."""
        claimed: set[str] = set()
        for s, v in zip(self.sites, values):
            if not s.members:
                continue
            dest = get_destination(self.destinations[int(v)])
            impls = s.impls
            if impls[min(dest.impl_index, len(impls) - 1)] != s.ref_impl:
                claimed.update(s.members)
        return frozenset(claimed)

    def destinations_of(self, values: Sequence[int]) -> dict[str, str]:
        """values -> {region name: destination name}."""
        assert len(values) == self.length, (len(values), self.length)
        return {s.region: self.destinations[int(v)]
                for s, v in zip(self.sites, values)}

    def all_off(self) -> tuple[int, ...]:
        return (0,) * self.length

    def all_on(self) -> tuple[int, ...]:
        return (1,) * self.length


def coding_from_graph(graph: RegionGraph,
                      exclude: Sequence[str] = (),
                      destinations: Sequence[str] = DEFAULT_ALPHABET
                      ) -> GeneCoding:
    """Build the gene coding from a region graph's offloadable regions,
    excluding regions already claimed by the function-block pass (paper
    §4.2: ループ文オフロードはオフロード可能だった機能ブロック部分を抜いた
    コードに対して試行)."""
    for d in destinations:
        get_destination(d)           # fail fast on unknown alphabet entries
    sites = []
    for r in graph.offloadable():
        if r.name in exclude:
            continue
        ref = r.alternatives[0] if r.alternatives else "ref"
        off = r.alternatives[1] if len(r.alternatives) > 1 else "offload"
        sites.append(Site(r.name, ref, off, tuple(r.alternatives[2:]),
                          members=tuple(r.meta.get("block_members", ()))))
    return GeneCoding(tuple(sites), tuple(destinations))


# ---------------------------------------------------------------------------
# cost model for cost-only destinations
# ---------------------------------------------------------------------------


def _trip_product(graph: RegionGraph, region: Region) -> int:
    """Static dynamic-trip estimate: own trip count times enclosing loops'."""
    trips = region.trip_count or 1 if region.kind == "loop" else 1
    r = region
    while r.parent is not None:
        r = graph.by_name(r.parent)
        if r.kind == "loop":
            trips *= r.trip_count or 1
    return trips


def site_modeled_cost_s(graph: RegionGraph, region: Region,
                        dest: Destination) -> float:
    """Deterministic modeled seconds for parking one region on ``dest``.

    Stub devices charge their launch + per-trip model; mesh destinations
    charge per-shard transfers plus a modeled collective for the axis
    (:func:`repro_torch.core.transfer_planner.modeled_mesh_cost_s`), with the
    region's def/use sets standing in for byte volumes (1.0 each — the
    same unit-bytes convention the transfer objective uses)."""
    trips = _trip_product(graph, region)
    if isinstance(dest, MeshDestination):
        from repro_torch.core import transfer_planner as tp
        return tp.modeled_mesh_cost_s(
            h2d_bytes=float(len(region.uses)),
            d2h_bytes=float(len(region.defs)),
            trips=trips, axis=dest.axis, n=dest.n)
    return dest.launch_overhead_s + trips * dest.per_trip_s


def modeled_cost_s(graph: RegionGraph, coding: GeneCoding,
                   values: Sequence[int],
                   mesh_executed: bool = False) -> float:
    """Deterministic modeled time for genes on cost-only destinations.

    Charged on top of the measured time of the chromosome (whose cost-only
    regions executed their reference path), so patterns that park work on a
    stub device pay that device's modeled latency in the fitness.

    Mesh genes charge the mesh cost model unless ``mesh_executed`` — the
    flag a frontend sets when its measured path genuinely executes mesh
    destinations (the export engine's mesh adapter, ``local_map`` over the
    destination's ranks), in which case the measurement already contains
    the real cost.
    An unavailable mesh (``is_cost_only``) charges the model regardless.
    """
    total = 0.0
    claimed = coding.claimed_members(values)
    for site, v in zip(coding.sites, values):
        if site.region in claimed:
            continue                 # the block adapter computes this region
        dest = get_destination(coding.destinations[int(v)])
        if isinstance(dest, MeshDestination):
            if mesh_executed and not dest.is_cost_only:
                continue             # really ran sharded: measured, not modeled
        elif not dest.is_cost_only:
            continue
        total += site_modeled_cost_s(graph, graph.by_name(site.region), dest)
    return total
