"""Port of ``repro/core/objectives.py`` (framework-free copy; the NVML
probe also reads NVML's own ``libnvidia-ml.so.1`` through ``ctypes``
where ``pynvml`` is absent).

Objective models for multi-objective offload search (arXiv:2110.11520 +
arXiv:2011.12431 direction): latency × energy × transfer bytes.

The paper's follow-on work evaluates *power saving* and *mixed offload
destinations* as the production goal, so the GA needs more than a wall-clock
scalar.  This module defines the objective vector the NSGA selection in
:func:`repro_torch.core.ga.run_ga` ranks by:

* ``latency``  — the measured (or cost-modeled) seconds, unchanged: the
  :class:`~repro_torch.core.ga.Evaluation`'s ``time_s``.
* ``energy``   — joules.  When the fitness measured real board power (an
  ``energy_j`` detail field, e.g. from NVML — :func:`nvml_power_w` probes
  for it) that number wins; otherwise a deterministic *modeled* estimate:
  the chromosome's execution seconds split across destinations by static
  trip share, each share charged that destination's
  ``Destination.active_power_w`` prior, plus the cost-only stub's modeled
  seconds at the stub's watts.  The priors differ per destination (GPU hot,
  FPGA stub cool, CPU in between), so mixed-destination Pareto fronts exist
  on CPU-only CI where every measurement runs on the same silicon.
* ``transfer`` — static transfer volume in bytes from the transfer planner
  (per-variable bytes × dynamic trip products), the paper's
  CPU↔accelerator round-trip penalty as its own axis.

Energy and transfer are pure functions of ``(bits, time_s)``, so journal
rows that predate this module (no per-objective detail fields) degrade
gracefully: the objective function recomputes the modeled values on the fly
and only the latency axis relies on what was persisted.
"""
from __future__ import annotations

import ctypes
import math
from typing import Callable, Optional, Sequence

from repro_torch.core.ga import Evaluation
from repro_torch.core.genes import (GeneCoding, MeshDestination, _trip_product,
                                    get_destination, site_modeled_cost_s)
from repro_torch.core.ir import RegionGraph
from repro_torch.core.transfer_planner import collective_factor, plan_transfers

__all__ = ["OBJECTIVES", "annotate_objectives", "make_objective_fn",
           "modeled_energy_j", "nvml_power_w", "objective_values",
           "static_transfer_bytes"]

#: the canonical objective order: index 0 is always latency (the GA's
#: patience/history axis and the single-objective fallback).
OBJECTIVES: tuple[str, ...] = ("latency", "energy", "transfer")

_nvml_watts: Optional[float] = None
_nvml_probed = False


def _load_nvml():
    """NVML's C library, or None on a host without it."""
    try:
        return ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return None


def _nvml_ctypes_watts(lib) -> Optional[float]:
    """Board power of device 0 in watts read through ``lib`` (NVML's C
    API: ``nvmlInit_v2``, ``nvmlDeviceGetHandleByIndex_v2``,
    ``nvmlDeviceGetPowerUsage`` in milliwatts), or None when a call fails
    (each returns 0 on success)."""
    lib.nvmlInit_v2.argtypes = []
    lib.nvmlInit_v2.restype = ctypes.c_int
    lib.nvmlDeviceGetHandleByIndex_v2.argtypes = [
        ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)]
    lib.nvmlDeviceGetHandleByIndex_v2.restype = ctypes.c_int
    lib.nvmlDeviceGetPowerUsage.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)]
    lib.nvmlDeviceGetPowerUsage.restype = ctypes.c_int
    lib.nvmlShutdown.argtypes = []
    lib.nvmlShutdown.restype = ctypes.c_int
    if lib.nvmlInit_v2() != 0:
        return None
    try:
        handle, milliwatts = ctypes.c_void_p(), ctypes.c_uint()
        if lib.nvmlDeviceGetHandleByIndex_v2(0, ctypes.pointer(handle)) \
                or lib.nvmlDeviceGetPowerUsage(handle,
                                               ctypes.pointer(milliwatts)):
            return None
        return milliwatts.value / 1000.0
    finally:
        lib.nvmlShutdown()


def nvml_power_w() -> Optional[float]:
    """Current GPU board power draw in watts via NVML, or None when no NVML
    stack (or no GPU) is available.  Probed once a process: through
    ``pynvml`` where it is installed, else through NVML's
    ``libnvidia-ml.so.1`` by ``ctypes``; a CPU-only host has neither, so
    the modeled per-destination priors are the portable default."""
    global _nvml_watts, _nvml_probed
    if _nvml_probed:
        return _nvml_watts
    _nvml_probed = True
    try:
        import pynvml
    except ImportError:
        lib = _load_nvml()
        _nvml_watts = None if lib is None else _nvml_ctypes_watts(lib)
        return _nvml_watts
    try:  # pragma: no cover — exercised only on hosts with pynvml
        pynvml.nvmlInit()
        handle = pynvml.nvmlDeviceGetHandleByIndex(0)
        _nvml_watts = pynvml.nvmlDeviceGetPowerUsage(handle) / 1000.0
    except Exception:  # noqa: BLE001 — any missing piece means "no NVML"
        _nvml_watts = None
    return _nvml_watts


def destination_power_w(name: str) -> float:
    """Active watts prior for one destination: ``Destination.watts()`` — the
    per-device prior times the device count, so an n-mesh draws n boards'
    worth.  NVML (when present) overrides the per-device prior for
    accelerator destinations — measured board power beats a table — while
    the reference path and cost-only stubs keep their modeled priors (NVML
    says nothing about them)."""
    dest = get_destination(name)
    prior = dest.watts()
    if not dest.is_cost_only and dest.impl_index > 0:
        measured = nvml_power_w()
        if measured is not None and measured > 0:
            return measured * dest.device_count
    return prior


def modeled_energy_j(graph: RegionGraph, coding: GeneCoding,
                     bits: Sequence[int], time_s: float) -> float:
    """Deterministic joules for one chromosome given its (charged) seconds.

    The stub's modeled seconds (already folded into ``time_s`` by the
    destination-cost fitness wrapper) are billed at the stub's watts; the
    remaining execution seconds are split across destinations by static
    trip share — each site's trip product weights its destination's
    ``active_power_w``, reference/claimed work weights the CPU — so a
    chromosome that parks heavy trips on a hot device pays for it even
    though CPU-only CI measured every pattern on the same silicon.
    """
    if not math.isfinite(time_s) or time_s < 0:
        return float("inf")
    bits = tuple(int(v) for v in bits)
    claimed = coding.claimed_members(bits)
    stub_s_total = 0.0
    stub_j = 0.0
    # trip-share watt mix of the executable seconds; weight 1.0 of host
    # work exists in every chromosome (dispatch, glue, unsited regions)
    watt_weight = destination_power_w(coding.destinations[0]) * 1.0
    weight = 1.0
    for site, v in zip(coding.sites, bits):
        dest = get_destination(coding.destinations[int(v)])
        region = graph.by_name(site.region)
        trips = float(_trip_product(graph, region))
        if site.region in claimed:
            continue                      # the block adapter's work is
                                          # counted by the block gene's site
        if dest.is_cost_only:
            # stub devices and unavailable meshes: the modeled seconds
            # (already folded into time_s by the destination-cost fitness
            # wrapper) bill at the destination's full draw — per-device
            # watts × device count for meshes (energy = watts × n)
            site_s = site_modeled_cost_s(graph, region, dest)
            stub_s_total += site_s
            stub_j += site_s * dest.watts()
            continue
        weight += trips
        watt_weight += trips * destination_power_w(dest.name)
    exec_s = max(time_s - stub_s_total, 0.0)
    return exec_s * (watt_weight / weight) + stub_j


def static_transfer_bytes(graph: RegionGraph, coding: GeneCoding,
                          bits: Sequence[int],
                          var_bytes: Optional[dict] = None,
                          base_impl: Optional[dict] = None) -> float:
    """Transfer volume of one chromosome: planner transfers weighted by
    per-variable bytes and dynamic trip products (per-iteration transfers
    pay every trip — the round-trip penalty).  Same accounting as the
    surrogate's ``bytes`` feature, exposed as an objective.

    Mesh placements change the accounting in two directions: each host<->
    device transfer splits across the mesh's n links (``Transfer.shards``
    divides its volume — the per-link bytes are what the PCIe round-trip
    penalty prices), while the axis's collective adds
    ``collective_factor(axis, n)`` times the region's output bytes per
    trip.  Sharding a transfer-heavy region can therefore *win* this axis
    over a single device — the trade-off the Pareto front exposes."""
    bits = tuple(int(v) for v in bits)
    impl = dict(base_impl or {})
    impl.update(coding.decode(bits))
    dests = coding.destinations_of(bits)
    plan = plan_transfers(graph, impl, hoist=True, destinations=dests)
    vb = var_bytes or {}
    total = 0.0
    for t in plan.transfers:
        trips = 1
        if t.per_iteration:
            trips = _trip_product(graph, graph.by_name(t.at_region))
        total += trips * float(vb.get(t.var, 1.0)) / max(t.shards, 1)
    claimed = coding.claimed_members(bits)
    for site in coding.sites:
        dest = get_destination(dests[site.region])
        if not isinstance(dest, MeshDestination) or site.region in claimed:
            continue
        region = graph.by_name(site.region)
        out_bytes = sum(float(vb.get(v, 1.0)) for v in region.defs)
        total += (_trip_product(graph, region)
                  * collective_factor(dest.axis, dest.n) * out_bytes)
    return total


def objective_values(ev: Evaluation, graph: RegionGraph, coding: GeneCoding,
                     objectives: Sequence[str] = OBJECTIVES,
                     var_bytes: Optional[dict] = None,
                     base_impl: Optional[dict] = None) -> tuple[float, ...]:
    """One evaluation's objective vector, smaller-is-better on every axis.

    Detail fields win when the measurement recorded them (``energy_j`` from
    a power-instrumented fitness, ``transfer_bytes`` stamped at annotation
    time); anything missing is recomputed from the models above, so legacy
    journal rows degrade to latency-plus-modeled instead of being dropped.
    Invalid/non-finite evaluations map to all-``inf`` (dominated by every
    real point, mutually non-dominating)."""
    if not ev.valid or not math.isfinite(ev.time_s):
        return tuple(float("inf") for _ in objectives)
    out = []
    for name in objectives:
        if name == "latency":
            v = ev.time_s
        elif name == "energy":
            v = ev.detail.get("energy_j")
            if not isinstance(v, (int, float)) or not math.isfinite(v):
                v = modeled_energy_j(graph, coding, ev.bits, ev.time_s)
        elif name == "transfer":
            v = ev.detail.get("transfer_bytes")
            if not isinstance(v, (int, float)) or not math.isfinite(v):
                v = static_transfer_bytes(graph, coding, ev.bits,
                                          var_bytes=var_bytes,
                                          base_impl=base_impl)
        else:
            raise ValueError(f"unknown objective {name!r}; "
                             f"known: {OBJECTIVES}")
        out.append(float(v) if math.isfinite(float(v)) else float("inf"))
    return tuple(out)


def make_objective_fn(graph: RegionGraph, coding: GeneCoding,
                      objectives: Sequence[str] = OBJECTIVES,
                      var_bytes: Optional[dict] = None,
                      base_impl: Optional[dict] = None
                      ) -> Callable[[Evaluation], tuple[float, ...]]:
    """Bind :func:`objective_values` for the GA's NSGA selection (and for
    :meth:`OffloadResult.front_summary`).  The static per-bits terms
    (transfer plan, trip products) are memoized per chromosome."""
    objectives = tuple(objectives)
    memo: dict[tuple[tuple, float, bool], tuple[float, ...]] = {}

    def fn(ev: Evaluation) -> tuple[float, ...]:
        key = (tuple(int(v) for v in ev.bits), float(ev.time_s), ev.valid)
        hit = memo.get(key)
        if hit is None:
            hit = objective_values(ev, graph, coding, objectives,
                                   var_bytes=var_bytes, base_impl=base_impl)
            memo[key] = hit
        return hit

    return fn


def annotate_objectives(graph: RegionGraph, coding: GeneCoding,
                        var_bytes: Optional[dict] = None,
                        base_impl: Optional[dict] = None
                        ) -> Callable[[Evaluation], Evaluation]:
    """An :class:`~repro_torch.core.evaluator.Evaluator` ``annotate`` hook that
    stamps ``energy_j`` / ``transfer_bytes`` into every new measurement's
    detail dict.  The measurement journal persists scalar detail fields, so
    rows written under this hook carry per-objective ground truth the
    per-objective surrogate fits train on; fields already present (a
    power-measuring fitness) are never overwritten."""

    def ann(ev: Evaluation) -> Evaluation:
        if not ev.valid or not math.isfinite(ev.time_s):
            return ev
        det = dict(ev.detail)
        if "energy_j" not in det:
            det["energy_j"] = modeled_energy_j(graph, coding, ev.bits,
                                               ev.time_s)
        if "transfer_bytes" not in det:
            det["transfer_bytes"] = static_transfer_bytes(
                graph, coding, ev.bits, var_bytes=var_bytes,
                base_impl=base_impl)
        return Evaluation(ev.bits, ev.time_s, ev.valid, det)

    return ann
