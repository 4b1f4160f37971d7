"""Port of ``repro/core/variants.py``: the frontend-neutral resolve / check
/ fallback rule and the uniform substitution report.

  * :func:`resolve_variant` — a requested implementation id (a reference
    alias, a concrete variant name, or the legacy ``"kernel"``/``"auto"``
    preference order) is bound against a
    :class:`~repro_torch.kernels.registry.CallSite` through the registry's
    availability predicates, with an output check (:func:`check_adapter`);
    any rejection degrades to the reference path with the reason kept.
  * :class:`SubstitutionChoice` / :class:`SubstitutionReport` — the record
    of what ran where.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from repro_torch.kernels.registry import (CallSite, KernelRegistry,
                                          VariantUnavailable,
                                          auto_variant_order,
                                          default_registry)
from repro_torch.obs import metrics as obs_metrics

__all__ = ["SubstitutionChoice", "SubstitutionReport", "check_adapter",
           "resolve_variant", "generic_plan_report"]


#: implementation ids that mean "the reference path" in any frontend.
_REF_IMPLS = frozenset({"ref", "interp", "host", "cpu"})
#: implementation ids that mean "pick the backend-preferred variant".
_AUTO_IMPLS = frozenset({"kernel", "offload", "auto"})


@dataclass(frozen=True)
class SubstitutionChoice:
    """What happened at one substitutable region."""

    region: str
    pattern: Optional[str]
    requested: str                    # the impl the plan asked for
    chosen: str                       # "ref" or the bound implementation id
    why: str = ""                     # fallback / resolution reason


@dataclass
class SubstitutionReport:
    choices: list[SubstitutionChoice] = field(default_factory=list)

    @property
    def substituted(self) -> dict[str, str]:
        """region -> implementation for every region not on the ref path."""
        return {c.region: c.chosen for c in self.choices if c.chosen != "ref"}

    @property
    def fallbacks(self) -> dict[str, str]:
        """region -> reason for every request the plan had to refuse."""
        return {c.region: c.why for c in self.choices
                if c.chosen == "ref" and c.requested not in _REF_IMPLS}

    def summary(self) -> dict:
        return {"substituted": self.substituted, "fallbacks": self.fallbacks}


def check_adapter(adapter: Callable, site: CallSite) -> None:
    """Require site-exact outputs for every used output (None stands for an
    output the variant skips).  Adapters that launch kernels declare their
    outputs (``adapter.out_avals``); the others are run on meta tensors —
    the counterpart of the reference's ``jax.eval_shape``."""
    outs = getattr(adapter, "out_avals", None)
    if outs is None:
        specs = [torch.empty(a.shape, dtype=a.dtype, device="meta")
                 for a in site.in_avals]
        try:
            outs = adapter(*specs)
        except Exception as e:  # noqa: BLE001 — adapter bug == unavailable
            raise VariantUnavailable(f"adapter failed abstract eval: "
                                     f"{type(e).__name__}: {e}") from None
    outs = tuple(outs) if isinstance(outs, (tuple, list)) else (outs,)
    if len(outs) != len(site.out_avals):
        raise VariantUnavailable(
            f"adapter returned {len(outs)} outputs, site has "
            f"{len(site.out_avals)}")
    for i, (got, want, used) in enumerate(
            zip(outs, site.out_avals, site.out_used)):
        if got is None:
            if used:
                raise VariantUnavailable(
                    f"output {i} is used but the variant skips it")
            continue
        if tuple(got.shape) != tuple(want.shape) or got.dtype != want.dtype:
            raise VariantUnavailable(
                f"output {i} mismatch: {tuple(got.shape)}/{got.dtype} vs "
                f"{tuple(want.shape)}/{want.dtype}")


def resolve_variant(site: CallSite, requested: str,
                    registry: Optional[KernelRegistry] = None,
                    backend: Optional[str] = None,
                    check: bool = True
                    ) -> tuple[Optional[Callable], str, str]:
    """Resolve one site's requested implementation.

    Returns ``(adapter or None, chosen name, why)``: the bound adapter and
    its variant name on success, ``(None, "ref", reason)`` for a reference
    request, an unknown id, an unmatched site, or a predicate/output-check
    rejection.
    """
    registry = registry or default_registry()
    backend = backend or site.backend

    def _count(outcome: str, variant: str) -> None:
        obs_metrics.counter("variants.resolutions",
                            pattern=site.pattern or "-",
                            variant=variant, outcome=outcome).inc()

    if requested in _REF_IMPLS:
        return None, "ref", "requested"
    if not site.pattern:
        _count("no_pattern", str(requested))
        return None, "ref", "no pattern matched this region"
    names = registry.variant_names(site.pattern)
    if requested in names:
        candidates = (requested,)
    elif requested in _AUTO_IMPLS:
        candidates = tuple(n for n in auto_variant_order(backend)
                           if n in names) or names
    else:
        _count("unknown", str(requested))
        return None, "ref", f"unknown implementation {requested!r}"
    why = ""
    for name in candidates:
        try:
            adapter = registry.get(site.pattern, name).bind(site)
            if check:
                check_adapter(adapter, site)
            _count("bound", name)
            return adapter, name, ""
        except VariantUnavailable as e:
            why = f"{name}: {e}"
    _count("fallback", str(requested))
    return None, "ref", why


def generic_plan_report(coding, values, base_impl: Optional[dict] = None,
                        patterns: Optional[dict] = None) -> SubstitutionReport:
    """Uniform :class:`SubstitutionReport` straight from the gene decode,
    for plans with no binding step (one choice per gene site plus one per
    block-pass claim)."""
    from repro_torch.core.genes import get_destination

    patterns = patterns or {}
    report = SubstitutionReport()
    for s, v in zip(coding.sites, tuple(values)):
        dest = get_destination(coding.destinations[int(v)])
        impls = s.impls
        impl = impls[min(dest.impl_index, len(impls) - 1)]
        requested, why = str(impl), ""
        if dest.impl_index >= len(impls):
            why = (f"impl_index {dest.impl_index} clamped to {impl!r} "
                   f"({len(impls)} impls)")
        is_ref = impl == s.ref_impl or str(impl) in _REF_IMPLS
        if dest.placement_tag is not None:
            requested = dest.name
            why = (f"cost-only destination {dest.name!r} runs the reference "
                   f"path" if dest.is_cost_only else
                   f"mesh destination {dest.name!r} (sharded execution is "
                   f"the frontend's to realize)")
        elif is_ref:
            requested, why = "ref", why or "requested"
        report.choices.append(SubstitutionChoice(
            s.region, patterns.get(s.region), requested,
            "ref" if is_ref else str(impl), why))
    for region, impl in sorted((base_impl or {}).items()):
        impl = str(impl)
        report.choices.append(SubstitutionChoice(
            region, patterns.get(region), impl,
            "ref" if impl in _REF_IMPLS else impl, "block-pass claim"))
    return report
