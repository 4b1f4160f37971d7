"""Port of ``repro/core/fitness.py``: :class:`WallClockFitness` only (the
cost-model fitness waits for the roofline port).

Execute and time (min over repeats after a warm-up run), verify results
against the reference path (PCAST analogue) -> invalid = time ∞.  The
warm-up run in :meth:`WallClockFitness.prepare` also absorbs the kernels'
first-use build (``repro_torch.kernels.build``), so a build is never timed.
Where the runner's outputs live on a CUDA device, each timed run ends in
``torch.cuda.synchronize()`` — the counterpart of ``block_until_ready``.

A plain ``bits -> Evaluation`` callable; caching, dedup and persistence
belong to :mod:`repro_torch.core.evaluator`.  Timings only mean something
when measured one at a time.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.ga import Evaluation
from repro_torch.core.verifier import verify


def _cuda_devices(out: Any) -> set:
    return {l.device for l in pytree.tree_leaves(out)
            if isinstance(l, torch.Tensor) and l.device.type == "cuda"}


def _synchronize(devices: set) -> None:
    for dev in devices:
        torch.cuda.synchronize(dev)


@dataclass
class PreparedRun:
    """Output of :meth:`WallClockFitness.prepare`: a built, verified
    runner awaiting its (strictly serial) timing loop — or the failure
    Evaluation that takes its place."""

    bits: tuple
    runner: Optional[Callable[[], Any]] = None
    failure: Optional[Evaluation] = None   # build/run/verify outcome
    devices: frozenset = frozenset()       # CUDA devices the outputs live on


@dataclass
class WallClockFitness:
    """bits -> build(bits) -> callable; timed and verified vs reference.

    Two-phase: :meth:`prepare` builds the artifact, runs the warm-up (which
    builds any kernel on first use) and verifies against the reference;
    :meth:`measure` runs the timing loop.  ``__call__`` chains them.
    """

    build: Callable[[tuple], Callable[[], Any]]   # returns a nullary runner
    reference_output: Any = None
    repeats: int = 3
    rtol: float = 1e-2
    atol: float = 1e-2
    verify_outputs: bool = True

    def prepare(self, bits: tuple) -> PreparedRun:
        bits = tuple(bits)
        try:
            runner = self.build(bits)
            out = runner()                        # warm-up (kernel build)
            devices = _cuda_devices(out)
            _synchronize(devices)
        except Exception as e:  # noqa: BLE001 — paper: errors leave the GA
            return PreparedRun(bits, failure=Evaluation(
                bits, float("inf"), False,
                {"error": f"{type(e).__name__}: {e}"[:300]}))
        if self.verify_outputs and self.reference_output is not None:
            v = verify(self.reference_output, out, self.rtol, self.atol)
            if not v.ok:
                return PreparedRun(bits, failure=Evaluation(
                    bits, float("inf"), False,
                    {"verify": f"max_abs={v.max_abs:.3g} "
                               f"max_rel={v.max_rel:.3g} {v.detail}"}))
        return PreparedRun(bits, runner=runner, devices=frozenset(devices))

    def measure(self, prepared: PreparedRun) -> Evaluation:
        if prepared.failure is not None:
            return prepared.failure
        best = float("inf")
        for _ in range(self.repeats):
            _synchronize(prepared.devices)
            t0 = time.perf_counter()
            prepared.runner()
            _synchronize(prepared.devices)
            best = min(best, time.perf_counter() - t0)
        return Evaluation(prepared.bits, best, True, {})

    def __call__(self, bits: tuple) -> Evaluation:
        return self.measure(self.prepare(bits))
