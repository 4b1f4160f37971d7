"""Port of ``repro/runtime/fault_tolerance.py``: checkpoint/restart
supervision and straggler detection.

The failure model: a step raises (a host died, or an injected failure), a
step's loss is not finite, or a step runs slow (a straggler).  The
:class:`Supervisor` restores the latest committed checkpoint and replays
from there on the first two, and flags the third from a per-step
wall-time EWMA (``mean + k*std`` and a multiplicative floor); the caller's
hook decides what to do.  The loss is read once a step, with ``float``
(the step's one host synchronisation).  ``reshard`` (restoring onto a
different mesh) waits for the mesh (``ROADMAP.md`` queue 1 item 10).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["RunReport", "StragglerMonitor", "Supervisor"]


# ---------------------------------------------------------------------------
# straggler detection
# ---------------------------------------------------------------------------


@dataclass
class StragglerMonitor:
    """EWMA step-time tracker with z-score + ratio flagging."""

    alpha: float = 0.1
    z_threshold: float = 4.0
    ratio_threshold: float = 2.0
    warmup: int = 3
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    flagged: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self.n += 1
        if self.n <= self.warmup:
            # prime the EWMA; never flag during warmup (includes compile)
            self.mean = dt if self.n == 1 else (self.mean + dt) / 2
            return False
        is_straggler = False
        std = math.sqrt(max(self.var, 1e-12))
        if dt > self.mean * self.ratio_threshold and \
                dt > self.mean + self.z_threshold * std:
            is_straggler = True
            self.flagged.append((step, dt, self.mean))
        else:
            # only fold non-outlier samples into the estimate
            d = dt - self.mean
            self.mean += self.alpha * d
            self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        return is_straggler


# ---------------------------------------------------------------------------
# supervised training with checkpoint/restart
# ---------------------------------------------------------------------------


@dataclass
class RunReport:
    steps_done: int
    restarts: int
    stragglers: list
    losses: list
    #: wall seconds of each completed step (its batch, the step and the
    #: loss read)
    step_seconds: list = field(default_factory=list)


class Supervisor:
    """Runs a step function under failure supervision.

    ``step_fn(state, batch) -> (state, metrics)`` may raise (injected or
    real); the supervisor restores the latest committed checkpoint and
    replays from there.  Checkpoints every ``ckpt_every`` steps (async).
    """

    def __init__(self, ckpt: CheckpointManager, ckpt_every: int = 10,
                 max_restarts: int = 10,
                 on_straggler: Optional[Callable[[int, float], None]] = None):
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.monitor = StragglerMonitor()
        self.on_straggler = on_straggler

    def run(self, state: Any, batch_fn: Callable[[int], dict],
            step_fn: Callable, n_steps: int,
            start_step: int = 0,
            failure_injector: Optional[Callable[[int], bool]] = None
            ) -> tuple[Any, RunReport]:
        restarts = 0
        losses: list = []
        seconds: list = []
        step = start_step
        # initial checkpoint so step-0 failures can restart
        self.ckpt.save(step, state, blocking=True)
        while step < n_steps:
            try:
                if failure_injector is not None and failure_injector(step):
                    raise RuntimeError(f"injected node failure at step {step}")
                t0 = time.perf_counter()
                batch = batch_fn(step)
                state, metrics = step_fn(state, batch)
                loss = metrics.get("loss")
                if loss is not None:
                    loss = float(loss)
                    if not math.isfinite(loss):
                        raise FloatingPointError(f"non-finite loss at step {step}")
                    losses.append(loss)
                dt = time.perf_counter() - t0
                seconds.append(dt)
                if self.monitor.observe(step, dt) and self.on_straggler:
                    self.on_straggler(step, dt)
                step += 1
                if step % self.ckpt_every == 0:
                    self.ckpt.save(step, state)
            except Exception:  # noqa: BLE001 — any failure triggers restart
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                self.ckpt.wait()
                step, state = self.ckpt.restore(state)
        self.ckpt.wait()
        return state, RunReport(step - start_step, restarts,
                                list(self.monitor.flagged), losses, seconds)
