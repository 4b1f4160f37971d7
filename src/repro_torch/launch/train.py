"""Port of ``repro/launch/train.py``: the training launcher; ``--arch <id>``
selects any architecture whose batch is tokens and labels.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_0_6b \\
      --steps 50 [--no-reduced] [--ckpt-dir DIR] [--resume] \\
      [--microbatch N] [--device cpu]

The reference's pipeline on the port's pieces: the pattern-DB block
offload over the module frontend's graph picks the ExecPlan knobs, then
the supervised loop (checkpoint/restart and the straggler monitor) trains
on synthetic data.  The step is ``runtime.train.jit_step`` of the
reference's builder, its state donated: on the card the first step runs
eagerly and captures the step as a CUDA graph, and each later step is one
replay, after which the supervisor reads the loss (the step's one host
synchronisation).  A restore hands it new moment tensors, which the next
step copies into the graph's buffers.  It runs on ``cuda`` unless
``--device cpu`` is asked for (it raises without a card) and on the
reduced same-family config unless ``--no-reduced`` is given.
Checkpoints go under ``build/launch_train`` of the checkout unless
``--ckpt-dir`` says otherwise.  ``_run(args)`` returns a
:class:`TrainRun` for drivers that read the run (``chip_smoke.py``, the
tests).
"""
from __future__ import annotations

import argparse
import statistics
import time
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.block_offload import block_offload_pass
from repro_torch.core.frontends import module_frontend
from repro_torch.core.frontends.export_frontend import resolve_device
from repro_torch.core.pattern_db import default_db
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.models import build_model
from repro_torch.models.plan import ExecPlan
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.log import get_logger, setup as setup_logging
from repro_torch.optim import OptimizerConfig, make_schedule
from repro_torch.runtime.fault_tolerance import RunReport, Supervisor
from repro_torch.runtime.train import (TrainState, init_train_state,
                                       jit_step, make_train_step)

__all__ = ["TrainRun", "launcher_plan", "main", "parse_args"]

log = get_logger("launch.train")

DEFAULT_CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "launch_train"


class TrainRun(NamedTuple):
    state: TrainState
    report: RunReport
    plan: ExecPlan
    plan_updates: dict
    start_step: int
    restore_s: Optional[float]     # seconds of the --resume restore
    ckpt: CheckpointManager
    step_fn: Callable
    batch_fn: Callable


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_0_6b", choices=list(ARCH_IDS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--no-reduced", action="store_true",
                    help="use the FULL config")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--trace", default="",
                    help="write an obs trace journal to this path")
    return ap.parse_args(argv)


def launcher_plan(cfg, microbatch: int = 1) -> tuple[ExecPlan, dict]:
    """The paper's pipeline: the pattern-DB block offload over the module
    frontend's graph decides the implementations.  Returns (the f32 plan
    with 128-key attention chunks and ``microbatch`` splits, the knobs the
    block offload set)."""
    updates = block_offload_pass(module_frontend.build_graph(cfg),
                                 default_db()).plan_updates
    plan = ExecPlan(compute_dtype="float32", attn_kv_chunk=128,
                    microbatch=microbatch).replace(**updates)
    return plan, updates


def main(argv: Optional[list] = None) -> None:
    setup_logging()
    args = parse_args(argv)
    with obs_trace.maybe_tracing(args.trace or None):
        _run(args)


def _run(args: argparse.Namespace) -> TrainRun:
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.no_reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    n_params = sum(p.numel() for p in model.param_shapes().parameters())
    log.info("arch=%s (%s) params=%.2fM device=%s", args.arch,
             "full" if args.no_reduced else "reduced", n_params / 1e6, dev)

    plan, plan_updates = launcher_plan(cfg, args.microbatch)
    log.info("offload plan: %s", plan_updates)

    data = SyntheticLMDataset(DataConfig(
        seq_len=args.seq_len, global_batch=args.global_batch,
        vocab=cfg.vocab, seed=0))
    # jax.jit(make_train_step(...), donate_argnums=(0,)): captured on the
    # card at its first call, each later step one replay
    step_fn = jit_step(make_train_step(
        model, plan, OptimizerConfig(lr=args.lr),
        make_schedule("cosine", peak_lr=args.lr, warmup_steps=10,
                      total_steps=args.steps)), "launcher_train_step")

    mgr = CheckpointManager(args.ckpt_dir, keep=3)
    state = init_train_state(model, torch.Generator().manual_seed(0),
                             device=dev)
    start, restore_s = 0, None
    if args.resume and mgr.latest_step() is not None:
        t0 = time.perf_counter()
        start, state = mgr.restore(state)
        restore_s = time.perf_counter() - t0
        log.info("resumed from step %d in %.1f s", start, restore_s)

    sup = Supervisor(mgr, ckpt_every=args.ckpt_every,
                     on_straggler=lambda s, dt: log.warning(
                         "straggler step %d: %.0f ms", s, dt * 1e3))

    def batch_fn(s: int) -> dict:
        return {k: torch.from_numpy(v).to(dev)
                for k, v in data.batch(s).items()}

    state, report = sup.run(state, batch_fn, step_fn, n_steps=args.steps,
                            start_step=start)
    losses = report.losses
    for i in range(9, len(losses), 10):
        log.info("step %4d  loss=%.4f", start + i + 1, losses[i])
    if losses:
        log.info("done: %d steps, %d restarts; loss %.4f -> %.4f",
                 report.steps_done, report.restarts, losses[0],
                 statistics.fmean(losses[-5:]))
    return TrainRun(state, report, plan, plan_updates, start, restore_s, mgr,
                    step_fn, batch_fn)


if __name__ == "__main__":
    main()
