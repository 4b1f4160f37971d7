"""End-to-end training script (the PyTorch port's twin of
``examples/train_e2e.py``; imports only ``repro_torch``): data pipeline ->
offload-planned model -> AdamW -> checkpoint/restart supervision ->
straggler monitoring.

Default runs a ~20M-param llama-family model for 120 steps; ``--full``
trains the ~100M config for 300 steps (same code path).  It runs on
``cuda`` unless ``--device cpu`` is asked for; checkpoints go under
``build/train_e2e`` of the checkout unless ``--ckpt-dir`` says otherwise.

  PYTHONPATH=src python examples/train_e2e_torch.py [--full] [--resume] [--steps N] [--device cpu]
"""
import argparse
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.block_offload import block_offload_pass
from repro_torch.core.frontends import module_frontend
from repro_torch.core.pattern_db import default_db
from repro_torch.data import Batcher, DataConfig, SyntheticLMDataset
from repro_torch.models import build_model
from repro_torch.models.plan import ExecPlan
from repro_torch.optim import OptimizerConfig, make_schedule
from repro_torch.runtime.fault_tolerance import Supervisor
from repro_torch.runtime.train import init_train_state, make_train_step

CKPT_DIR = Path(__file__).resolve().parents[1] / "build" / "train_e2e"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="~100M params, 300 steps")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--inject-failure", type=int, default=-1,
                    help="simulate a node failure at this step")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args()
    dev = args.device

    base = get_config("tinyllama_1_1b")
    if args.full:  # ~100M params
        cfg = dataclasses.replace(base, n_layers=10, d_model=768, n_heads=12,
                                  n_kv_heads=4, head_dim=64, d_ff=2048,
                                  vocab=32_000)
        seq, gbs, steps = 256, 8, args.steps or 300
    else:          # ~20M params
        cfg = dataclasses.replace(base, n_layers=6, d_model=384, n_heads=6,
                                  n_kv_heads=2, head_dim=64, d_ff=1024,
                                  vocab=8_000)
        seq, gbs, steps = 128, 8, args.steps or 120

    model = build_model(cfg)
    n_params = sum(p.numel() for p in model.param_shapes().parameters())
    print(f"model: {cfg.n_layers}L d={cfg.d_model} vocab={cfg.vocab} "
          f"params={n_params/1e6:.1f}M")

    # offload plan from the pattern DB (block pass) — the paper's pipeline
    graph = module_frontend.build_graph(cfg)
    block = block_offload_pass(graph, default_db())
    plan = ExecPlan(compute_dtype="float32", attn_kv_chunk=128,
                    remat="none").replace(**block.plan_updates)
    print("offload plan:", {k: v for k, v in block.plan_updates.items()})

    data = SyntheticLMDataset(DataConfig(seq_len=seq, global_batch=gbs,
                                         vocab=cfg.vocab, seed=0))
    opt_cfg = OptimizerConfig(lr=1e-3, weight_decay=0.01)
    sched = make_schedule("cosine", peak_lr=1e-3, warmup_steps=20,
                          total_steps=steps)
    step_fn = make_train_step(model, plan, opt_cfg, sched)

    mgr = CheckpointManager(args.ckpt_dir, keep=3)
    state = init_train_state(model, torch.Generator().manual_seed(0),
                             device=dev)
    start = 0
    if args.resume and mgr.latest_step() is not None:
        start, state = mgr.restore(state)
        print(f"resumed from step {start}")

    def on_straggler(s, dt):
        print(f"  [straggler] step {s}: {dt*1e3:.0f}ms")

    sup = Supervisor(mgr, ckpt_every=25, on_straggler=on_straggler)
    batchers = [Batcher(data, start_step=start)]

    def batch_fn(s):
        bstep, batch = next(batchers[0])
        if bstep != s:  # restart rewound the step counter: re-seek prefetch
            batchers[0].close()
            batchers[0] = Batcher(data, start_step=s)
            bstep, batch = next(batchers[0])
        assert bstep == s, (bstep, s)
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    injector = None
    if args.inject_failure >= 0:
        hit = set()

        def injector(s):
            if s == args.inject_failure and s not in hit:
                hit.add(s)
                print(f"  [injected failure at step {s} — restoring]")
                return True
            return False

    t0 = time.time()
    losses = []

    def wrapped_step(state, batch):
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if len(losses) % 10 == 0:
            rate = len(losses) / (time.time() - t0)
            print(f"step {start + len(losses):4d}  loss={losses[-1]:.4f}  "
                  f"({rate:.2f} steps/s)")
        return state, metrics

    state, report = sup.run(state, batch_fn, wrapped_step, n_steps=steps,
                            start_step=start, failure_injector=injector)
    batchers[0].close()
    print(f"\ndone: {report.steps_done} steps, {report.restarts} restarts, "
          f"{len(report.stragglers)} stragglers flagged")
    print(f"loss: {losses[0]:.4f} -> {np.mean(losses[-10:]):.4f}")
    assert np.mean(losses[-10:]) < losses[0]


if __name__ == "__main__":
    main()
