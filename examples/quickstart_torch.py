"""Quickstart (the PyTorch port's twin of ``examples/quickstart.py``;
imports only ``repro_torch``): build a model, let the unified offload
pipeline pick implementations, train a few steps, serve a few tokens.

The planner is one call for every frontend (``Offloader.plan``): here the
*module* frontend plans an ArchConfig -- the function-block pass matches
pattern-DB records, the GA searches the remaining offload sites, and the
returned artifact is the ExecPlan to train with.  The *export* frontend
goes further: its plan is **measured** -- every chromosome becomes a
substituted program (kernel-registry variants spliced into the exported
graph), verified against the reference and wall-clock timed, and the
artifact is that runnable substituted callable.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu] [--population 2 --generations 1]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.ga import GAConfig
from repro_torch.core.offload import OffloadConfig, Offloader
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.models import REFERENCE_PLAN, build_model
from repro_torch.optim import OptimizerConfig, make_schedule
from repro_torch.runtime.serve import ServeConfig, Server
from repro_torch.runtime.train import (init_train_state, jit_step,
                                       make_train_step)

PY_SRC = """
def rms_app(x, scale, n, d):
    out = np.zeros((n, d))
    for i in range(n):
        ss = 0.0
        for t in range(d):
            ss = ss + x[i][t] * x[i][t]
        inv = 1.0 / np.sqrt(ss / d + 1e-06)
        for t in range(d):
            out[i][t] = x[i][t] * inv * (1.0 + scale[t])
    return out
"""


def tiny_app(q, k, v, w):
    """An attention-shaped block, then four steps of h = tanh(h @ w)."""
    s = q @ k.T / (q.shape[-1] ** 0.5)
    mask = torch.ones(q.shape[0], k.shape[0], dtype=torch.bool,
                      device=q.device).tril()
    h = torch.softmax(torch.where(mask, s, -1e30), dim=-1) @ v
    for _ in range(4):
        h = torch.tanh(h @ w)
    return h


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--population", type=int, default=None,
                    help="every GA's population (default: each step's own)")
    ap.add_argument("--generations", type=int, default=None,
                    help="every GA's generations (default: each step's own)")
    args = ap.parse_args()
    dev = args.device

    def ga(population, generations):
        return GAConfig(population=args.population or population,
                        generations=args.generations or generations, seed=0)

    # 1. a reduced qwen3 (any of the 10 assigned archs works: --arch style)
    cfg = get_config("qwen3_0_6b").reduced()
    model = build_model(cfg)
    n_params = sum(p.numel() for p in model.param_shapes().parameters())
    print(f"arch={cfg.arch_id} params={n_params / 1e6:.2f}M device={dev}")

    # 2. unified offload planning: frontend detected from the target
    #    (ArchConfig -> module frontend; no lower_fn -> fast static-cost
    #    fitness.  Pass options={"lower_fn": ...} for the traced-artifact
    #    fitness of launch.dryrun.lower_cell.)
    res = Offloader(OffloadConfig(device=dev, ga=ga(8, 4))).plan(cfg)
    plan = res.artifact.replace(compute_dtype="float32")
    print(f"planned via {res.frontend}: blocks="
          f"{[b.pattern for b in res.block.offloads]} "
          f"best={''.join(map(str, res.best.bits))} "
          f"destinations={res.destinations}")

    # 2b. measured export plan: an nn-free callable with an attention-shaped
    #     block, exported with its example arguments -- the plan's fitness
    #     is real wall-clock over substituted programs, and the artifact is
    #     the runnable winner
    rng = np.random.default_rng(0)

    def arr(*shape, scale=1.0):
        return torch.as_tensor(rng.normal(size=shape) * scale,
                               dtype=torch.float32, device=dev)

    q, k, v, w = arr(64, 32), arr(64, 32), arr(64, 32), arr(32, 32, scale=0.1)
    eres = Offloader(OffloadConfig(
        device=dev, ga=ga(6, 3), repeats=2,
        options={"example_args": (q, k, v, w)})).plan(tiny_app)
    print(f"export plan: destinations={eres.destinations} "
          f"speedup={eres.speedup:.2f}x "
          f"verified={eres.verification['verified']} "
          f"substituted={eres.artifact.report.substituted}")
    _ = eres.artifact(q, k, v, w)            # the deliverable runs as-is

    # 2c. measured python_ast plan: the SAME variant alphabet on plain
    #     numeric Python -- the matched loop nest keeps its gene, and the GA
    #     picks between the CPython interpreter and the kernel-registry
    #     variants by measured wall clock
    py_inputs = dict(x=rng.standard_normal((64, 32)),
                     scale=rng.standard_normal(32) * 0.1)
    pres = Offloader(OffloadConfig(
        device=dev, ga=ga(6, 2), repeats=1,
        options={"consts": {"n": 64, "d": 32}})).plan(PY_SRC, py_inputs)
    print(f"python_ast plan: destinations={pres.destinations} "
          f"speedup={pres.speedup:.2f}x "
          f"verified={pres.verification['verified']} "
          f"substituted={pres.report.substituted}")
    _ = pres.artifact.run(**py_inputs)       # runs under the chosen variant

    # 3. train a few steps under the planned ExecPlan
    data = SyntheticLMDataset(DataConfig(seq_len=64, global_batch=4,
                                         vocab=cfg.vocab, seed=0))
    state = init_train_state(model, torch.Generator().manual_seed(0),
                             device=dev)
    # the reference's jax.jit: captured on the card, the state donated
    step = jit_step(make_train_step(
        model, plan, OptimizerConfig(lr=3e-3, weight_decay=0.0),
        make_schedule("constant", peak_lr=3e-3, warmup_steps=1)))
    for i in range(10):
        batch = {n: torch.from_numpy(a).to(dev)
                 for n, a in data.batch(i).items()}
        state, metrics = step(state, batch)
        if i % 3 == 0:
            print(f"step {i}: loss={float(metrics['loss']):.4f}")

    # 4. serve
    server = Server(model, state.params, REFERENCE_PLAN,
                    ServeConfig(max_new_tokens=8))
    toks = torch.from_numpy(data.batch(0)["tokens"][:2, :16]).to(dev)
    out = server.generate({"tokens": toks})
    print("generated:", out.tolist())


if __name__ == "__main__":
    main()
