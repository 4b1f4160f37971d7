"""Port of ``repro/launch/dryrun.py``, the one-device part: lower every
(architecture x input shape) for one H100 and record the artifact's
memory analysis, cost analysis and roofline terms.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_0_6b --shape train_4k [--batch 1] [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--plan tuned]

A cell is traced, never run: ``lower_cell`` builds the step's inputs as
fake tensors on the card (``device="cpu"``: meta tensors on the host) and
traces the train step, prefill or decode into an aten graph
(:func:`repro_torch.hlo_analysis.lower`).  A stack of identical layers is
traced at two and three periods of it and extrapolated to the model's
depth (the reference scans over its layers and multiplies one body).  A
train step through a ``scan`` (RG-LRU ``step``, RWKV-6) does not trace:
the scan's autograd compiles its body under a fake mode of its own, and
the cell records the error.  One card
holds ``--batch`` sequences of the cell's global batch (default 1, one
sequence), and the record's ``reduced`` says so.

Results go to ``build/dryrun/<arch>__<shape>__h100x1__<plan>.json`` of the
checkout unless ``--out`` says otherwise.  The reference's production
meshes (``pod16x16``, ``pod2x16x16``: shardings, collectives, the
multi-pod gradient path) wait for the port of the mesh (``ROADMAP.md``
queue 1 item 10).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from pathlib import Path
from typing import Optional

import torch
from torch.nn.utils.stateless import _reparametrize_module
from torch.utils import _pytree as pytree

from repro_torch import hlo_analysis
from repro_torch import roofline as rl
from repro_torch.configs.base import (ALL_SHAPES, ARCH_IDS, SHAPES_BY_NAME,
                                      ArchConfig, ShapeSpec, get_config)
from repro_torch.core.frontends.export_frontend import resolve_device
from repro_torch.launch.plans import production_plan, tuned_plan
from repro_torch.models.api import build_model
from repro_torch.models.plan import ExecPlan
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.log import get_logger, setup as setup_logging
from repro_torch.optim import (AdamWState, OptimizerConfig, adamw_init,
                               make_schedule)
from repro_torch.runtime.train import TrainState, make_train_step

__all__ = ["DEFAULT_OUT", "MESH", "lower_cell", "main", "run_cell"]

log = get_logger("launch.dryrun")

#: one H100: its mesh name in the records
MESH = "h100x1"
DEFAULT_OUT = Path(__file__).resolve().parents[3] / "build" / "dryrun"


# ---------------------------------------------------------------------------
# lowering one cell
# ---------------------------------------------------------------------------


def _depths(cfg: ArchConfig) -> Optional[tuple]:
    """(first depth, second depth, count) when ``cfg``'s layers repeat with
    a period: the model is the first-depth program plus ``count`` copies
    of what one more period adds.  The first depth holds two periods: the
    first layer's input lives differently from the others'.  None for an
    enc-dec model (two stacks) and for one no deeper than the traces."""
    if cfg.family == "encdec":
        return None
    p = len(cfg.block_pattern) if cfg.block_pattern else 1
    a = 2 * p + cfg.n_layers % p       # a hybrid's leading sublayers kept
    if cfg.n_layers <= a + p:
        return None
    return a, a + p, (cfg.n_layers - a) // p


def _placeholders(tree, dev: torch.device, grad_keys: frozenset):
    """Meta stand-ins of ``tree``'s tensors on ``dev``: the meta tensors
    themselves for the CPU, fake tensors on the card otherwise; the
    leaves under ``grad_keys`` require grad."""
    fake = None
    if dev.type != "cpu":
        from torch._subclasses.fake_tensor import FakeTensorMode
        fake = FakeTensorMode()
    flat, spec = pytree.tree_flatten_with_path(tree)
    out = []
    for path, t in flat:
        if not isinstance(t, torch.Tensor):
            out.append(t)
            continue
        if fake is None:
            x = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                    device="meta")
        else:
            with fake:
                x = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                        device=dev)
        if path[0].key in grad_keys:
            x.requires_grad_()
        out.append(x)
    return out, spec


def _lower_one(cfg: ArchConfig, shape: ShapeSpec, plan: ExecPlan,
               dev: torch.device, params_dtype) -> hlo_analysis.Lowered:
    model = build_model(cfg)
    train = shape.kind == "train"
    # training keeps f32 parameters; the serving paths bf16
    pdtype = params_dtype or (torch.float32 if train else torch.bfloat16)
    params = model.param_shapes(dtype=pdtype)
    specs = model.input_specs(shape)
    tree = {"params": dict(params.named_parameters()),
            "buffers": dict(params.named_buffers()), "inputs": specs}
    if train:
        opt = adamw_init(params)
        tree["opt"] = {"step": opt.step, "mu": opt.mu, "nu": opt.nu}
        step = make_train_step(model, plan, OptimizerConfig(),
                               make_schedule(total_steps=10_000))

    def run(t: dict):
        with _reparametrize_module(params, {**t["params"], **t["buffers"]}):
            if train:
                with torch.enable_grad():
                    o = t["opt"]
                    new, metrics = step(TrainState(
                        params, AdamWState(o["step"], o["mu"], o["nu"]),
                        None), t["inputs"])
                return new.opt, metrics
            with torch.no_grad():
                inp = t["inputs"]
                if shape.kind == "prefill":
                    return model.prefill(params, inp, plan,
                                         cache_capacity=shape.seq_len)
                return model.decode(params, inp["token"], inp["state"], plan)

    flat, spec = _placeholders(tree, dev, frozenset({"params"} if train
                                                    else ()))
    return hlo_analysis.lower(
        lambda *xs: run(pytree.tree_unflatten(list(xs), spec)), *flat,
        scope_root=params)


def lower_cell(cfg: ArchConfig, shape: ShapeSpec, plan: ExecPlan,
               device=None, params_dtype=None):
    """Returns (lowered, n_devices, model_flops_global) for one card
    (``cuda`` unless ``"cpu"`` is asked for; raises without a card)."""
    dev = resolve_device(device)
    depths = _depths(cfg)
    if depths is None:
        lowered = _lower_one(cfg, shape, plan, dev, params_dtype)
    else:
        a, b, count = depths
        lowered = _lower_one(dataclasses.replace(cfg, n_layers=a), shape,
                             plan, dev, params_dtype).repeated(
            _lower_one(dataclasses.replace(cfg, n_layers=b), shape, plan,
                       dev, params_dtype), count)
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        mf = rl.model_flops_train(n_active, shape.tokens)
    elif shape.kind == "prefill":
        mf = rl.model_flops_infer(n_active, shape.tokens)
    else:
        mf = rl.model_flops_infer(n_active, shape.global_batch)
    return lowered, 1, mf


# ---------------------------------------------------------------------------
# run + record
# ---------------------------------------------------------------------------


def run_cell(arch: str, shape_name: str, plan_kind: str = "production",
             out_dir=DEFAULT_OUT, verbose: bool = True, batch: int = 1,
             device=None) -> dict:
    setup_logging()          # idempotent — run_cell is also a library entry
    cfg = get_config(arch)
    full = SHAPES_BY_NAME[shape_name]
    shape = dataclasses.replace(full, global_batch=batch)
    rec: dict = {
        "arch": arch, "shape": shape_name, "mesh": MESH,
        "plan": plan_kind, "status": "skip", "ts": time.time(),
        "reduced": f"global batch {full.global_batch} -> {batch} "
                   f"(one card's share)",
    }
    if not cfg.supports_shape(shape):
        rec["skip_reason"] = cfg.skip_reason(shape)
        _write(rec, out_dir)
        if verbose:
            log.info("[skip] %s x %s: %s", arch, shape_name,
                     rec["skip_reason"])
        return rec
    try:
        plan = (tuned_plan if plan_kind == "tuned" else production_plan)(
            cfg, full)
        t0 = time.time()
        lowered, n_dev, mf = lower_cell(cfg, shape, plan, device)
        t_lower = time.time() - t0
        t0 = time.time()
        compiled = lowered.compile()
        mem = compiled.memory_analysis()
        ca = compiled.cost_analysis()
        t_compile = time.time() - t0
        log.info("%s", mem)   # proves it fits (per-device bytes)
        log.info("%s", ca)
        roof = rl.analyze(compiled, n_devices=n_dev, model_flops_global=mf)
        live = (mem.argument_size_in_bytes + mem.output_size_in_bytes
                + mem.temp_size_in_bytes + mem.generated_code_size_in_bytes)
        rec.update({
            "status": "ok",
            "lower_s": round(t_lower, 2),
            "compile_s": round(t_compile, 2),
            "memory": {
                "argument_bytes": mem.argument_size_in_bytes,
                "output_bytes": mem.output_size_in_bytes,
                "temp_bytes": mem.temp_size_in_bytes,
                "code_bytes": mem.generated_code_size_in_bytes,
                "live_bytes": live,
                "fits_80gb": bool(live <= rl.HBM_BYTES),
            },
            "roofline": roof.summary(),
            "collectives": roof.histogram,
            "cost_analysis": ca,
        })
        if verbose:
            s = roof.summary()
            log.info("[ok] %s x %s x %s: live=%.2fGB compute=%.2fms "
                     "memory=%.2fms collective=%.2fms dominant=%s "
                     "roofline_frac=%.3f",
                     arch, shape_name, MESH, live / 1e9,
                     s["compute_s"] * 1e3, s["memory_s"] * 1e3,
                     s["collective_s"] * 1e3, s["dominant"],
                     s["roofline_fraction"])
    except Exception as e:  # noqa: BLE001
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            log.error("[ERROR] %s x %s x %s: %s", arch, shape_name, MESH,
                      rec["error"][:300])
    _write(rec, out_dir)
    return rec


def _write(rec: dict, out_dir) -> None:
    os.makedirs(out_dir, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}__{rec['plan']}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1)


def main(argv: Optional[list] = None) -> None:
    setup_logging()
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS))
    ap.add_argument("--shape", default=None,
                    choices=[s.name for s in ALL_SHAPES])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--plan", default="production",
                    choices=["production", "tuned"])
    ap.add_argument("--batch", type=int, default=1,
                    help="sequences of the global batch on the card")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--resume", action="store_true",
                    help="skip cells already recorded ok/skip")
    ap.add_argument("--trace", default="",
                    help="write an obs trace journal to this path")
    args = ap.parse_args(argv)

    with obs_trace.maybe_tracing(args.trace or None):
        _run(args)


def _run(args) -> None:
    archs = list(ARCH_IDS) if args.all or not args.arch else [args.arch]
    shapes = [s.name for s in ALL_SHAPES] if args.all or not args.shape \
        else [args.shape]
    # cheap kinds first so failures surface early
    shape_order = {"decode_32k": 0, "prefill_32k": 1, "long_500k": 2, "train_4k": 3}
    cells = sorted((shape_order.get(sh, 9), arch, sh)
                   for sh in shapes for arch in archs)

    n_ok = n_err = n_skip = 0
    for _, arch, shape in cells:
        if args.resume:
            p = os.path.join(args.out,
                             f"{arch}__{shape}__{MESH}__{args.plan}.json")
            if os.path.exists(p):
                try:
                    with open(p) as f:
                        old = json.load(f)
                    if old.get("status") in ("ok", "skip"):
                        n_ok += old["status"] == "ok"
                        n_skip += old["status"] == "skip"
                        continue
                except (json.JSONDecodeError, OSError):
                    pass
        rec = run_cell(arch, shape, args.plan, args.out, batch=args.batch,
                       device=args.device)
        n_ok += rec["status"] == "ok"
        n_err += rec["status"] == "error"
        n_skip += rec["status"] == "skip"
    log.info("done: ok=%d error=%d skip=%d", n_ok, n_err, n_skip)
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
