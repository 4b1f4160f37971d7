"""Port of ``repro/launch/dryrun.py``: lower every (architecture x input
shape) for one H100 or for the reference's production meshes, and record
the artifact's memory analysis, cost analysis and roofline terms.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_0_6b --shape train_4k [--batch N] [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--plan tuned]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_0_6b --shape train_4k --mesh pod16x16 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_0_6b --shape train_4k --both-meshes

A cell is traced, never run: ``lower_cell`` builds the step's inputs as
fake tensors on the card (``device="cpu"``: meta tensors on the host) and
traces the train step, prefill or decode into an aten graph
(:func:`repro_torch.hlo_analysis.lower`).  A stack of identical layers is
traced at two and three periods of it and extrapolated to the model's
depth (the reference scans over its layers and multiplies one body).  A
train step through a ``scan`` (RG-LRU ``step``, RWKV-6's WKV) traces as
it runs: ``layers.remat_safe_scan`` calls the ``scan`` operator itself
with the tensors its body reads lifted into its inputs, so the graph holds
the forward scan and autograd's backward scan, each body costed times
its trip count.

``--mesh h100x1`` (the default): one card holds ``--batch`` sequences of
the cell's global batch.  The default is the plan's ``microbatch`` count,
one sequence a microbatch; a ``--batch`` that the plan's microbatches do
not split raises before anything is traced.  The record's ``reduced``
says so.

``--mesh pod16x16`` / ``pod2x16x16``: the reference's 256- and 512-rank
production meshes (``launch/mesh.py``).  The process starts a process
group of the ``fake`` backend at that world size before anything else (a
fake group is the process's default group, so the two meshes never share
a process; ``--both-meshes`` runs each in a child process).  The
parameters, the AdamW moments and the batch are DTensors placed by
``runtime.sharding.make_rules(mesh)`` over fake (meta on the CPU) local
shards, and the step is traced under ``axis_rules``: the graph is rank
0's program, its local ops and the collectives DTensor and the local
bodies make, each collective with its group size.  Every data-parallel
rank holds ``--batch`` sequences (by default the plan's ``microbatch``
count; the global batch is that times the ``pod`` x ``data`` ranks), as
``reduced`` says.  The record is per
device: ``memory.live_bytes`` and ``fits_80gb``, the collective histogram
by op and group size, and the compute, memory and collective terms.  The
collective term prices every axis at ``roofline.LINK_BW``, NVLink 4's 450
GB/s a direction: past one 8-GPU NVLink domain that is optimistic, a
known limit the record states (``link_bw_note``), not a second link rate.

Results go to ``build/dryrun/<arch>__<shape>__<mesh>__<plan>.json`` of the
checkout unless ``--out`` says otherwise.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import subprocess
import sys
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

__all__ = ["DEFAULT_OUT", "LINK_BW_NOTE", "MESH", "lower_cell", "main",
           "run_cell"]

log = get_logger("launch.dryrun")

#: one H100: its mesh name in the records
MESH = "h100x1"
#: what a production-mesh record says of its collective term
LINK_BW_NOTE = ("every mesh axis priced at roofline.LINK_BW = NVLink 4's "
                "450 GB/s a direction; optimistic past one 8-GPU NVLink "
                "domain")
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


def _mesh_placeholders(tree, axes, rules, dev: torch.device,
                       grad_keys: frozenset):
    """DTensor stand-ins of ``tree``'s tensors on the rules' mesh: each a
    fake (meta on the CPU) local shard of the placements its logical axes
    give (``axes``: a matching tree of tuples, None for a replicated
    leaf); the leaves under ``grad_keys`` require grad."""
    from torch.distributed.tensor import DTensor

    local_tree, spec = _placeholders(tree, dev, frozenset())
    flat_axes = pytree.tree_flatten(
        axes, is_leaf=lambda x: x is None or (isinstance(x, tuple) and all(
            a is None or isinstance(a, str) for a in x)))[0]
    paths = [p for p, _ in pytree.tree_flatten_with_path(tree)[0]]
    mesh = rules.mesh
    out = []
    for path, t, ax in zip(paths, local_tree, flat_axes):
        if not isinstance(t, torch.Tensor):
            out.append(t)
            continue
        ax = ax if ax is not None else (None,) * t.dim()
        pl = rules.placements(tuple(t.shape), ax)
        local_shape = list(t.shape)
        for size, p in zip(mesh.shape, pl):
            if hasattr(p, "dim") and not p.is_replicate():
                local_shape[p.dim] //= size
        local = t.new_empty(local_shape)
        x = DTensor.from_local(local, mesh, pl, run_check=False,
                               shape=t.shape,
                               stride=torch.empty(t.shape, device="meta")
                               .stride())
        if path[0].key in grad_keys:
            x.requires_grad_()
        out.append(x)
    return out, spec


def _lower_one_mesh(cfg: ArchConfig, shape: ShapeSpec, plan: ExecPlan,
                    dev: torch.device, params_dtype, rules
                    ) -> hlo_analysis.Lowered:
    """One rank's program of the step on the rules' mesh."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime.pspec import axis_rules

    model = build_model(cfg)
    train = shape.kind == "train"
    pdtype = params_dtype or (torch.float32 if train else torch.bfloat16)
    params = model.param_shapes(dtype=pdtype)
    specs = model.input_specs(shape)
    p_axes = shd.param_logical_axes(params, cfg, rules.mesh)
    named = dict(params.named_parameters())
    tree = {"params": named, "inputs": specs}
    inputs_axes = ({"token": ("batch", None),
                    "state": shd.state_logical_axes(specs["state"], cfg,
                                                    rules.mesh)}
                   if shape.kind == "decode"
                   else shd.batch_logical_axes(specs))
    axes = {"params": p_axes, "inputs": inputs_axes}
    if train:
        opt = adamw_init(params)
        tree["opt"] = {"step": opt.step, "mu": opt.mu, "nu": opt.nu}
        axes["opt"] = {"step": None, "mu": p_axes, "nu": p_axes}
        step = make_train_step(model, plan, OptimizerConfig(),
                               make_schedule(total_steps=10_000))

    def run(t: dict):
        with _reparametrize_module(params, t["params"]), \
                axis_rules(rules), implicit_replication():
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

    flat, spec = _mesh_placeholders(tree, axes, rules, dev,
                                    frozenset({"params"} if train else ()))
    lowered = hlo_analysis.lower(
        lambda *xs: run(pytree.tree_unflatten(list(xs), spec)), *flat,
        scope_root=params)
    # the parameters' bytes on one rank: their local shards, as placed
    placed = pytree.tree_unflatten(flat, spec)["params"]
    lowered.param_bytes = sum(t._local_tensor.numel()
                              * t._local_tensor.element_size()
                              for t in placed.values())
    return lowered


def lower_cell(cfg: ArchConfig, shape: ShapeSpec, plan: ExecPlan,
               device=None, params_dtype=None, mesh=None):
    """Returns (lowered, n_devices, model_flops_global) for one card
    (``cuda`` unless ``"cpu"`` is asked for; raises without a card), or,
    with ``mesh`` (a production ``DeviceMesh``), for rank 0 of that mesh:
    ``shape``'s global batch is then the whole mesh's."""
    dev = resolve_device(device)
    if mesh is None:
        one = functools.partial(_lower_one, shape=shape, plan=plan, dev=dev,
                                params_dtype=params_dtype)
        n_dev = 1
    else:
        from repro_torch.runtime.sharding import make_rules

        one = functools.partial(_lower_one_mesh, shape=shape, plan=plan,
                                dev=dev, params_dtype=params_dtype,
                                rules=make_rules(mesh))
        n_dev = mesh.size()
    depths = _depths(cfg)
    if depths is None:
        lowered = one(cfg)
    else:
        a, b, count = depths
        base = one(dataclasses.replace(cfg, n_layers=a))
        more = one(dataclasses.replace(cfg, n_layers=b))
        lowered = base.repeated(more, count)
        if mesh is not None:
            lowered.param_bytes = base.param_bytes + count * (
                more.param_bytes - base.param_bytes)
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        mf = rl.model_flops_train(n_active, shape.tokens)
    elif shape.kind == "prefill":
        mf = rl.model_flops_infer(n_active, shape.tokens)
    else:
        mf = rl.model_flops_infer(n_active, shape.global_batch)
    return lowered, n_dev, mf


# ---------------------------------------------------------------------------
# run + record
# ---------------------------------------------------------------------------


def run_cell(arch: str, shape_name: str, plan_kind: str = "production",
             out_dir=DEFAULT_OUT, verbose: bool = True,
             batch: Optional[int] = None, device=None,
             mesh_name: str = MESH, reduced: bool = False) -> dict:
    """Lower and analyse one cell on ``mesh_name`` (``h100x1``, or a
    production mesh, whose fake world this process then holds) and write
    its record; ``reduced`` takes the architecture's ``reduced()``
    config.  ``batch`` sequences sit on the card (a data-parallel rank of
    a mesh); None takes the plan's ``microbatch`` count.  Raises a
    ``ValueError`` when the plan's microbatches do not split ``batch``."""
    setup_logging()          # idempotent — run_cell is also a library entry
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    full = SHAPES_BY_NAME[shape_name]
    plan = (tuned_plan if plan_kind == "tuned" else production_plan)(
        cfg, full)
    if batch is None:
        batch = plan.microbatch
    elif batch % plan.microbatch:
        raise ValueError(f"--batch {batch} does not split into the plan's "
                         f"{plan.microbatch} microbatches")
    mesh = None
    if mesh_name == MESH:
        shape = dataclasses.replace(full, global_batch=batch)
        reduced_note = (f"global batch {full.global_batch} -> {batch} "
                        f"(one card's share)")
    else:
        from repro_torch.launch.mesh import (PRODUCTION_MESHES,
                                             make_production_mesh)
        dims = dict(zip(PRODUCTION_MESHES[mesh_name][1],
                        PRODUCTION_MESHES[mesh_name][0]))
        n_dp = dims.get("pod", 1) * dims["data"]
        shape = dataclasses.replace(full, global_batch=batch * n_dp)
        reduced_note = (f"global batch {full.global_batch} -> "
                        f"{batch * n_dp} ({batch} a data-parallel rank, "
                        f"{n_dp} ranks)")
    if plan.microbatch > 1:
        reduced_note = (f"{reduced_note} in {plan.microbatch} microbatches "
                        f"of the plan")
    if reduced:
        reduced_note = f"{reduced_note}; the reduced() config"
    rec: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "plan": plan_kind, "status": "skip", "ts": time.time(),
        "reduced": reduced_note,
    }
    if mesh_name != MESH:
        rec["link_bw_note"] = LINK_BW_NOTE
    if not cfg.supports_shape(shape):
        rec["skip_reason"] = cfg.skip_reason(shape)
        _write(rec, out_dir)
        if verbose:
            log.info("[skip] %s x %s: %s", arch, shape_name,
                     rec["skip_reason"])
        return rec
    try:
        t0 = time.time()
        if mesh_name != MESH:
            mesh = make_production_mesh(
                multi_pod=mesh_name == "pod2x16x16",
                device_type=resolve_device(device).type)
        lowered, n_dev, mf = lower_cell(cfg, shape, plan, device, mesh=mesh)
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
                **({"param_bytes": lowered.param_bytes}
                   if mesh is not None else {}),
            },
            "n_devices": n_dev,
            "roofline": roof.summary(),
            "collectives": roof.histogram,
            "cost_analysis": ca,
        })
        if verbose:
            s = roof.summary()
            log.info("[ok] %s x %s x %s: live=%.2fGB compute=%.2fms "
                     "memory=%.2fms collective=%.2fms dominant=%s "
                     "roofline_frac=%.3f",
                     arch, shape_name, mesh_name, live / 1e9,
                     s["compute_s"] * 1e3, s["memory_s"] * 1e3,
                     s["collective_s"] * 1e3, s["dominant"],
                     s["roofline_fraction"])
    except Exception as e:  # noqa: BLE001
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            log.error("[ERROR] %s x %s x %s: %s", arch, shape_name,
                      mesh_name, rec["error"][:300])
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
    ap.add_argument("--batch", type=int, default=None,
                    help="sequences of the global batch on the card (a "
                         "data-parallel rank); default: the plan's "
                         "microbatch count")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--mesh", default=MESH,
                    choices=[MESH, "pod16x16", "pod2x16x16"],
                    help="one card, or a production mesh traced on a fake "
                         "process group of its world size")
    ap.add_argument("--both-meshes", action="store_true",
                    help="both production meshes, each in a child process")
    ap.add_argument("--reduced", action="store_true",
                    help="the architecture's reduced() config (tests)")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--resume", action="store_true",
                    help="skip cells already recorded ok/skip")
    ap.add_argument("--trace", default="",
                    help="write an obs trace journal to this path")
    args = ap.parse_args(argv)

    if args.both_meshes:
        _run_both_meshes(argv if argv is not None else sys.argv[1:])
        return
    if args.mesh != MESH:
        from repro_torch.launch.mesh import PRODUCTION_MESHES, init_fake_world
        import math
        # before anything else: the fake world is this process's group
        init_fake_world(math.prod(PRODUCTION_MESHES[args.mesh][0]))
    with obs_trace.maybe_tracing(args.trace or None):
        _run(args)


def _run_both_meshes(argv: list) -> None:
    """Each production mesh in a child process of its own (one fake world
    a process); exits non-zero when either child does."""
    rest, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a == "--both-meshes":
            continue
        if a == "--mesh":
            skip = True
            continue
        if not a.startswith("--mesh="):
            rest.append(a)
    rcs = [subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           *rest, "--mesh", m]).returncode
           for m in ("pod16x16", "pod2x16x16")]
    if any(rcs):
        raise SystemExit(1)


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
                             f"{arch}__{shape}__{args.mesh}__{args.plan}.json")
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
                       device=args.device, mesh_name=args.mesh,
                       reduced=args.reduced)
        n_ok += rec["status"] == "ok"
        n_err += rec["status"] == "error"
        n_skip += rec["status"] == "skip"
    log.info("done: ok=%d error=%d skip=%d", n_ok, n_err, n_skip)
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
