"""Port of ``repro/runtime/train.py``: the single-device train step.

``make_train_step(model, plan, opt_cfg, schedule)`` returns
``train_step(state, batch) -> (state, metrics)``: the loss, its gradients
(``torch.autograd.grad``), AdamW, as the reference's step.  With
``plan.microbatch`` = mb > 1 the batch's axis 0 splits into mb parts; each
part's gradients accumulate in f32 divided by mb, and its metrics are
averaged (activation memory scales by 1/mb).  The metrics are the
model's (``ce``, ``loss``, a MoE model's ``moe_lb`` and ``moe_z``) with
``grad_norm`` and ``lr``, all device tensors (the step never reads one on
the host).  It is the pure builder that the dry run traces, as the
reference's is: it jits nothing.

The state is :class:`TrainState` (the parameter module, an
:class:`~repro_torch.optim.AdamWState` keyed by parameter names, and the
optional compression state).  The whole update is computed into new
tensors first, then written into the module's parameters, and the returned
state carries the new moments and step.  A failure before the write leaves
the state as it was, and a restore from a checkpoint
(``CheckpointManager.restore``) overwrites every leaf, so no half-applied
update survives one.

:func:`jit_step` is the port's ``jax.jit(step, donate_argnums=(0,))``
(reference ``launch/train.py:78``, ``runtime/train.py:98`` and ``:168``):
the step of :func:`in_place_step`, which also writes the new moments,
step count and error-feedback residuals back into the state it was given
and returns that state, as a
:class:`~repro_torch.core.device_program.CapturedFunction` whose first
argument is donated.  On the card its first call per signature runs
eagerly (a real step) and captures the step, forward, backward and AdamW,
as one CUDA graph; each later call copies what is not the graph's own
buffers in (a batch; moments a restore made; a parameter a restore
replaced) and replays it.  On the CPU, and inside ``disable_capture``, a
call is the plain in-place step.

Across devices (``runtime/pspec.py``, ``runtime/sharding.py``):

* ``jit_train_step``: ``make_train_step`` run under ``axis_rules(rules)``
  and captured as :func:`jit_step` captures, on a state whose parameters
  and AdamW moments are DTensors (placed by :func:`place_state` under
  :func:`state_shardings`, the moments with their parameters' placements)
  and a batch placed by ``batch_shardings`` (the rules' ``batch_logical_axes``
  when None).  Both are placed before the captured body, as the
  reference's ``in_shardings`` place them.  PyTorch is multi-controller:
  every rank calls it.
* ``make_compressed_dp_step``: pure data parallelism over ``(pod?,
  data)`` with replicated parameters, captured as :func:`jit_step`
  captures (the plain call on gloo CPU ranks): each rank takes its rows of
  the batch, the gradients are averaged exactly in f32 over ``data``, and
  over ``pod`` the error-feedback int8 payloads are all-gathered and summed
  in int16 (exact for up to 256 pods; neither gloo nor NCCL reduces int16
  itself), then scaled by ``1 / n_pods``, as the reference's ``psum`` of
  int16 does; the metrics are averaged over the first DP axis.  The pods
  first agree on each tensor's scale (the largest of theirs): the
  reference decodes every pod's payload with the local pod's own scale,
  so its pods' updates, and then their parameters, drift apart.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from repro_torch.core.device_program import CapturedFunction
from repro_torch.models.api import Model
from repro_torch.models.plan import ExecPlan
from repro_torch.optim import (AdamWState, CompressionState, OptimizerConfig,
                               adamw_init, adamw_update, ef_init)

__all__ = ["TrainState", "in_place_step", "init_train_state", "jit_step",
           "jit_train_step", "make_compressed_dp_step", "make_train_step",
           "place_state", "state_shardings"]


class TrainState(NamedTuple):
    params: nn.Module
    opt: AdamWState
    comp: Optional[CompressionState]


def init_train_state(model: Model, generator: Optional[torch.Generator] = None,
                     with_compression: bool = False,
                     dtype: torch.dtype = torch.float32,
                     device=None) -> TrainState:
    """Parameters drawn by ``model.init`` (on ``cuda`` unless ``"cpu"`` is
    asked for; raises without a card), zero AdamW moments, and the
    error-feedback state when ``with_compression``."""
    params = model.init(generator, dtype=dtype, device=device)
    return TrainState(params, adamw_init(params),
                      ef_init(params) if with_compression else None)


def make_train_step(model: Model, plan: ExecPlan, opt_cfg: OptimizerConfig,
                    schedule: Callable) -> Callable:
    def grads_of(params: nn.Module, named: dict, batch: dict) -> tuple:
        loss, metrics = model.loss(params, batch, plan)
        grads = torch.autograd.grad(loss, list(named.values()))
        return ({k: m.detach() for k, m in metrics.items()},
                {k: _like(g, p) for (k, p), g in zip(named.items(), grads)})

    def train_step(state: TrainState, batch: dict) -> tuple:
        named = dict(state.params.named_parameters())
        mb = max(plan.microbatch, 1)
        if mb == 1:
            metrics, grads = grads_of(state.params, named, batch)
        else:
            for k, x in batch.items():
                if x.shape[0] % mb:
                    raise ValueError(f"batch {k!r} of {x.shape[0]} rows does "
                                     f"not split into {mb} microbatches")
            micro = {k: x.chunk(mb) for k, x in batch.items()}
            # like the parameters (a DTensor's placements), summed out of
            # place
            grads = {k: torch.zeros_like(p, dtype=torch.float32)
                     for k, p in named.items()}
            metrics = None
            for i in range(mb):
                m, g = grads_of(state.params, named,
                                {k: x[i] for k, x in micro.items()})
                grads = {k: acc + g[k].float() / mb
                         for k, acc in grads.items()}
                del g
                metrics = {k: (0.0 if metrics is None else metrics[k])
                           + v / mb for k, v in m.items()}
        lr = schedule(state.opt.step)
        new_p, new_opt, om = adamw_update(grads, state.opt, named, opt_cfg,
                                          lr)
        del grads
        with torch.no_grad():
            for k, p in named.items():
                _write(p, new_p[k])
        metrics.update(om)
        return TrainState(state.params, new_opt, state.comp), metrics

    return train_step


def _state_leaves(state: TrainState) -> list:
    """The optimizer's and the compression's tensors of ``state``, in one
    order."""
    out = [state.opt.step, *state.opt.mu.values(), *state.opt.nu.values()]
    if state.comp is not None:
        out.extend(state.comp.error.values())
    return out


def in_place_step(step: Callable) -> Callable:
    """``step`` (a train step's signature) with its state donated: the new
    moments, step count and error-feedback residuals are written back into
    the tensors of the state it was given (the step writes the parameters
    itself), and that state is returned, as ``runtime/serve.py``'s decode
    step writes its state back."""
    def donated(state: TrainState, batch: dict) -> tuple:
        new, metrics = step(state, batch)
        with torch.no_grad():
            for old, leaf in zip(_state_leaves(state), _state_leaves(new),
                                 strict=True):
                if leaf is not old:
                    _write(old, leaf)
        return state, metrics

    return donated


def jit_step(step: Callable, name: str = "train_step") -> CapturedFunction:
    """``jax.jit(step, donate_argnums=(0,))`` for the port: the
    :func:`in_place_step` of ``step`` captured as a CUDA graph per call
    signature, its state donated (the returned state is the graph's
    buffers, the caller's own tensors); the plain in-place step on the CPU
    and inside ``disable_capture``.  A capture that fails raises."""
    return CapturedFunction(in_place_step(step), donate=(0,), name=name)


def _write(p: torch.Tensor, new: torch.Tensor) -> None:
    """``new`` written into the parameter ``p``; a DTensor's local shard
    is written directly (torch 2.11's DTensor refuses an in-place copy
    into a parameter under ``implicit_replication``)."""
    from torch.distributed.tensor import DTensor

    if isinstance(p, DTensor):
        p.to_local().copy_(_like(new, p).to_local())
    else:
        p.copy_(new)


def _like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient on its parameter's placements (autograd may
    leave it partial); a plain one as it is.  torch 2.11 hands the
    gradient of a table that two ``local_map`` bodies read (the tied
    embedding) back as a DTensor wrapping a DTensor: the inner one is the
    gradient."""
    from torch.distributed.tensor import DTensor

    while isinstance(g, DTensor) and isinstance(g._local_tensor, DTensor):
        g = g._local_tensor
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------


def state_shardings(state: TrainState, rules, cfg) -> dict:
    """{checkpoint leaf path: (mesh, placements)} of a train state: each
    parameter (``params/<name>``) by ``sharding.param_logical_axes``, its
    AdamW moments (``opt/mu/<name>``, ``opt/nu/<name>``) and error-feedback
    residual (``comp/error/<name>``) with the same placements.  The step
    counter stays a plain replicated scalar.  The paths are the checkpoint
    manager's, so a restore places the leaves (``reshard``)."""
    from repro_torch.runtime.sharding import (param_logical_axes,
                                              tree_shardings)

    named = dict(state.params.named_parameters())
    placed = tree_shardings(rules, named,
                            param_logical_axes(state.params, cfg, rules.mesh))
    out = {}
    for name in named:
        pl = (rules.mesh, placed[name])
        out[f"params/{name}"] = pl
        out[f"opt/mu/{name}"] = out[f"opt/nu/{name}"] = pl
        if state.comp is not None:
            out[f"comp/error/{name}"] = pl
    return out


def place_state(state: TrainState, shardings: dict) -> TrainState:
    """``state`` with its parameters (replaced in place in the module),
    moments and residuals placed as DTensors under ``shardings`` (from
    :func:`state_shardings`).  Every rank passes the same whole tensors; a
    leaf that is a DTensor already is kept (a placed parameter stays the
    module's own object)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def put(path, t):
        if isinstance(t, DTensor) or path not in shardings:
            return t
        mesh, pl = shardings[path]
        return distribute_tensor(t.detach(), mesh, pl)

    for name, p in list(state.params.named_parameters()):
        if isinstance(p, DTensor) or f"params/{name}" not in shardings:
            continue
        owner, _, leaf = name.rpartition(".")
        mod = state.params.get_submodule(owner) if owner else state.params
        mod._parameters[leaf] = nn.Parameter(put(f"params/{name}", p),
                                             requires_grad=p.requires_grad)
    opt = AdamWState(state.opt.step,
                     {k: put(f"opt/mu/{k}", v) for k, v in state.opt.mu.items()},
                     {k: put(f"opt/nu/{k}", v) for k, v in state.opt.nu.items()})
    comp = state.comp
    if comp is not None:
        comp = CompressionState({k: put(f"comp/error/{k}", v)
                                 for k, v in comp.error.items()})
    return TrainState(state.params, opt, comp)


def jit_train_step(model: Model, plan: ExecPlan, opt_cfg: OptimizerConfig,
                   schedule: Callable, rules, state_shardings: dict,
                   batch_shardings: Optional[dict] = None) -> Callable:
    """The sharded train step, ``step(state, batch) -> (state, metrics)``:
    the reference's ``jax.jit`` with ``in_shardings`` and
    ``donate_argnums=(0,)``.  Each call places the state under
    ``state_shardings`` (the first call replaces its module's parameters
    by DTensors; a placed leaf is kept) and a plain batch leaf under
    ``batch_shardings[key]`` (placements on the rules' mesh), or the
    rules' batch axes, outside the captured body; the body,
    ``make_train_step`` under ``axis_rules(rules)`` with plain tensors made
    inside it taken as replicated, is captured as :func:`jit_step`
    captures, the state donated (pass the returned state on); the step's
    ``jitted`` attribute is that captured program.  The metrics are
    replicated DTensors."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.runtime.pspec import axis_rules

    step = make_train_step(model, plan, opt_cfg, schedule)

    def place_batch(batch: dict) -> dict:
        out = {}
        for k, x in batch.items():
            if isinstance(x, DTensor):
                out[k] = x
                continue
            pl = (batch_shardings or {}).get(k) or rules.placements(
                tuple(x.shape), ("batch",) + (None,) * (x.dim() - 1))
            out[k] = distribute_tensor(x, rules.mesh, pl)
        return out

    def ruled_step(state: TrainState, batch: dict) -> tuple:
        with axis_rules(rules), implicit_replication():
            return step(state, batch)

    jitted = jit_step(ruled_step, "jit_train_step")

    def sharded_step(state: TrainState, batch: dict) -> tuple:
        return jitted(place_state(state, state_shardings), place_batch(batch))

    sharded_step.jitted = jitted
    return sharded_step


# ---------------------------------------------------------------------------
# compressed hierarchical-DP step over (pod?, data)
# ---------------------------------------------------------------------------


def make_compressed_dp_step(model: Model, plan: ExecPlan,
                            opt_cfg: OptimizerConfig, schedule: Callable,
                            mesh, compress: bool = True) -> Callable:
    """Pure data-parallel step over the mesh axes (pod?, data) with
    hierarchical gradient reduction: an exact f32 mean within a pod,
    error-feedback int8 across pods (``compress``, with ``state.comp``).
    The parameters are replicated (every rank holds the same module) and
    every rank passes the whole batch, of which it takes its rows.  Returns
    ``step(state, batch) -> (state, metrics)`` captured as :func:`jit_step`
    captures (the reference's ``jax.jit(..., donate_argnums=(0,))``): the
    whole update is computed, then written into the state it was given;
    on CPU ranks, the plain call."""
    import math

    from repro_torch.optim.compression import ef_compress_update, int8_scale
    from repro_torch.runtime.pspec import (axis_all_gather, axis_index,
                                           axis_max, axis_mean, axis_sizes,
                                           mesh_body)

    sizes = axis_sizes(mesh)
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    n_pods = sizes.get("pod", 1)
    n_rows = math.prod(sizes[a] for a in dp_axes)

    def rows(x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % n_rows:
            raise ValueError(f"batch of {x.shape[0]} rows does not split "
                             f"over {n_rows} data-parallel ranks")
        i = 0
        for a in dp_axes:
            i = i * sizes[a] + axis_index(a)
        return x.chunk(n_rows)[i]

    def step(state: TrainState, batch: dict) -> tuple:
        named = dict(state.params.named_parameters())
        with mesh_body(mesh):
            local = {k: rows(x) for k, x in batch.items()}
            loss, metrics = model.loss(state.params, local, plan)
            grads = torch.autograd.grad(loss, list(named.values()))
            metrics = {k: m.detach() for k, m in metrics.items()}
            with torch.no_grad():
                # exact reduction inside the pod
                grads = {k: axis_mean(g.float(), "data") if "data" in sizes
                         else g.float() for k, g in zip(named, grads)}
                comp = state.comp
                if "pod" in sizes:
                    if compress and comp is not None:
                        # one scale per tensor for every pod (the largest),
                        # so each payload decodes with its own scale
                        shared = {k: axis_max(int8_scale(
                            g + comp.error[k]), "pod")
                            for k, g in grads.items()}
                        qs, scales, comp = ef_compress_update(grads, comp,
                                                              shared)
                        # the int8 payload on the slow hop, summed in int16
                        grads = {k: axis_all_gather(q[None], "pod", 0)
                                 .to(torch.int16).sum(0).float()
                                 * scales[k] / n_pods for k, q in qs.items()}
                    else:
                        grads = {k: axis_mean(g, "pod")
                                 for k, g in grads.items()}
                lr = schedule(state.opt.step)
                new_p, new_opt, om = adamw_update(grads, state.opt, named,
                                                  opt_cfg, lr)
                metrics.update(om)
                if dp_axes:
                    metrics = {k: axis_mean(m, dp_axes[0])
                               for k, m in metrics.items()}
                for k, p in named.items():
                    p.copy_(new_p[k])
        return TrainState(state.params, new_opt, comp), metrics

    return jit_step(step, "compressed_dp_step")
