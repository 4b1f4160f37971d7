"""Port of ``repro/runtime/train.py``: the single-device train step.

``make_train_step(model, plan, opt_cfg, schedule)`` returns
``train_step(state, batch) -> (state, metrics)``: the loss, its gradients
(``torch.autograd.grad``), AdamW, as the reference's step.  With
``plan.microbatch`` = mb > 1 the batch's axis 0 splits into mb parts; each
part's gradients accumulate in f32 divided by mb, and its metrics are
averaged (activation memory scales by 1/mb).  The metrics are the
model's (``ce``, ``loss``, a MoE model's ``moe_lb`` and ``moe_z``) with
``grad_norm`` and ``lr``, all device tensors (the step never reads one on
the host).

The state is :class:`TrainState` (the parameter module, an
:class:`~repro_torch.optim.AdamWState` keyed by parameter names, and the
optional compression state).  The step takes the input state as the
reference's launcher donates it: the whole update is computed into new
tensors first, then written into the module's parameters, and the returned
state carries the new moments and step.  A failure before the write leaves
the state as it was, and a restore from a checkpoint
(``CheckpointManager.restore``) overwrites every leaf, so no half-applied
update survives one.

``jit_train_step`` (shardings and donation) and ``make_compressed_dp_step``
(error-feedback int8 across pods under ``shard_map``) wait for the mesh
(``ROADMAP.md`` queue 1 item 10).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from repro_torch.models.api import Model
from repro_torch.models.plan import ExecPlan
from repro_torch.optim import (AdamWState, CompressionState, OptimizerConfig,
                               adamw_init, adamw_update, ef_init)

__all__ = ["TrainState", "init_train_state", "make_train_step"]


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
                dict(zip(named, grads)))

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
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in named.items()}
            metrics = None
            for i in range(mb):
                m, g = grads_of(state.params, named,
                                {k: x[i] for k, x in micro.items()})
                for k, acc in grads.items():
                    acc.add_(g[k].float() / mb)
                del g
                metrics = {k: (0.0 if metrics is None else metrics[k])
                           + v / mb for k, v in m.items()}
        lr = schedule(state.opt.step)
        new_p, new_opt, om = adamw_update(grads, state.opt, named, opt_cfg,
                                          lr)
        del grads
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(new_p[k])
        metrics.update(om)
        return TrainState(state.params, new_opt, state.comp), metrics

    return train_step
