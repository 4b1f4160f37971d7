"""Port of ``repro/optim/adamw.py``: AdamW with decoupled weight decay and
global-norm clipping.

Parameters, gradients and the moments are mappings name -> tensor, keyed
by the parameters' names in ``named_parameters()`` order (``adamw_init``
also takes the module itself).  The optimizer state is f32 whatever the
parameter dtype; ``step`` is an int32 device scalar and the bias
corrections ``1 - b ** t`` are computed in f32, as in the reference.
Weight decay applies to every leaf, norm scales included, as in the
reference.  ``adamw_update`` returns new tensors and leaves its inputs as
they are.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, NamedTuple

import torch
from torch import nn

__all__ = ["AdamWState", "OptimizerConfig", "adamw_init", "adamw_update",
           "global_norm"]


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor               # () int32
    mu: dict[str, torch.Tensor]      # f32, keyed like the parameters
    nu: dict[str, torch.Tensor]


def _named(params) -> dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def adamw_init(params) -> AdamWState:
    """Zero moments for ``params`` (a module or a mapping name -> tensor),
    on the parameters' devices."""
    named = _named(params)
    dev = next(iter(named.values())).device if named else None

    def zeros():
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in named.items()}

    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      zeros(), zeros())


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.values()))


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], state: AdamWState,
                 params: Mapping[str, torch.Tensor], cfg: OptimizerConfig,
                 lr) -> tuple[dict, AdamWState, dict]:
    """One AdamW step: (new params, new state, {"grad_norm", "lr"})."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    t = step.float()
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float() * scale
        m = cfg.b1 * state.mu[k] + (1 - cfg.b1) * g
        v = cfg.b2 * state.nu[k] + (1 - cfg.b2) * torch.square(g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * p.float()
        new_p[k] = (p.float() - lr * delta).to(p.dtype)
        new_m[k], new_v[k] = m, v
    # a Python lr (a constant schedule) as a device fill, not a copy from
    # the host, which a capture refuses
    lr = lr.to(device=gnorm.device, dtype=torch.float32) \
        if isinstance(lr, torch.Tensor) else \
        torch.full((), lr, dtype=torch.float32, device=gnorm.device)
    return new_p, AdamWState(step, new_m, new_v), {"grad_norm": gnorm,
                                                   "lr": lr}
