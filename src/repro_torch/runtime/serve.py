"""Port of ``repro/runtime/serve.py``: the serving loop — batched prefill,
then autoregressive decode against the decode state (KV caches; for a
hybrid model also the RG-LRU states and local-attention rings; for an SSM
model the RWKV states; for an enc-dec model the self caches and the
cross caches its prefill computed over the encoded ``frames``).

``Server`` owns the parameters and a plan; ``generate`` prefills a request
batch, then decodes greedily (``argmax``) or with temperature sampling from
a ``torch.Generator`` seeded by ``ServeConfig.seed`` on every call.  Decode
steps write the KV caches in place (RG-LRU and RWKV states are
replaced), and ``cache_len`` stays a device scalar, so
no step synchronises with the host; the generated tokens are copied to the
host once, at the end.

On the card, as the reference jits them (its ``serve.py:51`` and ``:59``),
the decode step and the prefill run as CUDA graphs
(:mod:`repro_torch.core.device_program`): the decode step captured once
per (batch, capacity), its state donated — the graph writes the new
RG-LRU / RWKV states and ``cache_len`` back into the state's buffers, as
the KV caches are written — and the prefill once per capacity and input
shapes.  Sampling stays outside the graphs, as in the reference.  On the
CPU both are the plain calls.

The plan is **hot-swappable**: everything derived from it — here the
parameters cast once to the plan's compute dtype where the reference casts
them at each use (same values), and the captured programs — lives in one
immutable ``_Bound`` snapshot published by a single reference assignment.  ``generate`` reads the
snapshot once per call, so an in-flight generation always runs one complete
plan end to end; a concurrent :meth:`Server.swap_plan` takes effect on the
*next* call, never mid-sequence.  ``Server.from_store`` builds a server
from a plan the planning service persisted (``repro_torch.service``): no
search and no planner in the loop.
"""
from __future__ import annotations

import collections
import copy
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.device_program import CapturedFunction, capture_enabled
from repro_torch.models import layers as L
from repro_torch.models.api import Model
from repro_torch.models.moe import Router
from repro_torch.models.plan import ExecPlan
from repro_torch.models.rglru import F32_LEAVES as RGLRU_F32
from repro_torch.models.rwkv import F32_LEAVES as RWKV_F32
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

__all__ = ["ServeConfig", "Server"]


@dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0      # 0 = greedy
    seed: int = 0


#: a submodule's leaves that the reference reads in f32 whatever the
#: compute dtype
_F32_LEAVES = {"rglru": RGLRU_F32, "tm_cm": RWKV_F32}


def _cast_params(params: torch.nn.Module, dtype: torch.dtype):
    """``params`` with every floating weight in ``dtype`` — all but those
    the reference reads in f32 whatever the compute dtype (the RMSNorm
    scales, the LayerNorm scales and biases, the MoE router, an RG-LRU's
    conv, gate biases and ``lam``, and RWKV's decay ``w0`` and
    ``w_lora_b``, bonus ``u`` and head-norm scale and bias) — sharing the
    weights that are in ``dtype`` already (no copy when nothing needs a
    cast)."""
    keep = {id(p) for m in params.modules()
            if isinstance(m, (L.RMSNorm, L.LayerNorm, Router))
            for p in m.parameters(recurse=False)}
    for name, p in params.named_parameters():
        parts = name.split(".")
        if len(parts) >= 2 and parts[-1] in _F32_LEAVES.get(parts[-2], ()):
            keep.add(id(p))
    memo = {id(p): torch.nn.Parameter(p.detach().to(dtype),
                                      requires_grad=False)
            for p in params.parameters()
            if p.is_floating_point() and p.dtype != dtype
            and id(p) not in keep}
    return copy.deepcopy(params, memo) if memo else params


def _write_back(state, new) -> None:
    """Copy each leaf of ``new`` that is not ``state``'s own tensor into
    the leaf of ``state`` at its key path (a decode step's replaced
    RG-LRU / RWKV states and ``cache_len``)."""
    old = dict(pytree.tree_flatten_with_path(state)[0])
    for path, leaf in pytree.tree_flatten_with_path(new)[0]:
        if path not in old:
            raise ValueError(f"the decode step returned a state leaf the "
                             f"state lacks: {pytree.keystr(path)}")
        if leaf is not old[path]:
            old[path].copy_(leaf)


class _Bound:
    """One plan plus what is derived from it: the parameters in its
    compute dtype and the captured prefill and decode programs (their
    graphs per signature fill in on first use, and go with the snapshot).
    ``lock`` lets one ``generate`` at a time use them."""

    __slots__ = ("plan", "params", "_model", "_prefill", "_decode", "lock")

    def __init__(self, model: Model, params, plan: ExecPlan):
        self.plan = plan
        self.params = _cast_params(params, L.cdtype(plan))
        self._model = model
        self._prefill = CapturedFunction(self._prefill_plain, name="prefill")
        self._decode = CapturedFunction(self._decode_in_place, donate=(1,),
                                        name="decode")
        self.lock = threading.Lock()

    def _prefill_plain(self, inputs: dict, cache_capacity: int):
        return self._model.prefill(self.params, inputs, self.plan,
                                   cache_capacity=cache_capacity)

    def _decode_in_place(self, token: torch.Tensor, state: dict):
        logits, new = self._model.decode(self.params, token, state,
                                         self.plan)
        _write_back(state, new)
        return logits, state

    def prefill(self, inputs: dict, cache_capacity: int):
        """(last-token logits, decode state); captured per capacity and
        input shapes on the card."""
        return self._prefill(inputs, cache_capacity)

    def decode(self, token: torch.Tensor, state: dict):
        """(logits, new state).  On the card ``state`` is donated: the
        new state is the captured step's buffers, updated in place (a
        state that is not them is copied in first); on the CPU, and inside
        ``disable_capture``, the plain step."""
        if token.device.type != "cuda" or not capture_enabled():
            return self._model.decode(self.params, token, state, self.plan)
        return self._decode(token, state)


class Server:
    def __init__(self, model: Model, params, plan: ExecPlan,
                 cfg: Optional[ServeConfig] = None):
        self.model = model
        self.params = params
        self.cfg = cfg or ServeConfig()
        self._bound = _Bound(model, params, plan)
        # request-arrival timestamps for traffic_hz(): the signal the
        # planning service's operating-point policy reads (latency-optimal
        # under load, energy-optimal idle)
        self._req_times: collections.deque = collections.deque(maxlen=256)

    @classmethod
    def from_store(cls, model: Model, params, store, fingerprint: str,
                   cfg: Optional[ServeConfig] = None) -> "Server":
        """Construct a server from a persisted plan: loads the newest
        :class:`~repro_torch.service.store.PlanRecord` for ``fingerprint``
        from a :class:`~repro_torch.service.store.PlanStore` and rehydrates
        its ``ExecPlan`` — no search, no planner in the loop."""
        rec = store.load(fingerprint)
        if rec is None:
            raise LookupError(
                f"no stored plan for fingerprint {fingerprint!r} — run the "
                f"planning service (or Offloader.plan) first")
        plan = store.rehydrate(rec)
        if not isinstance(plan, ExecPlan):
            raise TypeError(
                f"stored plan for {fingerprint!r} rehydrates to "
                f"{type(plan).__name__}, not an ExecPlan — Server only "
                f"serves module-frontend plans")
        return cls(model, params, plan, cfg)

    @property
    def plan(self) -> ExecPlan:
        return self._bound.plan

    def swap_plan(self, plan: ExecPlan) -> None:
        """Hot-swap the execution plan: build the new snapshot first, then
        publish it in one reference assignment — concurrent ``generate``
        calls finish on the plan they started with and the next call picks
        this one up, never a torn mix."""
        self._bound = _Bound(self.model, self.params, plan)

    @torch.no_grad()
    def generate(self, inputs: dict,
                 max_new: Optional[int] = None) -> np.ndarray:
        """inputs: dict with 'tokens' (B,S) (+ 'frames' for an enc-dec
        model, 'patch_feats' for a VLM), tensors on the parameters'
        device.  Returns the generated tokens (B, max_new) as int32."""
        bound = self._bound          # one snapshot: the whole call runs one
        max_new = max_new or self.cfg.max_new_tokens   # complete plan
        tokens = inputs["tokens"]
        b, s = tokens.shape
        t0 = time.perf_counter()
        self._req_times.append(t0)
        obs_metrics.gauge("serve.traffic_hz").set(self.traffic_hz())
        with obs_trace.span("serve.generate", batch=b, prompt_len=s,
                            max_new=max_new), bound.lock:
            cap = s + max_new + (self.model.cfg.vision_patches or 0)
            logits, state = bound.prefill(inputs, cap)
            gen = torch.Generator(logits.device).manual_seed(self.cfg.seed)
            out = torch.empty((b, max_new), dtype=torch.int32,
                              device=logits.device)
            tok = self._sample(logits, gen)
            for i in range(max_new):
                out[:, i] = tok[:, 0]
                if i == max_new - 1:
                    break
                logits, state = bound.decode(tok, state)
                tok = self._sample(logits, gen)
            out = out.cpu().numpy()
        # the histogram lives in the process-wide registry keyed by name,
        # not on the _Bound snapshot — a mid-flight swap_plan publishes a
        # new snapshot but cannot reset the latency series
        obs_metrics.histogram("serve.generate_seconds").observe(
            time.perf_counter() - t0)
        return out

    def traffic_hz(self, window_s: float = 60.0) -> float:
        """Recent request rate (requests/s over the trailing window)."""
        if window_s <= 0:
            return 0.0
        cutoff = time.perf_counter() - float(window_s)
        return sum(1 for t in self._req_times if t >= cutoff) / float(window_s)

    def _sample(self, logits: torch.Tensor,
                gen: torch.Generator) -> torch.Tensor:
        lg = logits[:, -1].float()
        if self.cfg.temperature <= 0:
            return torch.argmax(lg, dim=-1, keepdim=True).to(torch.int32)
        probs = torch.softmax(lg / self.cfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen).to(torch.int32)
