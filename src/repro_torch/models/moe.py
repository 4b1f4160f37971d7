"""Port of ``repro/models/moe.py``: the Mixture-of-Experts block (olmoe
64e/top-8, llama4-scout 16e/top-1 + a shared expert).

Two region implementations (``ExecPlan.moe_impl``), as in the reference:

* ``dense_onehot`` -- every token runs through every expert, the top-k
  one-hot gate zeroes the rest (``moe_dense``);
* ``scatter_ep``   -- top-k routing, capacity-limited dispatch into
  per-expert (E, C, d) buffers, batched expert matmuls, weighted combine
  (``moe_scatter``).  Under a mesh's rules ``scatter_ep`` takes the
  expert-parallel body (``moe_scatter_ep_sharded``: local dispatch, two
  all-to-alls over ``model``, the aux losses averaged over the token
  axes, inside ``local_map``); it returns ``None`` when no mesh applies
  and ``moe_block`` then takes ``moe_scatter``, as in the reference.

The router is the submodule :class:`Router`, so the export frontend
isolates it as a region and a forward hook can read each layer's top-k
indices.  The dispatch keeps the reference's semantics exactly where a
straight transcription would not:

* the within-expert rank comes from a *stable* argsort (``jnp.argsort`` is
  stable), so the tokens an expert drops are the reference's;
* expert counts are a fixed-size one-hot sum (``torch.bincount`` has a
  data-dependent size, which ``torch.export`` refuses);
* each expert buffer slot *gathers* its token (slot c of expert e holds
  the c-th of e's assignments in sorted order, when it has that many),
  which is the reference's ``.at[e, rank].set(..., mode="drop")`` without
  an out-of-range write;
* the combine ``.at[tok_flat].add`` over ``tok_flat = repeat(arange(t),
  k)`` is ``reshape(t, k, d).sum(1)``: no atomics, so two runs of one
  program give the same bits and the next layer's routing repeats;
* ``cap = int(max(1, (t * k / E) * capacity_factor))`` in Python floats,
  so a decode step of batch 4 under olmoe has ``cap = 1``.

``w_router`` is f32 whatever the dtype and is read in f32.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.plan import ExecPlan

__all__ = ["MoE", "MoEAux", "Router", "moe_block", "moe_dense", "moe_init",
           "moe_scatter", "moe_scatter_ep_sharded"]


class MoEAux(NamedTuple):
    load_balance: torch.Tensor  # scalar
    router_z: torch.Tensor      # scalar


def moe_init(cfg, generator: torch.Generator, put=lambda name, w: w) -> dict:
    """The shapes and distributions of the reference's ``moe_init``, f32 on
    the CPU: ``w_router`` (d, E), expert ``w_gate``/``w_up`` (E, d, ff) and
    ``w_down`` (E, ff, d) (fan-in d and ff), and with shared experts
    ``shared`` {w_gate, w_up, w_down} of width ff * n_shared.  Each tensor
    goes through ``put(name, tensor)`` as it is drawn, so a caller can move
    it to the card before the next is drawn."""
    e = cfg.moe
    d, ff = cfg.d_model, (e.d_ff_expert or cfg.d_ff)
    p = {"w_router": put("w_router", L.dense_init((d, e.n_experts),
                                                  generator))}
    for name, shape in (("w_gate", (e.n_experts, d, ff)),
                        ("w_up", (e.n_experts, d, ff)),
                        ("w_down", (e.n_experts, ff, d))):
        p[name] = put(name, L.dense_init(shape, generator))
    if e.n_shared_experts:
        p["shared"] = {k: put(f"shared.{k}", w) for k, w in L.mlp_init(
            d, ff * e.n_shared_experts, generator).items()}
    return p


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of ``idx`` over ``n`` classes (a comparison, which
    exports without ``one_hot``'s data-dependent range check)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _expert_act(cfg) -> str:
    return cfg.mlp_act if cfg.mlp_act != "relu_sq" else "silu"


class Router(nn.Module):
    """Top-k softmax router: ``x2d`` (T, d) -> (gates (T, k) renormalized
    to sum 1, expert indices (T, k), :class:`MoEAux`).  ``weight`` is the
    reference's ``w_router`` (d, E), f32; ``x2d`` is read in f32."""

    def __init__(self, weight: nn.Parameter, top_k: int):
        super().__init__()
        self.weight = weight
        self.top_k = top_k

    def forward(self, x2d: torch.Tensor) -> tuple:
        n_experts = self.weight.shape[1]
        logits = L.cast(x2d, torch.float32) @ L.cast(self.weight,
                                                     torch.float32)
        probs = torch.softmax(logits, dim=-1)
        gates, idx = torch.topk(probs, self.top_k, dim=-1)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        # Switch-style load-balance loss + z-loss
        density = _one_hot(idx, n_experts).mean(dim=(0, 1))
        lb = n_experts * torch.sum(density * probs.mean(dim=0))
        z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
        return gates, idx, MoEAux(lb, z)


def moe_dense(x2d: torch.Tensor, p: Mapping, router: Router, cfg,
              plan: ExecPlan) -> tuple:
    """Every token through every expert; the combined top-k gate matrix
    (zero outside the top k) weights their outputs."""
    dt = L.cdtype(plan)
    gates, idx, aux = router(x2d)
    onehot = _one_hot(idx, cfg.moe.n_experts)                  # (T,k,E)
    combine = L.cast(torch.einsum("tk,tke->te", gates, onehot), dt)
    g = torch.einsum("td,edf->tef", x2d, L.cast(p["w_gate"], dt))
    u = torch.einsum("td,edf->tef", x2d, L.cast(p["w_up"], dt))
    h = L._act(g, _expert_act(cfg)) * u
    y = torch.einsum("tef,efd->ted", h, L.cast(p["w_down"], dt))
    out = torch.einsum("ted,te->td", y, combine)
    return out + _shared(x2d, p, cfg, plan), aux


def _dispatch(x: torch.Tensor, idx: torch.Tensor, n_experts: int,
              cap: int) -> tuple:
    """Capacity-limited dispatch of ``x`` (T, d) by ``idx`` (T, k): (the
    (E, cap, d) buffers, each assignment's expert, its within-expert rank,
    whether it was kept).  Slot c of expert e gathers e's c-th assignment
    in token order (a stable sort), when it has that many."""
    t, k = idx.shape
    n, dev = t * k, x.device
    e_flat = idx.reshape(-1)                                    # (N,)
    tok_flat = torch.arange(t, device=dev)[:, None].expand(t, k).reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    counts = _one_hot(e_flat, n_experts).sum(0).long()          # (E,)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(e_flat)
    rank[order] = torch.arange(n, device=dev) - starts[e_flat[order]]
    slot = torch.arange(cap, device=dev)
    filled = slot[None, :] < counts[:, None]                    # (E, C)
    src = order[torch.clamp(starts[:, None] + slot[None, :], max=n - 1)]
    xb = torch.where(filled[..., None], x[tok_flat[src]],
                     torch.zeros((), dtype=x.dtype, device=dev))
    return xb, e_flat, rank, rank < cap


def _combine(yb: torch.Tensor, e_flat: torch.Tensor, rank: torch.Tensor,
             keep: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """Each token's kept experts' rows of ``yb`` (E, cap, d), weighted by
    its gates (T, k) and summed (no atomics: the same bits every run)."""
    t, k = gates.shape
    cap, dt = yb.shape[1], yb.dtype
    gathered = torch.where(keep[:, None],
                           yb[e_flat, torch.clamp(rank, 0, cap - 1)],
                           torch.zeros((), dtype=dt, device=yb.device))
    weighted = gathered * L.cast(gates.reshape(-1), dt)[:, None]
    return weighted.reshape(t, k, yb.shape[2]).sum(1)


def _experts(xb: torch.Tensor, wg, wu, wd, cfg, dt) -> torch.Tensor:
    """The batched expert FFN: (E, C, d) x (E, d, ff) -> (E, C, d)."""
    g = torch.einsum("ecd,edf->ecf", xb, L.cast(wg, dt))
    u = torch.einsum("ecd,edf->ecf", xb, L.cast(wu, dt))
    h = L._act(g, _expert_act(cfg)) * u
    return torch.einsum("ecf,efd->ecd", h, L.cast(wd, dt))


def moe_scatter(x2d: torch.Tensor, p: Mapping, router: Router, cfg,
                plan: ExecPlan) -> tuple:
    """Capacity-limited dispatch: each expert takes its first ``cap``
    assignments in token order (the rest drop), runs them as one batched
    FFN, and each token sums its kept experts' outputs by gate."""
    e = cfg.moe
    dt = L.cdtype(plan)
    t = x2d.shape[0]
    gates, idx, aux = router(x2d)
    cap = int(max(1, (t * e.top_k / e.n_experts) * e.capacity_factor))
    xb, e_flat, rank, keep = _dispatch(L.cast(x2d, dt), idx, e.n_experts, cap)
    yb = _experts(xb, p["w_gate"], p["w_up"], p["w_down"], cfg, dt)
    out = _combine(yb, e_flat, rank, keep, gates)
    return out + _shared(x2d, p, cfg, plan), aux


# ---------------------------------------------------------------------------
# expert parallelism under the mesh: each rank routes its own tokens into
# (E, C_loc, d) buffers, an all-to-all over ``model`` swaps expert-major and
# rank-major, the local experts run, a second all-to-all returns, and each
# rank combines locally.  FSDP'd expert weights are all-gathered explicitly
# inside (the per-layer gather: the paper's transfer-hoisting knob, made
# explicit), as in the reference.
# ---------------------------------------------------------------------------


def _moe_ep_body(x_loc, wr, wg, wu, wd, *, cfg, plan: ExecPlan,
                 t_axes: tuple, fsdp: dict):
    from repro_torch.runtime.pspec import (axis_all_gather, axis_all_to_all,
                                           axis_mean)

    e = cfg.moe
    dt = L.cdtype(plan)
    tl = x_loc.shape[0]
    # FSDP gathers: each weight's dim that enters sharded over "data"
    wr, wg, wu, wd = (axis_all_gather(w, "data", fsdp[i]) if fsdp[i] is not
                      None else w for i, w in enumerate((wr, wg, wu, wd)))
    logits = L.cast(x_loc, torch.float32) @ L.cast(wr, torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, e.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    cap = int(max(1, (tl * e.top_k / e.n_experts) * e.capacity_factor))
    buf, e_flat, rank, keep = _dispatch(L.cast(x_loc, dt), idx, e.n_experts,
                                        cap)
    # expert-major <-> rank-major (the EP all-to-all over "model")
    xb = axis_all_to_all(buf, "model", 0, 1)                   # (E_loc, m*C, d)
    yb = axis_all_to_all(_experts(xb, wg, wu, wd, cfg, dt), "model", 1, 0)
    y = _combine(yb, e_flat, rank, keep, gates)
    # aux losses: global means, a mean over every token axis
    density = _one_hot(idx, e.n_experts).mean(dim=(0, 1))
    lb = e.n_experts * torch.sum(axis_mean(density, t_axes)
                                 * axis_mean(probs.mean(dim=0), t_axes))
    z = axis_mean(torch.mean(torch.square(torch.logsumexp(logits, dim=-1))),
                  t_axes)
    return y, lb, z


def moe_scatter_ep_sharded(x2d: torch.Tensor, p: Mapping, router: Router,
                           cfg, plan: ExecPlan) -> Optional[tuple]:
    """The expert-parallel path under the active rules' mesh: tokens over
    every mesh axis that divides them (``model`` among them), experts over
    ``model``.  Returns None when the mesh does not apply (no rules, no
    ``model`` or ``data`` axis, experts or tokens that do not divide, or
    fewer local tokens than experts), as the reference does."""
    import math

    from repro_torch.runtime.pspec import (axis_names, current_rules,
                                           dividing_axes, local_map)

    rules = current_rules()
    if rules is None:
        return None
    sizes = rules.axis_sizes
    msize = sizes.get("model", 1)
    if msize <= 1 or "data" not in sizes:
        return None
    if cfg.moe.n_experts % msize != 0:
        return None
    t = x2d.shape[0]
    t_axes = dividing_axes(t, (("pod", "data", "model"), ("data", "model")))
    if "model" not in t_axes:
        return None
    if t // math.prod(sizes[a] for a in t_axes) < cfg.moe.n_experts:
        return None           # a degenerate local dispatch
    ws = (router.weight, p["w_gate"], p["w_up"], p["w_down"])
    w_axes = (("fsdp", None), ("experts", "fsdp", None),
              ("experts", "fsdp", None), ("experts", None, "fsdp"))
    w_specs = tuple(rules.pspec(tuple(w.shape), a)
                    for w, a in zip(ws, w_axes))
    fsdp = tuple(next((d for d, s in enumerate(spec) if s == "data"), None)
                 for spec in w_specs)
    tspec = (t_axes if len(t_axes) > 1 else t_axes[0], None)

    def body(x_loc, wr, wg, wu, wd):
        return _moe_ep_body(x_loc, wr, wg, wu, wd, cfg=cfg, plan=plan,
                            t_axes=t_axes, fsdp=fsdp)

    # a weight whole over a token axis serves the rank's tokens only (its
    # shard over "data" is gathered in the body, whose backward sums it)
    sums = (None,) + tuple(
        tuple(a for a in t_axes
              if a not in {n for e in spec for n in axis_names(e)})
        for spec in w_specs)
    y, lb, z = local_map(body, (tspec,) + w_specs, [tspec, (), ()],
                         x2d, *ws, grad_sums=sums)
    return y, MoEAux(lb, z)


def _shared(x2d: torch.Tensor, p: Mapping, cfg, plan: ExecPlan):
    if "shared" not in p:
        return torch.zeros((), dtype=L.cdtype(plan), device=x2d.device)
    return L.mlp(x2d, p["shared"], _expert_act(cfg), plan)


def moe_block(x: torch.Tensor, p: Mapping, router: Router, cfg,
              plan: ExecPlan) -> tuple:
    """x: (B,S,d) -> (B,S,d), :class:`MoEAux`."""
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    if plan.moe_impl == "scatter_ep":
        out = moe_scatter_ep_sharded(x2d, p, router, cfg, plan)
        if out is not None:
            y, aux = out
            y = y + _shared(x2d, p, cfg, plan)
        else:
            y, aux = moe_scatter(x2d, p, router, cfg, plan)
    else:
        y, aux = moe_dense(x2d, p, router, cfg, plan)
    return y.reshape(b, s, d), aux


class MoE(nn.Module):
    """One layer's MoE at ``cfg``'s widths: the :class:`Router` and the
    experts' weights (``w_gate``, ``w_up``, ``w_down``, and ``shared`` when
    the config has shared experts), drawn by :func:`moe_init` from
    ``generator`` and moved to ``device`` in ``dtype`` one tensor at a time
    (the router stays f32).  ``forward(x, plan)`` -> (y, :class:`MoEAux`)."""

    def __init__(self, cfg, *, dtype: torch.dtype, device,
                 generator: torch.Generator):
        super().__init__()
        self.cfg = cfg

        def put(name, w):
            dt = torch.float32 if name == "w_router" else dtype
            return nn.Parameter(w.to(device=device, dtype=dt))

        p = moe_init(cfg, generator, put)
        self.router = Router(p["w_router"], cfg.moe.top_k)
        self.w_gate, self.w_up, self.w_down = \
            p["w_gate"], p["w_up"], p["w_down"]
        self.shared: Optional[nn.ParameterDict] = \
            nn.ParameterDict(p["shared"]) if "shared" in p else None

    def params(self) -> dict:
        p = {"w_gate": self.w_gate, "w_up": self.w_up, "w_down": self.w_down}
        if self.shared is not None:
            p["shared"] = self.shared
        return p

    def forward(self, x: torch.Tensor, plan: ExecPlan) -> tuple:
        return moe_block(x, self.params(), self.router, self.cfg, plan)
