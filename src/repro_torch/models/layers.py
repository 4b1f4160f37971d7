"""Port of ``repro/models/layers.py``: initializers (``dense_init``,
``embed_init``, ``mlp_init``), RMSNorm (``rmsnorm_ref``, ``rmsnorm_fused``,
the ``rmsnorm`` dispatch and the :class:`RMSNorm` submodule around it),
``layernorm`` and its :class:`LayerNorm` submodule, rotary embeddings, the
gated MLP (``mlp_ref``, ``mlp_fused``, the ``mlp`` dispatch), embeddings,
logits and the two cross-entropy forms.

Every layer has a ``ref`` implementation and, where the reference has one,
an offloaded form the :class:`~repro_torch.models.plan.ExecPlan` selects.
Matrix products run in the plan's compute dtype (:func:`cdtype`), with
each weight cast at its use as in the reference; norms keep f32 statistics.
The reference's sharding constraints (``_ff_constrain``) redistribute
DTensors under a mesh's rules and are the identity without one; a DTensor
embedding table is looked up, and the chunked loss computed
sequence-parallel, by local bodies (:func:`_embed_sharded`,
:func:`_cross_entropy_sharded`).

Casts to the dtype a tensor already has are skipped: under ``torch.export``
a no-op ``.float()`` returns the same tensor, and later uses of the input
would then read the cast's node, leaking the residual stream into the norm's
region.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch._higher_order_ops.partitioner import HopGraphMinCutPartitioner
from torch._higher_order_ops.scan import ScanAutogradOp, scan_op
from torch._subclasses.fake_tensor import is_fake

from torch.distributed.tensor import DTensor
from torch.fx.experimental.proxy_tensor import disable_proxy_modes_tracing
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import _get_current_dispatch_mode as \
    _current_dispatch_mode
from torch.utils._python_dispatch import _pop_mode_temporarily
from torch.utils.checkpoint import _CachedTorchDispatchMode as _sac_cached_mode
from torch.utils.checkpoint import _CachingTorchDispatchMode as _sac_caching_mode

from repro_torch.core.trace_lock import TRACE_LOCK
from repro_torch.models.plan import REFERENCE_PLAN, ExecPlan
from repro_torch.runtime.pspec import (axis_all_gather, axis_index,
                                       axis_sizes, axis_sum, constrain,
                                       current_rules, local_map,
                                       placements_spec)

__all__ = ["LayerNorm", "RMSNorm", "apply_rope", "cast", "cdtype",
           "cross_entropy_chunked", "cross_entropy_full", "dense_init",
           "embed_init", "embed_tokens",
           "layernorm", "logits_from_hidden", "mlp", "mlp_fused", "mlp_init",
           "mlp_ref", "plan_for", "rmsnorm", "rmsnorm_fused", "rmsnorm_ref",
           "rope_freqs"]


def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.to(dtype)``, or ``x`` itself when it has that dtype already."""
    return x if x.dtype == dtype else x.to(dtype)


def cdtype(plan: ExecPlan) -> torch.dtype:
    """The plan's compute dtype as a torch dtype."""
    return getattr(torch, plan.compute_dtype)


def plan_for(x: torch.Tensor, plan: Optional[ExecPlan]) -> ExecPlan:
    """``plan``, or, when None, ``REFERENCE_PLAN`` computing in ``x``'s
    dtype (what a bare block or sublayer runs)."""
    if plan is not None:
        return plan
    return REFERENCE_PLAN.replace(compute_dtype=str(x.dtype).split(".")[-1])


# ---------------------------------------------------------------------------
# initializers (f32 on the CPU, drawn from an explicit generator)
# ---------------------------------------------------------------------------


def dense_init(shape: tuple, generator: torch.Generator,
               in_axis: int = -2) -> torch.Tensor:
    """The reference's ``dense_init``: a normal truncated to +-2 std, scaled
    by 1/sqrt(fan_in), f32 on the CPU."""
    w = nn.init.trunc_normal_(torch.empty(shape), std=1.0, a=-2.0, b=2.0,
                              generator=generator)
    return w / math.sqrt(shape[in_axis])


def embed_init(shape: tuple, generator: torch.Generator) -> torch.Tensor:
    """The reference's ``embed_init``: N(0, 0.02), f32 on the CPU."""
    return torch.randn(shape, generator=generator) * 0.02


def mlp_init(d_model: int, d_ff: int,
             generator: torch.Generator) -> dict[str, torch.Tensor]:
    return {"w_gate": dense_init((d_model, d_ff), generator),
            "w_up": dense_init((d_model, d_ff), generator),
            "w_down": dense_init((d_ff, d_model), generator)}


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    """Reference: upcast, normalize, scale (separate ops)."""
    xf = cast(x, torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return cast(normed * (1.0 + cast(scale, torch.float32)), x.dtype)


def rmsnorm_fused(x: torch.Tensor, scale: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """One fused expression, numerically the reference's."""
    xf = cast(x, torch.float32)
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return cast(xf * inv * (1.0 + cast(scale, torch.float32)), x.dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float,
            plan: ExecPlan) -> torch.Tensor:
    if plan.norm_impl == "fused":
        return rmsnorm_fused(x, scale, eps)
    return rmsnorm_ref(x, scale, eps)


class RMSNorm(nn.Module):
    """RMSNorm over the last dim with the reference's ``(1 + scale)``
    weighting (``weight`` starts at zero = unit scale).  A submodule, so the
    export frontend sees it as one region; its body is the plan's
    :func:`rmsnorm` (the reference form when no plan is given)."""

    def __init__(self, dim: int, eps: float = 1e-6, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(dim, dtype=dtype, device=device))
        self.eps = eps

    def forward(self, x: torch.Tensor,
                plan: Optional[ExecPlan] = None) -> torch.Tensor:
        return rmsnorm(x, self.weight, self.eps, plan or REFERENCE_PLAN)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float) -> torch.Tensor:
    xf = cast(x, torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return cast(y * cast(scale, torch.float32) + cast(bias, torch.float32),
                x.dtype)


class LayerNorm(nn.Module):
    """:func:`layernorm` over the last dim with ``weight`` (starts at one)
    and ``bias`` (zero), both read in f32.  A submodule, so the export
    frontend sees it as one region (x, weight, bias): the ``rmsnorm``
    record matches it by name, and the kernel's binder, which takes (x,
    scale), refuses it."""

    def __init__(self, dim: int, eps: float = 1e-6, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype, device=device))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.weight, self.bias, self.eps)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S)."""
    if theta <= 0:
        return x
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = cast(positions[..., :, None, None], torch.float32) * freqs
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(cast(x, torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return cast(out, x.dtype)


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    if kind == "relu_sq":
        return torch.square(F.relu(x))
    raise ValueError(kind)


def _ff_constrain(h: torch.Tensor) -> torch.Tensor:
    """Pin the (..., ff) hidden to TP-column sharding, so that the (small)
    ``w_down`` weight is gathered, never the (large) activation, and no
    ``Partial`` sum is carried into it.  (B,S,ff) for dense layers, (T,ff)
    for the shared-expert path; the identity without a mesh."""
    return constrain(h, "batch", *(None,) * (h.dim() - 2), "tensor")


def mlp_ref(x: torch.Tensor, p: Mapping[str, torch.Tensor], act: str,
            plan: ExecPlan) -> torch.Tensor:
    """Reference: three separate matmuls, (in, out) weights."""
    dt = cdtype(plan)
    g = _ff_constrain(x @ cast(p["w_gate"], dt))
    u = _ff_constrain(x @ cast(p["w_up"], dt))
    return _ff_constrain(_act(g, act) * u) @ cast(p["w_down"], dt)


def mlp_fused(x: torch.Tensor, p: Mapping[str, torch.Tensor], act: str,
              plan: ExecPlan) -> torch.Tensor:
    """Fused: gate and up as one matmul."""
    dt = cdtype(plan)
    wgu = cast(torch.cat([p["w_gate"], p["w_up"]], dim=1), dt)
    g, u = torch.chunk(x @ wgu, 2, dim=-1)
    return _ff_constrain(_act(_ff_constrain(g), act) * _ff_constrain(u)) \
        @ cast(p["w_down"], dt)


def mlp(x: torch.Tensor, p: Mapping[str, torch.Tensor], act: str,
        plan: ExecPlan) -> torch.Tensor:
    if plan.mlp_impl == "fused":
        return mlp_fused(x, p, act, plan)
    return mlp_ref(x, p, act, plan)


# ---------------------------------------------------------------------------
# embedding + logits + losses
# ---------------------------------------------------------------------------


def _axes_of(entry) -> tuple:
    """The mesh axes of one ``PartitionSpec`` entry."""
    return () if entry is None else ((entry,) if isinstance(entry, str)
                                     else tuple(entry))


def _embed_sharded(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The lookup of a table that is a DTensor, under the rules' mesh: a
    local body that gathers the table's feature dim, looks up the tokens
    that fall in its vocab rows (zeros for the rest) and sums over the
    vocab axes.  DTensor's own strategy (a masked partial) does not survive
    a batch-sharded lookup of a vocab- and FSDP-sharded table."""
    mesh = table.device_mesh
    tspec = placements_spec(mesh, table.placements, 2)
    bspec = current_rules().pspec(tuple(tokens.shape),
                                  ("batch",) + (None,) * (tokens.dim() - 1))
    sizes = axis_sizes(mesh)
    v_axes, d_axes = _axes_of(tspec[0]), _axes_of(tspec[1])

    def body(tok, tab):
        for a in reversed(d_axes):
            tab = axis_all_gather(tab, a, 1)
        vl, off = tab.shape[0], 0
        for a in v_axes:
            off = off * sizes[a] + axis_index(a)
        rel = tok.long() - off * vl
        hit = (rel >= 0) & (rel < vl)
        out = F.embedding(rel.clamp(0, vl - 1), tab) * hit[..., None]
        return axis_sum(out, v_axes)

    return local_map(body, (bspec, tspec), bspec + (None,), tokens, table)


def embed_tokens(tokens: torch.Tensor, table: torch.Tensor, plan: ExecPlan,
                 scale: bool) -> torch.Tensor:
    if current_rules() is not None and isinstance(table, DTensor):
        looked = _embed_sharded(tokens, table)
    else:
        looked = F.embedding(tokens, table)
    x = cast(looked, cdtype(plan))
    if scale:   # sqrt(d) rounded to the compute dtype first, as jnp does
        x = x * torch.full((), math.sqrt(table.shape[1]), dtype=x.dtype,
                           device=x.device)
    return x


def logits_from_hidden(h: torch.Tensor, table: torch.Tensor, plan: ExecPlan,
                       softcap: float) -> torch.Tensor:
    out = h @ cast(table, cdtype(plan)).T
    if softcap > 0:
        out = torch.tanh(out / softcap) * softcap
    return out


def cross_entropy_full(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Reference loss: the full (B,S,V) f32 log-softmax.  Returns the
    per-token nll (B,S); the caller applies the loss mask."""
    lp = torch.log_softmax(cast(logits, torch.float32), dim=-1)
    return -torch.gather(lp, -1, labels[..., None].long())[..., 0]


def _online_ce(h, blocks, labels, softcap: float) -> torch.Tensor:
    """Per-token logsumexp minus the label logit over vocab blocks: each
    ``(rows (parts * width, d), first vocab id of each part (parts,),
    width)`` of ``blocks`` is ``parts`` runs of ``width`` consecutive vocab
    rows.  Never the f32 (B,S,V) tensor."""
    labels = labels.long()
    m = torch.full(labels.shape, -math.inf, device=h.device)
    ssum = torch.zeros(labels.shape, device=h.device)
    lbl_logit = torch.zeros(labels.shape, device=h.device)
    for rows, col0, width in blocks:
        lg = cast(h @ cast(rows, h.dtype).T, torch.float32)   # (B,S,n)
        if softcap > 0:
            lg = torch.tanh(lg / softcap) * softcap
        new_m = torch.maximum(m, lg.amax(dim=-1))
        ssum = ssum * torch.exp(m - new_m) \
            + torch.exp(lg - new_m[..., None]).sum(dim=-1)
        m = new_m
        # column j of the block is vocab id col0[j // width] + j % width
        rel = labels[..., None] - col0
        hit = (rel >= 0) & (rel < width)                     # (B,S,parts)
        part = hit.float().argmax(-1)
        idx = part * width + torch.gather(
            rel, -1, part[..., None])[..., 0].clamp(0, width - 1)
        picked = torch.gather(lg, -1, idx[..., None])[..., 0]
        lbl_logit = torch.where(hit.any(-1), picked, lbl_logit)
    return m + torch.log(ssum) - lbl_logit


def _cross_entropy_sharded(h, table, labels, plan: ExecPlan,
                           softcap: float) -> torch.Tensor:
    """The chunked loss under a mesh, in a local body: the hidden states
    and labels sequence-parallel over ``model`` (the reference's
    ``constrain(h, "batch", "seq_sp", None)``), and each step all-gathers
    one block of every vocab shard's rows (the table's FSDP dim gathered
    once), so a rank's logits are (its rows, the block) and the label
    gather stays local.  DTensor's own matmul over these placements
    searches its strategies for minutes on a three-axis mesh."""
    rules = current_rules()
    mesh = table.device_mesh
    sizes = axis_sizes(mesh)
    tspec = placements_spec(mesh, table.placements, 2)
    v_axes, d_axes = _axes_of(tspec[0]), _axes_of(tspec[1])
    hspec = rules.pspec(tuple(h.shape), ("batch", "seq_sp", None))
    lspec = rules.pspec(tuple(labels.shape), ("batch", "seq_sp"))
    n_shards = math.prod(sizes[a] for a in v_axes)
    width_of = -(-min(plan.loss_vocab_chunk, table.shape[0]) // n_shards)

    def body(h_loc, tab, lab):
        for a in reversed(d_axes):
            tab = axis_all_gather(tab, a, 1)
        vl = tab.shape[0]
        ranks = torch.arange(n_shards, device=tab.device)

        def blocks():
            for c0 in range(0, vl, width_of):
                piece = tab[c0:c0 + width_of]
                for a in reversed(v_axes):
                    piece = axis_all_gather(piece, a, 0)
                yield piece, ranks * vl + c0, min(width_of, vl - c0)

        return _online_ce(h_loc, blocks(), lab, softcap)

    return local_map(body, (hspec, tspec, lspec), lspec, h, table, labels)


def cross_entropy_chunked(h: torch.Tensor, table: torch.Tensor,
                          labels: torch.Tensor, plan: ExecPlan,
                          softcap: float) -> torch.Tensor:
    """Memory-lean loss: logsumexp and the label logit over vocab chunks of
    ``plan.loss_vocab_chunk`` rows, never the f32 (B,S,V) tensor.  The last
    chunk may be ragged: it is the table's remaining rows (the reference
    pads it with columns masked to -inf, which add nothing).  Under a
    mesh, with a DTensor table, :func:`_cross_entropy_sharded`."""
    if current_rules() is not None and isinstance(table, DTensor):
        return _cross_entropy_sharded(h, table, labels, plan, softcap)
    v = table.shape[0]
    chunk = min(plan.loss_vocab_chunk, v)
    labels = labels.long()
    m = torch.full(labels.shape, -math.inf, device=h.device)
    ssum = torch.zeros(labels.shape, device=h.device)
    lbl_logit = torch.zeros(labels.shape, device=h.device)
    for c0 in range(0, v, chunk):
        tchunk = table[c0:c0 + chunk]
        lg = cast(h @ cast(tchunk, h.dtype).T, torch.float32)  # (B,S,<=chunk)
        if softcap > 0:
            lg = torch.tanh(lg / softcap) * softcap
        new_m = torch.maximum(m, lg.amax(dim=-1))
        ssum = ssum * torch.exp(m - new_m) \
            + torch.exp(lg - new_m[..., None]).sum(dim=-1)
        m = new_m
        rel = labels - c0
        in_chunk = (rel >= 0) & (rel < lg.shape[-1])
        picked = torch.gather(lg, -1, rel.clamp(0, lg.shape[-1] - 1)[..., None])
        lbl_logit = torch.where(in_chunk, picked[..., 0], lbl_logit)
    return m + torch.log(ssum) - lbl_logit


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


#: the dispatch modes of a selective activation checkpoint
_SAC_MODES = (_sac_caching_mode, _sac_cached_mode)


@contextlib.contextmanager
def _without_selective_checkpoint():
    """The selective checkpoint's dispatch modes popped while a scan runs:
    the scan is neither saved nor tagged by the policy, so it is recomputed
    whole with its layer (its residuals are kept by the hooks above), and
    its joint graph is traced untagged (a tagged one fails torch 2.11's
    min-cut partition)."""
    with contextlib.ExitStack() as popped:
        while isinstance(_current_dispatch_mode(), _SAC_MODES):
            popped.enter_context(_pop_mode_temporarily())
        yield


#: the partitioned joint graphs of the scan bodies met with gradients, by
#: :func:`_partition_key`: partitioning traces a body's forward and
#: backward (~0.5 s a call on the host, a train step repeating it per
#: layer, microbatch and recompute); each call runs on a copy, since the
#: scan's autograd rewrites the graphs it is given
_PARTITIONED: collections.OrderedDict = collections.OrderedDict()
_PARTITIONED_MAX = 64


def _partition_key(combine_fn, operands: list) -> tuple:
    """The body's code and closure values and each operand's metadata
    (fake or real, shape, strides, dtype, device, requires_grad)."""
    cells = tuple(c.cell_contents for c in
                  getattr(combine_fn, "__closure__", None) or ())
    return (getattr(combine_fn, "__code__", combine_fn), cells) + tuple(
        (is_fake(t), tuple(t.shape), t.stride(), t.dtype, t.device,
         t.requires_grad) for t in operands)


def _scan_autograd(combine_fn, body, init: list, xs: list, consts: tuple,
                   y_spec: list) -> list:
    """``scan_op`` under autograd, with the body's partitioned joint graph
    traced once for each :func:`_partition_key` (what the operator's
    autograd rule does on every call); ``y_spec`` gets the body's ys
    structure, which a cached graph keeps beside it.  The cache is read and
    written under ``TRACE_LOCK``, as threads that trace share it."""
    key = _partition_key(combine_fn, [*init, *xs, *consts])
    with TRACE_LOCK:
        entry = _PARTITIONED.get(key)
        if entry is None:
            with disable_proxy_modes_tracing():
                graph = HopGraphMinCutPartitioner.create_partitioned_graph(
                    body, (*init, *[x[0] for x in xs], *consts),
                    always_recompute_complex_exprs=True)
            entry = _PARTITIONED[key] = (graph, y_spec[0])
            while len(_PARTITIONED) > _PARTITIONED_MAX:
                _PARTITIONED.popitem(last=False)
        graph = copy.deepcopy(entry[0])
    y_spec[:] = entry[1:]
    return ScanAutogradOp.apply(graph, len(init), len(xs), len(consts),
                                *init, *xs, *consts)


def remat_safe_scan(combine_fn, init, xs, consts: tuple = ()) -> tuple:
    """The models' one scan: ``combine_fn(carry, x, *consts) -> (carry,
    y)`` over dim 0 of ``xs`` from ``init`` -> (final carry, stacked ys),
    as ``torch._higher_order_ops.scan``'s ``scan``.

    The higher-order op is called itself, with the tensors the body reads
    besides its carry and slice passed as ``consts`` (its
    ``additional_inputs``): the public ``scan`` compiles the call through
    dynamo, whose fake mode of its own clashes with a ``make_fx`` trace,
    and a tensor the body closes over never reaches the trace as an input
    (a parameter that requires grad stays a real or meta tensor inside a
    fake one).  So one program runs eagerly, under ``torch.export`` (one
    ``scan`` node, ``consts`` its lifted inputs, as dynamo lifts a
    closure's) and under the dry run's trace, whose train step holds the
    forward scan and autograd's reversed backward scan.  A body whose
    closure holds a tensor, or a value that cannot key a dict, is refused.

    It also runs inside an activation checkpoint.  Under autograd the scan
    traces its joint forward and backward; the saved-tensor hooks of an
    enclosing checkpoint (``transformer._maybe_remat``) would reach into
    that trace and recompute the layer on its fake tensors, which fails.
    So while autograd records, the scan saves its tensors as they are
    (identity hooks above the checkpoint's): its residuals are kept, and
    the rest of the layer is recomputed as the policy says.  Under autograd
    its partitioned joint graph is traced once a body and operand metadata
    (:func:`_scan_autograd`)."""
    cells = [c.cell_contents for c in
             getattr(combine_fn, "__closure__", None) or ()]
    if any(isinstance(c, torch.Tensor) for c in cells):
        raise ValueError("a scan body closes over a tensor: pass it in "
                         "consts")
    try:
        hash(tuple(cells))
    except TypeError:
        raise ValueError("a scan body closes over a value that cannot be "
                         "hashed: pass it in consts or bind it hashable") \
            from None
    flat_init, init_spec = pytree.tree_flatten(init)
    flat_xs, xs_spec = pytree.tree_flatten(xs)
    n_init, n_xs = len(flat_init), len(flat_xs)
    y_spec = []

    def body(*args):
        carry = pytree.tree_unflatten(list(args[:n_init]), init_spec)
        x = pytree.tree_unflatten(list(args[n_init:n_init + n_xs]), xs_spec)
        carry, y = combine_fn(carry, x, *args[n_init + n_xs:])
        flat_y, spec = pytree.tree_flatten(y)
        y_spec[:] = [spec]
        return [*pytree.tree_leaves(carry), *flat_y]

    operands = [*flat_init, *flat_xs, *consts]
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        # an initial carry that needs no gradient is left out of the scan's
        # joint graph by torch 2.11, which then drops the carry's gradient
        # between steps: ask for its gradient (torch 2.13 does so itself)
        flat_init = [t.detach().requires_grad_()
                     if t.is_floating_point() and not t.requires_grad else t
                     for t in flat_init]
        with torch.autograd.graph.saved_tensors_hooks(_same, _same), \
                _without_selective_checkpoint():
            out = _scan_autograd(combine_fn, body, flat_init, flat_xs,
                                 tuple(consts), y_spec)
    else:
        out = scan_op(body, flat_init, flat_xs, tuple(consts))
    return (pytree.tree_unflatten(list(out[:n_init]), init_spec),
            pytree.tree_unflatten(list(out[n_init:]), y_spec[0]))
