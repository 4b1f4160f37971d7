"""Port of ``repro/runtime/sharding.py``: parameter, activation,
decode-state and batch sharding rules.

One table maps logical axis names to mesh axes (DP over ``pod`` +
``data``, FSDP over ``data``, TP/EP/SP over ``model``); path-pattern rules
assign logical axes to every parameter and decode-state leaf.
Divisibility fallbacks live in :meth:`ShardingRules.resolve`
(non-divisible dims replicate).

The reference matches its rules on "/"-joined key paths of stacked leaves
(``blocks/attn/wq``, layers on axis 0).  The port's parameters are a
module's ``named_parameters()``, one tensor a layer (``blocks.3.wq``,
``blocks.3.moe.router.weight``, ``blocks.0.sub2.wq``, ``ln1.weight``:
``models/convert.py``'s names).  :func:`reference_path` maps a port name
back to the reference's path (and whether the reference stacks it over
layers), and :func:`_axes_for_param` gives the port's leaf the axes the
reference gives the stacked leaf, less the layer axis.  The port keeps the
reference's (in, out) layouts, so the rules apply unchanged; the router's
``weight`` is the reference's ``w_router``, (d, E).

:func:`tree_pspecs` gives ``PartitionSpec`` tuples, :func:`tree_shardings`
DTensor placements, and :func:`distribute` places a module's parameters
as DTensors (or a dict or list tree of tensors, such as a decode state or
a batch) under them.
"""
from __future__ import annotations

import re
from typing import Any, Optional

import torch
from torch import nn
from torch.utils import _pytree as pytree

from repro_torch.runtime.pspec import ShardingRules, axis_sizes

__all__ = ["batch_logical_axes", "distribute", "logical_table",
           "make_rules", "param_logical_axes", "reference_path",
           "state_logical_axes", "tree_pspecs", "tree_shardings"]


# ---------------------------------------------------------------------------
# logical axis -> mesh axes
# ---------------------------------------------------------------------------


def logical_table(mesh) -> dict:
    has_pod = "pod" in axis_sizes(mesh)
    return {
        "batch": ("pod", "data") if has_pod else ("data",),
        "fsdp": "data",
        "tensor": "model",
        "vocab": "model",
        "experts": "model",
        "seq_sp": "model",
        "kv_heads": "model",
        "kv_seq": "model",
    }


def make_rules(mesh) -> ShardingRules:
    return ShardingRules(mesh, logical_table(mesh))


# ---------------------------------------------------------------------------
# parameter rules (the reference's, matched on its key paths)
# ---------------------------------------------------------------------------

_P_IN_OUT = ("fsdp", "tensor")    # (d_in, d_out-parallel) weights
_P_OUT_IN = ("tensor", "fsdp")    # (d_in-parallel, d_out) weights

_PARAM_RULES: list = [
    (r"moe/w_gate$", ("experts", "fsdp", None)),
    (r"moe/w_up$", ("experts", "fsdp", None)),
    (r"moe/w_down$", ("experts", None, "fsdp")),
    (r"moe/w_router$", ("fsdp", None)),
    (r"(^|/)(embed|lm_head)$", ("vocab", "fsdp")),
    (r"(^|/)(wq|wk|wv|wg|wr|w_gate|w_up|w_branch|w_in|dd_w1|w_lora_a|cm_wk|cm_wr|vis_w1)$",
     _P_IN_OUT),
    (r"(^|/)(wo|w_down|w_out|cm_wv|w_lora_b|dd_w2|vis_w2)$", _P_OUT_IN),
    (r"(^|/)(w_a|w_x)$", ("tensor", None, None)),
    (r"(^|/)w_conv$", (None, "tensor")),
    (r"(^|/)(lam|b_conv|b_a|b_x)$", ("tensor",)),
    (r"(^|/)w_router$", ("fsdp", None)),
]

_ATTN_Q = re.compile(r"(attn|xattn)/(wq|wo|bq)$")
_ATTN_KV = re.compile(r"(attn|xattn)/(wk|wv|bk|bv)$")
_RWKV_HEADED = re.compile(r"tm_cm/(wr|wk|wv|wg|wo)$")

#: the leaves a port block holds directly that the reference keeps under
#: its ``attn`` or ``mlp`` subtree
_ATTN_LEAVES = {"wq", "wk", "wv", "wo", "bq", "bk", "bv", "q_norm", "k_norm"}
_MLP_LEAVES = {"w_gate", "w_up", "w_down"}
#: the port's names of the reference's renamed leaves
_UNRENAMED = {"ln1.weight": "ln1_s", "ln1.bias": "ln1_b",
              "ln2.weight": "ln2_s", "ln2.bias": "ln2_b",
              "embed_norm.weight": "embed_norm_s",
              "embed_norm.bias": "embed_norm_b",
              "router.weight": "w_router"}


def _leaf(rest: list, rwkv: bool) -> list:
    """A block-relative port name (split on dots) -> the reference's key
    path inside the block (``rwkv``: an RWKV block, whose LayerNorms the
    reference names ``ln1_s`` / ``ln1_b``)."""
    name = ".".join(rest)
    if rwkv and name in _UNRENAMED:
        return [_UNRENAMED[name]]
    if rest[0] == "moe":
        if rest[1] == "shared":
            return ["moe", "shared", rest[2]]
        sub = ".".join(rest[1:])
        return ["moe", _UNRENAMED.get(sub, sub)]
    if rest[0] in ("rglru", "tm_cm", "xattn"):
        return [rest[0], rest[1]]
    if len(rest) == 2 and rest[1] == "weight":
        rest = [rest[0]]                     # a norm's scale
    if rest[0] in _ATTN_LEAVES:
        return ["attn", rest[0]]
    if rest[0] in _MLP_LEAVES:
        return ["mlp", rest[0]]
    return rest


def reference_path(name: str, family: Optional[str] = None) -> tuple:
    """A port parameter name -> (the reference's "/"-joined key path,
    whether the reference stacks the leaf over layers).  ``blocks.3.wq``
    -> (``blocks/attn/wq``, True); ``blocks.0.sub2.wq`` ->
    (``blocks/sub2/attn/wq``, True); ``pre_blocks.1.rglru.w_a`` ->
    (``pre_blocks/1/rglru/w_a``, False); ``final_norm.weight`` ->
    (``final_norm``, False).  ``family`` ``"ssm"`` names an RWKV block's
    LayerNorms as the reference does."""
    parts = name.split(".")
    if parts[0] in ("blocks", "enc_blocks") and len(parts) > 2:
        rest, prefix = parts[2:], [parts[0]]
        if rest[0].startswith("sub") and rest[0][3:].isdigit():
            prefix.append(rest[0])
            rest = rest[1:]
        return "/".join(prefix + _leaf(rest, family == "ssm")), True
    if parts[0] == "pre_blocks" and len(parts) > 2:
        return "/".join(parts[:2] + _leaf(parts[2:], False)), False
    joined = ".".join(parts)
    if joined in _UNRENAMED:
        return _UNRENAMED[joined], False
    if len(parts) == 2 and parts[1] == "weight":
        return parts[0], False
    return "/".join(parts), False


def _ref_axes(path: str, ndim: int, cfg=None, mesh=None) -> tuple:
    """The reference's ``_axes_for_param`` on its own path and rank."""
    if cfg is not None and mesh is not None:
        msize = axis_sizes(mesh).get("model", 1)
        if _ATTN_Q.search(path):
            ok = cfg.n_heads % msize == 0
            ax = ("tensor", "fsdp") if path.endswith("wo") else ("fsdp", "tensor")
            if not ok:
                ax = (None, "fsdp") if path.endswith("wo") else ("fsdp", None)
            return (None,) * (ndim - len(ax)) + ax[-ndim:]
        if _ATTN_KV.search(path):
            ok = cfg.n_kv_heads % msize == 0
            ax = ("fsdp", "tensor") if ok else ("fsdp", None)
            return (None,) * (ndim - len(ax)) + ax[-ndim:]
        if _RWKV_HEADED.search(path):
            nh = cfg.d_model // max(cfg.rwkv_head_dim, 1)
            ok = nh % msize == 0
            if path.endswith("wo"):
                ax = ("tensor", "fsdp") if ok else (None, "fsdp")
            else:
                ax = ("fsdp", "tensor") if ok else ("fsdp", None)
            return (None,) * (ndim - len(ax)) + ax
    for pat, axes in _PARAM_RULES:
        if re.search(pat, path):
            if len(axes) > ndim:
                axes = axes[-ndim:]
            return (None,) * (ndim - len(axes)) + tuple(axes)
    return (None,) * ndim


def _axes_for_param(name: str, ndim: int, cfg=None, mesh=None) -> tuple:
    """Logical axes of one port parameter: the reference's axes for its
    (stacked) leaf, less the layer axis."""
    path, stacked = reference_path(name, getattr(cfg, "family", None))
    if not stacked:
        return _ref_axes(path, ndim, cfg, mesh)
    return _ref_axes(path, ndim + 1, cfg, mesh)[1:]


def param_logical_axes(params: nn.Module, cfg=None, mesh=None) -> dict:
    """{parameter name: logical-axis tuple} for every parameter of
    ``params`` (an ``LMParams``, a ``WhisperParams`` or a block)."""
    return {n: _axes_for_param(n, p.dim(), cfg, mesh)
            for n, p in params.named_parameters()}


def tree_pspecs(rules: ShardingRules, shapes: dict, axes: dict) -> dict:
    """{name: PartitionSpec tuple} of a {name: tensor} map and its axes."""
    return {n: rules.pspec(tuple(t.shape), axes[n]) for n, t in shapes.items()}


def tree_shardings(rules: ShardingRules, shapes: dict, axes: dict) -> dict:
    """{name: DTensor placements} of a {name: tensor} map and its axes."""
    return {n: rules.placements(tuple(t.shape), axes[n])
            for n, t in shapes.items()}


# ---------------------------------------------------------------------------
# decode-state rules
# ---------------------------------------------------------------------------


def _axes_for_state(path: str, shape: tuple, cfg, mesh) -> tuple:
    ndim = len(shape)
    model = axis_sizes(mesh).get("model", 1)
    if path.endswith("cache_len"):
        return ()
    if re.search(r"(^|/)(k|v|xk|xv)$", path):
        # (L, B, S, Hkv, D) or (B, S, Hkv, D)
        hkv, s = shape[-2], shape[-3]
        lead = (None,) * (ndim - 4)
        if hkv % model == 0:
            return lead + ("batch", None, "kv_heads", None)
        if s % model == 0:
            return lead + ("batch", "kv_seq", None, None)
        return lead + ("batch", None, None, None)
    if path.endswith("wkv"):  # (L,B,H,Dk,Dv)
        h = shape[-3]
        lead = (None,) * (ndim - 4)
        if h % model == 0:
            return lead + ("batch", "kv_heads", None, None)
        return lead + ("batch", None, None, "tensor")
    if re.search(r"shift_(tm|cm)$", path):  # (L,B,d)
        return (None,) * (ndim - 2) + ("batch", "tensor")
    if path.endswith("/h"):  # rglru state (L,B,dr)
        return (None,) * (ndim - 2) + ("batch", "tensor")
    if path.endswith("conv"):  # (L,B,w-1,dr)
        return (None,) * (ndim - 3) + ("batch", None, "tensor")
    return (None,) * ndim


def _path_str(path) -> str:
    parts = []
    for p in path:
        for attr in ("key", "idx", "name"):
            if hasattr(p, attr):
                parts.append(str(getattr(p, attr)))
                break
        else:
            parts.append(str(p))
    return "/".join(parts)


def _with_paths(tree) -> tuple:
    """(["/"-joined path per tensor leaf], leaves, treespec)."""
    flat, spec = pytree.tree_flatten_with_path(tree)
    return [_path_str(p) for p, _ in flat], [v for _, v in flat], spec


def state_logical_axes(state: Any, cfg, mesh) -> Any:
    """A tree of logical-axis tuples matching a decode state (the port's
    lists of per-layer ``KVCache``, ``RGLRUState`` and ``RWKVState``)."""
    paths, leaves, spec = _with_paths(state)
    return pytree.tree_unflatten(
        [_axes_for_state(p, tuple(v.shape), cfg, mesh)
         for p, v in zip(paths, leaves)], spec)


# ---------------------------------------------------------------------------
# batch (input) rules
# ---------------------------------------------------------------------------


def batch_logical_axes(batch: Any) -> Any:
    return pytree.tree_map(lambda leaf: ("batch",) + (None,) * (leaf.dim() - 1),
                           batch)


# ---------------------------------------------------------------------------
# placing tensors
# ---------------------------------------------------------------------------


def _place(t: torch.Tensor, rules: ShardingRules, axes: tuple):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, rules.mesh,
                             rules.placements(tuple(t.shape), axes))


def distribute(tree, rules: ShardingRules, axes) -> Any:
    """Place ``tree`` as DTensors on the rules' mesh.  A module (its
    ``axes`` from :func:`param_logical_axes`) has every parameter replaced
    in place by an ``nn.Parameter`` holding the DTensor, keeping its
    ``requires_grad``, and is returned; any other tree (a batch, a decode
    state; ``axes`` a matching tree of tuples) comes back as the same tree
    of DTensors.  Every rank must pass the same whole tensors."""
    if isinstance(tree, nn.Module):
        for name, p in list(tree.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            mod = tree.get_submodule(owner) if owner else tree
            mod._parameters[leaf] = nn.Parameter(
                _place(p.detach(), rules, axes[name]),
                requires_grad=p.requires_grad)
        return tree
    paths, leaves, spec = _with_paths(tree)
    ax_leaves = pytree.tree_flatten(
        axes, is_leaf=lambda x: isinstance(x, tuple)
        and all(a is None or isinstance(a, str) for a in x))[0]
    return pytree.tree_unflatten(
        [_place(v, rules, a) if isinstance(v, torch.Tensor) else v
         for v, a in zip(leaves, ax_leaves)], spec)
