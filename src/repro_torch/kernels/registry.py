"""Port of ``repro/kernels/registry.py`` for the ``softmax_attention``,
``rmsnorm``, ``linear_recurrence`` and ``wkv_recurrence`` patterns and the
``attention_stack`` and ``moe_dispatch`` block patterns: pattern-DB entries
-> executable variants.

Each pattern maps to an ordered set of :class:`Variant`\\ s — ``fused_torch``
(the system's own fused PyTorch rewrite, counterpart of ``fused_jnp``) and
``cuda`` (the hand-written Hopper kernel through
:mod:`repro_torch.kernels.ops`, counterpart of ``pallas``) — that the
substitution engine (:mod:`repro_torch.core.substitution`) splices into an
exported program in place of the matched span.  Registration order is the
reference's, so gene implementation indices map 1:1.

A variant *binds* to a concrete call site: ``Variant.bind(site)`` inspects
the site's shapes and dtypes (from the export graph's ``node.meta["val"]``)
and which outputs are used, and either returns an adapter whose outputs
match the site's, or raises :class:`VariantUnavailable` with the reason —
the substitution report then records the fallback to the reference path.
The ``cuda`` variants reject what their kernels do not take (head dims that
are not multiples of 8 up to 256, dtypes other than f32/bf16, WKV head dims
other than 16/32/64).

Each ``fused_torch`` and ``cuda`` adapter carries ``adapter.cost``, a
:class:`repro_torch.roofline.KernelCost` over the site's input avals with
the kernels' operation and byte counts, so the cost analyzer
(:mod:`repro_torch.hlo_analysis`) charges a substituted program's kernel
nodes without calling them.  A causal ``cuda`` attention counts the pairs
its mask keeps; the ``fused_torch`` rewrite computes every pair with f32
matmuls.

The block patterns bind merged ``block`` sites: an export window (the
export frontend's ``annotate_block_sites``), whose operand roles come from
its FX nodes' dataflow, or a python_ast block, whose operands the frontend
ordered positionally.  ``attention_stack`` (rmsnorm + q/k/v projections +
causal attention over an (S, d) residual stream) has ``block_chunked`` and
``block_fused``; ``moe_dispatch`` (router, top-k, one-hot combine and the
expert FFN over (T, d) tokens) has ``block_scatter``, the capacity-limited
dispatch of :func:`repro_torch.models.moe.moe_scatter` at a capacity that
drops nothing.  All three are PyTorch rewrites and launch no hand kernel.
"""
from __future__ import annotations

import math
import operator
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, NamedTuple, Optional

import torch

from repro_torch import roofline as rl

__all__ = ["Aval", "CallSite", "KernelRegistry", "Variant",
           "VariantUnavailable", "auto_variant_order", "default_registry"]


class VariantUnavailable(Exception):
    """A variant's availability predicate rejected the call site."""


class Aval(NamedTuple):
    """Shape and dtype of one value of the exported graph."""

    shape: tuple
    dtype: torch.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @classmethod
    def of(cls, val: Any) -> "Aval":
        return cls(tuple(int(s) for s in val.shape), val.dtype)


@dataclass(frozen=True)
class CallSite:
    """What a variant binds against: one matched region, concretized.

    ``kind`` is ``"span"`` (a run of ``call_function`` nodes of the export
    graph), ``"scan"`` (a ``scan`` node, or a python_ast recurrence loop),
    ``"call"`` (a python_ast loop nest) or ``"block"`` (a python_ast
    function block); the python_ast frontend orders a site's operands by
    role itself and passes no nodes.  A span's ``in_avals`` follow its
    inputs in first-use order (NOT the module's call order — see
    :func:`_attention_roles`), ``out_avals`` its outputs in graph order; a
    scan's follow the reference's ``[consts..., carry..., xs...]`` in and
    ``[carry..., ys...]`` out, with ``params`` holding ``num_consts``,
    ``num_carry``, ``reverse`` and ``zero_init`` (the initial carry is a
    ``zeros`` node).  ``out_used[i]`` is False when output ``i`` is dropped
    by the program.  ``nodes``/``in_nodes`` are the FX nodes, for
    structural operand-role inference.
    """

    pattern: str
    kind: str
    in_avals: tuple
    out_avals: tuple
    out_used: tuple
    params: Mapping = field(default_factory=dict)
    backend: str = "cpu"
    nodes: tuple = ()
    in_nodes: tuple = ()


@dataclass(frozen=True)
class Variant:
    """One executable implementation of a pattern."""

    pattern: str
    name: str
    bind: Callable[[CallSite], Callable[..., tuple]]
    description: str = ""

    def available(self, site: CallSite) -> bool:
        try:
            self.bind(site)
            return True
        except VariantUnavailable:
            return False


class KernelRegistry:
    """Ordered pattern -> variants store (registration order is the gene
    implementation order ``("ref",) + names``)."""

    def __init__(self) -> None:
        self._by_pattern: dict[str, dict[str, Variant]] = {}

    def register(self, variant: Variant, replace: bool = False) -> None:
        slot = self._by_pattern.setdefault(variant.pattern, {})
        if variant.name in slot and not replace:
            raise ValueError(f"variant {variant.pattern}:{variant.name} "
                             f"already registered")
        slot[variant.name] = variant

    def patterns(self) -> tuple[str, ...]:
        return tuple(self._by_pattern)

    def variants_for(self, pattern: str) -> tuple[Variant, ...]:
        return tuple(self._by_pattern.get(pattern, {}).values())

    def variant_names(self, pattern: str) -> tuple[str, ...]:
        return tuple(self._by_pattern.get(pattern, {}))

    def get(self, pattern: str, name: str) -> Variant:
        try:
            return self._by_pattern[pattern][name]
        except KeyError:
            raise KeyError(
                f"unknown variant {pattern}:{name}; registered for "
                f"{pattern!r}: {self.variant_names(pattern)}") from None


# ---------------------------------------------------------------------------
# binding helpers
# ---------------------------------------------------------------------------

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
#: the matrix-product ops of the (pre-decomposition) export graph
_DOT_OPS = (torch.ops.aten.matmul.default, torch.ops.aten.bmm.default,
            torch.ops.aten.mm.default)
_EINSUM = torch.ops.aten.einsum.default


def _require(cond: bool, why: str) -> None:
    if not cond:
        raise VariantUnavailable(why)


def _floats(avals) -> bool:
    return all(a.dtype.is_floating_point for a in avals)


def _cast(x: torch.Tensor, aval: Aval) -> torch.Tensor:
    return x.to(aval.dtype) if x.dtype != aval.dtype else x


def _costed(fn: Callable, cost: rl.KernelCost) -> Callable:
    """Declare an adapter's work for the cost analyzer."""
    fn.cost = cost
    return fn


def _kernel_adapter(fn: Callable, site: CallSite,
                    cost: rl.KernelCost) -> Callable:
    """Mark an adapter that launches a kernel: it cannot run on meta
    tensors, so it declares its outputs (the site's, which it casts to)
    for :func:`repro_torch.core.variants.check_adapter`, and its cost."""
    fn.out_avals = tuple(a if u else None
                         for a, u in zip(site.out_avals, site.out_used))
    return _costed(fn, cost)


def _rows(aval: Aval) -> int:
    n = 1
    for s in aval.shape[:-1]:
        n *= s
    return n


# ---------------------------------------------------------------------------
# softmax_attention: causal attention block
# ---------------------------------------------------------------------------


def _attention_roles(site: CallSite) -> tuple:
    """Indices of (q, k, v) among the site inputs.

    A span's inputs arrive in first-use order, which need not be the call
    order.  Trace each matrix-product operand back to the unique span input
    it derives from: the first product's lhs is q, its rhs is k, the last
    product's rhs is v.
    """
    if site.kind != "span" or not site.nodes:
        return (0, 1, 2)
    dots = [n for n in site.nodes if n.target in _DOT_OPS]
    _require(len(dots) >= 2, "attention span needs score and output matmuls")
    inputs = set(site.in_nodes)
    span = set(site.nodes)

    def sole_root(node, what: str):
        out, stack, seen = set(), [node], set()
        while stack:
            x = stack.pop()
            if x in seen:
                continue
            seen.add(x)
            if x in inputs:
                out.add(x)
            elif x in span:
                stack.extend(x.all_input_nodes)
        _require(len(out) == 1, f"cannot identify the {what} operand")
        return next(iter(out))

    qn = sole_root(dots[0].args[0], "q")
    kn = sole_root(dots[0].args[1], "k")
    vn = sole_root(dots[-1].args[1], "v")
    _require(len({qn, kn, vn}) == 3, "attention operands are entangled")
    index = {n: i for i, n in enumerate(site.in_nodes)}
    return (index[qn], index[kn], index[vn])


def _attention_site(site: CallSite):
    _require(site.kind in ("span", "call"),
             f"attention binds span/call sites, not {site.kind}")
    _require(len(site.in_avals) == 3, "attention needs exactly (q, k, v)")
    _require(sum(site.out_used) == 1 and len(site.out_avals) >= 1,
             "attention produces one used output")
    roles = _attention_roles(site)
    q, k, v = (site.in_avals[i] for i in roles)
    _require(_floats((q, k, v)), "attention needs floating inputs")
    _require(q.ndim == k.ndim == v.ndim, "q/k/v rank mismatch")
    _require(q.ndim in (2, 4), "attention supports (S,D) or (B,S,H,D)")
    _require(k.shape == v.shape, "k/v shape mismatch")
    _require(q.shape[-1] == k.shape[-1], "q/k head-dim mismatch")
    _require(q.shape[-1] <= 512, "head dim too large for the kernels")
    out = site.out_avals[list(site.out_used).index(True)]
    _require(out.shape == q.shape[:-1] + (v.shape[-1],),
             "output shape is not attention-like")
    if q.ndim == 4:
        _require(q.shape[2] % k.shape[2] == 0, "Hq must be a multiple of Hkv")
        _require(q.shape[0] == k.shape[0], "batch mismatch")
    return q, k, v, out, roles


def _attention_cost(q: Aval, k: Aval, causal: bool) -> rl.KernelCost:
    """Flash attention's counts over (S, D) or (B, S, H, D) operands."""
    if q.ndim == 2:
        return rl.flash_cost(1, q.shape[0], k.shape[0], 1, 1, q.shape[1],
                             causal, q.dtype)
    b, sq, hq, d = q.shape
    return rl.flash_cost(b, sq, k.shape[1], hq, k.shape[2], d, causal,
                         q.dtype)


def _out_tuple(site: CallSite, o: torch.Tensor) -> tuple:
    """The adapter's output tuple: the one used output, None elsewhere."""
    return tuple(o if used else None for used in site.out_used)


def _bind_attention_fused(site: CallSite):
    """GQA attention without materializing the KV-head repeat: query heads
    are grouped under their KV head and broadcast against it; f32 scores,
    softmax and products."""
    q_av, k_av, v_av, out_av, roles = _attention_site(site)
    scale = 1.0 / math.sqrt(q_av.shape[-1])

    def attend(q, k, v):                  # (B,S,H,D) layout
        b, sq, hq, d = q.shape
        sk, hkv = k.shape[1], k.shape[2]
        g = hq // hkv
        qg = q.float().permute(0, 2, 1, 3).reshape(b, hkv, g * sq, d)
        kh = k.float().permute(0, 2, 3, 1)                  # (B,Hkv,D,Sk)
        s = torch.matmul(qg, kh).reshape(b, hkv, g, sq, sk) * scale
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, -1e30)
        p = torch.softmax(s, dim=-1).reshape(b, hkv, g * sq, sk)
        o = torch.matmul(p, v.float().transpose(1, 2))      # (B,Hkv,G*Sq,D)
        return o.reshape(b, hq, sq, -1).transpose(1, 2)

    def fn(*xs):
        q, k, v = (xs[i] for i in roles)
        if q.ndim == 2:
            o = attend(q[None, :, None], k[None, :, None], v[None, :, None])
            o = o[0, :, 0]
        else:
            o = attend(q, k, v)
        return _out_tuple(site, _cast(o, out_av))
    return _costed(fn, _attention_cost(q_av, k_av, causal=False)._replace(
        dtype="f32", matmul=True))


def _bind_attention_cuda(site: CallSite):
    from repro_torch.kernels import ops

    q_av, k_av, v_av, out_av, roles = _attention_site(site)
    d = q_av.shape[-1]
    _require(d % 8 == 0 and 8 <= d <= 256,
             f"cuda flash kernel takes head dims that are multiples of 8 up "
             f"to 256, not {d}")
    _require(q_av.dtype == k_av.dtype == v_av.dtype
             and q_av.dtype in _KERNEL_DTYPES,
             "cuda flash kernel takes f32 or bf16 q/k/v of one dtype")
    if q_av.ndim == 4:
        _require(q_av.shape[0] * q_av.shape[2] <= 65535,
                 "cuda flash kernel takes B*Hq <= 65535")

    def fn(*xs):
        q, k, v = (xs[i] for i in roles)
        if q.ndim == 2:
            o = ops.flash_attention(q[None, :, None], k[None, :, None],
                                    v[None, :, None], causal=True)[0, :, 0]
        else:
            o = ops.flash_attention(q, k, v, causal=True)
        return _out_tuple(site, _cast(o, out_av))
    return _kernel_adapter(fn, site, _attention_cost(q_av, k_av, True))


# ---------------------------------------------------------------------------
# rmsnorm: (x, scale) -> normalized x, (1 + scale) weighting
# ---------------------------------------------------------------------------


def _rmsnorm_site(site: CallSite):
    _require(site.kind in ("span", "call"),
             f"rmsnorm binds span/call sites, not {site.kind}")
    _require(len(site.in_avals) == 2, "rmsnorm needs exactly (x, scale)")
    _require(sum(site.out_used) == 1, "rmsnorm produces one used output")
    a, b = site.in_avals
    x_av, s_av = (a, b) if a.ndim >= b.ndim else (b, a)
    swapped = x_av is b
    _require(_floats((x_av, s_av)), "rmsnorm needs floating inputs")
    _require(s_av.ndim == 1 and x_av.ndim >= 1, "scale must be rank 1")
    _require(x_av.shape[-1] == s_av.shape[0], "scale must match last dim")
    out = site.out_avals[list(site.out_used).index(True)]
    _require(out.shape == x_av.shape, "output must be x-shaped")
    return x_av, s_av, out, swapped


def _rmsnorm_eps(site: CallSite, default: float = 1e-6) -> float:
    """The epsilon the span adds to its mean of squares (the default when
    the span does not show one)."""
    for n in site.nodes:
        if n.target in (torch.ops.aten.add.Tensor, torch.ops.aten.add.Scalar,
                        operator.add) and len(n.args) == 2:
            src, eps = n.args
            if getattr(src, "target", None) is torch.ops.aten.mean.dim \
                    and isinstance(eps, float):
                return eps
    return default


def _bind_rmsnorm_fused(site: CallSite):
    """One fused expression: f32 statistics, ``(1 + scale)`` weighting."""
    x_av, s_av, out_av, swapped = _rmsnorm_site(site)
    eps = _rmsnorm_eps(site)

    def fn(a, b):
        x, s = (b, a) if swapped else (a, b)
        xf = x.float()
        o = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps) \
            * (1.0 + s.float())
        return _out_tuple(site, _cast(o, out_av))
    return _costed(fn, rl.rmsnorm_cost(_rows(x_av), x_av.shape[-1],
                                       x_av.dtype, s_av.dtype))


def _bind_rmsnorm_cuda(site: CallSite):
    from repro_torch.kernels import ops

    x_av, s_av, out_av, swapped = _rmsnorm_site(site)
    _require(x_av.ndim >= 2, "cuda rmsnorm needs a row dimension")
    _require(x_av.shape[-1] % 8 == 0,
             f"cuda rmsnorm takes d a multiple of 8, not {x_av.shape[-1]}")
    _require(x_av.dtype in _KERNEL_DTYPES and s_av.dtype in _KERNEL_DTYPES,
             "cuda rmsnorm takes f32 or bf16")
    eps = _rmsnorm_eps(site)

    def fn(a, b):
        x, s = (b, a) if swapped else (a, b)
        return _out_tuple(site, _cast(ops.rmsnorm(x, s, eps=eps), out_av))
    return _kernel_adapter(fn, site, rl.rmsnorm_cost(
        _rows(x_av), x_av.shape[-1], x_av.dtype, s_av.dtype))


# ---------------------------------------------------------------------------
# linear_recurrence: scan of h = exp(log_a) * h + b, ys = h
# ---------------------------------------------------------------------------


def _recurrence_site(site: CallSite):
    _require(site.kind == "scan", "linear_recurrence binds scan sites")
    _require(site.params.get("num_consts") == 0
             and site.params.get("num_carry") == 1,
             "expected scan(carry, (log_a, b))")
    _require(not site.params.get("reverse"), "reverse scan unsupported")
    _require(len(site.in_avals) == 3, "expected (h0, log_a, b)")
    _require(len(site.out_avals) == 2, "expected (h_final, ys) outputs")
    h0, la, b = site.in_avals
    _require(_floats((h0, la, b)), "needs floating inputs")
    _require(la.shape == b.shape and la.ndim in (2, 3),
             "xs must be equal-shaped (S,D) or (S,B,D)")
    _require(h0.shape == la.shape[1:], "carry must match one timestep")
    ys = site.out_avals[1]
    _require(ys.shape == la.shape, "ys must be xs-shaped")
    return h0, la, b, site.out_avals


def _recurrence_fn(site: CallSite, kernel: Callable):
    """Shared adapter: time-major scan xs -> the (B,S,D) kernels and back.

    ``kernel(log_a, b, h0) -> hs`` over batch-major (B,S,D) views (no copy:
    the wrappers index through strides); the final carry is served from
    ``hs[:, -1]`` (valid because the pattern's ys *is* the carry), so a
    downstream use of the scan's carry output still works.
    """
    h0_av, la_av, _, out_avals = _recurrence_site(site)
    batched = la_av.ndim == 3          # (S,B,D) time-major

    def fn(h0, la, b):
        if batched:
            la_b, b_b, h0_b = la.transpose(0, 1), b.transpose(0, 1), h0
        else:
            la_b, b_b, h0_b = la[None], b[None], h0[None]
        hs = kernel(la_b, b_b, h0_b)
        carry = hs[:, -1] if batched else hs[0, -1]
        ys = hs.transpose(0, 1) if batched else hs[0]
        return (_cast(carry, out_avals[0]) if site.out_used[0] else None,
                _cast(ys, out_avals[1]) if site.out_used[1] else None)
    return fn


def _recurrence_cost(site: CallSite, h0: bool) -> rl.KernelCost:
    la = site.in_avals[1]
    b = la.shape[1] if la.ndim == 3 else 1
    return rl.rglru_cost(b, la.shape[0], la.shape[-1], h0)


def _bind_recurrence_fused(site: CallSite):
    """The step oracle in f32, ``h0`` folded into ``b[:, 0]``."""
    from repro_torch.kernels import ref

    def kernel(la, b, h0):
        b = b.float().clone()          # the scan math is f32 anyway
        b[:, 0] += torch.exp(la[:, 0].float()) * h0
        return ref.rglru_scan_ref(la, b)
    return _costed(_recurrence_fn(site, kernel),
                   _recurrence_cost(site, h0=True))


def _bind_recurrence_cuda(site: CallSite):
    from repro_torch.kernels import ops

    zero_init = bool(site.params.get("zero_init"))

    def kernel(la, b, h0):
        # a zeros initial carry needs no fold into b[:, 0]
        return ops.rglru_scan(la, b, None if zero_init else h0)
    return _kernel_adapter(_recurrence_fn(site, kernel), site,
                           _recurrence_cost(site, h0=not zero_init))


# ---------------------------------------------------------------------------
# wkv_recurrence: scan of the RWKV6 state update with bonus u
# ---------------------------------------------------------------------------


def _wkv_site(site: CallSite):
    _require(site.kind == "scan", "wkv_recurrence binds scan sites")
    _require(site.params.get("num_consts") == 1
             and site.params.get("num_carry") == 1,
             "expected scan(u; state, (r, k, v, log_w))")
    _require(not site.params.get("reverse"), "reverse scan unsupported")
    _require(len(site.in_avals) == 6, "expected (u, s0, r, k, v, log_w)")
    _require(len(site.out_avals) == 2, "expected (s_final, ys) outputs")
    u, s0, r, k, v, lw = site.in_avals
    _require(_floats(site.in_avals), "needs floating inputs")
    _require(r.ndim == 2 and r.shape == k.shape == v.shape == lw.shape,
             "xs must be equal-shaped (S,D)")
    d = r.shape[1]
    _require(u.shape == (d,) and s0.shape == (d, d),
             "bonus (D,) and state (D,D) expected")
    _require(not site.out_used[0],
             "the kernels do not produce the final state")
    _require(bool(site.params.get("zero_init")),
             "the kernels start from a zero state")
    ys = site.out_avals[1]
    _require(ys.shape == r.shape, "ys must be (S,D)")
    return site.out_avals


def _wkv_cost(site: CallSite) -> rl.KernelCost:
    s, d = site.in_avals[2].shape
    return rl.wkv6_cost(1, s, 1, d)


def _bind_wkv_fused(site: CallSite):
    """The step oracle in f32."""
    from repro_torch.kernels import ref

    out_avals = _wkv_site(site)

    def fn(u, s0, r, k, v, lw):
        ys = ref.wkv6_ref(r[None], k[None], v[None], lw[None], u[None, None])
        return (None, _cast(ys[0], out_avals[1]))
    return _costed(fn, _wkv_cost(site))


def _bind_wkv_cuda(site: CallSite):
    from repro_torch.kernels import ops
    from repro_torch.kernels.wkv6 import HEAD_DIMS

    out_avals = _wkv_site(site)
    d = site.in_avals[2].shape[1]
    _require(d in HEAD_DIMS,
             f"cuda wkv6 kernel takes head dims {HEAD_DIMS}, not {d}")

    def fn(u, s0, r, k, v, lw):
        ys = ops.wkv6(r[None, :, None, :], k[None, :, None, :],
                      v[None, :, None, :], lw[None, :, None, :], u[None])
        return (None, _cast(ys[0, :, 0, :], out_avals[1]))
    return _kernel_adapter(fn, site, _wkv_cost(site))


# ---------------------------------------------------------------------------
# block-level variants (function-block offload, arXiv 2004.09883): one
# variant replaces a *merged multi-region window* — the whole algorithm, not
# a single loop.  Block sites arrive with ``kind == "block"``; an export
# block carries every node of its window (``site.nodes``), so the binders
# infer operand roles by dataflow through the FX graph, as the span binders
# do.  A python_ast block carries no nodes: its site builder ordered the
# operands positionally.
# ---------------------------------------------------------------------------


def _dot_operands(node) -> Optional[tuple]:
    """(lhs, rhs) of a two-operand matrix product (``matmul``/``mm``/``bmm``
    or a two-operand ``einsum``), else None."""
    if node.target in _DOT_OPS:
        return node.args[0], node.args[1]
    if node.target is _EINSUM and len(node.args[1]) == 2:
        return tuple(node.args[1])
    return None


def _input_roots(site: CallSite) -> Callable:
    """Dataflow helper: map any node of the site to the set of site inputs
    it derives from (non-raising twin of ``_attention_roles``'s
    ``sole_root``)."""
    inputs = set(site.in_nodes)
    span = set(site.nodes)

    def roots(node) -> frozenset:
        out, stack, seen = set(), [node], set()
        while stack:
            x = stack.pop()
            if not isinstance(x, torch.fx.Node) or x in seen:
                continue
            seen.add(x)
            if x in inputs:
                out.add(x)
            elif x in span:
                stack.extend(x.all_input_nodes)
        return frozenset(out)
    return roots


def _sole_rhs_dots(site: CallSite) -> list:
    """The block's matrix products whose rhs traces back to exactly ONE
    site input: its weight matmuls (score/combine products mix several
    inputs on the rhs and drop out).  Returns [(node, rhs input node), ...]
    in graph order — the program's weight-application order."""
    roots = _input_roots(site)
    out = []
    for n in site.nodes:
        ops = _dot_operands(n)
        if ops is None:
            continue
        rr = roots(ops[1])
        if len(rr) == 1:
            out.append((n, next(iter(rr))))
    return out


def _scan_params(nodes, op, key: str):
    """The argument ``key`` of the first ``op`` node among ``nodes`` (by
    the op's schema: positional or keyword), or None where there is none
    — e.g. ``k`` of an ``aten.topk``."""
    for n in nodes:
        if n.target is not op:
            continue
        names = [a.name for a in op._schema.arguments]
        i = names.index(key)
        if key in n.kwargs:
            return n.kwargs[key]
        if i < len(n.args):
            return n.args[i]
        return op._schema.arguments[i].default_value
    return None


# --- attention_stack: rmsnorm + q/k/v projections + causal attention -------


def _attention_stack_site(site: CallSite):
    _require(site.kind == "block",
             f"attention_stack binds merged block sites, not {site.kind}")
    _require(len(site.in_avals) == 5, "expected (x, scale, wq, wk, wv)")
    _require(sum(site.out_used) == 1,
             "attention stack produces one used output")
    _require(_floats(site.in_avals), "needs floating inputs")
    if site.nodes:
        projs = _sole_rhs_dots(site)
        _require(len(projs) == 3,
                 "expected exactly the q/k/v projection matmuls")
        index = {n: i for i, n in enumerate(site.in_nodes)}
        w_idx = tuple(index[r] for _, r in projs)  # (wq, wk, wv)
        one_d = [i for i, a in enumerate(site.in_avals) if a.ndim == 1]
        _require(len(one_d) == 1, "expected one rank-1 rmsnorm scale")
        rest = set(range(5)) - set(w_idx) - {one_d[0]}
        _require(len(rest) == 1, "cannot identify the residual-stream input")
        roles = (rest.pop(), one_d[0]) + w_idx     # (x, scale, wq, wk, wv)
    else:
        # no nodes (the python_ast frontend): the site builder already
        # ordered the operands positionally; the shape checks below reject
        # a wrong assignment
        roles = (0, 1, 2, 3, 4)
    x_av, s_av, wq_av, wk_av, wv_av = (site.in_avals[i] for i in roles)
    _require(x_av.ndim == 2, "(S, d) residual stream expected")
    _require(s_av.ndim == 1, "expected one rank-1 rmsnorm scale")
    _require(wq_av.shape == wk_av.shape == wv_av.shape and wq_av.ndim == 2,
             "q/k/v projection weight shapes disagree")
    _require(wq_av.shape[0] == x_av.shape[1], "projection d_model mismatch")
    _require(s_av.shape[0] == x_av.shape[1], "scale must match d_model")
    dh = wq_av.shape[1]
    _require(2 <= dh <= 512, "head dim outside kernel range")
    out_av = site.out_avals[list(site.out_used).index(True)]
    _require(out_av.shape == (x_av.shape[0], dh),
             "output is not attention-shaped")
    return x_av, out_av, roles


def _bind_attention_stack_chunked(site: CallSite):
    from repro_torch.kernels import ref
    from repro_torch.models.attention import attend_chunked
    from repro_torch.models.plan import ExecPlan

    x_av, out_av, roles = _attention_stack_site(site)
    plan = ExecPlan(attn_impl="chunked", attn_kv_chunk=128,
                    compute_dtype=str(x_av.dtype).split(".")[-1])

    def fn(*xs):
        x, sc, wq, wk, wv = (xs[i] for i in roles)
        xn = ref.rmsnorm_ref(x, sc)
        q, k, v = xn @ wq, xn @ wk, xn @ wv
        pos = torch.arange(x.shape[0], device=x.device)
        o = attend_chunked(q[None, :, None, :], k[None, :, None, :],
                           v[None, :, None, :], pos, pos, True, 0, plan)
        return _out_tuple(site, _cast(o[0, :, 0, :], out_av))
    return fn


def _bind_attention_stack_fused(site: CallSite):
    from repro_torch.kernels import ref

    x_av, out_av, roles = _attention_stack_site(site)
    scale = 1.0 / math.sqrt(out_av.shape[-1])

    def fn(*xs):
        x, sc, wq, wk, wv = (xs[i] for i in roles)
        xn = ref.rmsnorm_ref(x, sc)
        q, k, v = xn @ wq, xn @ wk, xn @ wv
        o = ref.flash_attention_ref(q[None], k[None], v[None],
                                    causal=True, scale=scale)[0]
        return _out_tuple(site, _cast(o, out_av))
    return fn


# --- moe_dispatch: router + top-k dispatch + batched expert FFN ------------


def _moe_site(site: CallSite):
    _require(site.kind == "block",
             f"moe_dispatch binds merged block sites, not {site.kind}")
    _require(bool(site.nodes), "block site carries no nodes")
    _require(len(site.in_avals) == 5,
             "expected (x, w_router, w_gate, w_up, w_down)")
    _require(sum(site.out_used) == 1, "moe dispatch produces one used output")
    _require(_floats(site.in_avals), "needs floating inputs")
    rank3 = [i for i, a in enumerate(site.in_avals) if a.ndim == 3]
    _require(len(rank3) == 3, "expected three (E,·,·) expert weight stacks")
    index = {n: i for i, n in enumerate(site.in_nodes)}
    # expert weights in application order: gate, up, down
    w_order = [index[r] for _, r in _sole_rhs_dots(site)
               if index[r] in rank3]
    _require(len(w_order) == 3, "cannot order the expert weight matmuls")
    wg_i, wu_i, wd_i = w_order
    rank2 = [i for i, a in enumerate(site.in_avals) if a.ndim == 2]
    _require(len(rank2) == 2, "expected tokens (T,d) and router (d,E)")
    top_k = _scan_params(site.nodes, torch.ops.aten.topk.default, "k")
    _require(top_k is not None, "no top-k routing found in the block")
    # the router weight has E columns; tokens have d columns
    wg_av = site.in_avals[wg_i]
    n_experts, d = wg_av.shape[0], wg_av.shape[1]
    a2, b2 = (site.in_avals[i] for i in rank2)
    if a2.shape[1] == n_experts and b2.shape[1] == d:
        wr_i, x_i = rank2
    else:
        _require(b2.shape[1] == n_experts and a2.shape[1] == d,
                 "cannot tell router weight from token matrix")
        x_i, wr_i = rank2
    roles = (x_i, wr_i, wg_i, wu_i, wd_i)
    x_av = site.in_avals[x_i]
    _require(site.in_avals[wu_i].shape == wg_av.shape,
             "gate/up expert shapes disagree")
    _require(site.in_avals[wd_i].shape == (n_experts, wg_av.shape[2], d),
             "down projection shape mismatch")
    out_av = site.out_avals[list(site.out_used).index(True)]
    _require(out_av.shape == x_av.shape, "moe output must be token-shaped")
    return x_av, out_av, roles, n_experts, int(top_k)


def _bind_moe_scatter(site: CallSite):
    from repro_torch.configs.base import ArchConfig, MoEConfig
    from repro_torch.models.moe import Router, moe_scatter
    from repro_torch.models.plan import ExecPlan

    x_av, out_av, roles, n_experts, top_k = _moe_site(site)
    ff = site.in_avals[roles[2]].shape[2]
    # capacity_factor = E makes the dispatch dropless (cap = T*k), so the
    # scatter route is numerically the dense one-hot reference
    cfg = ArchConfig("block_moe", "moe", d_model=x_av.shape[1],
                     moe=MoEConfig(n_experts=n_experts, top_k=top_k,
                                   d_ff_expert=ff,
                                   capacity_factor=float(n_experts)))
    plan = ExecPlan(moe_impl="scatter_ep",
                    compute_dtype=str(x_av.dtype).split(".")[-1])

    def fn(*xs):
        x, wr, wg, wu, wd = (xs[i] for i in roles)
        params = {"w_gate": wg, "w_up": wu, "w_down": wd}
        out, _aux = moe_scatter(x, params, Router(wr, top_k), cfg, plan)
        return _out_tuple(site, _cast(out, out_av))
    return fn


# ---------------------------------------------------------------------------
# the default registry
# ---------------------------------------------------------------------------

_DEFAULT: Optional[KernelRegistry] = None


def default_registry() -> KernelRegistry:
    """The shipped variants; built once (registration order defines the
    ``("ref", "fused_torch", "cuda")`` gene-implementation order)."""
    global _DEFAULT
    if _DEFAULT is not None:
        return _DEFAULT
    reg = KernelRegistry()
    for pattern, fused, cuda in (
        ("softmax_attention", _bind_attention_fused, _bind_attention_cuda),
        ("rmsnorm", _bind_rmsnorm_fused, _bind_rmsnorm_cuda),
        ("linear_recurrence", _bind_recurrence_fused, _bind_recurrence_cuda),
        ("wkv_recurrence", _bind_wkv_fused, _bind_wkv_cuda),
    ):
        reg.register(Variant(pattern, "fused_torch", fused,
                             "fused PyTorch rewrite"))
        reg.register(Variant(pattern, "cuda", cuda,
                             "hand-written Hopper kernel "
                             "(repro_torch.kernels.ops)"))
    # block-level patterns: whole-algorithm replacements over merged
    # regions.  Registration order is the gene implementation order, so the
    # flash-style chunked route sits at impl_index 1
    reg.register(Variant("attention_stack", "block_chunked",
                         _bind_attention_stack_chunked,
                         "rmsnorm + QKV + flash attention via "
                         "models/attention.attend_chunked"))
    reg.register(Variant("attention_stack", "block_fused",
                         _bind_attention_stack_fused,
                         "rmsnorm + QKV + naive causal attention"))
    reg.register(Variant("moe_dispatch", "block_scatter",
                         _bind_moe_scatter,
                         "capacity-limited scatter dispatch via "
                         "models/moe.moe_scatter"))
    _DEFAULT = reg
    return reg


def auto_variant_order(backend: str) -> tuple[str, ...]:
    """Preference order for the legacy ``"kernel"`` (auto) implementation:
    the CUDA kernels on a CUDA device, the fused rewrites elsewhere (on the
    CPU the kernel wrappers run their plain versions)."""
    return ("cuda", "fused_torch") if backend == "cuda" \
        else ("fused_torch", "cuda")
