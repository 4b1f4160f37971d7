"""Port of ``repro/hlo_analysis.py``: the compiled-artifact cost analyzer,
over aten graphs.

The port's counterpart of post-partitioning HLO text is the aten graph: an
FX ``GraphModule`` whose nodes carry ``meta["val"]`` (an exported program's,
or the trace of a train step that :func:`lower` records).  The module
keeps the reference's path so the mirror holds.  A static walk, never a
run, computes per-device totals with the reference's rules:

  * FLOPs are counted for matmul-class and convolution ops only (the
    reference's ``dot``/``convolution``), by ``torch.utils.flop_counter``'s
    formulas, so they equal ``FlopCounterMode`` on the same ops; a
    composite op an exported graph keeps (``matmul``, ``linear``,
    ``einsum``) is run once on meta tensors under ``FlopCounterMode``.
    Each is charged to the precision class it runs in
    (``roofline.matmul_class``);
  * bytes are operand + result bytes for each op that launches; views,
    reshapes and ``getitem`` cost 0 (an op that may alias — ``reshape``,
    ``to``, ``contiguous`` — costs 0 where its result shares its input's
    storage), and an operand counts at most its storage (a broadcast reads
    its source once);
  * a slice or index update costs its slice, not the whole operand (a
    one-token KV-cache update costs one token), and a gather reads what it
    writes;
  * a ``scan`` / ``while_loop`` / ``map`` higher-order op multiplies its
    body by its trip count, and nested multipliers compose — the
    counterpart of ``known_trip_count`` (a ``while_loop`` reads
    ``node.meta["known_trip_count"]``, else counts its body once);
  * collectives (``_c10d_functional``) get ring-model link bytes with their
    group size: all-gather and reduce-scatter carry it as an argument, the
    others name their process group, whose size it is (an all-reduce over
    one axis of a 2-D mesh spans that axis, not the world);
  * a hand-written kernel's node (the substitution engine's adapter) is
    charged the cost its registry variant declares (``adapter.cost``, a
    ``roofline.KernelCost``), FLOPs included — the reference's
    ``custom-call`` rule counts bytes only;
  * ``by_computation`` is keyed by module scope (``nn_module_stack``).

The "compiled artifact" has the reference's interface: :func:`lower`
traces a function into a :class:`Lowered`, whose ``.compile()`` gives a
:class:`Compiled` with ``.memory_analysis()`` (argument, output and
peak-temporary bytes from a liveness walk over the graph's order, each
storage counted once however many views share it), ``.cost_analysis()``
and ``.as_text()``.  A :class:`Lowered` may carry a repeated part
(``repeat=(graph, count)``): the artifact then stands for the base program
plus ``count`` more copies of what the other graph adds to it — a stack of
identical layers traced at one and two layers, the counterpart of the
reference's scan over layers.
"""
from __future__ import annotations

import contextlib
import operator
from dataclasses import dataclass, field, replace
from typing import Any, Optional

import torch
import torch.fx
from torch._higher_order_ops.scan import scan_op
from torch._higher_order_ops.utils import materialize_as_graph
from torch.fx import traceback as fx_traceback
from torch.fx.experimental.proxy_tensor import get_proxy_mode
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch import roofline as rl
from repro_torch.core.trace_lock import TRACE_LOCK
from torch.distributed.tensor import DTensor as _DTensor

__all__ = ["Compiled", "HloCost", "Lowered", "MemoryStats", "analyze_hlo",
           "lower", "memory_analysis"]

_aten = torch.ops.aten

#: functional collectives -> the reference's HLO op names
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
    "collective_permute": "collective-permute",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional")

#: ops that launch nothing
_FREE = {_aten.empty.memory_format, _aten.empty_strided.default,
         _aten.empty_like.default, _aten.sym_size.int,
         _aten.sym_stride.int, _aten.sym_numel.default,
         _aten._assert_async.msg, _aten._assert_scalar.default,
         _aten._assert_tensor_metadata.default, _aten.lift_fresh.default}
#: reads of a slice: the slice read and the result written
_GATHERS = {_aten.index_select.default, _aten.gather.default,
            _aten.index.Tensor, _aten.embedding.default}
#: updates of a slice: (operand index of the update) -> read + write it
_UPDATES = {_aten.slice_scatter.default: 1, _aten.select_scatter.default: 1,
            _aten.index_put.default: 2, _aten.index_put_.default: 2,
            _aten.index_copy.default: 3, _aten.index_copy_.default: 3,
            _aten.scatter.src: 3, _aten.scatter_.src: 3,
            _aten.scatter_add.default: 3, _aten.scatter_add_.default: 3,
            _aten.index_add.default: 3, _aten.index_add_.default: 3,
            _aten.copy_.default: 1, _aten.copy.default: 1}


# ---------------------------------------------------------------------------
# values
# ---------------------------------------------------------------------------


def _int(x) -> int:
    if isinstance(x, torch.SymInt):
        hint = x.node.hint
        if hint is None:
            raise ValueError(f"unbacked size {x} in the graph")
        return int(hint)
    return int(x)


def _tensors(val) -> list:
    return [t for t in pytree.tree_leaves(val) if isinstance(t, torch.Tensor)]


def _storage(t: torch.Tensor) -> tuple:
    """(storage key, storage bytes) of a graph value; a value whose storage
    cannot be read stands alone."""
    try:
        st = t.untyped_storage()
        return st._cdata, _int(st.nbytes())
    except (NotImplementedError, RuntimeError, TypeError):
        return id(t), _logical_bytes(t)


def _logical_bytes(t: torch.Tensor) -> int:
    n = 1
    for s in t.shape:
        n *= _int(s)
    return n * t.element_size()


def _bytes(val) -> int:
    """Bytes a value's tensors span: each its logical size, at most its
    storage's (a broadcast view reads its source once)."""
    total = 0
    for t in _tensors(val):
        total += min(_logical_bytes(t), _storage(t)[1])
    return total


def _val(node) -> Any:
    return node.meta.get("val") if isinstance(node, torch.fx.Node) else None


def _operand_bytes(node: torch.fx.Node) -> int:
    return sum(_bytes(_val(a)) for a in node.all_input_nodes)


def _scope(node: torch.fx.Node, default: str) -> str:
    stack = node.meta.get("nn_module_stack")
    if stack:
        return list(stack.values())[-1][0] or default
    return default


# ---------------------------------------------------------------------------
# costs
# ---------------------------------------------------------------------------


@dataclass
class OpCost:
    flops: float = 0.0
    bytes: float = 0.0
    link_bytes: float = 0.0
    collectives: list = field(default_factory=list)
    flops_by_dtype: dict = field(default_factory=dict)

    def add_flops(self, flops: float, cls: str) -> None:
        self.flops += flops
        self.flops_by_dtype[cls] = self.flops_by_dtype.get(cls, 0.0) + flops


@dataclass
class HloCost:
    flops: float
    bytes: float
    link_bytes: float
    collectives: list            # (op, result_bytes, group, link_bytes, mult)
    by_computation: dict
    flops_by_dtype: dict = field(default_factory=dict)
    uncosted: list = field(default_factory=list)   # adapters without a cost

    def collective_histogram(self) -> dict:
        h: dict = {}
        for op, rb, g, lb, mult in self.collectives:
            k = f"{op}@g{g}"
            e = h.setdefault(k, {"count": 0, "link_bytes": 0.0})
            e["count"] += mult
            e["link_bytes"] += lb * mult
        return h

    def extrapolate(self, step: "HloCost", count: float) -> "HloCost":
        """This program plus ``count`` more copies of what ``step`` adds to
        it (``step`` is this program with one more repeated part)."""
        def lin(a, b):
            return a + count * (b - a)

        def lin_dict(a: dict, b: dict) -> dict:
            return {k: lin(a.get(k, 0.0), b.get(k, 0.0))
                    for k in {**a, **b}}

        def executions(cols: list) -> dict:
            # identical collectives add up: one entry an op, many an op kind
            out: dict = {}
            for op, rb, g, lb, m in cols:
                out[(op, rb, g, lb)] = out.get((op, rb, g, lb), 0.0) + m
            return out

        base, more = executions(self.collectives), executions(step.collectives)
        cols = [(*k, lin(base.get(k, 0.0), more.get(k, 0.0)))
                for k in {**base, **more}]
        by_comp = {}
        for k in {**self.by_computation, **step.by_computation}:
            a = self.by_computation.get(k, {})
            b = step.by_computation.get(k, {})
            by_comp[k] = {f: lin(a.get(f, 0.0), b.get(f, 0.0)) if f != "mult"
                          else max(a.get(f, 0.0), b.get(f, 0.0))
                          for f in ("flops", "bytes", "link_bytes", "mult")}
        return HloCost(lin(self.flops, step.flops),
                       lin(self.bytes, step.bytes),
                       lin(self.link_bytes, step.link_bytes), cols, by_comp,
                       lin_dict(self.flops_by_dtype, step.flops_by_dtype),
                       sorted(set(self.uncosted) | set(step.uncosted)))


class _Uncosted(Exception):
    """A node whose callable declares no cost (a block variant's
    adapter, a Python function)."""


def _ring_bytes(op: str, result_bytes: int, g: int) -> float:
    return rl.CollectiveOp(op, result_bytes, g, "").link_bytes


def _group_size(group_name, n_devices: int) -> int:
    """The size of the process group a functional collective names; the
    whole world when the name resolves to no group of this process (a
    graph traced elsewhere)."""
    import torch.distributed as dist

    if not isinstance(group_name, str) or not dist.is_initialized():
        return n_devices
    try:
        from torch.distributed.distributed_c10d import _resolve_process_group
        return int(_resolve_process_group(group_name).size())
    except (KeyError, ValueError, RuntimeError):
        return n_devices


def _collective(node: torch.fx.Node, name: str, n_devices: int
                ) -> Optional[tuple]:
    """(op, result bytes, group size) of a functional collective, its group
    size read from the group it names (its last argument): an all-reduce
    over a 16-rank ``model`` axis of a 256-rank mesh spans 16 ranks, the
    reference's "true replica-group size"."""
    op = _COLLECTIVES.get(name)
    if op is None:
        return None
    if name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        g = int(node.args[-2])
    else:
        g = _group_size(node.args[-1], n_devices)
    return op, _bytes(_val(node)), g


def _subgraph(gm: torch.fx.GraphModule, arg) -> Optional[torch.fx.GraphModule]:
    if isinstance(arg, torch.fx.Node) and arg.op == "get_attr":
        sub = getattr(gm, arg.target, None)
        if isinstance(sub, torch.fx.GraphModule):
            return sub
    return None


def _children(gm: torch.fx.GraphModule, node: torch.fx.Node) -> list:
    """(subgraph, trip count) of a higher-order op's bodies; trip counts
    come from the shapes (scan, map) or the node's ``known_trip_count``."""
    name = getattr(node.target, "__name__", "")
    if name == "scan":
        xs = node.args[2]
        trip = _int(_val(xs[0]).shape[0]) if xs else 1
        return [(_subgraph(gm, node.args[0]), trip)]
    if name == "map_impl":
        trip = _int(_val(node.args[1][0]).shape[0])
        return [(_subgraph(gm, node.args[0]), trip)]
    if name == "while_loop":
        trip = int(node.meta.get("known_trip_count", 1))
        return [(_subgraph(gm, node.args[0]), trip),
                (_subgraph(gm, node.args[1]), trip)]
    return [(_subgraph(gm, a), 1) for a in pytree.tree_leaves(node.args)]


def _aliases(node: torch.fx.Node) -> bool:
    """Whether a view-annotated op's results share its inputs' storage."""
    ins = {_storage(t)[0] for a in node.all_input_nodes
           for t in _tensors(_val(a))}
    return all(_storage(t)[0] in ins for t in _tensors(_val(node)))


def _composite(op: torch._ops.OpOverload) -> bool:
    return op.namespace == "aten" and \
        torch._C._dispatch_has_kernel_for_dispatch_key(
            op.name(), "CompositeImplicitAutograd")


def _flops(op: torch._ops.OpOverload, args, kwargs, out) -> float:
    """``FlopCounterMode``'s count of one op: its formula, or for a
    composite op one run on meta tensors (which decomposes it)."""
    packet = op.overloadpacket
    if packet in flop_registry:
        return float(flop_registry[packet](*args, **kwargs, out_val=out))
    if not _composite(op) or not _tensors(args):
        return 0.0

    def meta(t):
        return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                   device="meta")

    margs, mkwargs = pytree.tree_map_only(torch.Tensor, meta, (args, kwargs))
    with FlopCounterMode(display=False) as fc:
        op(*margs, **mkwargs)
    return float(fc.get_total_flops())


def _node_cost(gm, node: torch.fx.Node, n_devices: int) -> tuple:
    """Cost of one node + (subgraph, multiplier) children.  A callable
    that is neither an aten op nor a costed adapter raises
    :class:`_Uncosted`."""
    cost = OpCost()
    target = node.target
    if node.op != "call_function" or target is operator.getitem:
        return cost, []
    if isinstance(target, torch._ops.HigherOrderOperator):
        children = [(g, m) for g, m in _children(gm, node) if g is not None]
        if getattr(target, "__name__", "") == "scan":
            # per trip a slice of each xs is read and of each ys written
            cost.bytes += 2 * (sum(_bytes(_val(x)) for x in node.args[2])
                               + _bytes(_val(node)))
        return cost, children
    kcost = getattr(target, "cost", None)
    if isinstance(kcost, rl.KernelCost):          # a hand kernel's adapter
        cls = "tf32" if kcost.matmul and rl.matmul_class(torch.float32) \
            == "tf32" else kcost.dtype
        cost.add_flops(kcost.flops, cls)
        cost.bytes += kcost.bytes
        return cost, []
    if isinstance(target, type):                 # a container of outputs
        return cost, []
    if not isinstance(target, torch._ops.OpOverload):
        raise _Uncosted(node.name)
    ns = target.namespace
    name = target._schema.name.split("::")[-1]
    if ns in _COLLECTIVE_NS:
        coll = _collective(node, name, n_devices)
        if coll is not None:
            op, rb, g = coll
            lb = _ring_bytes(op, rb, g)
            cost.link_bytes += lb
            cost.bytes += rb + _operand_bytes(node)
            cost.collectives.append((op, rb, g, lb))
        return cost, []
    out = _val(node)
    if target in _FREE or not _tensors(out) \
            or (target.is_view and _aliases(node)):
        return cost, []
    args, kwargs = pytree.tree_map_only(
        torch.fx.Node, _val, (node.args, node.kwargs))
    flops = _flops(target, args, kwargs, out)
    if flops:
        first = next(t for t in _tensors(args))
        cost.add_flops(flops, rl.matmul_class(first.dtype))
    if target in _GATHERS:
        cost.bytes += 2 * _bytes(out)
    elif target in _UPDATES:
        i = _UPDATES[target]
        upd = node.args[i] if i < len(node.args) else node
        cost.bytes += 2 * _bytes(_val(upd))
    else:
        cost.bytes += _bytes(out) + _operand_bytes(node)
    return cost, []


def _walk(gm: torch.fx.GraphModule, mult: float, scope: str, n_devices: int,
          totals: OpCost, coll_out: list, by_comp: dict, uncosted: list
          ) -> None:
    for node in gm.graph.nodes:
        try:
            cost, children = _node_cost(gm, node, n_devices)
        except _Uncosted:
            uncosted.append(node.name)
            continue
        key = _scope(node, scope)
        totals.flops += cost.flops * mult
        totals.bytes += cost.bytes * mult
        totals.link_bytes += cost.link_bytes * mult
        for cls, f in cost.flops_by_dtype.items():
            totals.flops_by_dtype[cls] = \
                totals.flops_by_dtype.get(cls, 0.0) + f * mult
        for c in cost.collectives:
            coll_out.append((*c, mult))
        if cost.flops or cost.bytes or cost.link_bytes:
            e = by_comp.setdefault(key, {"flops": 0.0, "bytes": 0.0,
                                         "link_bytes": 0.0, "mult": 0.0})
            e["flops"] += cost.flops * mult
            e["bytes"] += cost.bytes * mult
            e["link_bytes"] += cost.link_bytes * mult
            e["mult"] = max(e["mult"], mult)
        for sub, m in children:
            _walk(sub, mult * m, key, n_devices, totals, coll_out, by_comp,
                  uncosted)


def _graph_module(obj) -> torch.fx.GraphModule:
    if isinstance(obj, torch.fx.GraphModule):
        return obj
    for attr in ("graph_module", "gm"):
        gm = getattr(obj, attr, None)
        if isinstance(gm, torch.fx.GraphModule):
            return gm
    raise TypeError(f"no aten graph in {type(obj).__name__}")


def analyze_hlo(obj, n_devices: int) -> HloCost:
    """Per-device totals of an aten graph: a ``GraphModule``, an exported
    program, a :class:`SubstitutedCallable` (its ``gm``) or a
    :class:`Compiled` artifact."""
    if isinstance(obj, Compiled):
        return obj.hlo_cost(n_devices)
    gm = _graph_module(obj)
    totals, coll_out, by_comp, uncosted = OpCost(), [], {}, []
    _walk(gm, 1.0, "", n_devices, totals, coll_out, by_comp, uncosted)
    return HloCost(totals.flops, totals.bytes, totals.link_bytes, coll_out,
                   by_comp, totals.flops_by_dtype, uncosted)


# ---------------------------------------------------------------------------
# memory: a liveness walk
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MemoryStats:
    """The reference's ``memory_analysis()`` fields, in bytes."""

    argument_size_in_bytes: float = 0
    output_size_in_bytes: float = 0
    temp_size_in_bytes: float = 0
    generated_code_size_in_bytes: float = 0
    alias_size_in_bytes: float = 0

    def extrapolate(self, step: "MemoryStats", count: float) -> "MemoryStats":
        f = lambda a, b: a + count * (b - a)   # noqa: E731
        return MemoryStats(*(f(a, b) for a, b in zip(
            (self.argument_size_in_bytes, self.output_size_in_bytes,
             self.temp_size_in_bytes, self.generated_code_size_in_bytes,
             self.alias_size_in_bytes),
            (step.argument_size_in_bytes, step.output_size_in_bytes,
             step.temp_size_in_bytes, step.generated_code_size_in_bytes,
             step.alias_size_in_bytes))))


def memory_analysis(gm: torch.fx.GraphModule) -> MemoryStats:
    """Argument, output and peak-temporary bytes of one run of ``gm`` in
    its node order.  A storage is live from the first node that produces
    it to the last node that reads any value aliasing it; arguments and
    outputs are live throughout and not counted as temporaries; an output
    that aliases an argument counts once (``alias_size_in_bytes``)."""
    nodes = list(gm.graph.nodes)
    size: dict = {}
    keys_of: dict = {}
    for node in nodes:
        keys = []
        for t in _tensors(_val(node)):
            k, b = _storage(t)
            size[k] = b
            keys.append(k)
        keys_of[node] = keys
    args = {k for n in nodes if n.op == "placeholder" for k in keys_of[n]}
    out_node = nodes[-1] if nodes and nodes[-1].op == "output" else None
    outs = set()
    if out_node is not None:
        for a in pytree.tree_leaves(out_node.args):
            if isinstance(a, torch.fx.Node):
                outs.update(keys_of.get(a, ()))
    aliased = outs & args
    outs -= args
    birth, last = {}, {}
    for i, node in enumerate(nodes):
        for k in keys_of[node]:
            birth.setdefault(k, i)
            last[k] = max(last.get(k, i), i)
        for a in node.all_input_nodes:
            for k in keys_of.get(a, ()):
                last[k] = max(last.get(k, i), i)
    delta = [0] * (len(nodes) + 1)
    for k, b in birth.items():
        if k in args or k in outs:
            continue
        delta[b] += size[k]
        delta[last[k] + 1] -= size[k]
    peak, live = 0, 0
    for i, node in enumerate(nodes):
        live += delta[i]
        transient = 0
        if node.op == "call_function" and isinstance(
                node.target, torch._ops.HigherOrderOperator):
            transient = max((memory_analysis(sub).temp_size_in_bytes
                             for sub, _ in _children(gm, node)
                             if sub is not None), default=0)
        peak = max(peak, live + transient)
    return MemoryStats(sum(size[k] for k in args), sum(size[k] for k in outs),
                       peak, 0, sum(size[k] for k in aliased))


# ---------------------------------------------------------------------------
# the "compiled artifact": lower(...).compile()
# ---------------------------------------------------------------------------


class Compiled:
    """A lowered program's analysable artifact (the counterpart of
    ``jax.stages.Compiled``).  With ``repeat=(step, count)`` it stands for
    ``gm`` plus ``count`` more copies of what ``step`` adds to ``gm``."""

    def __init__(self, gm: torch.fx.GraphModule,
                 repeat: Optional[tuple] = None):
        self.gm = gm
        self.repeat = repeat
        self._cost: dict = {}
        self._memory: Optional[MemoryStats] = None

    def hlo_cost(self, n_devices: int = 1) -> HloCost:
        if n_devices not in self._cost:
            c = analyze_hlo(self.gm, n_devices)
            if self.repeat is not None:
                step, count = self.repeat
                c = c.extrapolate(analyze_hlo(step, n_devices), count)
            self._cost[n_devices] = c
        return self._cost[n_devices]

    def memory_analysis(self) -> MemoryStats:
        if self._memory is None:
            m = memory_analysis(self.gm)
            if self.repeat is not None:
                step, count = self.repeat
                m = m.extrapolate(memory_analysis(step), count)
            self._memory = m
        return self._memory

    def cost_analysis(self) -> dict:
        c = self.hlo_cost(1)
        return {"flops": c.flops, "bytes accessed": c.bytes}

    def as_text(self) -> str:
        text = self.gm.print_readable(print_output=False)
        if self.repeat is not None:
            step, count = self.repeat
            text = (f"# the program below plus {count:g} more copies of "
                    f"what the next one adds to it\n{text}\n"
                    f"{step.print_readable(print_output=False)}")
        return text


@dataclass
class Lowered:
    """A traced program awaiting :meth:`compile` (the counterpart of
    ``jax.stages.Lowered``)."""

    gm: torch.fx.GraphModule
    repeat: Optional[tuple] = None     # (step GraphModule, count)
    _compiled: Optional[Compiled] = field(default=None, init=False,
                                          repr=False, compare=False)

    def compile(self) -> Compiled:
        """The artifact (made once: its analyses are cached on it)."""
        if self._compiled is None:
            self._compiled = Compiled(self.gm, self.repeat)
        return self._compiled

    def as_text(self) -> str:
        return self.compile().as_text()

    def repeated(self, step: "Lowered", count: float) -> "Lowered":
        """This program plus ``count`` more copies of what ``step`` adds."""
        return replace(self, repeat=(step.gm, count))


@contextlib.contextmanager
def _module_scopes(root: Optional[torch.nn.Module], stack: list):
    """Keep ``stack`` the (qualified name, (name, class)) of the
    ``root`` submodules being run (forward hooks), mirrored into FX's
    current node meta as ``nn_module_stack``."""
    names = {m: n for n, m in root.named_modules()} if root is not None \
        else {}

    def sync():
        if stack:
            fx_traceback.current_meta["nn_module_stack"] = dict(stack)
        else:
            fx_traceback.current_meta.pop("nn_module_stack", None)

    def push(mod, args):
        name = names.get(mod)
        if name is not None:
            stack.append((name, (name, type(mod).__qualname__)))
            sync()

    def pop(mod, args, out):
        if names.get(mod) is not None and stack:
            stack.pop()
            sync()

    pre = torch.nn.modules.module.register_module_forward_pre_hook(push)
    post = torch.nn.modules.module.register_module_forward_hook(pop)
    try:
        with fx_traceback.preserve_node_meta():
            yield
    finally:
        pre.remove()
        post.remove()
        stack.clear()
        sync()


class _Recorder(TorchDispatchMode):
    """Records every aten op dispatched under it into an FX graph, each
    node's output as its ``meta["val"]`` (the tensors themselves: meta or
    fake, so views share their base's storage), and the module scope.  A
    tensor is its latest producer's node (an in-place op's node after the
    op); the recorder keeps every tensor it saw alive, so ids stay
    unique."""

    def __init__(self, stack: list):
        super().__init__()
        self.graph = torch.fx.Graph()
        self.root = torch.nn.Module()       # holds the scan bodies
        self.stack = stack
        self.node_of: dict = {}
        self.seen: list = []

    def _track(self, t: torch.Tensor, node: torch.fx.Node) -> None:
        node.meta["val"] = t
        self.node_of[id(t)] = node
        self.seen.append(t)

    def placeholder(self, t, name: str):
        if isinstance(t, _DTensor):
            t = t._local_tensor           # the rank's shard is its argument
        if isinstance(t, torch.Tensor):
            self._track(t, self.graph.placeholder(name))

    def node(self, x):
        if isinstance(x, _DTensor):
            x = x._local_tensor
        if not isinstance(x, torch.Tensor):
            return x
        if id(x) not in self.node_of:      # a tensor made outside the trace
            self.placeholder(x, f"const_{len(self.seen)}")
        return self.node_of[id(x)]

    def scan(self, combine_fn, init, xs, consts) -> list:
        """Record one ``scan`` node: its body a subgraph (``combine_fn``
        itself when autograd's forward or backward scan passes a graph,
        else the callable traced on the first slices), its outputs made
        from one run of the body: the carries as they come, each ys leaf
        stacked over the trip count."""
        first = [x[0] for x in xs]
        if isinstance(combine_fn, torch.fx.GraphModule):
            body = combine_fn
        else:
            with TRACE_LOCK:
                body = materialize_as_graph(combine_fn,
                                            (*init, *first, *consts))
        step = body(*init, *first, *consts)
        trip = xs[0].shape[0]
        out = [torch.empty_like(t) for t in step[:len(init)]] \
            + [t.new_empty((trip, *t.shape)) for t in step[len(init):]]
        name = f"scan_body_{len(self.root._modules)}"
        self.root.add_module(name, body)
        node = self.graph.call_function(scan_op, (
            self.graph.get_attr(name), [self.node(t) for t in init],
            [self.node(x) for x in xs], tuple(self.node(c) for c in consts)))
        if self.stack:
            node.meta["nn_module_stack"] = dict(self.stack)
        node.meta["val"] = out
        for i, t in enumerate(out):
            self._track(t, self.graph.call_function(operator.getitem,
                                                    (node, i)))
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if get_proxy_mode() is not None:
            # torch tracing a scan's body or its joint graph: not the
            # program's ops
            return func(*args, **kwargs)
        if any(issubclass(t, _DTensor) for t in types):
            # a DTensor op: let DTensor run it; the local ops and the
            # collectives it makes come back here, one rank's program
            return NotImplemented
        out = func(*args, **kwargs)
        node = self.graph.call_function(
            func, *pytree.tree_map(self.node, (args, kwargs)))
        if self.stack:
            node.meta["nn_module_stack"] = dict(self.stack)
        if isinstance(out, torch.Tensor):
            self._track(out, node)
        else:
            node.meta["val"] = out
            if isinstance(out, (tuple, list)):
                for i, t in enumerate(out):
                    if isinstance(t, torch.Tensor):
                        self._track(t, self.graph.call_function(
                            operator.getitem, (node, i)))
        return out


@scan_op.py_impl(_Recorder)
def _record_scan(rec: _Recorder, combine_fn, init, xs, consts):
    """The recorder's rule for ``scan``.  A scan that needs gradients
    reaches it twice through autograd: the forward scan of the partitioned
    body, then in the backward the reversed scan of its gradient body; one
    without, once with the body as written.  The rule runs with the
    recorder popped, so the body's own run records nothing."""
    return rec.scan(combine_fn, init, xs, consts)


def lower(fn, *args, scope_root: Optional[torch.nn.Module] = None
          ) -> Lowered:
    """Trace ``fn(*args)`` into an aten graph: meta or fake tensors in, no
    kernel runs, autograd's backward traced where ``fn`` asks for
    gradients, the outputs flattened.  ``fn`` must reach its tensors
    through ``args``.  ``scope_root``'s submodules name the nodes' module
    scopes.

    A dispatch mode records the ops as they run (a quarter of ``make_fx``'s
    time); an op on DTensors is left to DTensor, whose local ops and
    collectives it records, so a sharded program's graph is one rank's,
    with the local shards as its arguments (DTensor's sharding propagation
    also runs ops, on fake tensors, the first time it meets an op's
    shapes: trace such a program once before the trace that counts).  A
    ``scan`` is one node of the recorder's (:func:`_record_scan`), its
    body a subgraph; another higher-order op, which the mode has no rule
    for, raises ``NotImplementedError``."""
    from torch._guards import detect_fake_mode

    stack: list = []
    local = [a._local_tensor if isinstance(a, _DTensor) else a for a in args]
    mode = detect_fake_mode(local)
    rec = _Recorder(stack)
    for i, a in enumerate(args):
        rec.placeholder(a, f"arg_{i}")
    # fake inputs: their mode makes the tensors the program creates fake too
    fake = mode or contextlib.nullcontext()
    with _module_scopes(scope_root, stack), fake, rec:
        out = pytree.tree_leaves(fn(*args))
    rec.graph.output(tuple(rec.node(t) for t in out))
    return Lowered(torch.fx.GraphModule(rec.root, rec.graph))
