"""Port of ``repro/core/frontends/ast_frontend.py``: the Python-``ast``
frontend over PyTorch.

The analysis and the program model carry over unchanged: the same
:class:`RegionGraph` (regions, parents, def/use sets, trip counts and
``ast_vector``\\ s) for the same source.  What changes is the offload side:

  * **The rewrite is np -> torch, without ``.at[].set``.**  Torch takes
    in-place writes, so ``a[i] = v`` and ``a[i] += v`` stay as written; the
    loop gets its own copies (``clone``) of the live-in arrays it writes,
    so it never mutates the executor's hoisted device cache (the reference's
    jitted loop is pure).  The writes the reference cannot functionalize
    (a write through a chained subscript ``a[i][j] = v``, several or tuple
    targets, an augmented write other than ``+=``/``*=``) still fail the
    rewrite, so the same loops leave the gene.
  * **``np.``/``numpy.``/``math.`` map onto :class:`TorchNumpy`**, a small
    explicit numpy-compatible namespace over torch: it creates float32
    tensors on the executor's device (as ``jnp`` creates f32 with x64 off),
    takes Python scalars, and raises ``AttributeError`` on any name it lacks
    (a loop that uses one leaves the gene, as an unknown ``jnp`` name does).
  * **The compiled loop is the rewritten function captured as a CUDA
    graph** (:class:`~repro_torch.core.device_program.CapturedFunction`,
    the reference's ``jax.jit``): captured on its first call for its
    arguments' shapes and dtypes, cached under the loop's key (which holds
    the static range bounds, the reference's static trip counts), and
    replayed after — one host submission where the eager function makes
    one launch per scalar op.  On the CPU it runs eagerly.  So that the
    rewrite captures, a subscript goes through ``tnp.getitem`` /
    ``tnp.setitem``, which select by a 0-d integer tensor (a loop index
    that an enclosing interpreted loop hands over) with ``index_select``
    / ``index_copy_`` on the device where PyTorch reads it on the host,
    and ``tnp`` makes a tensor of a Python scalar with a fill on the
    device, not a copy from the host.
  * **The feasibility check** runs each loop's rewritten function once on
    its calibration snapshot under :class:`_NoConcretization`, a
    ``TorchFunctionMode`` that raises where ``jax.eval_shape`` raises on a
    traced value: ``bool()``/``float()``/``int()``/``__index__`` of a
    tensor, ``.item()``, ``.tolist()``, ``.numpy()``, and the ops whose
    output shape depends on the data (``nonzero``, a boolean mask).  So
    data-dependent Python control flow (``if s > m:``) excludes the loop,
    as in the reference.  (Meta tensors and ``FakeTensorMode`` refuse the
    same, but run an unrolled scalar loop 36x and 240x slower than eager
    torch on the CPU.)
  * **Transfers** go through ``torch.tensor(..., device=dev)`` (float64 ->
    float32, int64 -> int32, as ``jnp.asarray`` with x64 off) and
    ``.cpu().numpy()``; :class:`ExecStats` counts them as the reference
    does, with one repair: each value an interpreted loop gives its target
    is a new version, so a loop offloaded inside it re-uploads the index
    (the reference's hoisting reuses the first one and computes a wrong
    result there).  A host copy is writable (the reference's
    ``np.asarray`` of a jax array is read-only, so an interpreted write
    after an offloaded loop raises there).  The interpreted path stays
    CPython + numpy.
  * **Library adapters** are ``torch.matmul`` and ``torch.fft.fft``; the
    registry-variant menus bind the port's ``fused_torch``/``cuda``
    variants (:mod:`repro_torch.kernels.registry`), so a matched loop nest
    whose gene selects ``gpu_kernel`` runs the hand-written CUDA kernel.

Entry points (:class:`Executor`, :meth:`PyProgram.check_offloadable`, the
frontend) run on ``cuda`` unless the caller passes ``device="cpu"``, and
raise when CUDA is absent.

Python-`ast` frontend (paper §3.3.2 / §4.3.2).

Parses a *numeric* Python function with ``ast`` (exactly the tool the paper
names), extracts its loop statements and per-statement variable def/use sets,
and builds:

  * a :class:`RegionGraph` for the common core (genes, pattern DB, transfer
    planner), and
  * an *executor* that runs the function with any offload pattern: bit 0
    keeps a loop in the CPython interpreter (the paper's CPU path), bit 1
    runs it on the device after an np→torch rewrite (the paper's PyCUDA
    path).

Loops that fail the offload rewrite or its check are excluded from the
gene (paper: エラーが出る for 文は GA の対象外とする).  The executor counts
host↔device transfers and consults the transfer planner to hoist
loop-invariant transfers out of interpreted loops (paper's 一括転送).

Matched loop nests whose pattern has kernel-registry variants additionally
keep their gene over the *variant alphabet*: role inference concretizes the
loop to a :class:`~repro_torch.kernels.registry.CallSite`, the shared
resolver (:mod:`repro_torch.core.variants`) applies each variant's
availability predicate, and the bound adapters become the region's
lib-call menu — gene value k runs implementation k.
"""
from __future__ import annotations

import ast
import inspect
import math
import textwrap
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from repro_torch.core import similarity as sim
from repro_torch.core.device_program import CapturedFunction
from repro_torch.core.frontends.export_frontend import resolve_device
from repro_torch.core.ir import Region, RegionGraph

__all__ = ["AstFrontend", "ExecStats", "Executor", "PyOffloadArtifact",
           "PyProgram", "TorchNumpy", "device_value", "host_value",
           "resolve_block_sites", "resolve_lib_variants"]

# ---------------------------------------------------------------------------
# AST analysis helpers
# ---------------------------------------------------------------------------


def _defs_uses(node: ast.AST) -> tuple[set, set]:
    defs: set = set()
    uses: set = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            if isinstance(n.ctx, ast.Store):
                defs.add(n.id)
            else:
                uses.add(n.id)
        elif isinstance(n, ast.Subscript):
            base = n.value
            while isinstance(base, ast.Subscript):
                base = base.value
            if isinstance(base, ast.Name):
                if isinstance(n.ctx, ast.Store):
                    defs.add(base.id)
                    uses.add(base.id)  # partial write reads the rest
        elif isinstance(n, ast.AugAssign):
            t = n.target
            if isinstance(t, ast.Name):
                uses.add(t.id)
    return defs, uses


def _callees(node: ast.AST) -> tuple:
    out = []
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            name = sim._call_name(n)
            if name:
                out.append(name)
    return tuple(out)


def _static_trip_count(loop: ast.For, consts: dict) -> Optional[int]:
    it = loop.iter
    if isinstance(it, ast.Call) and isinstance(it.func, ast.Name) and it.func.id == "range":
        vals = []
        for a in it.args:
            if isinstance(a, ast.Constant) and isinstance(a.value, int):
                vals.append(a.value)
            elif isinstance(a, ast.Name) and isinstance(consts.get(a.id), int):
                vals.append(consts[a.id])
            else:
                return None
        if len(vals) == 1:
            return vals[0]
        if len(vals) >= 2:
            step = vals[2] if len(vals) == 3 else 1
            return max(0, (vals[1] - vals[0] + step - 1) // step)
    return None


# ---------------------------------------------------------------------------
# host <-> device values
# ---------------------------------------------------------------------------

#: numpy dtypes the device holds narrower, as ``jnp.asarray`` does with x64
#: disabled
_NARROW = {np.dtype(np.float64): torch.float32,
           np.dtype(np.int64): torch.int32,
           np.dtype(np.uint64): torch.int32,
           np.dtype(np.complex128): torch.complex64}


def _device_dtype(value: Any) -> torch.dtype:
    """The dtype ``value`` takes on the device: Python bool/int/float/
    complex as bool/int32/float32/complex64, a numpy dtype narrowed as in
    :data:`_NARROW`."""
    if isinstance(value, torch.Tensor):
        return value.dtype
    if isinstance(value, bool):
        return torch.bool
    if isinstance(value, int):
        return torch.int32
    if isinstance(value, float):
        return torch.float32
    if isinstance(value, complex):
        return torch.complex64
    dt = np.asarray(value).dtype
    return _NARROW.get(dt) or torch.from_numpy(np.zeros((), dt)).dtype


def device_value(value: Any, device: torch.device) -> torch.Tensor:
    """``value`` as a tensor of its own on ``device`` (a copy: the host
    array stays the host's), in :func:`_device_dtype`."""
    if isinstance(value, torch.Tensor):
        return value if value.device == device else value.to(device)
    return torch.tensor(np.asarray(value), dtype=_device_dtype(value),
                        device=device)


def host_value(value: Any) -> Any:
    """A tensor as a numpy array of its own (a 0-d tensor as a 0-d array);
    anything else unchanged."""
    if not isinstance(value, torch.Tensor):
        return value
    hv = value.detach().cpu().numpy()
    # on the CPU ``numpy()`` shares the tensor's memory: interpreted writes
    # to the host array must not reach the device copy the executor caches
    return hv.copy() if value.device.type == "cpu" else hv


# ---------------------------------------------------------------------------
# the numpy-compatible namespace an offloaded loop sees as np / math
# ---------------------------------------------------------------------------


class _FFT:
    def __init__(self, ns: "TorchNumpy"):
        self._ns = ns

    def fft(self, x):
        return torch.fft.fft(self._ns.asarray(x))


class TorchNumpy:
    """``np.X`` / ``math.X`` inside an offloaded loop, over torch on one
    device: the names the repository's numeric programs use.  ``zeros``
    makes float32 tensors there (``jnp`` with x64 off), every function
    takes Python scalars, and a name not defined here raises
    ``AttributeError`` — the loop then leaves the gene, as a name ``jnp``
    lacks does in the reference.  ``torch._numpy`` is not used: it is
    private."""

    pi = math.pi

    def __init__(self, device: torch.device):
        self.device = device
        self.fft = _FFT(self)

    def asarray(self, x):
        if isinstance(x, torch.Tensor):
            return x
        if np.ndim(x) == 0:          # a fill on the device: capturable
            v = x.item() if isinstance(x, (np.generic, np.ndarray)) else x
            return torch.full((), v, dtype=_device_dtype(x),
                              device=self.device)
        return torch.as_tensor(x, dtype=_device_dtype(x), device=self.device)

    # subscripts: the rewrite routes ``a[ix]`` and ``a[ix] = v`` here
    def getitem(self, a, ix):
        p = _tensor_index(a, ix)
        if p is None:
            return a[ix]
        view, d, k, rest = _select_split(a, ix, p)
        out = view.index_select(d, k).squeeze(d)
        return self.getitem(out, (slice(None),) * d + rest) if rest else out

    def setitem(self, a, ix, v) -> None:
        p = _tensor_index(a, ix)
        if p is None:
            a[ix] = v
            return
        view, d, k, rest = _select_split(a, ix, p)
        rows = view.index_select(d, k)
        if rest:
            self.setitem(rows.select(d, 0), (slice(None),) * d + rest, v)
        else:
            rows.select(d, 0)[...] = v
        view.index_copy_(d, k, rows)

    def zeros(self, shape):
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    def zeros_like(self, x):
        return torch.zeros_like(self.asarray(x))

    def exp(self, x):
        return torch.exp(self.asarray(x))

    def sqrt(self, x):
        return torch.sqrt(self.asarray(x))

    def tanh(self, x):
        return torch.tanh(self.asarray(x))

    def sin(self, x):
        return torch.sin(self.asarray(x))

    def cos(self, x):
        return torch.cos(self.asarray(x))

    def abs(self, x):
        return torch.abs(self.asarray(x))

    def matmul(self, a, b):
        return torch.matmul(self.asarray(a), self.asarray(b))


def _tensor_index(a, ix) -> Optional[int]:
    """Where ``ix`` (a subscript of the tensor ``a``) first holds a 0-d
    integer tensor after basic entries only (ints, slices, None), which
    PyTorch would read on the host to select; None where it holds none,
    or the selection is left to PyTorch (an Ellipsis before it)."""
    if not isinstance(a, torch.Tensor):
        return None
    for p, e in enumerate(ix if isinstance(ix, tuple) else (ix,)):
        if isinstance(e, torch.Tensor):
            if e.ndim == 0 and not e.is_floating_point() \
                    and not e.is_complex() and e.dtype != torch.bool:
                return p
            return None
        if e is Ellipsis:
            return None
    return None


def _select_split(a: torch.Tensor, ix, p: int) -> tuple:
    """(``a`` under the basic entries before ``p`` (a view), the dim the
    tensor index selects in it, that index as a 1-element long tensor
    with a negative one wrapped, the entries after ``p``)."""
    ix = ix if isinstance(ix, tuple) else (ix,)
    pre = ix[:p]
    view = a[pre] if pre else a
    d = sum(1 for e in pre if e is None or isinstance(e, slice))
    k = ix[p].reshape(1).long()
    k = torch.where(k < 0, k + view.shape[d], k)
    return view, d, k, ix[p + 1:]


#: the global name the rewrite gives ``np`` / ``numpy`` / ``math``
_NS = "tnp"


def _ns_call(name: str, *args) -> ast.Call:
    return ast.Call(func=ast.Attribute(value=ast.Name(id=_NS, ctx=ast.Load()),
                                       attr=name, ctx=ast.Load()),
                    args=list(args), keywords=[])


def _index_expr(node: ast.AST) -> ast.AST:
    """A subscript's slice as an expression: ``a:b`` -> ``slice(a, b)``."""
    if isinstance(node, ast.Slice):
        none = ast.Constant(value=None)
        return ast.Call(func=ast.Name(id="slice", ctx=ast.Load()),
                        args=[node.lower or none, node.upper or none,
                              node.step or none], keywords=[])
    if isinstance(node, ast.Tuple):
        return ast.Tuple(elts=[_index_expr(e) for e in node.elts],
                         ctx=ast.Load())
    return node


# ---------------------------------------------------------------------------
# np -> torch rewriting (the "language-dependent code generation")
# ---------------------------------------------------------------------------


class _TorchRewriter(ast.NodeTransformer):
    """np.X / math.X -> tnp.X; in-place writes stay in place, recorded in
    ``written``; ``a[ix]`` -> ``tnp.getitem(a, ix)``, ``a[ix] = v`` ->
    ``tnp.setitem(a, ix, v)`` and ``a[ix] += v`` -> ``tnp.setitem(a, ix,
    tnp.getitem(a, ix) + v)``.  Raises :class:`_RewriteError` on exactly
    the writes the reference's functionalization (``a = a.at[i].set(v)``)
    refuses or jax cannot trace, so the same loops leave the gene."""

    def __init__(self):
        self.written: set = set()

    def visit_Name(self, node: ast.Name):
        if node.id in ("np", "numpy", "math"):
            return ast.copy_location(ast.Name(id=_NS, ctx=node.ctx), node)
        return node

    def _subscript_write(self, tgt: ast.Subscript) -> None:
        if not isinstance(tgt.value, ast.Name):
            raise _RewriteError("can only functionalize writes to simple names")
        self.written.add(tgt.value.id)

    def visit_Subscript(self, node: ast.Subscript):
        self.generic_visit(node)
        if isinstance(node.ctx, ast.Load):
            return ast.copy_location(
                _ns_call("getitem", node.value, _index_expr(node.slice)),
                node)
        return node

    def visit_Assign(self, node: ast.Assign):
        self.generic_visit(node)
        if len(node.targets) == 1 and isinstance(node.targets[0], ast.Subscript):
            tgt = node.targets[0]
            self._subscript_write(tgt)
            return ast.copy_location(ast.Expr(value=_ns_call(
                "setitem", tgt.value, _index_expr(tgt.slice), node.value)),
                node)
        elif any(isinstance(n, ast.Subscript) and isinstance(n.ctx, ast.Store)
                 for t in node.targets for n in ast.walk(t)):
            # the reference leaves these unrewritten and jax refuses the
            # in-place write on a traced array
            raise _RewriteError("cannot functionalize a subscript write among "
                                "several targets")
        return node

    def visit_AugAssign(self, node: ast.AugAssign):
        self.generic_visit(node)
        if isinstance(node.target, ast.Subscript):
            if type(node.op).__name__ not in ("Add", "Mult"):
                raise _RewriteError(
                    f"unsupported augmented op {type(node.op).__name__}")
            tgt = node.target
            self._subscript_write(tgt)
            ix = _index_expr(tgt.slice)
            new = ast.BinOp(left=_ns_call("getitem", tgt.value, ix),
                            op=node.op, right=node.value)
            return ast.copy_location(ast.Expr(value=_ns_call(
                "setitem", tgt.value, ix, new)), node)
        return node


class _RewriteError(Exception):
    pass


class _NoConcretization(TorchFunctionMode):
    """Refuse what ``jax.eval_shape`` refuses on a traced value: a tensor's
    value read into Python, or an op whose output shape depends on it."""

    _READS = {torch.Tensor.__bool__, torch.Tensor.__float__,
              torch.Tensor.__int__, torch.Tensor.__index__,
              torch.Tensor.__complex__, torch.Tensor.item,
              torch.Tensor.tolist, torch.Tensor.numpy,
              torch.Tensor.__array__}
    _DATA_SHAPED = {torch.nonzero, torch.Tensor.nonzero, torch.masked_select,
                    torch.Tensor.masked_select, torch.unique,
                    torch.Tensor.unique, torch.argwhere}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self._READS:
            raise RuntimeError(f"concretization of a traced value "
                               f"({func.__name__})")
        if func in self._DATA_SHAPED:
            raise RuntimeError(f"data-dependent output shape "
                               f"({getattr(func, '__name__', func)})")
        if func is torch.Tensor.__getitem__ or func is torch.Tensor.__setitem__:
            index = args[1] if len(args) > 1 else ()
            for ix in (index if isinstance(index, tuple) else (index,)):
                if isinstance(ix, torch.Tensor) and ix.dtype == torch.bool:
                    raise RuntimeError("data-dependent output shape "
                                       "(boolean mask index)")
        return func(*args, **kwargs)


# ---------------------------------------------------------------------------
# program model
# ---------------------------------------------------------------------------


@dataclass
class _Node:
    """Executor tree node: plain statements or a (potentially offloadable) loop."""
    kind: str                       # "stmt" | "loop"
    region: Optional[str]           # region name for loops
    stmts: list = field(default_factory=list)   # ast stmts ("stmt" nodes)
    loop: Optional[ast.For] = None
    body: list = field(default_factory=list)    # child _Nodes ("loop" nodes)


class PyProgram:
    """A parsed numeric Python function, ready for offload search."""

    def __init__(self, fn: Callable | str, name: str = "",
                 consts: Optional[dict] = None):
        src = fn if isinstance(fn, str) else textwrap.dedent(inspect.getsource(fn))
        self.source = src
        tree = ast.parse(src)
        fdefs = [n for n in tree.body if isinstance(n, ast.FunctionDef)]
        assert fdefs, "source must contain a function definition"
        self.fdef: ast.FunctionDef = fdefs[0]
        self.name = name or self.fdef.name
        self.arg_names = [a.arg for a in self.fdef.args.args]
        self.consts = dict(consts or {})
        self.output_names: list[str] = []
        body = self._strip_returns(self.fdef.body)
        self._regions: list[Region] = []
        self._counter = 0
        self.tree_nodes = self._build_nodes(body, depth=0, parent=None)
        self._graph = RegionGraph(self._regions, "python_ast", self.name)
        self._compiled_cache: dict[str, Callable] = {}
        # code-object caches shared by all Executors of this program: the GA
        # re-runs the interpreter once per measurement, and re-`compile()`ing
        # every stmt node / loop-iter expression dominated interp time
        self._stmt_code: dict[str, Any] = {}
        self._iter_code: dict[str, Any] = {}

    def stmt_code(self, node: "_Node"):
        code = self._stmt_code.get(node.region)
        if code is None:
            code = compile(ast.Module(body=node.stmts, type_ignores=[]),
                           f"<interp:{node.region}>", "exec")
            self._stmt_code[node.region] = code
        return code

    def iter_code(self, node: "_Node"):
        code = self._iter_code.get(node.region)
        if code is None:
            code = compile(ast.Expression(node.loop.iter),
                           f"<it:{node.region}>", "eval")
            self._iter_code[node.region] = code
        return code

    def _strip_returns(self, stmts: list) -> list:
        out = []
        for s in stmts:
            if isinstance(s, ast.Return):
                v = s.value
                if isinstance(v, ast.Tuple):
                    self.output_names = [e.id for e in v.elts if isinstance(e, ast.Name)]
                elif isinstance(v, ast.Name):
                    self.output_names = [v.id]
                continue
            out.append(s)
        return out

    # --- region extraction ---------------------------------------------------
    def _build_nodes(self, stmts: list, depth: int, parent: Optional[str]) -> list:
        nodes: list[_Node] = []
        pending: list = []

        def flush():
            nonlocal pending
            if pending:
                name = f"stmt_{self._counter}"
                self._counter += 1
                d, u = set(), set()
                for s in pending:
                    dd, uu = _defs_uses(s)
                    d |= dd
                    u |= uu
                self._regions.append(Region(
                    name=name, kind="stmt", depth=depth, parent=parent,
                    defs=frozenset(d), uses=frozenset(u),
                    callees=tuple(c for s in pending for c in _callees(s)),
                    feature_vector={}, offloadable=False))
                nodes.append(_Node("stmt", name, stmts=list(pending)))
                pending = []

        for s in stmts:
            if isinstance(s, ast.For):
                flush()
                rname = f"loop_{self._counter}"
                self._counter += 1
                d, u = _defs_uses(s)
                region = Region(
                    name=rname, kind="loop", depth=depth, parent=parent,
                    defs=frozenset(d), uses=frozenset(u),
                    callees=_callees(s),
                    feature_vector=sim.ast_vector(s),
                    offloadable=False,  # set by check_offloadable()
                    alternatives=("interp", "jit"),
                    trip_count=_static_trip_count(s, self.consts))
                self._regions.append(region)
                node = _Node("loop", rname, loop=s)
                node.body = self._build_nodes(s.body, depth + 1, rname)
                nodes.append(node)
            else:
                pending.append(s)
        flush()
        return nodes

    @property
    def graph(self) -> RegionGraph:
        return self._graph

    # --- offload feasibility (paper: failing loops leave the gene) -----------
    def check_offloadable(self, example_inputs: dict,
                          device: Any = None) -> list[str]:
        """Interpret the program once to snapshot the live environment at each
        loop entry, then run each loop's rewritten function once against its
        snapshot on ``device`` under :class:`_NoConcretization`; loops that
        error are excluded from the gene (paper §4.2.2)."""
        dev = resolve_device(device)
        snaps: dict[str, dict] = {}
        ex = Executor(self, {}, hoist_transfers=False, device=dev)
        ex.pre_loop_hook = lambda name, env: snaps.setdefault(name, dict(env))
        ex.run(**example_inputs)
        ok = []
        for r in self._graph.loops():
            env = snaps.get(r.name)
            if env is None:
                r.offloadable = False
                r.meta["offload_error"] = "loop never entered during calibration"
                continue
            try:
                node = self._find_loop(r.name)
                fn, live_in, _ = self._compile_loop(node, env, dev)
                with torch.inference_mode(), _NoConcretization():
                    fn.fn(*[device_value(env[v], dev) for v in live_in])
                r.offloadable = True
                ok.append(r.name)
            except Exception as e:  # noqa: BLE001 — any failure disqualifies
                r.offloadable = False
                r.meta["offload_error"] = f"{type(e).__name__}: {e}"[:200]
        return ok

    def _find_loop(self, name: str, nodes: Optional[list] = None) -> _Node:
        for n in (nodes if nodes is not None else self.tree_nodes):
            if n.kind == "loop":
                if n.region == name:
                    return n
                try:
                    return self._find_loop(name, n.body)
                except KeyError:
                    pass
        raise KeyError(name)

    # --- loop compilation ------------------------------------------------------
    @staticmethod
    def _range_names(loop: ast.For) -> set:
        """Names used inside range(...) calls anywhere in the loop subtree —
        these must stay static (Python ints) so trip counts are concrete."""
        names: set = set()
        for n in ast.walk(loop):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                    and n.func.id in ("range", "len"):
                for a in n.args:
                    for nn in ast.walk(a):
                        if isinstance(nn, ast.Name):
                            names.add(nn.id)
        return names

    @staticmethod
    def _loop_targets(loop: ast.For) -> set:
        tgts: set = set()
        for n in ast.walk(loop):
            if isinstance(n, ast.For) and isinstance(n.target, ast.Name):
                tgts.add(n.target.id)
        return tgts

    def _compile_loop(self, node: _Node, env: dict,
                      device: torch.device) -> tuple[Callable, list, list]:
        """Build the device function for one loop.  Returns (fn, live_in,
        live_out); ``fn`` is the rewritten function captured on the card
        (a :class:`~repro_torch.core.device_program.CapturedFunction`; its
        ``fn`` the plain function), the reference's ``jax.jit``.

        Arrays and non-range scalars become arguments (device tensors);
        range/len bounds become closure constants (static trip counts — the
        OpenACC "kernels" region analogue).  The function clones the live-in
        arrays it writes, then runs the rewritten loop and returns the
        variables it assigns.
        """
        region = self._graph.by_name(node.region)
        key = node.region
        loop_src = ast.unparse(node.loop)
        static_names = self._range_names(node.loop)
        targets = self._loop_targets(node.loop)

        static: dict = {}
        live_in: list[str] = []
        for v in sorted((region.uses | region.defs) - targets):
            if v in static_names:
                val = env.get(v, self.consts.get(v))
                if not isinstance(val, (int, np.integer)):
                    raise _RewriteError(f"range bound '{v}' is not a static int")
                static[v] = int(val)
            elif v in env and isinstance(
                    env[v], (np.ndarray, torch.Tensor, int, float, bool,
                             np.number)):
                live_in.append(v)
        live_out = sorted((region.defs - targets) - set(static))
        cache_key = (f"{key}:{hash(loop_src)}:{tuple(sorted(static.items()))}"
                     f":{tuple(live_in)}:{tuple(live_out)}:{device}")
        if cache_key in self._compiled_cache:
            return self._compiled_cache[cache_key], live_in, live_out

        rewriter = _TorchRewriter()
        rewritten = rewriter.visit(ast.parse(loop_src))
        ast.fix_missing_locations(rewritten)
        own = "".join(f"    {v} = {v}.clone()\n"
                      for v in live_in if v in rewriter.written)
        body_src = textwrap.indent(ast.unparse(rewritten), "    ")
        fn_src = (f"def _offload({', '.join(live_in)}):\n"
                  f"{own}{body_src}\n"
                  f"    return ({', '.join(live_out)}{',' if len(live_out) == 1 else ''})\n")
        glb: dict = {_NS: TorchNumpy(device), "range": range, "len": len,
                     "min": min, "max": max, "abs": abs, "float": float,
                     "int": int, "enumerate": enumerate, "zip": zip}
        glb.update(static)
        glb.update({k: v for k, v in self.consts.items()
                    if k not in live_in and k not in glb})
        loc: dict = {}
        exec(compile(ast.parse(fn_src), f"<offload:{key}>", "exec"), glb, loc)  # noqa: S102
        fn = CapturedFunction(loc["_offload"], name=f"offload:{key}")
        self._compiled_cache[cache_key] = fn
        return fn, live_in, live_out


# ---------------------------------------------------------------------------
# executor with transfer accounting
# ---------------------------------------------------------------------------


@dataclass
class ExecStats:
    h2d: int = 0
    d2h: int = 0
    h2d_bytes: int = 0
    d2h_bytes: int = 0
    jit_calls: int = 0
    interp_loops: int = 0


class Executor:
    """Runs a PyProgram under an offload pattern with transfer accounting.

    ``hoist_transfers=True`` enables the paper's batched-transfer
    optimization: device copies of host arrays are cached and only
    re-uploaded when the host version changes (so a loop-invariant array
    transfers once instead of once per iteration).  Offloaded loops and
    library calls run on ``device`` (``cuda`` unless the caller asks for
    the CPU).
    """

    def __init__(self, program: PyProgram, impl: dict[str, str],
                 hoist_transfers: bool = True,
                 globals_env: Optional[dict] = None,
                 lib_calls: Optional[dict] = None,
                 block_sites: Optional[dict] = None,
                 device: Any = None):
        self.p = program
        self.impl = impl
        self.device = resolve_device(device)
        # region -> {impl id: (callable, in_names, out_names)}: the variant
        # menu of library implementations for a matched block.  The legacy
        # single-implementation form (region -> triple) normalizes to a
        # one-entry menu under the historical "lib" id.
        self.lib_calls: dict[str, dict] = {}
        for region, entry in (lib_calls or {}).items():
            self.lib_calls[region] = dict(entry) if isinstance(entry, dict) \
                else {"lib": entry}
        # function-block sites: synthetic region -> its member node regions
        # (adjacent sibling loops).  When the block's gene selects a bound
        # menu variant, the lib call runs once at the first member and the
        # remaining member nodes are skipped — the whole run is replaced.
        self.block_sites: dict[str, tuple] = dict(block_sites or {})
        self._block_first: dict[str, str] = {
            members[0]: bname for bname, members in self.block_sites.items()
            if members}
        self.hoist = hoist_transfers
        self.stats = ExecStats()
        self.globals = {"np": np, "math": math,
                        "range": range, "len": len, "min": min, "max": max,
                        "abs": abs, "float": float, "int": int,
                        "enumerate": enumerate, "zip": zip}
        if globals_env:
            self.globals.update(globals_env)
        self._dev_cache: dict[str, tuple[int, Any]] = {}
        self._ver: dict[str, int] = {}
        self.pre_loop_hook: Optional[Callable[[str, dict], None]] = None

    # --- transfers -------------------------------------------------------------
    def _to_device(self, name: str, env: dict):
        v = env[name]
        if isinstance(v, torch.Tensor):
            return v
        ver = self._ver.get(name, 0)
        if self.hoist and name in self._dev_cache:
            cver, cval = self._dev_cache[name]
            if cver == ver:
                return cval
        dv = device_value(v, self.device)
        self.stats.h2d += 1
        self.stats.h2d_bytes += getattr(v, "nbytes", 8)
        self._dev_cache[name] = (ver, dv)
        return dv

    def _to_host(self, name: str, env: dict):
        v = env[name]
        if isinstance(v, torch.Tensor):
            hv = host_value(v)
            self.stats.d2h += 1
            self.stats.d2h_bytes += hv.nbytes
            env[name] = hv
            self._ver[name] = self._ver.get(name, 0)  # same logical version
            self._dev_cache[name] = (self._ver.get(name, 0), v)
            return hv
        return v

    def _bump(self, names) -> None:
        for n in names:
            self._ver[n] = self._ver.get(n, 0) + 1
            self._dev_cache.pop(n, None) if not self.hoist else None

    # --- execution ------------------------------------------------------------
    def run(self, **inputs) -> dict:
        env = dict(self.p.consts)
        # interpreted statements write arrays IN PLACE (a[i] = v); copy array
        # inputs so repeated measurement runs (and the calibration run before
        # them) start from identical state instead of each other's leftovers
        env.update({k: v.copy() if isinstance(v, np.ndarray) else v
                    for k, v in inputs.items()})
        for name in list(env):
            self._ver[name] = 0
        self._exec_nodes(self.p.tree_nodes, env)
        return env

    def _exec_nodes(self, nodes: list, env: dict) -> None:
        skip: set = set()
        for node in nodes:
            if node.region in skip:
                continue
            blk = self._block_first.get(node.region)
            if blk is not None:
                menu = self.lib_calls.get(blk)
                chosen = self.impl.get(blk)
                if menu and chosen in menu:
                    # active function-block gene: the library implementation
                    # computes the whole run; member nodes are claimed
                    self._exec_lib(node, env, menu[chosen])
                    skip.update(self.block_sites[blk])
                    continue
            if node.kind == "stmt":
                self._exec_stmts(node, env)
            else:
                if self.pre_loop_hook is not None:
                    self.pre_loop_hook(node.region, env)
                menu = self.lib_calls.get(node.region)
                chosen = self.impl.get(node.region)
                if menu and chosen in menu:
                    self._exec_lib(node, env, menu[chosen])
                    continue
                region = self.p.graph.by_name(node.region)
                offload = region.offloadable and self.impl.get(node.region) == "jit"
                if offload:
                    self._exec_offloaded(node, env)
                else:
                    # includes the fallback for a variant that did not bind:
                    # the reference interpreter is the ast "ref" path
                    self._exec_interp_loop(node, env)

    def _exec_stmts(self, node: _Node, env: dict) -> None:
        region = self.p.graph.by_name(node.region)
        for v in region.uses:
            if v in env:
                self._to_host(v, env)
        # fresh namespace per exec: a shared one would leak bindings across
        # regions (stale names resolving instead of NameError) and change
        # the reference interpreter's semantics
        g = dict(self.globals)
        g.update(env)
        exec(self.p.stmt_code(node), g)  # noqa: S102
        for v in region.defs | region.uses:
            if v in g:
                env[v] = g[v]
        self._bump(region.defs)

    def _store(self, env: dict, names: list, outs) -> None:
        """Device results into the environment, each a new version.  A
        Python scalar a loop left untouched becomes a 0-d tensor, as a
        jitted function returns arrays only."""
        for v, o in zip(names, outs):
            o = device_value(o, self.device)
            env[v] = o
            self._ver[v] = self._ver.get(v, 0) + 1
            self._dev_cache[v] = (self._ver[v], o)

    def _exec_offloaded(self, node: _Node, env: dict) -> None:
        fn, live_in, live_out = self.p._compile_loop(node, env, self.device)
        args = [self._to_device(v, env) for v in live_in]
        outs = fn(*args)
        self.stats.jit_calls += 1
        self._store(env, live_out, outs)

    def _exec_lib(self, node: _Node, env: dict, entry: tuple) -> None:
        """Function-block offload: run a device-tuned library implementation
        in place of the matched block (paper §4.2.1)."""
        fn, in_names, out_names = entry
        args = [self._to_device(v, env) for v in in_names]
        outs = fn(*args)
        self.stats.jit_calls += 1
        if not isinstance(outs, (tuple, list)):
            outs = (outs,)
        self._store(env, out_names, outs)

    def _exec_interp_loop(self, node: _Node, env: dict) -> None:
        self.stats.interp_loops += 1
        region = self.p.graph.by_name(node.region)
        loop = node.loop
        for v in region.uses:
            if v in env and not any(
                    ch.kind == "loop" and self.impl.get(ch.region) == "jit"
                    for ch in node.body):
                self._to_host(v, env)
        g = dict(self.globals)
        g.update(env)
        iter_vals = eval(self.p.iter_code(node), g)  # noqa: S307
        tname = loop.target.id if isinstance(loop.target, ast.Name) else None
        for val in iter_vals:
            if tname:
                env[tname] = val
                # each value of the target is a new version: a hoisted
                # device copy of the previous one must not be reused (the
                # reference reuses it, and its nested offloads read a stale
                # index)
                self._bump((tname,))
            self._exec_nodes(node.body, env)

    def outputs(self, env: dict, names: list) -> dict:
        return {n: np.asarray(host_value(env[n])) for n in names}


# ---------------------------------------------------------------------------
# library-call adapters ("CUDA library" substitution, paper §4.2.1)
# ---------------------------------------------------------------------------


def _order_by_appearance(names, source: str) -> list:
    return sorted(names, key=lambda v: source.find(v) if v in source else 1 << 30)


def _adapt_matmul(region, env, source):
    arrays_in = [v for v in region.uses - region.defs
                 if isinstance(env.get(v), np.ndarray) and env[v].ndim == 2]
    outs = [v for v in region.defs
            if isinstance(env.get(v), np.ndarray) and env[v].ndim == 2]
    arrays_in = _order_by_appearance(arrays_in, source)
    if len(arrays_in) != 2 or len(outs) != 1:
        raise ValueError("matmul adapter needs exactly (a, b) -> c")
    return (lambda a, b: torch.matmul(a, b)), arrays_in, outs


def _adapt_fft(region, env, source):
    ins = _order_by_appearance(
        [v for v in region.uses - region.defs
         if isinstance(env.get(v), np.ndarray)], source)
    outs = _order_by_appearance(
        [v for v in region.defs if isinstance(env.get(v), np.ndarray)], source)
    if len(ins) == 2 and len(outs) == 2:    # (re, im) -> (re, im): adapt complex
        def fft2ri(re, im):
            z = torch.fft.fft(torch.complex(re, im))
            return z.real.contiguous(), z.imag.contiguous()
        return fft2ri, ins, outs
    if len(ins) == 1 and len(outs) == 1:
        return (lambda x: torch.abs(torch.fft.fft(x))), ins, outs
    raise ValueError("fft adapter: unsupported interface")


_AST_ADAPTERS: dict[str, Callable] = {
    "matmul": _adapt_matmul,
    "fft": _adapt_fft,
}


# ---------------------------------------------------------------------------
# registry-variant lib-call sites (kernel substitution for the ast path)
# ---------------------------------------------------------------------------
#
# A matched loop nest concretizes to a CallSite the registry's binders
# take: role inference maps the region's live arrays onto the pattern's
# signature — structurally where the loop AST proves the role (q is the
# array rows-indexed by the outer loop variable, log_a the scan input inside
# exp(...)), by in-loop appearance order otherwise — the interface-matching
# step the paper's library substitution performs.  The environment snapshot
# supplies the abstract values, and the shared resolution rule
# (repro_torch.core.variants.resolve_variant) applies every variant's
# availability predicate.  A bound variant becomes one entry of the region's
# lib-call menu; anything role inference or the avals cannot prove (a
# mis-assigned operand, a non-causal attention loop against the causal
# kernels) is caught by the per-measurement verifier, the paper's PCAST
# flow — the chromosome measures invalid and the site stays on its
# reference path.


def _walk_program_order(node: ast.AST):
    """DFS pre-order (ast.walk is BFS, which scrambles appearance order)."""
    yield node
    for child in ast.iter_child_nodes(node):
        yield from _walk_program_order(child)


def _loop_order(loop: ast.AST, names) -> list:
    """`names` by first occurrence as a Name node inside the loop subtree —
    token-exact, unlike substring search over the source."""
    pos: dict[str, int] = {}
    for i, n in enumerate(_walk_program_order(loop)):
        if isinstance(n, ast.Name) and n.id in names and n.id not in pos:
            pos[n.id] = i
    return sorted(names, key=lambda v: pos.get(v, 1 << 30))


def _sub_base(node: ast.AST) -> Optional[str]:
    while isinstance(node, ast.Subscript):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _first_index_names(loop: ast.AST, arr: str) -> set:
    """Name ids used as `arr`'s leading subscript index inside the loop."""
    out: set = set()
    for n in ast.walk(loop):
        if isinstance(n, ast.Subscript) and isinstance(n.value, ast.Name) \
                and n.value.id == arr and isinstance(n.slice, ast.Name):
            out.add(n.slice.id)
    return out


def _mult_partners(loop: ast.AST, arr: str) -> set:
    """Arrays that share a product (BinOp Mult subtree) with `arr`."""
    partners: set = set()
    for n in ast.walk(loop):
        if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Mult):
            arrs = {_sub_base(m) for m in ast.walk(n)
                    if isinstance(m, ast.Subscript)}
            if arr in arrs:
                partners |= arrs - {arr, None}
    return partners


def _used_inside_exp(loop: ast.AST, arr: str) -> bool:
    for n in ast.walk(loop):
        if isinstance(n, ast.Call):
            fname = n.func.attr if isinstance(n.func, ast.Attribute) \
                else getattr(n.func, "id", "")
            if fname == "exp" and any(
                    _sub_base(m) == arr for a in n.args
                    for m in ast.walk(a) if isinstance(m, ast.Subscript)):
                return True
    return False


def _is_array(value: Any) -> bool:
    return isinstance(value, (np.ndarray, torch.Tensor))


def _snapshot_arrays(region, node: "_Node", env: dict, *, read_only: bool,
                     ndim: int) -> list:
    pool = (region.uses - region.defs) if read_only else region.defs
    names = [v for v in pool
             if _is_array(env.get(v)) and env[v].ndim == ndim]
    return _loop_order(node.loop, names)


def _aval_of(value):
    """The site's abstract value: shape and the device dtype (interpreted
    numpy defaults to float64, which the device holds as float32)."""
    from repro_torch.kernels.registry import Aval
    return Aval(tuple(int(s) for s in np.shape(value)), _device_dtype(value))


def _site_attention(region, node, env):
    from repro_torch.kernels.registry import VariantUnavailable
    ins = _snapshot_arrays(region, node, env, read_only=True, ndim=2)
    outs = _snapshot_arrays(region, node, env, read_only=False, ndim=2)
    if len(ins) != 3 or len(outs) != 1:
        raise VariantUnavailable(
            f"attention site needs (q, k, v) -> out arrays, found "
            f"{len(ins)} in / {len(outs)} out")
    # structural roles: q is rows-indexed by the outer loop variable only;
    # k shares the score product with q; v is the remaining operand.  An
    # attention loop the structure cannot prove keeps appearance order
    # (the verifier rejects a wrong assignment at measurement time).
    loop = node.loop
    outer = loop.target.id if isinstance(loop.target, ast.Name) else None
    if outer is not None:
        qs = [a for a in ins if _first_index_names(loop, a) == {outer}]
        rest = [a for a in ins if a not in qs]
        if len(qs) == 1 and len(rest) == 2:
            ks = [a for a in rest if qs[0] in _mult_partners(loop, a)]
            if len(ks) == 1:
                ins = [qs[0], ks[0],
                       rest[0] if rest[1] == ks[0] else rest[1]]
    return ins, outs, "call", {}


def _site_rmsnorm(region, node, env):
    from repro_torch.kernels.registry import VariantUnavailable
    xs = _snapshot_arrays(region, node, env, read_only=True, ndim=2)
    scales = _snapshot_arrays(region, node, env, read_only=True, ndim=1)
    outs = _snapshot_arrays(region, node, env, read_only=False, ndim=2)
    if len(xs) != 1 or len(scales) != 1 or len(outs) != 1:
        raise VariantUnavailable(
            f"rmsnorm site needs (x, scale) -> out arrays, found "
            f"{len(xs)}/{len(scales)} in / {len(outs)} out")
    return [xs[0], scales[0]], outs, "call", {}


def _site_recurrence(region, node, env):
    from repro_torch.kernels.registry import VariantUnavailable
    xs = _snapshot_arrays(region, node, env, read_only=True, ndim=2)
    carries = [v for v in region.uses & region.defs
               if _is_array(env.get(v)) and env[v].ndim == 1]
    ys = [v for v in _snapshot_arrays(region, node, env, read_only=False,
                                      ndim=2) if v not in xs]
    if len(xs) != 2 or len(carries) != 1 or len(ys) != 1:
        raise VariantUnavailable(
            f"recurrence site needs carry + (log_a, b) -> ys, found "
            f"xs={len(xs)} carry={len(carries)} ys={len(ys)}")
    # structural roles: log_a is the xs operand inside exp(...) — the decay
    # coefficient of h = exp(log_a) * h + b; appearance order otherwise
    in_exp = [a for a in xs if _used_inside_exp(node.loop, a)]
    if len(in_exp) == 1:
        xs = [in_exp[0], xs[0] if xs[1] == in_exp[0] else xs[1]]
    h = carries[0]
    # scan-site signature: inputs (carry, xs...), outputs (carry, ys);
    # the adapters serve the final carry from ys[-1]
    params = {"num_consts": 0, "num_carry": 1,
              "length": int(env[xs[0]].shape[0]), "reverse": False}
    return [h] + xs, [h, ys[0]], "scan", params


#: pattern -> (region, env, source) -> (in_names, out_names, kind, params)
_VARIANT_SITE_BUILDERS: dict[str, Callable] = {
    "softmax_attention": _site_attention,
    "rmsnorm": _site_rmsnorm,
    "linear_recurrence": _site_recurrence,
}


def resolve_lib_variants(region, pattern: str, env: dict,
                         program: "PyProgram",
                         registry=None, backend: Optional[str] = None
                         ) -> tuple[dict, dict]:
    """Bind every registry variant of ``pattern`` against the region.

    Returns ``(menu, fallbacks)``: ``menu`` maps bound variant names to
    executor lib-call entries ``(callable, in_names, out_names)``,
    ``fallbacks`` maps refused names to the predicate's reason — the same
    record the export engine keeps, so both frontends report substitution
    the same way.  ``backend`` is the device type the site runs on
    (``"cuda"`` or ``"cpu"``).
    """
    from repro_torch.core.variants import resolve_variant
    from repro_torch.kernels.registry import (CallSite, VariantUnavailable,
                                              default_registry)

    registry = registry or default_registry()
    backend = backend or "cuda"
    builder = _VARIANT_SITE_BUILDERS.get(pattern)
    if builder is None:
        return {}, {"site": f"no ast site builder for pattern {pattern!r}"}
    try:
        node = program._find_loop(region.name)
        in_names, out_names, kind, params = builder(region, node, env)
    except (VariantUnavailable, KeyError) as e:
        return {}, {"site": str(e)}
    site = CallSite(
        pattern=pattern, kind=kind,
        in_avals=tuple(_aval_of(env[v]) for v in in_names),
        out_avals=tuple(_aval_of(env[v]) for v in out_names),
        out_used=(True,) * len(out_names),
        params=params, backend=backend)
    menu: dict[str, tuple] = {}
    fallbacks: dict[str, str] = {}
    for name in registry.variant_names(pattern):
        adapter, chosen, why = resolve_variant(site, name, registry=registry,
                                               backend=backend)
        if adapter is not None:
            menu[chosen] = (adapter, list(in_names), list(out_names))
        else:
            fallbacks[name] = why
    return menu, fallbacks


# ---------------------------------------------------------------------------
# function-block sites (whole-run substitution, arXiv 2004.09883)
# ---------------------------------------------------------------------------
#
# Maximal runs of *adjacent sibling loops* are matched — merged feature
# vectors, merged callees — against the pattern DB's ``block`` records.  An
# accepted run appends one synthetic ``fnblock_*`` region to the graph: an
# extra gene whose accelerated alternatives are the registry's block-level
# variants, and whose activation claims the member loops (decode-level,
# :class:`repro_torch.core.genes.Site`), shrinking the loop-level search to
# the unclaimed remainder.  Role inference here orders the operands
# positionally for the shared binders (a block CallSite without nodes).


def _block_site_attention_stack(members, nodes, program, env, live_after):
    """Order a merged run's arrays as (x, scale, wq, wk, wv) -> (out,)."""
    from repro_torch.kernels.registry import VariantUnavailable

    all_defs = set().union(*(set(r.defs) for r in members))
    free = set().union(*(set(r.uses) for r in members)) - all_defs
    module = ast.Module(body=[n.loop for n in nodes], type_ignores=[])

    def arrays(names, ndim):
        picked = [v for v in names
                  if _is_array(env.get(v)) and env[v].ndim == ndim]
        return _loop_order(module, picked)

    scales = arrays(free, 1)
    mats = arrays(free, 2)
    if len(scales) != 1 or len(mats) != 4:
        raise VariantUnavailable(
            f"attention-stack block needs (x, scale, wq, wk, wv) free "
            f"inputs, found rank1={len(scales)} rank2={len(mats)}")
    xs = [v for v in mats if v in members[0].uses]
    if len(xs) != 1:
        raise VariantUnavailable(
            "cannot identify the residual-stream input of the block")
    outs = arrays(all_defs & live_after, 2)
    if len(outs) != 1:
        raise VariantUnavailable(
            f"attention-stack block must produce one surviving array, "
            f"found {outs}")
    return [xs[0], scales[0]] + [v for v in mats if v != xs[0]], outs


#: block pattern -> (members, nodes, program, env, live_after)
#:              -> (ordered in_names, out_names)
_BLOCK_SITE_BUILDERS: dict[str, Callable] = {
    "attention_stack": _block_site_attention_stack,
}


def _live_after(program: "PyProgram", members) -> set:
    """Names that survive the block: program outputs plus anything read by
    a region outside the run (regions before it cannot read its writes, so
    the over-approximation is harmless)."""
    g = program.graph
    mem = {r.name for r in members}

    def inside(r) -> bool:
        if r.name in mem:
            return True
        p = r.parent
        while p is not None:
            if p in mem:
                return True
            p = g.by_name(p).parent
        return False

    live = set(program.output_names)
    for r in g.regions:
        if not inside(r):
            live |= r.uses
    return live


def resolve_block_sites(program: "PyProgram", db, snaps: dict,
                        registry=None, backend: Optional[str] = None,
                        log: Optional[Callable] = None) -> dict:
    """Detect function-block sites and wire them for the executor.

    Returns ``{fnblock name: {"menu": variant menu, "fallbacks": reasons,
    "members": top-level member regions, "claims": members + descendants}}``
    and appends the synthetic regions to ``program.graph``.  Windows are
    tried widest-first, accepted greedily non-overlapping, and kept only
    when at least one registry variant binds the concrete avals.
    """
    from repro_torch.core.variants import resolve_variant
    from repro_torch.kernels.registry import (CallSite, VariantUnavailable,
                                              default_registry)

    registry = registry or default_registry()
    backend = backend or "cuda"
    log = log or (lambda s: None)
    graph = program.graph

    runs: list[list] = []
    cur: list = []
    for node in program.tree_nodes:
        if node.kind == "loop":
            cur.append(node)
        else:
            if len(cur) >= 2:
                runs.append(cur)
            cur = []
    if len(cur) >= 2:
        runs.append(cur)

    sites: dict[str, dict] = {}
    taken: set = set()
    for run in runs:
        for width in range(len(run), 1, -1):
            for lo in range(len(run) - width + 1):
                nodes = run[lo:lo + width]
                if any(id(n) in taken for n in nodes):
                    continue
                members = [graph.by_name(n.region) for n in nodes]
                m = db.match_block(members, graph.frontend)
                if m is None:
                    continue
                names = registry.variant_names(m.record.name)
                builder = _BLOCK_SITE_BUILDERS.get(m.record.name)
                if not names or builder is None:
                    continue
                env = snaps.get(nodes[0].region)
                if env is None:
                    continue
                try:
                    in_names, out_names = builder(
                        members, nodes, program, env,
                        _live_after(program, members))
                except VariantUnavailable as e:
                    log(f"block run {[r.name for r in members]}: {e}")
                    continue
                site = CallSite(
                    pattern=m.record.name, kind="block",
                    in_avals=tuple(_aval_of(env[v]) for v in in_names),
                    out_avals=tuple(_aval_of(env[v]) for v in out_names),
                    out_used=(True,) * len(out_names), params={},
                    backend=backend)
                menu: dict[str, tuple] = {}
                fails: dict[str, str] = {}
                for nm in names:
                    adapter, chosen, why = resolve_variant(
                        site, nm, registry=registry, backend=backend)
                    if adapter is not None:
                        menu[chosen] = (adapter, list(in_names),
                                        list(out_names))
                    else:
                        fails[nm] = why
                if not menu:
                    log(f"block run {[r.name for r in members]} "
                        f"({m.record.name}): no variant bound: {fails}")
                    continue
                claims = tuple(r.name for r in graph.regions
                               if r in members
                               or _parent_chain_hits(graph, r,
                                                     {x.name for x
                                                      in members}))
                vec: dict = {}
                for r in members:
                    for k, c in r.feature_vector.items():
                        vec[k] = vec.get(k, 0) + c
                bname = f"fnblock_{len(sites)}"
                graph.regions.append(Region(
                    name=bname, kind="block", depth=0, parent=None,
                    defs=frozenset(), uses=frozenset(),
                    callees=tuple(dict.fromkeys(
                        c for r in members for c in r.callees)),
                    feature_vector=vec, offloadable=True,
                    alternatives=("interp",) + tuple(
                        n for n in names if n in menu),
                    meta={"pattern": m.record.name,
                          "pattern_match": {"how": m.how,
                                            "score": round(m.score, 4)},
                          "block_members": claims}))
                sites[bname] = {"menu": menu, "fallbacks": fails,
                                "members": tuple(r.name for r in members),
                                "claims": claims}
                taken.update(id(n) for n in nodes)
    return sites


def _parent_chain_hits(graph, region, names: set) -> bool:
    p = region.parent
    while p is not None:
        if p in names:
            return True
        p = graph.by_name(p).parent
    return False


# ---------------------------------------------------------------------------
# the Frontend adapter (repro_torch.core.frontends.registry protocol)
# ---------------------------------------------------------------------------


@dataclass
class PyOffloadArtifact:
    """The python frontend's deliverable: a program bound to its plan."""

    program: PyProgram
    impl: dict                       # region -> implementation id
    lib_calls: dict                  # region -> variant menu (or the legacy
                                     # (callable, in_names, out_names) triple)
    hoist_transfers: bool = True
    report: Optional[Any] = None     # SubstitutionReport: what runs where
                                     # and why the rest fell back
    block_sites: dict = field(default_factory=dict)  # fnblock -> member nodes
    device: Any = None               # where offloaded code runs (None = cuda)

    def executor(self) -> Executor:
        return Executor(self.program, self.impl,
                        hoist_transfers=self.hoist_transfers,
                        lib_calls=self.lib_calls,
                        block_sites=self.block_sites, device=self.device)

    def run(self, **inputs) -> dict:
        """Execute under the planned pattern; returns the output arrays
        (numpy, on the host)."""
        env = self.executor().run(**inputs)
        names = self.program.output_names or sorted(
            v for v in env if isinstance(env[v], np.ndarray))
        return {n: np.asarray(host_value(env[n])) for n in names}


class AstFrontend:
    """Python-source frontend for the unified pipeline: parse with ``ast``,
    measure with the interpreting Executor (wall clock, PCAST-style
    verification), substitute device libraries for matched blocks.

    Matched blocks with kernel-registry variants stay in the gene and the
    GA selects the implementation (``VARIANT_ALPHABET`` proposed via
    ``FitnessBundle.destinations``); blocks with a single library adapter
    (matmul, fft) keep the legacy measured-combination claim.  Options:
    ``consts`` (the program's constants), ``registry``, ``block_sites``
    (default True)."""

    name = "python_ast"

    def normalize_target(self, target, inputs, config) -> PyProgram:
        if isinstance(target, PyProgram):
            return target
        return PyProgram(target, consts=config.options.get("consts"))

    def build_graph(self, target: PyProgram, inputs, config):
        device = resolve_device(config.device)
        if inputs:
            # interpret once against real inputs; loops that fail the
            # offload rewrite or its check leave the gene (paper §4.2.2)
            target.check_offloadable(inputs, device=device)
        return target.graph

    def make_fitness(self, graph, program: PyProgram, inputs, config):
        import hashlib
        import itertools
        import os
        import platform

        from repro_torch.core.block_offload import block_offload_pass
        from repro_torch.core.fitness import WallClockFitness
        from repro_torch.core.frontends.registry import FitnessBundle
        from repro_torch.core.genes import (VARIANT_ALPHABET,
                                            with_mesh_destinations)
        from repro_torch.core.pattern_db import default_db
        from repro_torch.kernels.registry import default_registry

        device = resolve_device(config.device)
        db = config.db or default_db()
        log = config.log or (lambda s: None)
        inputs = inputs or {}

        # --- calibration: interpret once; snapshots + reference outputs ----
        snaps: dict[str, dict] = {}
        ex0 = Executor(program, {}, hoist_transfers=False, device=device)
        ex0.pre_loop_hook = lambda name, env: snaps.setdefault(name, dict(env))
        env0 = ex0.run(**inputs)
        out_names = program.output_names or sorted(
            v for v in env0 if isinstance(env0[v], (np.ndarray,)))
        reference = {n: np.asarray(env0[n]) for n in out_names}

        # fnblock -> member node regions, filled by block detection below
        # (runner closes over it; the dict is updated in place)
        block_members: dict[str, tuple] = {}

        def runner(impl: dict, lib_calls: dict) -> Callable[[], dict]:
            def run():
                ex = Executor(program, impl,
                              hoist_transfers=config.hoist_transfers,
                              lib_calls=lib_calls,
                              block_sites=block_members, device=device)
                env = ex.run(**inputs)
                return {n: np.asarray(host_value(env[n])) for n in out_names}
            return run

        # one fitness instance for the whole planning run; `build` reads the
        # measurement spec staged by `timed` / the GA fitness below
        _spec: dict = {"impl": {}, "lib": {}}
        wall_fit = WallClockFitness(
            build=lambda bits: runner(_spec["impl"], _spec["lib"]),
            reference_output=reference, repeats=config.repeats)

        def timed(impl: dict, lib_calls: dict):
            _spec["impl"], _spec["lib"] = impl, lib_calls
            return wall_fit(())

        baseline = timed({}, {})
        log(f"baseline (all-interpreted): {baseline.time_s:.4f}s")

        # --- function-block offload first (paper §4.2) ---------------------
        block = block_offload_pass(graph=program.graph, db=db,
                                   confirm=config.confirm)

        # registry-variant sites: a matched block whose pattern has
        # executable kernel-registry variants stays IN the gene with the
        # variant menu as its extra implementations — the GA picks which
        # code runs, and the paper's measure-replacements-on/off step
        # becomes part of the search.
        registry = config.options.get("registry") or default_registry()
        variant_sites: dict[str, dict] = {}
        variant_fallbacks: dict[str, dict] = {}
        candidates = {}
        for bo in block.offloads:
            envs = snaps.get(bo.region)
            if envs is None:
                continue
            region = program.graph.by_name(bo.region)
            names = registry.variant_names(bo.pattern)
            if names and bo.pattern in _VARIANT_SITE_BUILDERS:
                menu, fails = resolve_lib_variants(
                    region, bo.pattern, envs, program, registry=registry,
                    backend=device.type)
                variant_fallbacks[bo.region] = fails
                if menu:
                    variant_sites[bo.region] = menu
                    region.meta["pattern"] = bo.pattern
                    region.meta["pattern_match"] = {"how": bo.how,
                                                    "score": round(bo.score, 4)}
                    # a variant site needs no jit path of its own: the menu
                    # is its accelerated implementation set, the interpreter
                    # its reference — it joins the gene even when the loop
                    # itself failed the offload rewrite
                    region.offloadable = True
                    region.meta.pop("offload_error", None)
                    # only BOUND variants enter the menu: an unbound name in
                    # the gene would decode to a variant label while running
                    # the interpreter — a second, mislabeled measurement of
                    # the gene-0 phenotype that could win on timing noise
                    region.alternatives = ("interp",) + tuple(
                        n for n in names if n in menu)
                    log(f"block {bo.region} ({bo.pattern}): variants "
                        f"{sorted(menu)} join the gene")
                    continue
                log(f"block {bo.region} ({bo.pattern}): no variant bound: "
                    f"{fails}")
            adapter = _AST_ADAPTERS.get(bo.pattern)
            if adapter is None:
                continue
            try:
                candidates[bo.region] = adapter(region, envs, program.source)
            except ValueError as e:
                log(f"block {bo.region} ({bo.pattern}): adapter failed: {e}")

        # function-block sites: runs of adjacent sibling loops whose merged
        # shape matches a block record join the gene as one synthetic
        # region each; an active block gene claims its members at decode
        # time (repro_torch.core.genes) and at execution time (the Executor
        # runs the lib call once and skips the member nodes)
        block_sites: dict[str, dict] = {}
        if config.options.get("block_sites", True):
            block_sites = resolve_block_sites(
                program, db, snaps, registry=registry, backend=device.type,
                log=log)
            for bname, entry in block_sites.items():
                block_members[bname] = entry["members"]
                log(f"function block {bname} "
                    f"({program.graph.by_name(bname).meta['pattern']}): "
                    f"members={list(entry['members'])} variants "
                    f"{sorted(entry['menu'])} join the gene")

        # measure each block and combinations (paper §4.2.1)
        best_lib: dict = {}
        best_time = baseline.time_s
        keys = list(candidates)
        combos = itertools.chain.from_iterable(
            itertools.combinations(keys, r) for r in range(1, len(keys) + 1)) \
            if len(keys) <= 3 else [tuple(keys)] + [(k,) for k in keys]
        for combo in combos:
            lib = {k: candidates[k] for k in combo}
            impl = {k: "lib" for k in combo}
            ev = timed(impl, lib)
            log(f"block combo {combo}: {ev.time_s:.4f}s valid={ev.valid}")
            if ev.valid and ev.time_s < best_time:
                best_time, best_lib = ev.time_s, lib
        block_impl = {k: "lib" for k in best_lib}

        # claimed regions (and their descendants) leave the gene; a variant
        # site keeps its own gene — the GA picks its implementation — but
        # claims its descendants (the nested loops it replaces wholesale)
        claimed = set(best_lib)
        roots = set(best_lib) | set(variant_sites)
        for r in program.graph.regions:
            p_ = r.parent
            while p_ is not None:
                if p_ in roots:
                    claimed.add(r.name)
                    break
                p_ = program.graph.by_name(p_).parent
        claimed = tuple(sorted(claimed))

        # persistent-cache key context: wall-clock measurements are only
        # comparable for the same source, constants, input shapes AND the
        # same machine — timings are not portable between hosts
        shapes = {k: getattr(v, "shape", ()) for k, v in sorted(inputs.items())}
        block_patterns = sorted((bo.region, bo.pattern) for bo in block.offloads
                                if bo.region in best_lib)
        variants_sig = sorted((r, tuple(sorted(m)))
                              for r, m in variant_sites.items())
        variants_sig += sorted((b, tuple(sorted(e["menu"])))
                               for b, e in block_sites.items())
        device_name = torch.cuda.get_device_name(device) \
            if device.type == "cuda" else "cpu"
        cache_extra = (
            f"src={hashlib.sha256(program.source.encode()).hexdigest()[:12]}"
            f"|consts={sorted(program.consts.items())}"
            f"|shapes={sorted(shapes.items())}"
            f"|block={block_patterns}"
            f"|variants={variants_sig}"
            f"|hoist={config.hoist_transfers}|repeats={config.repeats}"
            f"|host={platform.node()}|ncpu={os.cpu_count()}"
            f"|dev={device_name}|wallclock")

        # the full lib-call table: legacy single-implementation claims plus
        # the per-region variant menus the genes select from
        lib_all: dict[str, dict] = {k: {"lib": v} for k, v in best_lib.items()}
        lib_all.update(variant_sites)
        lib_all.update({b: e["menu"] for b, e in block_sites.items()})

        def fitness_factory(coding):
            # a WallClockFitness whose build decodes per call (no shared
            # staging state); Executors are per-run
            def build(values):
                impl = dict(block_impl)
                impl.update(coding.decode(tuple(values)))
                return runner(impl, lib_all)

            return WallClockFitness(build, reference_output=reference,
                                    repeats=config.repeats)

        # no impl_resolver: ast bind results are already folded in at the
        # *menu* level — region.alternatives holds only BOUND variants, so
        # the gene decode itself clamps every chromosome into implementations
        # that run (phenotype dedup needs no extra resolution step here)
        return FitnessBundle(
            fitness_factory=fitness_factory,
            block=block, claimed=claimed, base_impl=block_impl,
            cache_extra=cache_extra, measured=True,
            serial_only=True, overlap_compiles=True,
            # variant sites make the gene an implementation choice, so the
            # frontend proposes the variant alphabet, plus this host's mesh
            # destinations (cost-modeled: mesh_executed stays False, the
            # interpreter never runs a gene on a mesh); plain programs keep
            # the paper's binary interp/jit gene
            destinations=(with_mesh_destinations(VARIANT_ALPHABET)
                          if variant_sites or block_sites else None),
            context={"program": program, "lib_calls": lib_all,
                     "variant_sites": variant_sites,
                     "variant_fallbacks": variant_fallbacks,
                     "block_sites": block_sites,
                     "baseline": baseline, "block_time_s": best_time,
                     "out_names": out_names, "reference": reference,
                     "hoist": config.hoist_transfers, "device": device})

    def apply_plan(self, graph, coding, values, bundle) -> PyOffloadArtifact:
        from repro_torch.core.frontends.registry import decoded_pattern
        from repro_torch.core.variants import (_REF_IMPLS, SubstitutionChoice,
                                               SubstitutionReport)

        impl = decoded_pattern(coding, values, bundle.base_impl)
        blocks = bundle.context.get("block_sites", {})
        menus = dict(bundle.context.get("variant_sites", {}))
        menus.update({b: e["menu"] for b, e in blocks.items()})
        fails = dict(bundle.context.get("variant_fallbacks", {}))
        fails.update({b: e["fallbacks"] for b, e in blocks.items()})
        report = SubstitutionReport()
        for s in coding.sites:
            region = s.region
            req = str(impl.get(region, s.ref_impl))
            pattern = graph.by_name(region).meta.get("pattern")
            if req in _REF_IMPLS:
                report.choices.append(SubstitutionChoice(
                    region, pattern, "ref", "ref", "requested"))
            elif region in menus and req in menus[region]:
                report.choices.append(SubstitutionChoice(
                    region, pattern, req, req, ""))
            elif region in menus:
                why = fails.get(region, {}).get(
                    req, f"variant {req!r} did not bind")
                report.choices.append(SubstitutionChoice(
                    region, pattern, req, "ref", why))
            else:                        # the paper's plain offload path
                report.choices.append(SubstitutionChoice(
                    region, pattern, req, req, ""))
        for region in sorted(bundle.base_impl):
            report.choices.append(SubstitutionChoice(
                region, graph.by_name(region).meta.get("pattern"),
                "lib", "lib", "block-pass claim"))
        bundle.context["substitution_report"] = report
        return PyOffloadArtifact(
            program=bundle.context["program"], impl=impl,
            lib_calls=bundle.context["lib_calls"],
            hoist_transfers=bundle.context.get("hoist", True),
            report=report,
            block_sites={b: e["members"] for b, e in blocks.items()},
            device=bundle.context.get("device"))
