"""Port of ``repro/runtime/pspec.py``: logical-axis sharding rules on a
``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh`.

Model code annotates activations with ``constrain(x, "batch", "seq",
None)``.  Outside a rules context, or on a plain tensor, that is the
identity; inside one, on a :class:`~torch.distributed.tensor.DTensor`, it
is ``x.redistribute`` onto the placements the rules give.  The reference
uses its constraints to steer XLA's partitioner; PyTorch is
multi-controller and DTensor propagates placements op by op, so here each
``constrain`` is an actual redistribution (a no-op where the placements
already agree), and it is what keeps DTensor from carrying a ``Partial``
sum into a large activation.

:meth:`ShardingRules.pspec` keeps the reference's rules exactly: a logical
axis keeps the longest prefix of its mesh axes whose size divides the dim,
and each mesh axis is used once.  It returns the reference's
``PartitionSpec`` as a plain tuple (an entry is ``None``, an axis name or a
tuple of names).  :meth:`ShardingRules.placements` turns it into DTensor
placements: ``Shard(d)`` on every mesh dim that tensor dim ``d`` is
sharded over, ``Replicate()`` elsewhere.  A non-divisible dim never reaches
``Shard``: the rules replicate it, as the reference does.

The rules' mesh is a ``DeviceMesh`` (axis sizes from ``mesh_dim_names``
and ``mesh.shape``) or any object whose ``.shape`` is a dict of axis
sizes (the reference tests' ``StubMesh``); the second kind resolves specs
but places nothing.

:func:`local_map` and :func:`shard_map` run a function on each rank's
local shards (``torch.distributed.tensor.experimental.local_map``): the
bodies that have no DTensor sharding strategy — the flash attention's
``autograd.Function``, the ``scan`` recurrences, the MoE's expert-parallel
dispatch — run there with the rules off, as the reference runs them under
``shard_map``.  Inside a body, :func:`axis_all_gather`,
:func:`axis_all_to_all` and :func:`axis_mean` are the reference's
``lax.all_gather``, ``lax.all_to_all``, ``lax.pmean``, ``lax.psum`` and
``lax.axis_index`` over a named mesh axis (:func:`axis_sum` and
:func:`axis_index` serve the port's sharded embedding lookup).  The
reference's ``shard_map_compat`` version switch has no counterpart.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Callable, Optional, Sequence, Union

import torch
from torch.utils import _pytree as pytree

# the APIs this module stands on: a torch without them fails here, loudly
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map as _torch_local_map
import torch.distributed._functional_collectives as funcol

__all__ = ["AxisVal", "ShardingRules", "axis_all_gather", "axis_all_to_all",
           "axis_gather_whole", "axis_index", "axis_max", "axis_mean",
           "axis_names", "axis_rules", "axis_sizes", "axis_sum", "constrain",
           "current_rules", "dense", "dividing_axes", "grad_sum", "local_map",
           "mesh_body", "model_divides", "placements_spec", "shard_map",
           "sharded_over", "spec_placements"]

AxisVal = Union[None, str, tuple]

_STATE = threading.local()


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or of a stub whose ``.shape``
    is that dict already."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names or (), mesh.shape))
    return dict(mesh.shape)


def spec_placements(mesh, spec: Sequence) -> list:
    """DTensor placements of a ``PartitionSpec`` tuple on ``mesh``: for each
    mesh dim, ``Shard(d)`` when tensor dim ``d``'s entry names that axis,
    else ``Replicate()``.  A tensor dim sharded over several mesh axes must
    name them in mesh order (DTensor's order: the first is the major).  A
    mesh dim of size 1 holds the whole tensor: ``Replicate()`` there, the
    same layout, which DTensor's view rules take where they refuse to
    reshape a dim sharded one way (a batch of one)."""
    sizes = axis_sizes(mesh)
    names = list(sizes)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"dim {d} sharded over {axes}, not in the "
                             f"mesh's order {tuple(names)}")
        for p in pos:
            if sizes[names[p]] > 1:
                out[p] = Shard(d)
    return out


def placements_spec(mesh, placements: Sequence, ndim: int) -> tuple:
    """The ``PartitionSpec`` tuple of DTensor placements (the inverse of
    :func:`spec_placements`); a ``Partial`` counts as unsharded."""
    names = list(axis_sizes(mesh))
    parts: list = [[] for _ in range(ndim)]
    for name, p in zip(names, placements):
        if isinstance(p, Shard):
            parts[p.dim % ndim].append(name)
    return tuple(None if not a else (a[0] if len(a) == 1 else tuple(a))
                 for a in parts)


class ShardingRules:
    """logical name -> mesh axis (or tuple of mesh axes)."""

    def __init__(self, mesh, table: dict):
        self.mesh = mesh
        self.table = dict(table)
        self.axis_sizes = axis_sizes(mesh)

    def resolve(self, logical: Optional[str], dim: int) -> AxisVal:
        """Resolve one logical axis to mesh axes, dropping non-divisible
        shards: the longest prefix of its mesh axes that divides ``dim``."""
        if logical is None:
            return None
        axes = self.table.get(logical)
        if axes is None:
            return None
        if isinstance(axes, str):
            axes = (axes,)
        kept: list = []
        size = 1
        for a in axes:
            if a not in self.axis_sizes:
                continue
            nxt = size * self.axis_sizes[a]
            if dim % nxt != 0:
                break
            kept.append(a)
            size = nxt
        if not kept:
            return None
        return tuple(kept) if len(kept) > 1 else kept[0]

    def pspec(self, shape: Sequence[int],
              logical_axes: Sequence[Optional[str]]) -> tuple:
        """The reference's ``PartitionSpec`` as a tuple; a mesh axis appears
        at most once."""
        assert len(shape) == len(logical_axes), (shape, logical_axes)
        used: set = set()
        parts: list = []
        for dim, name in zip(shape, logical_axes):
            r = self.resolve(name, dim)
            if r is not None:
                rt = (r,) if isinstance(r, str) else r
                rt = tuple(a for a in rt if a not in used)
                used.update(rt)
                r = None if not rt else (rt[0] if len(rt) == 1 else rt)
            parts.append(r)
        return tuple(parts)

    def placements(self, shape: Sequence[int],
                   logical_axes: Sequence[Optional[str]]) -> list:
        """DTensor placements of :meth:`pspec` on this rules' mesh."""
        return spec_placements(self.mesh, self.pspec(shape, logical_axes))


@contextlib.contextmanager
def axis_rules(rules: Optional[ShardingRules]):
    prev = getattr(_STATE, "rules", None)
    _STATE.rules = rules
    try:
        yield rules
    finally:
        _STATE.rules = prev


def current_rules() -> Optional[ShardingRules]:
    return getattr(_STATE, "rules", None)


def constrain(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """``x`` redistributed onto the active rules' placements for
    ``logical_axes``; ``x`` itself without rules or when ``x`` is not a
    DTensor."""
    rules = current_rules()
    if rules is None or not isinstance(x, DTensor):
        return x
    want = tuple(rules.placements(x.shape, logical_axes))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def model_divides(n: int) -> bool:
    """Whether the active rules' ``model`` axis divides ``n`` heads (True
    without rules).  Where it does not, a channel shard over ``model``
    cannot be viewed into those heads by DTensor (XLA reshards it
    implicitly), and the models pin the channels whole or split in
    ``local_map`` instead."""
    rules = current_rules()
    return rules is None or n % rules.axis_sizes.get("model", 1) == 0


def dividing_axes(dim: int, candidates=(("pod", "data", "model"),
                                        ("data", "model"), ("pod", "data"),
                                        ("data",), ("model",))) -> tuple:
    """Longest mesh-axis tuple whose size divides ``dim`` (empty if none)."""
    rules = current_rules()
    if rules is None:
        return ()
    sizes = rules.axis_sizes
    for cand in candidates:
        axes = tuple(a for a in cand if a in sizes)
        if not axes:
            continue
        if dim % math.prod(sizes[a] for a in axes) == 0:
            return axes
    return ()


# ---------------------------------------------------------------------------
# local bodies: run a function on each rank's shards
# ---------------------------------------------------------------------------


def _placements_tree(mesh, specs, n: int) -> tuple:
    """One placement list (or None for a non-tensor) per flat leaf."""
    if len(specs) != n:
        raise ValueError(f"{len(specs)} specs for {n} values")
    return tuple(None if s is None else tuple(spec_placements(mesh, s))
                 for s in specs)


@contextlib.contextmanager
def mesh_body(mesh: DeviceMesh):
    """The context of a local body on ``mesh``: its axes are named by the
    collectives below, and no rules are active."""
    prev = getattr(_STATE, "local_mesh", None)
    _STATE.local_mesh = mesh
    try:
        with axis_rules(None):
            yield mesh
    finally:
        _STATE.local_mesh = prev


class _SumGrad(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the named
    axes' ranks (:func:`grad_sum`)."""

    @staticmethod
    def forward(ctx, x, axes):
        ctx.groups = [_group(a) for a in axes]    # the backward runs outside
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        for grp in ctx.groups:
            g = funcol.wait_tensor(funcol.all_reduce(g.contiguous(), "sum",
                                                     grp))
        return g, None


def grad_sum(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """``x`` itself, its gradient summed over ``axes``' ranks: inside a
    local body, a value each rank of those axes holds whole but uses for
    its own share of the work only (its rows of a batch, its columns, its
    chunks), so each rank's gradient of it is a part of the whole one."""
    axes = tuple(a for a in ((axes,) if isinstance(axes, str) else axes)
                 if _axis_size(a) > 1)
    if not axes or not (isinstance(x, torch.Tensor) and x.requires_grad):
        return x
    return _SumGrad.apply(x, axes)


def shard_map(fn: Callable, *, mesh: DeviceMesh, in_specs: Sequence,
              out_specs: Any, grad_sums: Optional[Sequence] = None
              ) -> Callable:
    """``fn`` run on each rank's shards of its inputs over ``mesh``: the
    reference's ``shard_map``.  ``in_specs`` has one ``PartitionSpec``
    tuple per (flat) input, ``None`` for a non-tensor; ``out_specs`` is one
    such tuple for a body that returns one tensor, or a list of them, one
    per output, for a body that returns a tuple.  A plain-tensor input is
    taken as replicated (each rank holds the whole), so its sharding is a
    local slice; the outputs are DTensors.  Inside ``fn`` the mesh's axes
    are named by :func:`axis_all_gather` and its kin, and no rules are
    active.  An input's gradient takes its placements: a replicated one is
    each rank's own, whole.  ``grad_sums`` (one entry per flat input: axis
    names, or None) sums an input's gradient over axes it is replicated on
    but the body's work on it is split over (:func:`grad_sum`)."""
    multi = isinstance(out_specs, list)
    # one output's placements are a list; several are a tuple of them
    out_pl = (tuple(list(spec_placements(mesh, s)) for s in out_specs)
              if multi else list(spec_placements(mesh, out_specs)))

    def body(*local):
        with mesh_body(mesh):
            if grad_sums is not None:
                flat, tree = pytree.tree_flatten(local)
                flat = [grad_sum(t, ax) if ax else t
                        for t, ax in zip(flat, grad_sums)]
                local = pytree.tree_unflatten(flat, tree)
            return fn(*local)

    def run(*args):
        flat, tree = pytree.tree_flatten(args)
        in_pl = _placements_tree(mesh, tuple(in_specs), len(flat))
        flat = [DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
                if isinstance(a, torch.Tensor) and not isinstance(a, DTensor)
                and p is not None else a for a, p in zip(flat, in_pl)]
        wrapped = _torch_local_map(
            body, out_placements=out_pl, in_placements=in_pl,
            device_mesh=mesh, redistribute_inputs=True)
        return wrapped(*pytree.tree_unflatten(flat, tree))

    return run


def local_map(fn: Callable, in_specs: Sequence, out_specs: Any, *args,
              grad_sums: Optional[Sequence] = None):
    """:func:`shard_map` of ``fn`` under the active rules' mesh, applied to
    ``args``; ``fn(*args)`` itself without rules."""
    rules = current_rules()
    if rules is None:
        return fn(*args)
    return shard_map(fn, mesh=rules.mesh, in_specs=in_specs,
                     out_specs=out_specs, grad_sums=grad_sums)(*args)


def axis_names(entry: AxisVal) -> tuple:
    """The mesh axes of one ``PartitionSpec`` entry (or a resolved logical
    axis): ``()``, ``(name,)`` or the tuple itself."""
    return () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))


def sharded_over(t: torch.Tensor, dim: int, axis: str) -> bool:
    """Whether DTensor ``t``'s dim ``dim`` is sharded over mesh axis
    ``axis`` (False for a plain tensor)."""
    return isinstance(t, DTensor) and axis in axis_names(placements_spec(
        t.device_mesh, t.placements, t.dim())[dim])


def dense(x: torch.Tensor, w: torch.Tensor, *, cols: bool = False,
          rows: bool = False) -> torch.Tensor:
    """``x @ w`` (x (B, ..., K), w (..., K, N)) laid out under the active
    rules as the reference's XLA partitioner lays out a projection: rows
    on the rank's batch shard, and over ``model``

    * the output columns where ``w``'s columns are sharded over it, or
      where ``cols`` asks for them (the consumer splits its channels over
      ``model``: the reference's constraint or ``shard_map`` in_specs) and
      ``w``'s rows are not sharded;
    * the contraction, summed over ``model``, where ``w``'s rows are
      sharded (over ``model``, or over the batch axes: XLA moves that shard
      onto ``model`` rather than gathering the weight), or where ``rows``
      says the reference pins ``x``'s channels over ``model``;
    * nothing otherwise: each rank computes every column of its rows.

    A weight's shard over the batch axes is gathered (FSDP).  DTensor's own
    strategy would split a replicated weight's rows over ``model`` for
    free, a split the reference's program lacks, and picks its layout by a
    cost that moves with the sizes and the torch version; the body in
    :func:`local_map` fixes the layout.  ``x @ w`` itself without rules or
    with a ``model`` axis of one rank."""
    rules = current_rules()
    m = rules.axis_sizes.get("model", 1) if rules is not None else 1
    if m == 1 or not (isinstance(x, DTensor) or isinstance(w, DTensor)):
        return x @ w
    k, n = w.shape[-2], w.shape[-1]
    wk = (placements_spec(w.device_mesh, w.placements, w.dim())[-2]
          if isinstance(w, DTensor) else None)
    if sharded_over(w, -1, "model"):
        mode = "cols"
    elif (wk is not None or rows) and k % m == 0:
        mode = "rows"
    elif cols and n % m == 0:
        mode = "cols"
    else:
        mode = "whole"
    bax = rules.resolve("batch", x.shape[0])
    lead = (bax,) + (None,) * (x.dim() - 2)
    wlead = (None,) * (w.dim() - 2)
    xs = lead + ("model" if mode == "rows" else None,)
    ws = wlead + {"cols": (None, "model"), "rows": ("model", None),
                  "whole": (None, None)}[mode]
    out = lead + ("model" if mode == "cols" else None,)
    # x, whole over model, feeds its columns only; w, whole over the batch
    # axes, the rank's rows only
    sums = (("model",) if mode == "cols" else None, axis_names(bax))
    if mode == "rows":
        return local_map(lambda a, b: axis_sum(a @ b, "model"), (xs, ws),
                         out, x, w, grad_sums=sums)
    return local_map(lambda a, b: a @ b, (xs, ws), out, x, w,
                     grad_sums=sums)


# ---------------------------------------------------------------------------
# collectives over a named axis, inside a local body
# ---------------------------------------------------------------------------


def _group(axis: str):
    mesh = getattr(_STATE, "local_mesh", None)
    if mesh is None:
        raise RuntimeError(f"axis {axis!r} named outside a shard_map body")
    return mesh.get_group(axis)


def _axis_size(axis: str) -> int:
    return _group(axis).size()


def axis_all_gather(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """``lax.all_gather(x, axis, axis=dim, tiled=True)``, differentiable
    (the backward reduce-scatters: each rank's gradient of the gathered
    value is a part of the whole one)."""
    if _axis_size(axis) == 1:
        return x
    return funcol.all_gather_tensor_autograd(x.contiguous(), dim,
                                             _group(axis))


class _GatherWhole(torch.autograd.Function):
    """All-gather along ``dim``; the backward keeps this rank's slice of
    the gradient, which every rank holds whole."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        grp = _group(axis)
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.index = axis_index(axis)
        return funcol.wait_tensor(funcol.all_gather_tensor(
            x.detach().contiguous(), dim, grp))

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None


def axis_gather_whole(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """:func:`axis_all_gather` of a value that leaves the body replicated
    over ``axis`` (an output placed whole there): its gradient comes the
    same on every rank, so the backward takes this rank's slice of it
    where a reduce-scatter would count it once a rank."""
    if _axis_size(axis) == 1:
        return x
    return _GatherWhole.apply(x, axis, dim)


def axis_all_to_all(x: torch.Tensor, axis: str, split_dim: int,
                    concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``,
    differentiable: ``x`` splits into the axis size's parts along
    ``split_dim``, part j goes to the axis' rank j, and the parts received
    concatenate along ``concat_dim`` in rank order."""
    n = _axis_size(axis)
    if n == 1:
        return x
    xs = x.movedim(split_dim, 0).contiguous()
    got = funcol.all_to_all_single_autograd(xs, None, None, _group(axis))
    # (n received parts, part, *rest) -> the part back at split_dim, then
    # the rank axis merged, major, into concat_dim
    got = got.reshape(n, xs.shape[0] // n, *xs.shape[1:])
    got = got.movedim(1, split_dim + 1).movedim(0, concat_dim)
    shape = list(got.shape)
    shape[concat_dim:concat_dim + 2] = [shape[concat_dim]
                                        * shape[concat_dim + 1]]
    return got.reshape(shape)


def _all_reduce(x: torch.Tensor, op: str, axis: str) -> torch.Tensor:
    """A functional all-reduce over one axis (what a graph records, with
    its group), waited on."""
    return funcol.wait_tensor(funcol.all_reduce(x.detach().contiguous(), op,
                                                _group(axis)))


def axis_index(axis: str) -> int:
    """``lax.axis_index(axis)``: this rank's coordinate on the axis."""
    mesh = getattr(_STATE, "local_mesh", None)
    if mesh is None:
        raise RuntimeError(f"axis {axis!r} named outside a shard_map body")
    return mesh.get_local_rank(axis)


class _AllReduceSum(torch.autograd.Function):
    """The sum over one axis' ranks of a value each rank holds a part of;
    the (replicated) upstream gradient is each part's gradient."""

    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, "sum", axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def axis_sum(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """``lax.psum(x, axes)`` of partial values, one all-reduce per axis."""
    for a in ((axes,) if isinstance(axes, str) else tuple(axes)):
        if _axis_size(a) > 1:
            x = _AllReduceSum.apply(x, a)
    return x


def axis_max(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """``lax.pmax(x, axes)`` (no gradient)."""
    out = x.detach()
    for a in ((axes,) if isinstance(axes, str) else tuple(axes)):
        if _axis_size(a) > 1:
            out = _all_reduce(out, "max", a)
    return out


class _AllReduceMean(torch.autograd.Function):
    """The mean over one axis' ranks; its gradient is the (replicated)
    upstream gradient over the axis size, as each rank's share of the
    mean is."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.n = _axis_size(axis)
        return _all_reduce(x, "sum", axis) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def axis_mean(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """``lax.pmean(x, axes)``: the mean over every named axis' ranks (one
    all-reduce per axis; equal group sizes make the mean of means the
    mean)."""
    for a in ((axes,) if isinstance(axes, str) else tuple(axes)):
        if _axis_size(a) > 1:
            x = _AllReduceMean.apply(x, a)
    return x
