"""Port of ``repro/core/similarity.py``: ``ast_vector`` carries over
unchanged; ``export_vector`` counts aten op names of a ``torch.export``
graph where the reference counts jaxpr primitives.

Deckard-style structural similarity (paper §3.2.2: 類似性検出ツール).

Deckard (ICSE'07) maps AST subtrees to *characteristic vectors* of node-type
counts and clusters near vectors.  We retarget the exact algorithm at our two
IRs:

  * Python ``ast`` subtrees  -> counts of ast node types      (CloneDigger role)
  * ``torch.export`` graphs  -> counts of aten op names      (Deckard role)

Similarity = cosine between count vectors; a match needs similarity >= the
pattern's threshold.  This catches "copied then modified" implementations
that exact name matching misses — e.g. a hand-written softmax-attention with
an extra mask still matches the flash-attention pattern at ~0.9.
"""
from __future__ import annotations

import ast as pyast
from collections import Counter
from typing import Any, Callable

import numpy as np


# ---------------------------------------------------------------------------
# characteristic vectors
# ---------------------------------------------------------------------------


_CALL_WEIGHT = 6   # call identities discriminate far better than node types


def ast_vector(node: pyast.AST) -> dict[str, int]:
    """Characteristic vector over a Python AST subtree.

    Features: node-type counts, weighted call names (cos/exp/dot identify a
    block much more strongly than generic loop scaffolding), binary-op kinds,
    and a loop-nesting histogram (Deckard's stratified vectors analogue).
    """
    counts: Counter = Counter()

    def walk(n: pyast.AST, loop_depth: int) -> None:
        counts[type(n).__name__] += 1
        if isinstance(n, pyast.Call):
            name = _call_name(n)
            if name:
                counts[f"call:{name.split('.')[-1]}"] += _CALL_WEIGHT
        if isinstance(n, pyast.BinOp):
            counts[f"op:{type(n.op).__name__}"] += 1
        d = loop_depth
        if isinstance(n, (pyast.For, pyast.While)):
            counts[f"nest:{loop_depth}"] += 2
            d += 1
        for c in pyast.iter_child_nodes(n):
            walk(c, d)

    walk(node, 0)
    return dict(counts)


def _call_name(node: pyast.Call) -> str:
    f = node.func
    parts: list[str] = []
    while isinstance(f, pyast.Attribute):
        parts.append(f.attr)
        f = f.value
    if isinstance(f, pyast.Name):
        parts.append(f.id)
    return ".".join(reversed(parts))


#: dtype plumbing and trace bookkeeping, not structure: counting these would
#: make the same block in bf16 look unlike its f32 comparison code.
_IGNORED_OPS = {"_assert_tensor_metadata", "to", "_to_copy"}


def _op_name(target: Any) -> str:
    """Short aten op name of an FX call target (``aten.softmax.int`` ->
    ``softmax``); plain callables give their ``__name__``."""
    name = getattr(target, "__name__", str(target))
    # OpOverload names read "softmax.int"; the overload is not structure
    return name.split(".")[0]


def is_scan(node: Any) -> bool:
    """True for the ``scan`` higher-order-op node of an exported graph."""
    import torch

    return node.op == "call_function" \
        and node.target is torch.ops.higher_order.scan


def scan_body(node: Any):
    """The combine ``GraphModule`` of a ``scan`` node: its first argument
    is a ``get_attr`` of the owning graph module."""
    return getattr(node.graph.owning_module, node.args[0].target)


def export_vector(graph_module_or_nodes: Any) -> dict[str, int]:
    """Characteristic vector over a ``torch.export`` graph (or a list of its
    nodes): counts of aten op names of the ``call_function`` nodes — the
    export frontend's counterpart of the reference's ``jaxpr_vector``.  A
    ``scan`` node counts as its combine graph's ops plus one ``scan``, as
    a jaxpr ``scan`` equation does in the reference."""
    nodes = graph_module_or_nodes
    if hasattr(nodes, "graph"):
        nodes = nodes.graph.nodes
    counts: Counter = Counter()
    for n in nodes:
        if n.op != "call_function":
            continue
        if is_scan(n):
            counts.update(export_vector(scan_body(n)))
        name = _op_name(n.target)
        if name not in _IGNORED_OPS:
            counts[name] += 1
    return dict(counts)


def vector_of_callable(fn: Callable, *example_args) -> dict[str, int]:
    """Export a callable (module or function) and take its vector."""
    import torch

    from repro_torch.core.trace_lock import TRACE_LOCK

    mod = fn if isinstance(fn, torch.nn.Module) else _fn_module(fn)
    with TRACE_LOCK:
        ep = torch.export.export(mod, tuple(example_args))
    return export_vector(ep.graph_module)


def _fn_module(fn: Callable):
    import torch

    class _Wrap(torch.nn.Module):
        def forward(self, *args):
            return fn(*args)

    return _Wrap()


# ---------------------------------------------------------------------------
# similarity
# ---------------------------------------------------------------------------


def cosine(a: dict[str, int], b: dict[str, int]) -> float:
    if not a or not b:
        return 0.0
    keys = set(a) | set(b)
    va = np.array([a.get(k, 0) for k in keys], dtype=np.float64)
    vb = np.array([b.get(k, 0) for k in keys], dtype=np.float64)
    na, nb = np.linalg.norm(va), np.linalg.norm(vb)
    if na == 0 or nb == 0:
        return 0.0
    return float(va @ vb / (na * nb))


def similarity(a: dict[str, int], b: dict[str, int]) -> float:
    """Cosine over characteristic vectors (Deckard uses euclidean LSH; cosine
    is scale-invariant which suits loop-trip-count differences)."""
    return cosine(a, b)


def graph_vector(graph) -> dict[str, int]:
    """Whole-program characteristic vector of a RegionGraph: the sum of the
    regions' vectors plus weighted callee names — what the offload seed bank
    compares to find *near*-identical programs whose best patterns can warm-
    start a new search (ROADMAP: similarity-based measurement reuse)."""
    counts: Counter = Counter()
    for r in graph.regions:
        for k, v in r.feature_vector.items():
            counts[k] += v
        for name in r.callees:
            counts[f"call:{name.split('.')[-1]}"] += _CALL_WEIGHT
        counts[f"kind:{r.kind}"] += 1
    return dict(counts)
