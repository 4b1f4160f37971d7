"""Port of ``repro/core/verifier.py``: the same tolerant allclose, over
torch tensors (any device) as well as numpy arrays and Python numbers.

Where both leaves of a pair are torch tensors, the pair is compared on the
reference leaf's device in float64 -- the shape check, the non-finite
pattern, ``max |r - c|`` and ``max |r - c| / max(|r|, 1e-9)`` -- and only
those per-leaf scalars come to the host, once for the whole tree; other
pairs go through numpy in float64 as in the reference.  Either way the
verdict is the reference's, leaf for leaf and in the same order.

Result verification — the PCAST analogue (paper §4.2.2: PGI コンパイラの
PCAST 機能等を用いて並列処理した場合の計算結果が、元のコードと大きく差分が
ないかチェックし、許容外の場合は、処理時間を∞とする).

Compares the offloaded execution's outputs against the reference path on the
same inputs; out-of-tolerance -> the caller assigns time = inf (fitness 0).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch.utils import _pytree as pytree


@dataclass
class VerifyResult:
    ok: bool
    max_abs: float
    max_rel: float
    detail: str = ""


def _as_f64(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", torch.float64).numpy()
    return np.asarray(leaf, dtype=np.float64)


def _numeric(leaf: Any) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype != torch.bool and not leaf.dtype.is_complex
    return hasattr(leaf, "dtype") and np.issubdtype(np.asarray(leaf).dtype,
                                                    np.number)


def _leaves(x: Any) -> list:
    return [l for l in pytree.tree_leaves(x) if _numeric(l)]


def _shape(leaf: Any) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
        else np.shape(leaf)


def _pair_numpy(r: Any, c: Any) -> tuple:
    """(non-finite mismatch, max_abs, max_rel) of one pair, on the host."""
    r, c = _as_f64(r), _as_f64(c)
    mismatch = not (np.all(np.isfinite(r)) and np.all(np.isfinite(c))) \
        and not np.array_equal(np.isfinite(r), np.isfinite(c))
    d = np.abs(r - c)
    if not d.size:
        return mismatch, 0.0, 0.0
    return (mismatch, float(np.max(d)),
            float(np.max(d / np.maximum(np.abs(r), 1e-9))))


def _pair_torch(r: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(non-finite mismatch, max_abs, max_rel) of one tensor pair as a
    float64 tensor of three on ``r``'s device (NaN propagates through the
    maxima, as ``np.max`` does)."""
    r = r.detach().to(torch.float64)
    c = c.detach().to(r.device, torch.float64)
    mismatch = (torch.isfinite(r) != torch.isfinite(c)).any()
    if not r.numel():
        return torch.stack([mismatch.double(), r.new_zeros(()),
                            r.new_zeros(())])
    d = (r - c).abs()
    rel = d / torch.clamp(r.abs(), min=1e-9)
    return torch.stack([mismatch.double(), d.max(), rel.max()])


def verify(reference: Any, candidate: Any, rtol: float = 1e-2,
           atol: float = 1e-2) -> VerifyResult:
    """Tolerant allclose over arbitrary pytrees of numerics."""
    ref_l, cand_l = _leaves(reference), _leaves(candidate)
    if len(ref_l) != len(cand_l):
        return VerifyResult(False, float("inf"), float("inf"),
                            f"structure mismatch: {len(ref_l)} vs {len(cand_l)} leaves")
    # pairs up to the first shape mismatch, the device pairs gathered into
    # one host copy
    pairs, failed_shape = [], None
    for r, c in zip(ref_l, cand_l):
        if _shape(r) != _shape(c):
            failed_shape = (_shape(r), _shape(c))
            break
        pairs.append((r, c))
    on_device = [i for i, (r, c) in enumerate(pairs)
                 if isinstance(r, torch.Tensor) and isinstance(c, torch.Tensor)]
    rows = {i: _pair_torch(*pairs[i]) for i in on_device}
    stats = {}
    for dev in {row.device for row in rows.values()}:   # one copy a device
        idx = [i for i, row in rows.items() if row.device == dev]
        host = torch.stack([rows[i] for i in idx]).tolist()
        stats.update({i: (bool(m), a, r) for i, (m, a, r) in zip(idx, host)})
    max_abs = 0.0
    max_rel = 0.0
    for i, (r, c) in enumerate(pairs):
        mismatch, pair_abs, pair_rel = stats[i] if i in stats \
            else _pair_numpy(r, c)
        if mismatch:
            return VerifyResult(False, float("inf"), float("inf"), "non-finite mismatch")
        max_abs = max(max_abs, pair_abs)
        max_rel = max(max_rel, pair_rel)
    if failed_shape is not None:
        return VerifyResult(False, float("inf"), float("inf"),
                            f"shape mismatch: {failed_shape[0]} vs {failed_shape[1]}")
    ok = max_abs <= atol or max_rel <= rtol
    return VerifyResult(ok, max_abs, max_rel)
