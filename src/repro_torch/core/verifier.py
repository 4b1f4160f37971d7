"""Port of ``repro/core/verifier.py``: the same tolerant allclose, over
torch tensors (any device) as well as numpy arrays and Python numbers.

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


def _leaves(x: Any) -> list[np.ndarray]:
    return [_as_f64(l) for l in pytree.tree_leaves(x) if _numeric(l)]


def verify(reference: Any, candidate: Any, rtol: float = 1e-2,
           atol: float = 1e-2) -> VerifyResult:
    """Tolerant allclose over arbitrary pytrees of numerics."""
    ref_l, cand_l = _leaves(reference), _leaves(candidate)
    if len(ref_l) != len(cand_l):
        return VerifyResult(False, float("inf"), float("inf"),
                            f"structure mismatch: {len(ref_l)} vs {len(cand_l)} leaves")
    max_abs = 0.0
    max_rel = 0.0
    for r, c in zip(ref_l, cand_l):
        if r.shape != c.shape:
            return VerifyResult(False, float("inf"), float("inf"),
                                f"shape mismatch: {r.shape} vs {c.shape}")
        if not (np.all(np.isfinite(r)) and np.all(np.isfinite(c))):
            if not np.array_equal(np.isfinite(r), np.isfinite(c)):
                return VerifyResult(False, float("inf"), float("inf"), "non-finite mismatch")
        d = np.abs(r - c)
        max_abs = max(max_abs, float(np.max(d)) if d.size else 0.0)
        denom = np.maximum(np.abs(r), 1e-9)
        max_rel = max(max_rel, float(np.max(d / denom)) if d.size else 0.0)
    ok = max_abs <= atol or max_rel <= rtol
    return VerifyResult(ok, max_abs, max_rel)
