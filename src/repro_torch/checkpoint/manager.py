"""Port of ``repro/checkpoint/manager.py``: step-indexed checkpointing with
atomic commits, async save and keep-last-k.

Layout:  <dir>/step_<n>/  {manifest.json, arr_<i>.npy ...}
A checkpoint is written under ``.tmp_step_<n>`` and renamed on completion,
so a crash mid-save never corrupts the latest committed checkpoint (a
restart scans for the newest *committed* step).

A tree is nested mappings, NamedTuples, lists and tuples of tensors (numpy
arrays and Python numbers pass too), and ``nn.Module``s, whose leaves are
their parameters by name; ``None`` holds no leaf.  A leaf's path joins the
keys, field names, indices and parameter names on the way to it with
``/`` (``"opt/mu/blocks.0.wq"``).  bf16 leaves are stored as their int16
bits (numpy has no bf16) and the manifest names the dtype.

``save`` snapshots every leaf to host memory before it returns (and before
the async writer starts): the train step writes into the parameters in
place, and a writer reading them late would see the next step's values.
``restore`` rebuilds the tree with each leaf in the template leaf's dtype
and on its device; a module of the template is restored in place (its
parameters overwritten) and returned.  Each save records its bytes and
seconds in ``CheckpointManager.saves``.  ``reshard`` onto another mesh waits
for the mesh (``ROADMAP.md`` queue 1 item 10).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

__all__ = ["CheckpointManager", "load_pytree", "save_pytree"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs in a stable order."""
    def join(key) -> str:
        return f"{prefix}/{key}" if prefix else str(key)

    if tree is None:
        return []
    if isinstance(tree, nn.Module):
        return [(join(k), p) for k, p in tree.named_parameters()]
    if _is_namedtuple(tree):
        items = zip(tree._fields, tree)
    elif isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    return [pair for k, v in items
            for pair in _flatten_with_paths(v, join(k))]


def _rebuild(template: Any, leaves: dict, prefix: str = "") -> Any:
    """``template``'s structure with each leaf taken from ``leaves`` (path
    -> tensor); module parameters are overwritten in place."""
    def join(key) -> str:
        return f"{prefix}/{key}" if prefix else str(key)

    if template is None:
        return None
    if isinstance(template, nn.Module):
        with torch.no_grad():
            for k, p in template.named_parameters():
                p.copy_(leaves[join(k)])
        return template
    if _is_namedtuple(template):
        return type(template)(*(_rebuild(v, leaves, join(k))
                                for k, v in zip(template._fields, template)))
    if isinstance(template, dict):
        return type(template)((k, _rebuild(v, leaves, join(k)))
                              for k, v in template.items())
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, leaves, join(i))
                              for i, v in enumerate(template))
    return leaves[prefix]


def _host_copy(leaf: Any):
    """A host copy of one leaf that later writes to the leaf do not reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _host_snapshot(tree: Any) -> dict:
    """Every leaf of ``tree`` copied to host memory, by path (all that the
    writer needs of the structure)."""
    return {p: _host_copy(leaf) for p, leaf in _flatten_with_paths(tree)}


def _to_numpy(leaf: Any) -> tuple[np.ndarray, str]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_pytree(tree: Any, path: str) -> int:
    """Write ``tree`` under ``path``; returns the bytes of its leaves."""
    os.makedirs(path, exist_ok=True)
    manifest = {"leaves": []}
    n_bytes = 0
    for i, (p, leaf) in enumerate(_flatten_with_paths(tree)):
        arr, dtype = _to_numpy(leaf)
        np.save(os.path.join(path, f"arr_{i}.npy"), arr, allow_pickle=False)
        n_bytes += arr.nbytes
        manifest["leaves"].append({"path": p, "file": f"arr_{i}.npy",
                                   "dtype": dtype, "shape": list(arr.shape)})
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return n_bytes


def load_pytree(template: Any, path: str) -> Any:
    with open(os.path.join(path, "manifest.json")) as f:
        by_path = {e["path"]: e for e in json.load(f)["leaves"]}
    leaves = {}
    for p, leaf in _flatten_with_paths(template):
        e = by_path[p]
        t = torch.from_numpy(np.load(os.path.join(path, e["file"]),
                                     allow_pickle=False))
        if e["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        if isinstance(leaf, torch.Tensor):
            t = t.to(device=leaf.device, dtype=leaf.dtype)
        leaves[p] = t
    return _rebuild(template, leaves)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None
        #: one record a save: step, bytes, snapshot_s (to host memory, on
        #: the caller's thread) and write_s (to disk and committed)
        self.saves: list[dict] = []
        os.makedirs(directory, exist_ok=True)

    # --- save ----------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        t0 = time.perf_counter()
        host_tree = _host_snapshot(tree)
        record = {"step": step, "snapshot_s": time.perf_counter() - t0}
        self.wait()

        def _do():
            t1 = time.perf_counter()
            tmp = os.path.join(self.dir, f".tmp_step_{step}")
            final = os.path.join(self.dir, f"step_{step}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            record["bytes"] = save_pytree(host_tree, tmp)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)      # atomic commit
            self._gc()
            record["write_s"] = time.perf_counter() - t1

        self.saves.append(record)
        if self.async_save and not blocking:
            self._pending = threading.Thread(target=_do, daemon=True)
            self._pending.start()
        else:
            _do()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # --- restore ------------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "manifest.json")):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None
                ) -> tuple[int, Any]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {self.dir}")
        return step, load_pytree(template, os.path.join(self.dir,
                                                        f"step_{step}"))
