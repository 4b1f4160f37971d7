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
seconds in ``CheckpointManager.saves``.

A DTensor leaf is saved whole (``full_tensor``: a collective, so every
rank saves), so the files do not depend on the mesh; under a process group
of several ranks only rank 0 writes.  ``restore(template, shardings=...)``
(``{leaf path: (mesh, placements)}``) places each listed leaf as a DTensor
on that mesh (a module's parameter is replaced by one): the elastic-rescale
path, ``runtime.fault_tolerance.reshard``.  Without shardings a restore is
what it was.
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
        from torch.distributed.tensor import DTensor

        with torch.no_grad():
            for k, p in list(template.named_parameters()):
                new = leaves[join(k)]
                if isinstance(new, DTensor) or isinstance(p, DTensor):
                    owner, _, leaf = k.rpartition(".")
                    mod = template.get_submodule(owner) if owner else template
                    mod._parameters[leaf] = nn.Parameter(
                        new, requires_grad=p.requires_grad)
                else:
                    p.copy_(new)
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
    """A host copy of one leaf that later writes to the leaf do not reach
    (a DTensor's whole value)."""
    if isinstance(leaf, torch.Tensor):
        full = getattr(leaf, "full_tensor", None)
        if full is not None:
            leaf = full()
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _writes() -> bool:
    """Whether this process writes checkpoints: rank 0, or no group."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


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


def load_pytree(template: Any, path: str,
                shardings: Optional[dict] = None) -> Any:
    """``template`` rebuilt from the files under ``path``; a leaf whose path
    ``shardings`` lists is placed as a DTensor by its (mesh, placements)."""
    from torch.distributed.tensor import distribute_tensor

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
            mesh = getattr(leaf, "device_mesh", None)
            dev = torch.device(mesh.device_type) if mesh is not None \
                else leaf.device
            t = t.to(device=dev, dtype=leaf.dtype)
        if shardings and p in shardings:
            mesh, pl = shardings[p]
            t = distribute_tensor(t.to(mesh.device_type), mesh, pl)
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
            if not _writes():
                return
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

    def restore(self, template: Any, step: Optional[int] = None,
                shardings: Optional[dict] = None) -> tuple[int, Any]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {self.dir}")
        return step, load_pytree(template, os.path.join(self.dir,
                                                        f"step_{step}"),
                                 shardings)
