"""Port of ``repro/launch/mesh.py``: device meshes on
``torch.distributed``.

* :func:`make_production_mesh` — the reference's production meshes: a
  single pod of 16 x 16 = 256 ranks over ``(data, model)``, or two pods,
  2 x 16 x 16 = 512 ranks over ``(pod, data, model)`` (the ``pod`` axis
  carries pure DP: the gradient all-reduce that the compression path
  targets).  No host has 256 GPUs here: the mesh lives on a process group
  of the ``fake`` backend (``FakeStore``), whose collectives return at
  once, so the dry run traces the per-rank program of rank 0.  A fake
  group is its process's default group and cannot live beside a real
  one: only the dry run's production-mesh process starts it, before
  anything else (``launch/dryrun.py --mesh``).
* :func:`make_host_mesh` — the real ranks of the default group as
  ``(data, model)``.  Without a group it starts one of world size 1 from a
  ``HashStore`` (no network): NCCL on the card (with gloo for CPU
  tensors), gloo on the CPU.  Asked for ``cuda`` without a card it raises;
  it never builds a CPU mesh in the card's place.
* :func:`make_destination_mesh` — the mesh behind one ``MeshDestination``
  gene: ``n`` ranks on one named axis, cached per (n, axis, device type).
  With more ranks than ``n`` the world splits into ``world / n`` replicas
  of the n-rank mesh, so every rank (the port is multi-controller: every
  rank runs the program) computes the whole result.  Fewer ranks than
  ``n`` raise ``ValueError``, as the reference does.

Functions, so importing this module starts no process group.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["PRODUCTION_MESHES", "host_device_type", "init_fake_world",
           "init_host_group", "make_destination_mesh", "make_host_mesh",
           "make_production_mesh"]

#: name -> (shape, axis names): the dry run's ``--mesh`` choices
PRODUCTION_MESHES = {
    "pod16x16": ((16, 16), ("data", "model")),
    "pod2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


def host_device_type(device=None) -> str:
    """``"cuda"`` unless ``"cpu"`` is asked for; raises when ``cuda`` is
    wanted and the host has no card."""
    kind = torch.device(device).type if device is not None else "cuda"
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh was asked for and no CUDA device is "
                           "visible; pass device='cpu' for a CPU mesh")
    return kind


def init_fake_world(world_size: int) -> None:
    """Start the default process group on the ``fake`` backend at
    ``world_size`` (this process is rank 0).  Raises when a group exists."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group already exists; the "
                           "fake world needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def init_host_group(device=None) -> None:
    """The default group at world size 1 from a ``HashStore`` when none
    exists: NCCL (and gloo for CPU tensors) on the card, gloo on the CPU."""
    if dist.is_initialized():
        return
    kind = host_device_type(device)
    backend = "cpu:gloo,cuda:nccl" if kind == "cuda" else "gloo"
    if kind == "cuda":
        torch.cuda.set_device(torch.cuda.current_device())
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """The 256- or 512-rank production mesh on a fake world (started here
    when no group exists).  ``device_type`` is the tensors' device kind:
    ``cuda`` on the card, ``cpu`` where the dry run traces meta tensors."""
    shape, axes = PRODUCTION_MESHES["pod2x16x16" if multi_pod
                                    else "pod16x16"]
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        init_fake_world(n)
    if dist.get_world_size() != n:
        raise ValueError(f"production mesh {shape} wants {n} ranks, the "
                         f"world has {dist.get_world_size()}")
    kind = device_type or ("cuda" if torch.cuda.is_available() else "cpu")
    return init_device_mesh(kind, shape, mesh_dim_names=axes)


def make_host_mesh(*, model: int = 1, device=None) -> DeviceMesh:
    """Whatever ranks the default group has, as ``(data, model)`` (a
    world-size-1 group is started when none exists)."""
    kind = host_device_type(device)
    init_host_group(kind)
    n = dist.get_world_size()
    model = max(1, min(model, n))
    if n % model:
        raise ValueError(f"model axis {model} does not divide {n} ranks")
    return init_device_mesh(kind, (n // model, model),
                            mesh_dim_names=("data", "model"))


@functools.lru_cache(maxsize=None)
def _destination_mesh(n: int, axis: str, kind: str) -> DeviceMesh:
    world = dist.get_world_size()
    if world % n:
        raise ValueError(f"mesh destination of {n} ranks does not divide "
                         f"the host's {world}")
    if world == n:
        return init_device_mesh(kind, (n,), mesh_dim_names=(axis,))
    mesh = init_device_mesh(kind, (world // n, n),
                            mesh_dim_names=("replica", axis))
    return mesh[axis]


def make_destination_mesh(n: int, axis: str = "data",
                          device=None) -> DeviceMesh:
    """The 1-D mesh of ``n`` ranks behind one ``MeshDestination`` gene
    (cached: every rank asks for the same meshes in the same order)."""
    kind = host_device_type(device)
    init_host_group(kind)
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"mesh destination wants {n} devices, "
                         f"host has {world}")
    return _destination_mesh(n, axis, kind)
