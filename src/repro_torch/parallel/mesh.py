"""Device meshes over ``torch.distributed`` (the port's ``make_mesh_compat``).

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with named
axes, by default ``("data", "model")``: seed columns are sharded over
``data``, edges over ``model`` (DESIGN.md §6).  Per-axis collectives run
on ``mesh.get_group(axis)``.

The mesh is laid over the world that exists: the one ``torchrun`` (or any
caller) started with ``torch.distributed.init_process_group``.  When none
exists and the mesh has one device, :func:`make_mesh` starts a world of
one rank itself (NCCL on a card, gloo on the CPU, a ``FileStore`` in a
temporary directory, an explicit timeout), so that a one-device solve
still reduces through a process group: the card runs the code path a
multi-GPU run takes.  A mesh larger than the world raises ``ValueError``;
there is no fallback to a single-device engine.  :func:`destroy_owned_world`
ends a world this module started (also at interpreter exit).
"""

from __future__ import annotations

import atexit
import dataclasses
import inspect
import math
import os
import shutil
import tempfile
from datetime import timedelta
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

#: every process group this package starts waits at most this long
PG_TIMEOUT = timedelta(seconds=300)

_OWNED = {"store_dir": None}


def world_size() -> int:
    """Ranks in the current world, 1 when there is none."""
    return dist.get_world_size() if dist.is_initialized() else 1


def backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def rank_device(device: DeviceLike = None) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` under a launcher that sets
    it when the caller names no card index, else ``resolve_device``."""
    dev = resolve_device(device)
    local = os.environ.get("LOCAL_RANK")
    if dev.type == "cuda" and local is not None and (device is None or str(device) == "cuda"):
        dev = torch.device("cuda", int(local))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def is_rank_zero() -> bool:
    """Whether this process is rank 0 of its world (or has no world)."""
    if dist.is_initialized():
        return dist.get_rank() == 0
    return int(os.environ.get("RANK", "0")) == 0


def ensure_world(device: DeviceLike = None, *, timeout: timedelta = PG_TIMEOUT) -> int:
    """Start a world for ``device`` when none exists; returns its size.

    Under a launcher (``torchrun`` sets ``RANK``, ``WORLD_SIZE`` and
    ``MASTER_ADDR``) the world is the launcher's, met through ``env://``;
    otherwise one rank meets itself through a ``FileStore``.  A failure to
    start raises.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    dev = rank_device(device)
    kw = {}
    if dev.type == "cuda" and "device_id" in inspect.signature(dist.init_process_group).parameters:
        kw["device_id"] = dev
    store_dir = tempfile.mkdtemp(prefix="repro_torch_pg_")
    try:
        if "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(
                backend_for(dev), init_method="env://", timeout=timeout, **kw
            )
        else:
            store = dist.FileStore(os.path.join(store_dir, "store"), 1)
            dist.init_process_group(
                backend_for(dev), store=store, rank=0, world_size=1, timeout=timeout, **kw
            )
    except Exception:
        shutil.rmtree(store_dir, ignore_errors=True)
        raise
    _OWNED["store_dir"] = store_dir
    return dist.get_world_size()


def destroy_owned_world() -> None:
    """End the world :func:`ensure_world` started, if any (a world the
    caller started is left alone)."""
    store_dir = _OWNED["store_dir"]
    if store_dir is None:
        return
    _OWNED["store_dir"] = None
    if dist.is_initialized():
        dist.destroy_process_group()
    shutil.rmtree(store_dir, ignore_errors=True)


atexit.register(destroy_owned_world)


def make_mesh(
    shape: Sequence[int],
    axes: Sequence[str] = ("data", "model"),
    device: DeviceLike = None,
):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the world's ranks.

    Starts the launcher's world, or a world of one rank when
    ``prod(shape) == 1``, if none exists (:func:`ensure_world`).  Raises
    ``ValueError`` when the mesh needs more devices than the world has
    ranks, or covers fewer than all of them.
    """
    from torch.distributed.device_mesh import init_device_mesh

    shape = tuple(int(k) for k in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    k = math.prod(shape)
    dev = rank_device(device)
    world = world_size()
    if not dist.is_initialized() and (k == 1 or "MASTER_ADDR" in os.environ):
        world = ensure_world(dev)
    if k != world:
        raise ValueError(
            f"a {shape} mesh needs {k} devices, one per rank; the world has "
            f"{world} rank(s) (start {k} ranks, e.g. torchrun --nproc-per-node {k})"
        )
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


@dataclasses.dataclass(frozen=True)
class MeshSharding:
    """Where a restored leaf goes: a ``DeviceMesh`` and one placement per
    mesh axis (``Shard(0)``, ``Replicate()``), as ``distribute_tensor``
    takes them.  A leaf of a restore's ``shardings`` tree."""

    mesh: object
    placements: Tuple[object, ...]


def distribute(t: torch.Tensor, sharding: MeshSharding):
    """``t`` (the same on every rank) as a ``DTensor`` on the sharding's mesh."""
    from torch.distributed.tensor import distribute_tensor

    mesh = sharding.mesh
    if mesh.device_type == "cuda":
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    return distribute_tensor(t, mesh, list(sharding.placements))


__all__ = [
    "MeshSharding",
    "PG_TIMEOUT",
    "axis_size",
    "backend_for",
    "destroy_owned_world",
    "distribute",
    "ensure_world",
    "is_rank_zero",
    "make_mesh",
    "rank_device",
    "world_size",
]
