"""Production mesh builders: the port's ``repro.launch.mesh``.

The dry run lays each cell over the reference's production meshes, (16,
16) ``("data", "model")`` for one pod and (2, 16, 16) ``("pod", "data",
"model")`` for two, in ONE process: :func:`make_production_mesh` starts a
world of 256 or 512 ranks over a fake process group (``FakeStore`` and
the ``"fake"`` backend, whose collectives move nothing), this process
being rank 0, and builds a CPU ``DeviceMesh`` over it.  DTensors on that
mesh hold rank 0's shards; their ops run locally and their collectives
are recorded by whoever watches the dispatcher (the dry run's census).

The default process group is process-global state, so the mesh is a
context manager that owns its world: it refuses to start while any
default group exists (a real gloo or NCCL world of this process) and
destroys the fake one on exit, also when the body raises.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Sequence

import torch
import torch.distributed as dist

PRODUCTION_SHAPES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


@contextlib.contextmanager
def fake_world(world_size: int) -> Iterator[None]:
    """A world of ``world_size`` ranks over a fake process group, this
    process rank 0; destroyed on exit.  Raises ``RuntimeError`` while a
    default process group exists."""
    if dist.is_initialized():
        raise RuntimeError(
            "a fake world needs the default process group, and one exists "
            f"(backend {dist.get_backend()}, {dist.get_world_size()} ranks)"
        )
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def make_production_mesh(*, multi_pod: bool = False):
    """``with make_production_mesh() as mesh``: the (16, 16) or (2, 16, 16)
    production ``DeviceMesh`` over its own fake world (see the module
    docstring)."""
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    with make_host_mesh(shape, axes) as mesh:
        yield mesh


@contextlib.contextmanager
def make_host_mesh(shape: Sequence[int], axes: Sequence[str]):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over its own fake world
    of ``prod(shape)`` ranks (tests, local census runs)."""
    shape = tuple(int(k) for k in shape)
    if len(shape) != len(tuple(axes)):
        raise ValueError(f"mesh shape {shape} and axes {tuple(axes)} differ in rank")
    from torch.distributed.device_mesh import DeviceMesh

    with fake_world(math.prod(shape)):
        yield DeviceMesh("cpu", torch.arange(math.prod(shape)).reshape(shape),
                         mesh_dim_names=tuple(axes))


def data_axes(mesh) -> tuple:
    """The batch/data axes of a mesh: ``("pod", "data")`` when multi-pod."""
    return tuple(n for n in mesh.mesh_dim_names if n in ("pod", "data"))


__all__ = ["PRODUCTION_SHAPES", "data_axes", "fake_world", "make_host_mesh",
           "make_production_mesh"]
