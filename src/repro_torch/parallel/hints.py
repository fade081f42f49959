"""Activation-sharding hints: the port's ``repro.parallel.hints``.

Model code names LOGICAL axes (:data:`BATCH`, :data:`TP`); a launcher
registers the physical mesh for the calling thread
(:func:`set_ambient_mesh`, a ``DeviceMesh`` of :mod:`.mesh`), and
:func:`shard_hint` resolves the logical axes against its
``mesh_dim_names`` as the reference does: ``BATCH`` is the mesh's
``"pod"`` and ``"data"`` axes, ``TP`` its ``"model"`` axis, and an axis
that the mesh lacks or that does not divide the dimension is dropped.

:func:`shard_hint` returns ``x`` unchanged when no mesh is registered.
A DTensor on the mesh is placed as the reference's
``with_sharding_constraint`` places it: redistributed to the placements
the spec names (``Shard(d)`` on each mesh dim over dimension ``d``,
``Replicate()`` elsewhere).  A plain tensor is returned unchanged when
every axis the spec resolves to has size 1 (one device holds the whole
tensor, which is what the hint asks for), and raises ``ValueError`` when
one is wider: it has no layout to change, and passing it through would
compute replicated where the reference shards.
The dry run (:mod:`repro_torch.launch.dryrun`) is the caller that
registers such a mesh (:func:`ambient_mesh`).

The reference's ``make_mesh_compat``, ``shard_map_compat`` and
``auto_axis_types`` are shims over JAX versions; they have no torch
counterpart (the port's meshes come from :func:`.mesh.make_mesh`).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple, Union

# logical axes
BATCH = "__batch__"  # data-parallel axes: ("pod", "data") ∩ mesh
TP = "__model__"  # tensor/expert-parallel axis: "model"

_state = threading.local()


def set_ambient_mesh(mesh) -> None:
    """Register ``mesh`` (or None) for the calling thread's hints."""
    _state.mesh = mesh


def get_ambient_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def ambient_mesh(mesh):
    """Register ``mesh`` for the calling thread's hints inside the block;
    the previous one (or None) again after it."""
    prev = get_ambient_mesh()
    set_ambient_mesh(mesh)
    try:
        yield mesh
    finally:
        set_ambient_mesh(prev)


def _resolve(axis, mesh) -> Optional[Union[str, Tuple[str, ...]]]:
    names = tuple(mesh.mesh_dim_names or ())
    if axis is None:
        return None
    if axis == BATCH:
        axes = tuple(a for a in ("pod", "data") if a in names)
        return axes or None
    if axis == TP:
        return "model" if "model" in names else None
    return axis if axis in names else None


def _axes_size(axes, mesh) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    names = tuple(mesh.mesh_dim_names)
    n = 1
    for a in axes:
        n *= mesh.size(names.index(a))
    return n


def shard_hint(x, *spec):
    """``x`` with the sharding ``spec`` (one logical or mesh axis, or None,
    per dimension) asked of the ambient mesh; see the module docstring."""
    mesh = get_ambient_mesh()
    if mesh is None:
        return x
    if len(spec) != x.dim():
        raise ValueError(f"spec rank {len(spec)} != array rank {x.dim()}")
    resolved = []
    for axis, dim in zip(spec, x.shape):
        r = _resolve(axis, mesh)
        if r is not None and dim % _axes_size(r, mesh) != 0:
            r = None
        resolved.append(r)
    if not hasattr(x, "redistribute"):
        if all(_axes_size(r, mesh) == 1 for r in resolved):
            return x
        raise ValueError(
            f"shard_hint over mesh axes {[r for r in resolved if r is not None]}: a plain "
            f"{tuple(x.shape)} tensor has no layout on the mesh (only a DTensor can be placed)"
        )
    want = placements(mesh, resolved)
    return x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)


def placements(mesh, spec) -> tuple:
    """DTensor placements, one per mesh dim, of a per-tensor-dim ``spec``
    (None, a mesh axis or a tuple of them per dim, major axis first): a
    mesh dim over tensor dim ``d`` is ``Shard(d)``, any other
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        for a in (axes,) if isinstance(axes, str) else (axes or ()):
            out[names.index(a)] = Shard(d)
    return tuple(out)


__all__ = ["BATCH", "TP", "ambient_mesh", "get_ambient_mesh", "placements", "set_ambient_mesh",
           "shard_hint"]
