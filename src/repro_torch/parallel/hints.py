"""Activation-sharding hints: the port's ``repro.parallel.hints``.

Model code names LOGICAL axes (:data:`BATCH`, :data:`TP`); a launcher
registers the physical mesh for the calling thread
(:func:`set_ambient_mesh`, a ``DeviceMesh`` of :mod:`.mesh`), and
:func:`shard_hint` resolves the logical axes against its
``mesh_dim_names`` as the reference does: ``BATCH`` is the mesh's
``"pod"`` and ``"data"`` axes, ``TP`` its ``"model"`` axis, and an axis
that the mesh lacks or that does not divide the dimension is dropped.

:func:`shard_hint` returns ``x`` unchanged when no mesh is registered,
or when every axis it resolves has size 1: one device holds the whole
tensor, which is what the hint would ask for.  With a mesh whose
resolved axes are wider, the hint would place a sharded activation
(``with_sharding_constraint`` in the reference), which the port does not
do yet: it raises ``NotImplementedError`` naming ROADMAP A.9.5 (the dry
run, the only caller of the reference that registers a mesh) rather than
compute replicated.

The reference's ``make_mesh_compat``, ``shard_map_compat`` and
``auto_axis_types`` are shims over JAX versions; they have no torch
counterpart (the port's meshes come from :func:`.mesh.make_mesh`).
"""

from __future__ import annotations

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
    wide = [r for r in resolved if _axes_size(r, mesh) > 1]
    if wide:
        raise NotImplementedError(
            f"shard_hint over mesh axes {wide}: sharded activations are not ported yet "
            "(ROADMAP A.9.5: the dry run)"
        )
    return x


__all__ = ["BATCH", "TP", "get_ambient_mesh", "set_ambient_mesh", "shard_hint"]
