"""Elastic re-mesh: checkpoint-restore-reshard on device-count change.

Checkpoints are saved UNSHARDED (host copies, see
:mod:`repro_torch.checkpoint.store`), so surviving a device-count change
is a policy decision plus a restore with new shardings, no resharding
tool.  :class:`repro_torch.ft.ElasticController` owns the policy (shrink
to the largest power-of-two ≤ healthy devices); :func:`remesh` executes it
end to end: save the current state, build shardings for the target mesh,
restore every leaf onto it as a ``DTensor``
(:class:`repro_torch.parallel.mesh.MeshSharding` leaves).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.ft.runtime import ElasticController

PyTree = Any


def remesh(
    manager,
    tree: PyTree,
    *,
    healthy_devices: int,
    current_devices: int,
    make_shardings: Optional[Callable[[int], PyTree]] = None,
    controller: Optional[ElasticController] = None,
    step: int = 0,
    telemetry=None,
) -> Tuple[PyTree, Optional[Dict]]:
    """Plan and execute a re-mesh for ``tree``.

    ``make_shardings(target_devices)`` returns a tree of ``MeshSharding``
    (same structure as ``tree``) for the shrunk mesh; ``None`` restores to
    the template's own devices, which is still the correct durability
    round-trip on a single-device runner.  Returns ``(tree, plan)`` — the
    input tree untouched when the device count is unchanged
    (``plan is None``).
    """
    controller = controller or ElasticController()
    plan = controller.plan(healthy_devices, current_devices)
    if plan is None:
        return tree, None
    manager.save(step, tree, metadata={"elastic": plan})
    manager.wait()
    shardings = make_shardings(plan["to"]) if make_shardings else None
    restored_step, restored = manager.restore_latest(tree, shardings=shardings)
    if restored is None:
        raise RuntimeError("elastic remesh: checkpoint restore failed")
    if telemetry is not None:
        telemetry.count("ft.remeshes")
        telemetry.gauge("ft.mesh_devices", plan["to"])
    return restored, plan
