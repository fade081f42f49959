"""Fault tolerance: the step guard, straggler watch, fault injection, the
elastic re-mesh and the checkpointed solve (DESIGN.md §16)."""

from repro_torch.ft.elastic import remesh
from repro_torch.ft.runtime import (
    ElasticController,
    FailureInjector,
    StepGuard,
    StragglerWatch,
    TransientWorkerError,
    is_retryable,
)

__all__ = [
    "ElasticController",
    "FailureInjector",
    "StepGuard",
    "StragglerWatch",
    "TransientWorkerError",
    "checkpointed_solve",
    "is_retryable",
    "remesh",
    "supports_checkpointed",
]


def __getattr__(name):
    # checkpointed_solve pulls in numpy/engine machinery; keep the base
    # package import-light for the spec layer
    if name in ("checkpointed_solve", "supports_checkpointed"):
        from repro_torch.ft import solve as _solve

        return getattr(_solve, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
