"""Fault tolerance: the step guard, straggler watch, fault injection and
the checkpointed solve (DESIGN.md §16).  The elastic re-mesh
(``ft/elastic.py`` and ``ElasticController`` in the reference) needs
sharded engines and comes with them (``ROADMAP.md`` queue A.8)."""

from repro_torch.ft.runtime import (
    FailureInjector,
    StepGuard,
    StragglerWatch,
    TransientWorkerError,
    is_retryable,
)

__all__ = [
    "FailureInjector",
    "StepGuard",
    "StragglerWatch",
    "TransientWorkerError",
    "checkpointed_solve",
    "is_retryable",
    "supports_checkpointed",
]


def __getattr__(name):
    # checkpointed_solve pulls in numpy/engine machinery; keep the base
    # package import-light for the spec layer
    if name in ("checkpointed_solve", "supports_checkpointed"):
        from repro_torch.ft import solve as _solve

        return getattr(_solve, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
