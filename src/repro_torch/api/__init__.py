"""Unified declarative API: RunSpec → Session → Artifacts (DESIGN.md §13).

One serializable job description over everything the repo can run:

>>> from repro_torch.api import RunSpec, Session
>>> spec = RunSpec.from_file("examples/specs/quickstart_run.json")
>>> artifacts = Session(spec).run()      # solve → eval → serve → bench

The spec tree (``repro_torch.api.spec``) is import-light and strictly
validated; the :class:`Session` resolves it against the engine/scenario
registries once, shares one prepared engine across stages, and writes
typed artifacts under ``results/<run_id>/``.  The ``python -m repro run``
driver is a thin CLI over exactly this module.
"""

from repro_torch.api.artifacts import (
    Artifact,
    BenchArtifact,
    DryrunArtifact,
    EvalArtifact,
    ServeArtifact,
    SolveArtifact,
    TrainArtifact,
    jsonable,
)
from repro_torch.api.session import Session
from repro_torch.api.spec import (
    BenchSpec,
    DryrunSpec,
    EvalSpec,
    FTSpec,
    NetworkSpec,
    ObsSpec,
    RunSpec,
    ServeSpec,
    SLOSpec,
    SolveSpec,
    SpecError,
    TrainSpec,
)

__all__ = [
    "Artifact",
    "BenchArtifact",
    "BenchSpec",
    "DryrunArtifact",
    "DryrunSpec",
    "EvalArtifact",
    "EvalSpec",
    "FTSpec",
    "NetworkSpec",
    "ObsSpec",
    "RunSpec",
    "SLOSpec",
    "ServeArtifact",
    "ServeSpec",
    "Session",
    "SolveArtifact",
    "SolveSpec",
    "SpecError",
    "TrainArtifact",
    "TrainSpec",
    "jsonable",
]
