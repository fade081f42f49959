"""Typed run artifacts written under ``results/<run_id>/`` (DESIGN.md §13).

Each :class:`~repro_torch.api.session.Session` stage returns one artifact:
``solve()`` → :class:`SolveArtifact` (rankings + solver outputs),
``evaluate()`` → :class:`EvalArtifact` (protocol metrics), ``serve()`` →
:class:`ServeArtifact` (workload report), ``bench()`` →
:class:`BenchArtifact` (BENCH record summary), ``train()`` →
:class:`TrainArtifact` (guarded training-loop stats), ``dryrun()`` →
:class:`DryrunArtifact` (per-cell census, emitted in the telemetry
event format so the ``roofline`` suite and ``repro obs`` read the same
artifact).  Artifacts carry their heavy payloads (score
matrices, LPOutputs) in memory and write a JSON summary plus ``.npz``
arrays via :meth:`write`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, ClassVar, Dict, List, Optional, Tuple

import numpy as np


def jsonable(obj: Any) -> Any:
    """Recursively coerce numpy scalars/arrays into JSON-native values."""
    if isinstance(obj, dict):
        return {str(k): jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return jsonable(obj.tolist())
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    return obj


def _write_json(path: str, payload: Dict[str, Any]) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(jsonable(payload), f, indent=2, sort_keys=True)
        f.write("\n")
    return path


@dataclasses.dataclass
class Artifact:
    """Base: provenance (run id + sections) and wall time."""

    kind: ClassVar[str] = "?"
    run_id: str
    seconds: float

    def summary(self) -> Dict[str, Any]:
        """The JSON-able report body (subclasses extend)."""
        return {
            "kind": self.kind,
            "run_id": self.run_id,
            "seconds": round(self.seconds, 4),
        }

    def write(self, run_dir: str) -> List[str]:
        """Write the artifact under ``run_dir``; returns written paths."""
        return [_write_json(os.path.join(run_dir, f"{self.kind}.json"), self.summary())]


@dataclasses.dataclass
class SolveArtifact(Artifact):
    """A converged propagation plus the paper's step-G ranking."""

    kind: ClassVar[str] = "solve"
    backend: str = "?"
    alg: str = "dhlp2"
    converged: bool = False
    outer_iters: int = 0
    inner_iters: int = 0
    supersteps: int = 0
    network: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: the reported ranking: pair, entity, top-k candidate ids + scores
    ranking: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: durability roll-up (empty when the spec declared no ft block):
    #: checkpoints written, resume cursor, checkpoint root
    ft: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: in-memory payloads (not serialized into the JSON summary)
    F: Optional[np.ndarray] = None
    outputs: Optional[object] = None  # repro_torch.core.ranking.LPOutputs

    def summary(self) -> Dict[str, Any]:
        out = super().summary()
        out.update(
            {
                "backend": self.backend,
                "alg": self.alg,
                "converged": self.converged,
                "outer_iters": self.outer_iters,
                "inner_iters": self.inner_iters,
                "supersteps": self.supersteps,
                "network": self.network,
                "ranking": self.ranking,
            }
        )
        if self.ft:
            out["ft"] = self.ft
        return out

    def write(self, run_dir: str) -> List[str]:
        paths = super().write(run_dir)
        if self.outputs is not None:
            arrays: Dict[str, np.ndarray] = {}
            for (i, j), m in self.outputs.interactions.items():
                arrays[f"R_{i}_{j}"] = np.asarray(m)
            for t, s in enumerate(self.outputs.similarities):
                arrays[f"P_{t}"] = np.asarray(s)
            npz = os.path.join(run_dir, "solve_outputs.npz")
            np.savez_compressed(npz, **arrays)
            paths.append(npz)
        return paths


@dataclasses.dataclass
class EvalArtifact(Artifact):
    """Recovery / k-fold CV metrics against planted ground truth."""

    kind: ClassVar[str] = "eval"
    protocol: str = "recovery"
    backend: str = "?"
    pair: Tuple[int, int] = (0, 0)
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    metrics: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: recovery protocol's converged labels (in memory only — the
    #: scenario CLI's cross-backend agreement check reads it)
    F: Optional[np.ndarray] = None

    def summary(self) -> Dict[str, Any]:
        out = super().summary()
        out.update(
            {
                "protocol": self.protocol,
                "backend": self.backend,
                "pair": list(self.pair),
                "params": self.params,
                "metrics": self.metrics,
            }
        )
        return out


@dataclasses.dataclass
class ServeArtifact(Artifact):
    """An online-workload report (trace replay or synthetic zipf)."""

    kind: ClassVar[str] = "serve"
    mode: str = "zipf"  # "zipf" | "trace"
    engine: str = "?"
    report: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: one representative query result for provenance checks
    sample: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: the SLO watchdog roll-up (empty when the spec declared no slo block)
    slo: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: durability roll-up (empty when the spec declared no ft block):
    #: guarded-batch retries/restores, checkpoint cadence, watermark
    ft: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def summary(self) -> Dict[str, Any]:
        out = super().summary()
        out.update(
            {
                "mode": self.mode,
                "engine": self.engine,
                "report": self.report,
                "sample": self.sample,
            }
        )
        if self.slo:
            out["slo"] = self.slo
        if self.ft:
            out["ft"] = self.ft
        return out


@dataclasses.dataclass
class DryrunArtifact(Artifact):
    """A dry-run census: one record per (arch × shape × mesh) cell.

    ``write`` emits ``dryrun.json`` (status roll-up) plus
    ``telemetry/dryrun.jsonl`` — the cells as ``repro_torch.obs`` event lines
    (meta line first) so roofline analysis and ``repro obs --validate``
    consume the census through one schema.  The JSONL is written whether
    or not the run's telemetry level is on: the census IS the stage's
    product, not an observation of it.
    """

    kind: ClassVar[str] = "dryrun"
    mesh: str = "single"
    #: raw ``run_cell`` records, in sweep order
    cells: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    #: seconds-from-stage-start offset per cell (parallel to ``cells``)
    offsets: List[float] = dataclasses.field(default_factory=list)

    def summary(self) -> Dict[str, Any]:
        statuses: Dict[str, int] = {}
        for rec in self.cells:
            status = rec.get("status", "?")
            statuses[status] = statuses.get(status, 0) + 1
        out = super().summary()
        out.update(
            {
                "mesh": self.mesh,
                "cells": len(self.cells),
                "statuses": statuses,
                "failures": [
                    {
                        "arch": rec.get("arch"),
                        "shape": rec.get("shape"),
                        "mesh": rec.get("mesh"),
                        "error": rec.get("error"),
                    }
                    for rec in self.cells
                    if rec.get("status") == "error"
                ],
            }
        )
        return out

    def write(self, run_dir: str) -> List[str]:
        from repro_torch.obs.telemetry import SCHEMA

        paths = super().write(run_dir)
        tel_dir = os.path.join(run_dir, "telemetry")
        os.makedirs(tel_dir, exist_ok=True)
        path = os.path.join(tel_dir, "dryrun.jsonl")
        with open(path, "w") as f:
            meta = {"kind": "meta", "schema": SCHEMA, "run_id": self.run_id}
            f.write(json.dumps(jsonable(meta), sort_keys=True) + "\n")
            for i, rec in enumerate(self.cells):
                t = self.offsets[i] if i < len(self.offsets) else float(i)
                line = {
                    "kind": "event",
                    "id": i,
                    "parent": None,
                    "name": "dryrun.cell",
                    "t": t,
                    "attrs": rec,
                }
                f.write(json.dumps(jsonable(line), sort_keys=True) + "\n")
        paths.append(path)
        return paths


@dataclasses.dataclass
class TrainArtifact(Artifact):
    """A guarded training run (lm / gnn / recsys arch families)."""

    kind: ClassVar[str] = "train"
    arch: str = "?"
    family: str = "?"
    steps: int = 0
    first_loss: float = float("nan")
    last_loss: float = float("nan")
    retries: int = 0
    restores: int = 0
    slow_steps: int = 0
    resumed: bool = False

    def summary(self) -> Dict[str, Any]:
        out = super().summary()
        out.update(
            {
                "arch": self.arch,
                "family": self.family,
                "steps": self.steps,
                "first_loss": self.first_loss,
                "last_loss": self.last_loss,
                "retries": self.retries,
                "restores": self.restores,
                "slow_steps": self.slow_steps,
                "resumed": self.resumed,
            }
        )
        return out


@dataclasses.dataclass
class BenchArtifact(Artifact):
    """Summary of a registered-suite benchmark pass (``repro_torch.bench``)."""

    kind: ClassVar[str] = "bench"
    label: str = "ci"
    suites: List[str] = dataclasses.field(default_factory=list)
    records: int = 0
    failures: int = 0
    report_paths: List[str] = dataclasses.field(default_factory=list)

    def summary(self) -> Dict[str, Any]:
        out = super().summary()
        out.update(
            {
                "label": self.label,
                "suites": self.suites,
                "records": self.records,
                "failures": self.failures,
                "report_paths": self.report_paths,
            }
        )
        return out
