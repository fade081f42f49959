"""Find a cell's files by the names ``BENCHMARK.json`` gives.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, so a later change adds one of them
by adding files and entries, never by editing a file that is there:

* ``perfbench/configs/<config>.json``: the deployment (network, solver,
  guarantees), the file ``BENCHMARK.json`` names under ``configs``;
* ``perfbench/traffic/<traffic>.json``: the mix (what a window runs, its
  loop, its rates);
* ``perfbench/cells/<workload>.json``: the cell's correctness limits and
  the readings they were set from;
* ``perfbench/metrics/<metric>.py``: the reader of one per-layer metric,
  a ``read(ctx)`` that returns a number or ``None``;
* ``perfbench/kinds/<kind>.py``: a traffic kind that the harness does not
  hold itself (``harness/cells.py::KINDS``): ``Loop``, a class with the
  interface of the kinds there (the constructor ``Loop(config, traffic,
  seed, device, control)``, ``window(seconds, tracer, done)``,
  ``end_to_end``, ``counters``, ``describe``, ``check``), and optionally
  ``RANGES``, the names of the ranges its window opens besides
  ``harness/trace.py::SPANS``.  The traffic file names it as ``kind``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = "perfbench"


class UnknownKind(LookupError):
    pass


def _module(path: Path, prefix: str, name: str):
    """The module of the file at ``path``, loaded under a name of its own."""
    spec = importlib.util.spec_from_file_location(
        prefix + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]  # this cell's end-to-end metric entries
    per_layer: List[dict]  # this cell's per-layer metric entries
    root: Path

    def reader(self, metric: str) -> Callable:
        """The ``read`` function of ``perfbench/metrics/<metric>.py``."""
        path = self.root / BENCH_DIR / "metrics" / f"{metric}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no reader for per-layer metric {metric!r} at {path}")
        return _module(path, "perfbench_metric_", metric).read

    def kind_file(self):
        """The module of ``perfbench/kinds/<kind>.py`` for this cell's
        traffic kind; ``UnknownKind``, naming the file, where there is none."""
        kind = self.traffic["kind"]
        path = self.root / BENCH_DIR / "kinds" / f"{kind}.py"
        if not path.is_file():
            raise UnknownKind(f"traffic kind {kind!r} of cell {self.name!r} is neither the "
                              f"harness's own nor a file: no {path}")
        return _module(path, "perfbench_kind_", kind)


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(root: Path, name: str, bench: Optional[dict] = None) -> Cell:
    """Resolve workload ``name`` of ``<root>/BENCHMARK.json`` (or of the
    parsed ``bench`` given in its place) to its files."""
    root = Path(root)
    if bench is None:
        bench = _load(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    config = _load(root / cfg_entry["file"])
    traffic = _load(root / BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    cell_file = _load(root / BENCH_DIR / "cells" / f"{name}.json")
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=config,
        traffic=traffic,
        limits=dict(cell_file["limits"]),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        root=root,
    )
