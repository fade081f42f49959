"""Tiny copies of the benchmark's cells, for the CPU tests.

The widths of each configuration stay as they are (the type ratio, the
degree law, the solver); only the scale shrinks: a 20,000-edge target for
the drug network, 3,000 nodes and 30,000 edges with 64 seeds for the
dhlp-bio graph.
"""

import copy
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench.harness import spec  # noqa: E402

CELLS = ("pl1m-dhlp2-solve", "bio20m-step", "pl1m-dhlp1-solve")


def shrink(cell: spec.Cell) -> spec.Cell:
    cell = copy.deepcopy(cell)
    if cell.config["kind"] == "drugnet":
        cell.config["generator"]["target_edges"] = 20000
    else:
        cell.config["graph"].update(num_nodes=3000, num_edges=30000, seeds=64)
        cell.traffic["check_chunk"] = 16
    return cell


def tiny_cell(name: str, root: Path = ROOT) -> spec.Cell:
    return shrink(spec.load_cell(root, name))


def tiny_checkout(dst: Path) -> Path:
    """A checkout of the benchmark alone (``BENCHMARK.json`` and
    ``perfbench/``) at ``dst``, its configurations and traffic cut to the
    tiny sizes; the program stays in this repository's ``src/``."""
    shutil.copytree(ROOT / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    for name in CELLS:
        tiny = shrink(spec.load_cell(dst, name))
        bench = json.loads((dst / "BENCHMARK.json").read_text())
        w = {c["name"]: c for c in bench["workloads"]}[name]
        cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
        (dst / cfg["file"]).write_text(json.dumps(tiny.config))
        (dst / spec.BENCH_DIR / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(tiny.traffic))
    return dst
