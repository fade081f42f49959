"""Architecture registry: an arch id → its configs, shapes and cells.

The port's copy of ``repro.configs.registry``: the same 11 ids in the same
order, each resolved by importing its config module and calling its
``spec()``.  ``ArchSpec.make_cell`` builds every cell of
:func:`all_cells` (:mod:`.cells`, :mod:`.dhlp_bio`); the dry run that
compiles them is ROADMAP A.9.5.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, List, Optional, Tuple

from repro_torch.configs.cells import Cell

ARCH_IDS = [
    # LM family (5)
    "granite-moe-3b-a800m",
    "moonshot-v1-16b-a3b",
    "h2o-danube-1.8b",
    "stablelm-1.6b",
    "minicpm3-4b",
    # GNN (4)
    "gat-cora",
    "gcn-cora",
    "dimenet",
    "meshgraphnet",
    # recsys (1)
    "wide-deep",
    # the paper's own technique as an arch (extra, not in the 40-cell grid)
    "dhlp-bio",
]

_MODULES = {
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "stablelm-1.6b": "stablelm_1_6b",
    "minicpm3-4b": "minicpm3_4b",
    "gat-cora": "gat_cora",
    "gcn-cora": "gcn_cora",
    "dimenet": "dimenet",
    "meshgraphnet": "meshgraphnet",
    "wide-deep": "wide_deep",
    "dhlp-bio": "dhlp_bio",
}


@dataclasses.dataclass
class ArchSpec:
    arch_id: str
    family: str  # "lm" | "gnn" | "recsys" | "lp"
    full_config: Any
    reduced_config: Any
    shapes: List[str]
    make_cell: Callable[[str], Cell]
    source: str = ""  # citation tag
    # the same cell with `trip` layers / rounds (the dry run's probes)
    make_probe_cell: Optional[Callable[[str, int], Cell]] = None


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {', '.join(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.spec()


def list_archs() -> List[str]:
    return list(ARCH_IDS)


def all_cells(include_extra: bool = False) -> List[Tuple[str, str]]:
    """The 40 assigned (arch × shape) cells (+ the dhlp-bio extras if asked)."""
    out = []
    for a in ARCH_IDS:
        if a == "dhlp-bio" and not include_extra:
            continue
        for s in get_arch(a).shapes:
            out.append((a, s))
    return out


__all__ = ["ARCH_IDS", "ArchSpec", "all_cells", "get_arch", "list_archs"]
