"""Cells, (architecture × input shape) units, from ``repro.configs.cells``.

A :class:`Cell` names a step function and stand-ins for its positional
inputs (:class:`TensorSpec`, the port's ``jax.ShapeDtypeStruct``: a shape
and a dtype, nothing allocated).  Here are the shape tables of the LM,
GNN and recsys cells, the LM cache-length rule, ``pad512`` and the
sampled cells' padded union sizes.  The builders of the train, prefill,
decode and serve cells (``lm_cell``, ``gnn_cell``, ``recsys_cell``) are
not ported: they build training steps (ROADMAP A.9.4) or feed the dry run
(A.9.5).  The ``dhlp-bio`` cells are built in :mod:`.dhlp_bio`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models.gnn import GCNConfig
from repro_torch.models.transformer import TransformerConfig


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """The shape and dtype of one step input (``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def sds(shape, dtype: torch.dtype) -> TensorSpec:
    return TensorSpec(tuple(int(x) for x in shape), dtype)


@dataclasses.dataclass
class Cell:
    """One (arch × shape) unit: a step and its inputs' specs."""

    arch: str
    shape: str
    kind: str  # train|prefill|decode|serve
    step_fn: Callable  # positional-argument step function
    input_specs: Tuple[Any, ...]  # TensorSpecs, positional
    donate: Tuple[int, ...] = ()
    skip_reason: Optional[str] = None  # set => the cell is a noted skip
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)


def pad512(x: int) -> int:
    """Round up to a shard-friendly multiple, as the reference's cells do."""
    return ((int(x) + 511) // 512) * 512


# repro.configs.cells.lm_cell: train and prefill take (batch, seq) tokens;
# decode takes `batch` one-token steps against a cache of `ctx` positions
LM_SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(ctx=32768, batch=128, kind="decode"),
    "long_500k": dict(ctx=524288, batch=1, kind="decode"),
}


def lm_cache_len(cfg: TransformerConfig, shape_name: str) -> int:
    """KV buffer slots of an LM cell: ``seq`` for prefill; for decode the
    window of an SWA config, ``min(ctx, window)``, else ``ctx``
    (``repro/configs/cells.py:116``).  A full-attention config has no
    ``long_500k`` cell (``repro`` skips it) and raises here."""
    sh = LM_SHAPES[shape_name]
    if sh["kind"] == "train":
        raise ValueError(f"{shape_name} is a training shape: no cache")
    if sh["kind"] == "prefill":
        return sh["seq"]
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        raise ValueError(f"{cfg.name}: full quadratic attention has no {shape_name} cell")
    return min(sh["ctx"], cfg.window) if cfg.window else sh["ctx"]


GNN_SHAPES = {
    "full_graph_sm": dict(n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7),
    "minibatch_lg": dict(
        n_nodes=232_965,
        n_edges=114_615_892,
        batch_nodes=1024,
        fanouts=(15, 10),
        d_feat=602,
        n_classes=41,
    ),
    "ogb_products": dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100, n_classes=47),
    "molecule": dict(n_nodes=30, n_edges=64, batch=128, d_feat=16, n_classes=1),
}

RECSYS_SHAPES = {
    "train_batch": dict(batch=65_536, kind="train"),
    "serve_p99": dict(batch=512, kind="serve"),
    "serve_bulk": dict(batch=262_144, kind="serve"),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000, kind="serve"),
}


def _union_sizes(sh) -> Tuple[int, int]:
    """Padded union-subgraph sizes ``(nodes, edges)`` of a sampled cell."""
    b = sh["batch_nodes"]
    f1, f2 = sh["fanouts"]
    nodes = b * (1 + f1 + f1 * f2)
    edges = b * f1 + b * f1 * f2
    return nodes, edges


def gcn_at_shape(cfg: GCNConfig, shape_name: str) -> GCNConfig:
    """The config at a full-graph shape's widths (``d_feat``, classes),
    as the reference's ``_spmm_family_cell`` replaces them."""
    sh = GNN_SHAPES[shape_name]
    return dataclasses.replace(cfg, d_feat=sh["d_feat"], n_classes=sh["n_classes"])


__all__ = [
    "Cell",
    "GNN_SHAPES",
    "LM_SHAPES",
    "RECSYS_SHAPES",
    "TensorSpec",
    "gcn_at_shape",
    "lm_cache_len",
    "pad512",
    "sds",
]
