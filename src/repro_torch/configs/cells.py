"""The shapes of the LM, GCN and Wide & Deep cells, from ``repro.configs.cells``.

Only the shape tables, the LM cache-length rule and ``pad512``: the
``ArchSpec`` registry and the dry-run ``Cell`` machinery wait for the
slice that ports ``launch/``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.gnn import GCNConfig
from repro_torch.models.transformer import TransformerConfig


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


def gcn_at_shape(cfg: GCNConfig, shape_name: str) -> GCNConfig:
    """The config at a full-graph shape's widths (``d_feat``, classes),
    as the reference's ``_spmm_family_cell`` replaces them."""
    sh = GNN_SHAPES[shape_name]
    return dataclasses.replace(cfg, d_feat=sh["d_feat"], n_classes=sh["n_classes"])


__all__ = ["GNN_SHAPES", "LM_SHAPES", "RECSYS_SHAPES", "gcn_at_shape", "lm_cache_len", "pad512"]
