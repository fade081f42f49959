"""Carry ``repro``'s model parameters into the port's modules.

``repro`` keeps parameters as pytrees of JAX arrays; a caller converts
one to numpy (``jax.tree.map(np.asarray, params)``) and loads it here, so
both packages compute with the same weights — the model counterpart of
the ``.npz`` network exchange in :mod:`repro_torch.core.network`.  This
module imports neither ``jax`` nor ``repro``: it reads plain numpy.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.models.gnn import GCN
from repro_torch.models.recsys import WideDeep


def _copy(dst: torch.Tensor, src, name: str) -> None:
    arr = np.asarray(src)
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: shape {arr.shape}, expected {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.from_numpy(np.array(arr)))  # a copy: JAX's arrays are read-only


def _copy_list(dst: Sequence[torch.Tensor], src: Sequence, name: str) -> None:
    if len(dst) != len(src):
        raise ValueError(f"{name}: {len(src)} arrays, expected {len(dst)}")
    for i, (d, s) in enumerate(zip(dst, src)):
        _copy(d, s, f"{name}[{i}]")


def load_gcn(model: GCN, params: Mapping) -> GCN:
    """Load ``repro.models.gnn.gcn_init``'s ``{"w": [...], "b": [...]}``."""
    _copy_list(model.weights, params["w"], "w")
    _copy_list(model.biases, params["b"], "b")
    return model


def load_widedeep(model: WideDeep, params: Mapping) -> WideDeep:
    """Load ``repro.models.recsys.widedeep_init``'s pytree."""
    for name in ("table", "wide_table", "wide_dense", "bias"):
        _copy(getattr(model, name), params[name], name)
    _copy_list(model.mlp_w, params["mlp_w"], "mlp_w")
    _copy_list(model.mlp_b, params["mlp_b"], "mlp_b")
    return model


__all__ = ["load_gcn", "load_widedeep"]
