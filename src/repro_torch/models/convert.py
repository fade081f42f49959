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
from repro_torch.models.transformer import Transformer


def _copy(dst: torch.Tensor, src, name: str) -> None:
    arr = np.asarray(src)
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: shape {arr.shape}, expected {tuple(dst.shape)}")
    if arr.dtype.kind not in "biuf":
        # bfloat16 (``ml_dtypes``, what np.asarray gives for a JAX bf16
        # array) has no torch counterpart in numpy form: widen to f32,
        # which is exact, and let copy_ narrow to the destination's dtype
        arr = arr.astype(np.float32)
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


def load_transformer(model: Transformer, params: Mapping) -> Transformer:
    """Load ``repro.models.transformer.init_params``'s pytree (GQA, dense
    FFN): the stacked ``(L, ...)`` arrays of ``params["layers"]`` are
    sliced into the model's per-layer parameters."""
    for name in ("embed", "final_norm", "lm_head"):
        _copy(getattr(model, name), params[name], name)
    layers = params["layers"]
    want = set(dict(model.layers[0].named_parameters())) if len(model.layers) else set(layers)
    if set(layers) != want:
        raise ValueError(f"layers: keys {sorted(layers)}, expected {sorted(want)}")
    n = len(model.layers)
    for name, stacked in layers.items():
        arr = np.asarray(stacked)
        if arr.ndim == 0 or arr.shape[0] != n:
            raise ValueError(f"layers.{name}: shape {arr.shape}, expected {n} stacked layers")
        for i, lp in enumerate(model.layers):
            _copy(getattr(lp, name), arr[i], f"layers.{name}[{i}]")
    return model


__all__ = ["load_gcn", "load_transformer", "load_widedeep"]
