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

from repro_torch.models.gnn import GAT, GCN, SAGE, DimeNet, MeshGraphNet
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


def _copy_dict(dst, src: Mapping, name: str) -> None:
    if set(src) != set(dst.keys()):
        raise ValueError(f"{name}: keys {sorted(src)}, expected {sorted(dst.keys())}")
    for key in src:
        _copy(dst[key], src[key], f"{name}.{key}")


def _copy_blocks(dst: Sequence, src: Sequence, name: str, load) -> None:
    if len(dst) != len(src):
        raise ValueError(f"{name}: {len(src)} entries, expected {len(dst)}")
    for i, (d, s) in enumerate(zip(dst, src)):
        load(d, s, f"{name}[{i}]")


def load_gat(model: GAT, params: Mapping) -> GAT:
    """Load ``repro.models.gnn.gat_init``'s ``{"layers": [{"w", "a_src",
    "a_dst"}, ...]}``."""
    _copy_blocks(model.layers, params["layers"], "layers", _copy_dict)
    return model


def load_dimenet(model: DimeNet, params: Mapping) -> DimeNet:
    """Load ``repro.models.gnn.dimenet_init``'s pytree."""
    for name in ("embed_z", "rbf_proj", "msg_mlp_w", "msg_mlp_b", "out_w1", "out_w2"):
        _copy(getattr(model, name), params[name], name)
    _copy_blocks(model.blocks, params["blocks"], "blocks", _copy_dict)
    return model


def _load_mgn_mlp(mod, p: Mapping, name: str) -> None:
    _copy_list(mod.w, p["w"], f"{name}.w")
    _copy_list(mod.b, p["b"], f"{name}.b")
    _copy(mod.ln_g, p["ln_g"], f"{name}.ln_g")
    _copy(mod.ln_b, p["ln_b"], f"{name}.ln_b")


def load_mgn(model: MeshGraphNet, params: Mapping) -> MeshGraphNet:
    """Load ``repro.models.gnn.mgn_init``'s pytree."""
    for name in ("node_enc", "edge_enc", "decoder"):
        _load_mgn_mlp(getattr(model, name), params[name], name)

    def load_block(blk, p, name):
        _load_mgn_mlp(blk["edge"], p["edge"], f"{name}.edge")
        _load_mgn_mlp(blk["node"], p["node"], f"{name}.node")

    _copy_blocks(model.blocks, params["blocks"], "blocks", load_block)
    return model


def load_sage(model: SAGE, params: Mapping) -> SAGE:
    """Load ``repro.models.gnn.sage_init``'s pytree."""
    _copy(model.w_in, params["w_in"], "w_in")
    _copy_list(model.w_nbr, params["w_nbr"], "w_nbr")
    _copy_list(model.w_self, params["w_self"], "w_self")
    _copy(model.w_out, params["w_out"], "w_out")
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


__all__ = [
    "load_dimenet",
    "load_gat",
    "load_gcn",
    "load_mgn",
    "load_sage",
    "load_transformer",
    "load_widedeep",
]
