"""Carry ``repro``'s model parameters into the port's modules.

``repro`` keeps parameters as pytrees of JAX arrays; a caller converts
one to numpy (``jax.tree.map(np.asarray, params)``) and loads it here, so
both packages compute with the same weights — the model counterpart of
the ``.npz`` network exchange in :mod:`repro_torch.core.network`.  The
reference's optimizer state carries across too (:func:`load_opt_state`),
onto a model's parameter tree (``param_tree()``).  This module imports
neither ``jax`` nor ``repro``: it reads plain numpy.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.models.gnn import GAT, GCN, SAGE, DimeNet, MeshGraphNet
from repro_torch.models.recsys import WideDeep
from repro_torch.models.transformer import Transformer
from repro_torch.optim import OptState, tree_leaves


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
    """Load ``repro.models.transformer.init_params``'s pytree: the stacked
    ``(L, ...)`` arrays of ``params["layers"]`` (GQA or MLA attention,
    dense or MoE FFN: the experts' ``(L, E, ...)`` stacks and the shared
    experts too) are sliced into the model's per-layer parameters.  A key
    missing or extra, or a shape that differs (another expert count, say),
    raises ``ValueError`` naming it."""
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


def _moment_tree(like, ref, name: str):
    """``ref`` (the reference's pytree of numpy arrays) in the structure of
    the port's parameter tree ``like``, as f32 tensors on each leaf's
    device.  A port list against a reference dict is a stack of layers
    (the transformer's ``layers``), sliced along its leading axis."""
    if isinstance(like, dict):
        if set(like) != set(ref):
            raise ValueError(f"{name}: keys {sorted(ref)}, expected {sorted(like)}")
        return {k: _moment_tree(like[k], ref[k], f"{name}.{k}") for k in sorted(like)}
    if isinstance(like, list):
        if isinstance(ref, dict):
            ref = [{k: np.asarray(v)[i] for k, v in ref.items()} for i in range(len(like))]
        if len(ref) != len(like):
            raise ValueError(f"{name}: {len(ref)} entries, expected {len(like)}")
        return [_moment_tree(a, b, f"{name}[{i}]") for i, (a, b) in enumerate(zip(like, ref))]
    arr = np.asarray(ref)
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{name}: shape {arr.shape}, expected {tuple(like.shape)}")
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(like.device)


def load_opt_state(params, state) -> OptState:
    """The reference's ``OptState`` with numpy leaves (``jax.tree.map(
    np.asarray, state)``) as the port's, for the port's parameter tree
    ``params``: the step as an int32 tensor, the moments f32 in
    ``params``' structure on its leaves' devices."""
    dev = tree_leaves(params)[0].device
    return OptState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32, device=dev),
        mu=_moment_tree(params, state.mu, "mu"),
        nu=None if state.nu is None else _moment_tree(params, state.nu, "nu"),
    )


__all__ = [
    "load_dimenet",
    "load_gat",
    "load_gcn",
    "load_mgn",
    "load_opt_state",
    "load_sage",
    "load_transformer",
    "load_widedeep",
]
