"""Sharding rules per architecture family: the port's ``repro.launch.shardings``.

Maps every input of a :class:`~repro_torch.configs.cells.Cell` (params,
optimizer state, batch) to a layout on the production mesh:

  LM     — TP over ``model`` (heads / ff / experts), DP over pod×data;
           KV caches shard sequence over ``model`` (sequence-parallel
           serving) and batch over pod×data.
  GNN    — node/edge arrays over pod×data, params replicated.
  recsys — embedding tables vocab-sharded over ``model``; batch over
           pod×data.
  lp     — edges over ``model``, seed columns over pod×data.

A dim is sharded only if the axis size divides it; otherwise the rule
drops that axis, as the reference's ``_maybe`` does.

Each rule first builds the reference's ``PartitionSpec`` of a leaf, a
:data:`Spec`: per TENSOR dim, None or the mesh axes over it (major to
minor).  ``hints.placements`` then inverts it into DTensor placements, one
per MESH dim: a mesh dim that splits tensor dim ``d`` is ``Shard(d)``,
any other ``Replicate()``.  A tensor dim over ``("pod", "data")`` is
``Shard(d)`` on both mesh dims, the pod dim the major one, as in JAX.
The rules read leaf names as the reference's ``tree_map_with_path`` does:
a dict key, or ``"[i]"`` for a list element, so a list leaf never matches
a named rule there either.  The port keeps an LM's layers as a list of
per-layer trees where the reference stacks them on a leading layer axis;
a layer leaf's spec is the reference's for the stacked leaf without that
axis.

:func:`register_scatter_shardings` gives DTensor the scatters'
strategies that the LP and GAT steps need (see its docstring).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple, Union

from repro_torch.configs.cells import Cell, TensorSpec
from repro_torch.launch.mesh import data_axes
from repro_torch.optim import OptState
from repro_torch.parallel.hints import placements

#: per tensor dim: None, one mesh axis, or a tuple of them
Axes = Optional[Union[str, Tuple[str, ...]]]


class Spec(tuple):
    """A leaf's per-tensor-dim axes (the reference's ``PartitionSpec``)."""


def _axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    names = mesh.mesh_dim_names
    n = 1
    for a in axes:
        n *= mesh.size(names.index(a))
    return n


def _maybe(mesh, dim_size: int, axes) -> Axes:
    """``axes`` if they divide ``dim_size``, else None."""
    return axes if dim_size % _axis_size(mesh, axes) == 0 else None


def _norm(axes) -> Axes:
    """One axis as a name, several as a tuple, none as None (``P``'s forms)."""
    if isinstance(axes, tuple):
        return None if not axes else (axes[0] if len(axes) == 1 else axes)
    return axes


def _spec(ndim: int, *lead: Axes) -> Spec:
    """A spec of ``ndim`` dims: ``lead`` then None (``P(*lead)`` padded)."""
    return Spec(tuple(_norm(a) for a in lead) + (None,) * (ndim - len(lead)))


def _map_named(fn: Callable[[str, Any], Any], tree, name: str = "") -> Any:
    """``tree``'s structure with ``fn(name, leaf)`` at every leaf; ``name``
    the leaf's last path key (dict key, ``"[i]"``, NamedTuple field)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, str(k)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_named(fn, v, f"[{i}]") for i, v in enumerate(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_named(fn, v, f) for f, v in zip(tree._fields, tree)))
    if isinstance(tree, tuple):
        return tuple(_map_named(fn, v, f"[{i}]") for i, v in enumerate(tree))
    return fn(name, tree)


def _replicated(tree) -> Any:
    return _map_named(lambda _n, leaf: _spec(len(leaf.shape)), tree)


# ====================================================================== LM
_COL = {"wq", "wk", "wv", "q_a", "q_b", "kv_b", "shared_gate", "shared_up"}  # (L, in, out)
_ROW = {"wo", "o", "shared_down"}  # (L, in, out): in over TP


def _lm_leaf_spec(mesh, name: str, shape: Tuple[int, ...]) -> Spec:
    """The reference's tensor-parallel spec of a leaf by name, on its
    stacked shape (layer leaves carry the leading layer axis here)."""
    mdl, nd = "model", len(shape)
    if name == "embed" and nd == 2:
        return _spec(2, _maybe(mesh, shape[0], mdl), None)
    if name == "lm_head" and nd == 2:
        return _spec(2, None, _maybe(mesh, shape[1], mdl))
    if name in ("w_gate", "w_up", "w_down"):
        if nd == 4:  # MoE (L, E, a, b)
            if shape[1] % mesh.size(mesh.mesh_dim_names.index(mdl)) == 0:
                return _spec(4, None, mdl)  # expert-parallel: experts over model
            # E not divisible: TP inside each expert on the ff dim instead
            ff_dim = 3 if name in ("w_gate", "w_up") else 2
            spec = [None] * 4
            spec[ff_dim] = _maybe(mesh, shape[ff_dim], mdl)
            return _spec(4, *spec)
        if name == "w_down":  # dense (L, ff, d)
            return _spec(3, None, _maybe(mesh, shape[1], mdl))
        return _spec(3, None, None, _maybe(mesh, shape[2], mdl))
    if name in _COL and nd == 3:
        return _spec(3, None, None, _maybe(mesh, shape[2], mdl))
    if name in _ROW and nd == 3:
        return _spec(3, None, _maybe(mesh, shape[1], mdl))
    return _spec(nd)  # norms, routers, kv_a: replicated


def _lm_param_specs(mesh, p_specs) -> Any:
    n_layers = len(p_specs.get("layers", ()))

    def layer(name, leaf):
        return Spec(_lm_leaf_spec(mesh, name, (n_layers,) + tuple(leaf.shape))[1:])

    out = {k: _map_named(lambda n, leaf: _lm_leaf_spec(mesh, n, tuple(leaf.shape)), v, k)
           for k, v in p_specs.items() if k != "layers"}
    if "layers" in p_specs:
        out["layers"] = [_map_named(layer, lay) for lay in p_specs["layers"]]
    return out


def _opt_state_specs(o_specs: OptState, p_sh) -> OptState:
    """Optimizer moments mirror the parameters; the step is replicated."""
    return OptState(step=_spec(0), mu=p_sh, nu=p_sh if o_specs.nu is not None else None)


def _cache_spec(mesh, cache: TensorSpec, dp) -> Spec:
    """KV cache: batch over dp, sequence over model (sequence-parallel)."""
    shape = cache.shape
    if len(shape) == 6:  # GQA (L, 2, B, S, hkv, hd)
        return _spec(6, None, None, _maybe(mesh, shape[2], dp), _maybe(mesh, shape[3], "model"))
    # MLA (L, B, S, r)
    return _spec(4, None, _maybe(mesh, shape[1], dp), _maybe(mesh, shape[2], "model"))


def _batch_spec(mesh, v: TensorSpec, dp) -> Spec:
    return _spec(len(v.shape), _maybe(mesh, v.shape[0], dp))


def lm_specs(mesh, cell: Cell) -> Tuple:
    dp = data_axes(mesh)
    p_sh = _lm_param_specs(mesh, cell.input_specs[0])
    if cell.kind == "train":
        o_specs, batch = cell.input_specs[1], cell.input_specs[2]
        return (p_sh, _opt_state_specs(o_specs, p_sh),
                {k: _batch_spec(mesh, v, dp) for k, v in batch.items()})
    if cell.kind == "prefill":
        tokens, cache = cell.input_specs[1], cell.input_specs[2]
        return (p_sh, _batch_spec(mesh, tokens, dp), _cache_spec(mesh, cache, dp))
    if cell.kind == "decode":
        cache, token = cell.input_specs[1], cell.input_specs[2]
        return (p_sh, _cache_spec(mesh, cache, dp), _batch_spec(mesh, token, dp), _spec(0))
    raise ValueError(cell.kind)


# ===================================================================== GNN
def gnn_specs(mesh, cell: Cell) -> Tuple:
    dp = data_axes(mesh)
    p_specs, o_specs, batch = cell.input_specs
    p_sh = _replicated(p_specs)
    o_sh = OptState(step=_spec(0), mu=_replicated(o_specs.mu),
                    nu=None if o_specs.nu is None else _replicated(o_specs.nu))
    return (p_sh, o_sh, {k: _batch_spec(mesh, v, dp) for k, v in batch.items()})


# ================================================================== recsys
def recsys_specs(mesh, cell: Cell) -> Tuple:
    dp = data_axes(mesh)

    def spec_for(name, leaf):
        nd = len(leaf.shape)
        if name in ("table", "wide_table"):
            return _spec(nd, _maybe(mesh, leaf.shape[0], "model"))
        if name == "mlp_w" and nd == 2 and leaf.shape[1] > 64:
            return _spec(2, None, _maybe(mesh, leaf.shape[1], "model"))
        return _spec(nd)

    p_sh = _map_named(spec_for, cell.input_specs[0])
    if cell.kind == "train":
        o_specs, batch = cell.input_specs[1], cell.input_specs[2]
        o_sh = OptState(step=_spec(0), mu=p_sh, nu=None if o_specs.nu is None else p_sh)
        return (p_sh, o_sh, {k: _batch_spec(mesh, v, dp) for k, v in batch.items()})
    return (p_sh,) + tuple(_batch_spec(mesh, v, dp) for v in cell.input_specs[1:])


# ====================================================================== LP
def lp_specs(mesh, cell: Cell) -> Tuple:
    dp = data_axes(mesh)
    src, _dst, _w, Y, _F = cell.input_specs
    edge = _spec(1, _maybe(mesh, src.shape[0], "model"))
    seeds = _spec(2, None, _maybe(mesh, Y.shape[1], dp))
    return (edge, edge, edge, seeds, seeds)


FAMILY_SHARDINGS = {
    "lm": lm_specs,
    "gnn": gnn_specs,
    "recsys": recsys_specs,
    "lp": lp_specs,
}


def specs_for(mesh, family: str, cell: Cell) -> Tuple:
    """Each input's :data:`Spec` (the reference's ``PartitionSpec``), in
    the structure of ``cell.input_specs``."""
    return FAMILY_SHARDINGS[family](mesh, cell)


def shardings_for(mesh, family: str, cell: Cell) -> Tuple:
    """Each input's DTensor placements on ``mesh``, in the structure of
    ``cell.input_specs`` (the reference's ``NamedSharding`` tree)."""
    return _map_specs(lambda s: placements(mesh, s), specs_for(mesh, family, cell))


def _map_specs(fn, tree):
    """``fn`` at every :class:`Spec` of a spec tree."""
    if tree is None or isinstance(tree, Spec):
        return None if tree is None else fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_specs(fn, v) for v in tree]
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_specs(fn, v) for v in tree))
    return tuple(_map_specs(fn, v) for v in tree)


_REGISTERED = []


def register_scatter_shardings() -> None:
    """Give DTensor strategies for the scatters the steps run (once per
    process): ``aten.index_add`` (a segment sum, the LP step's
    aggregation) and ``aten.scatter_reduce.two`` (a segment max or min,
    GAT's edge softmax), for which it has none.

    Per mesh dim: all replicated stays replicated; index and source split
    on the scattered dim (edges) give a partial result, the initial
    ``self`` taken as partial too, so the scatter is reduced afterwards by
    one all-reduce (sum, max or min), as the reference's program does, and
    not by gathering the edges; and ``self``, index and source split alike
    on another dim stay split."""
    if _REGISTERED:
        return
    import torch
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.index_add.default)
    def _index_add(self, dim, index, source, alpha=1):
        d = dim % self.ndim
        out = [([Replicate()], [Replicate(), None, Replicate(), Replicate(), None]),
               ([Partial()], [Partial(), None, Shard(0), Shard(d), None])]
        for k in range(self.ndim):
            if k != d:
                out.append(([Shard(k)], [Shard(k), None, Replicate(), Shard(k), None]))
        return out

    @register_sharding(torch.ops.aten.scatter_reduce.two)
    def _scatter_reduce(self, dim, index, src, reduce, include_self=True):
        d = dim % self.ndim
        op = {"sum": "sum", "amax": "max", "amin": "min"}[reduce]
        out = [([Replicate()], [Replicate(), None, Replicate(), Replicate(), None, None]),
               ([Partial(op)], [Partial(op), None, Shard(d), Shard(d), None, None])]
        for k in range(self.ndim):
            if k != d:
                out.append(([Shard(k)], [Shard(k), None, Shard(k), Shard(k), None, None]))
        return out

    _REGISTERED.extend([_index_add, _scatter_reduce])


__all__ = [
    "FAMILY_SHARDINGS",
    "Spec",
    "gnn_specs",
    "lm_specs",
    "lp_specs",
    "recsys_specs",
    "register_scatter_shardings",
    "shardings_for",
    "specs_for",
]
