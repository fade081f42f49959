"""Multi-pod dry run: trace every (arch × shape × mesh) cell and take its
per-device census.  The port's ``repro.launch.dryrun``.

For each cell :func:`run_cell`:

  1. builds the step function and its inputs' specs
     (``get_arch(a).make_cell(s)``; nothing is allocated);
  2. lays the inputs over the production mesh (:mod:`.mesh`: 16×16 for one
     pod, 2×16×16 for two, a fake world of 256 or 512 ranks in this one
     process) with the family's placements (:mod:`.shardings`), as DTensors
     whose local shards are fake tensors (``FakeTensorMode`` over CPU
     tensors): every kernel wrapper therefore takes its plain version,
     and the census counts the reference step's work, not the hand
     kernels';
  3. runs ``step_fn`` once, eagerly, under :class:`Census`, a dispatch mode
     that sees rank 0's LOCAL ops (a DTensor op is left to DTensor, which
     calls the op again on the local shards) and counts, by XLA's
     ``HloCostAnalysis`` rules: FLOPs (matmul-family ops by
     ``torch.utils.flop_counter``'s formulas on local shapes, one per
     output element of an elementwise op, one per input element of a
     reduction or a scatter-add's source, transcendentals apart, nothing
     for views, gathers, copies and casts), bytes accessed (operand plus
     output bytes of every op that is not a view), and the collectives
     DTensor issues, by the reference's five kinds, with each result's
     local bytes;
  4. records it under the reference's keys: ``status``, ``cost``,
     ``memory``, ``collectives``, ``probe``, ``lower_s`` (the trace's
     seconds).  Nothing is compiled, so there is no ``compile_s``; the
     eager program has no loop body, so every round is counted at top
     level and the ``loop_*`` buckets are 0.  ``memory`` holds the local
     argument, output and alias (donated output) bytes; no live-storage
     peak is tracked, so there is no ``temp_size_in_bytes``.

What DTensor does besides the step is not the step's work and is not
counted: the fake runs of its sharding propagation, and the local
reshuffles of a redistribution (chunking, the division that makes a
replicated tensor partial), whose collectives are counted.  On a CPU mesh
DTensor rewrites a shard-to-shard all-to-all as an all-gather and a
chunk; the census records the all-to-all that NCCL would issue instead
(its input's bytes) and nothing of the rewrite.  Ops that no rule
classifies are counted for bytes only and listed under ``unclassified``.

A cell that cannot be placed or traced is an ``error`` record with its
traceback, and so is a trace that counts no FLOPs.  Where DTensor would
not lay an op out as the reference's GSPMD program does, the census takes
a fallback and counts it under ``fallbacks`` (see :class:`Census`); a parameter
(a sharded leaf of the step's first input) is never laid out anew, and a
step that would gather one is an ``error``.

The sweep is a RunSpec stage (``{"dryrun": {...}}`` →
``Session.dryrun``); ``main`` below is the deprecated shim over it.

Usage (deprecated shim):
  python -m repro_torch.launch.dryrun --arch stablelm-1.6b --shape train_4k \\
      --mesh single --out results/dryrun.jsonl
  python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import time
import traceback
from typing import Any, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute",
)

#: functional-collective ops -> the reference's collective kinds
_COLLECTIVE_KIND = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}

#: elementwise ops whose elements XLA counts as transcendentals, not FLOPs
_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh", "sigmoid", "rsqrt",
    "sqrt", "sin", "cos", "tan", "erf", "erfc", "erfinv", "pow", "atan", "atan2", "asin",
    "acos", "sinh", "cosh", "reciprocal",
}
#: elementwise ops that are one transcendental plus one FLOP per element
_TRANSCENDENTAL_PLUS_ONE = {"silu", "gelu", "softplus", "logit", "sigmoid_backward",
                            "tanh_backward", "silu_backward", "gelu_backward"}
#: elementwise ops not tagged pointwise: one FLOP per output element
_ELEMENTWISE = {"elu_backward", "leaky_relu_backward", "threshold_backward",
                "hardtanh_backward"}
#: ops that cost nothing: layout, allocation, metadata
_FREE = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "detach",
    "detach_", "lift_fresh", "lift_fresh_copy", "alias", "device", "sym_size", "sym_stride",
    "sym_numel", "sym_storage_offset", "_unsafe_view", "is_same_size", "_local_scalar_dense", "wait_tensor",
    "resize_", "set_", "_has_compatible_shallow_copy_type", "_to_copy_", "dim", "is_contiguous",
    "item", "promote_types",
}
#: moves of data with no arithmetic: bytes, no FLOPs
_COPY = {
    "_to_copy", "copy", "copy_", "clone", "contiguous", "index", "index_select", "gather",
    "scatter", "slice_backward", "select_backward", "index_select_backward",
    "embedding", "cat", "stack", "zeros", "zeros_like", "ones", "ones_like", "full",
    "full_like", "fill", "fill_", "zero_", "new_zeros", "new_ones", "new_full", "arange",
    "scalar_tensor", "constant_pad_nd", "repeat", "flip", "roll", "tril", "triu", "where_",
    "masked_select", "nonzero", "index_put", "index_put_", "slice_scatter", "select_scatter",
    "diagonal_scatter", "as_strided_scatter", "_unsafe_index", "narrow_copy", "randperm",
    "rand", "randn", "randint", "bernoulli", "bernoulli_", "normal_", "uniform_",
}
#: scatter-adds: one FLOP per element of the source
_SCATTER_ADD = {"index_add", "index_add_", "scatter_add", "scatter_add_", "scatter_reduce",
                "scatter_reduce_", "embedding_dense_backward", "_unsafe_index_put",
                "index_put_with_accumulate"}
#: composite ops eager PyTorch runs as one: FLOPs and transcendentals per
#: input element, as XLA counts their expansion (max, subtract, exp, sum,
#: divide for a softmax)
_COMPOSITE = {
    "_softmax": (4, 1), "_log_softmax": (4, 1), "_softmax_backward_data": (4, 0),
    "_log_softmax_backward_data": (4, 1), "native_layer_norm": (8, 1),
    "native_layer_norm_backward": (12, 0), "nll_loss_forward": (1, 0),
    "nll_loss_backward": (1, 0), "logsumexp": (3, 1), "cumsum": (1, 0), "cumprod": (1, 0),
    "mse_loss": (3, 0), "mse_loss_backward": (3, 0),
}


_VIEW_OPS = (torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default,
             torch.ops.aten.reshape.default)
_MATMUL_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
               torch.ops.aten.addmm.default)


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _tensors(tree) -> List[torch.Tensor]:
    from torch.utils._pytree import tree_leaves

    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _view_groups(shape, new_shape) -> List[Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """How a view of ``shape`` to ``new_shape`` maps dims: pairs of (input
    dims, output dims) whose sizes multiply alike, size-1 dims left out."""
    new_shape = list(new_shape)
    if -1 in new_shape:
        known = math.prod(d for d in new_shape if d != -1)
        new_shape[new_shape.index(-1)] = math.prod(shape) // max(known, 1)
    old = [d for d in range(len(shape)) if shape[d] != 1]
    new = [d for d in range(len(new_shape)) if new_shape[d] != 1]
    groups, i, j = [], 0, 0
    while i < len(old) and j < len(new):
        gi, gj = [old[i]], [new[j]]
        a, b = shape[old[i]], new_shape[new[j]]
        while a != b:
            if a < b:
                i += 1
                gi.append(old[i])
                a *= shape[old[i]]
            else:
                j += 1
                gj.append(new[j])
                b *= new_shape[new[j]]
        groups.append((tuple(gi), tuple(gj)))
        i, j = i + 1, j + 1
    return groups


def _empty_collectives() -> Dict[str, Dict[str, float]]:
    return {k: {"count": 0, "bytes": 0, "loop_count": 0, "loop_bytes": 0}
            for k in _COLLECTIVES}


class Census(TorchDispatchMode):
    """Counts the local ops of one rank (see the module docstring).

    ``paused`` > 0 stops all counting; ``reshuffling`` > 0 stops the
    counting of everything but collectives.  Before DTensor lays out a
    view or a product, and after it returns a masked partial, the census
    may change the layout (:meth:`_before_view`, :meth:`_settle_product`,
    :meth:`_reduce_masked`); each such fallback is counted in
    ``fallbacks``."""

    def __init__(self, guarded=()):
        super().__init__()
        self.flops = 0.0
        self.transcendentals = 0.0
        self.bytes = 0.0
        self.collectives = _empty_collectives()
        self.unclassified: Dict[str, int] = {}
        self.fallbacks: Dict[str, int] = {}
        self.paused = 0
        self.reshuffling = 0
        #: the local shards of the parameters (sharded step inputs), which
        #: no redistribution may lay out anew
        self.guarded_storage = {_storage(t._local_tensor) for t in guarded}
        self._keep = list(guarded)  # keeps the storages alive
        self._pass_through = None  # the op _dtensor_op hands to DTensor
        self.op = None  # the DTensor op being laid out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self._pass_through is func:  # the call _dtensor_op just made
                self._pass_through = None
                return NotImplemented  # DTensor runs it again on the local shards
            with self:  # counting on while DTensor works
                return self._dtensor_op(func, args, kwargs)
        out = func(*args, **kwargs)
        if not self.paused:
            self.count(func, args, kwargs, out)
        return out

    def _dtensor_op(self, func, args, kwargs):
        self.op = func
        if func in _VIEW_OPS and hasattr(args[0], "placements"):
            args = (self._before_view(func, args[0], args[1]),) + tuple(args[1:])
        elif func in _MATMUL_OPS:
            args = self._settle_product(func, args)
        self._pass_through = func
        try:
            return self._reduce_masked(func, func(*args, **kwargs))
        finally:
            self._pass_through = None

    def _before_view(self, func, x, shape):
        """``x`` ready for a view to ``shape``.  DTensor describes a split of
        a merged dim anywhere but its first part as a strided shard, which
        its propagation and redistribution cannot handle on fake tensors,
        and it splits a dim whose sharding does not divide the dim's first
        part into local shapes that do not fit.  So, per mesh dim, first:
        a mesh dim that splits a later dim of a merged group moves, by an
        all-to-all, to the group's first dim or else to a dim the view
        keeps, where the size divides, and is replicated failing both;
        then a dim split into parts keeps only the mesh dims (major first)
        whose ways divide its first part.  Each change is noted as a
        fallback."""
        from torch.distributed.tensor import Replicate, Shard

        groups = _view_groups(tuple(x.shape), tuple(shape))
        group_of = {d: g for g in groups for d in g[0]}
        kept = [g[0][0] for g in groups if len(g[0]) == 1 and len(g[1]) == 1]
        pl, mesh, notes = list(x.placements), x.device_mesh, []

        def ways(t, but=None):
            return math.prod(mesh.size(j) for j, q in enumerate(pl)
                             if q.is_shard() and q.dim == t and j != but)

        for i, p in enumerate(pl):
            g = group_of.get(p.dim) if p.is_shard() else None
            if g is None or p.dim == g[0][0]:
                continue
            for t in (g[0][0],) + tuple(kept):
                later = any(q.is_shard() and q.dim == t for q in pl[i + 1:])
                if x.shape[t] % (mesh.size(i) * ways(t, i)) == 0 and not later:
                    pl[i] = Shard(t)
                    break
            else:
                pl[i] = Replicate()
            notes.append(f"merged sharded dims, mesh dim {mesh.mesh_dim_names[i]} "
                         + ("replicated" if pl[i].is_replicate() else f"moved to dim {pl[i].dim}"))
        for ins, outs in groups:
            if len(ins) != 1 or len(outs) < 2:
                continue
            first = shape[outs[0]]
            for i in reversed(range(len(pl))):  # the minor mesh dim first
                if pl[i].is_shard() and pl[i].dim == ins[0] and first % ways(ins[0]) != 0:
                    pl[i] = Replicate()
                    notes.append(f"split of a sharded dim, mesh dim {mesh.mesh_dim_names[i]} "
                                 "replicated")
        if not notes:
            return x
        if self.is_guarded_local(x._local_tensor):
            raise RuntimeError(f"{func}: a view of the sharded parameter {tuple(x.shape)} "
                               f"needs it laid out anew ({'; '.join(notes)})")
        for n in notes:
            self._note(f"{func}: {n}")
        return x.redistribute(mesh, pl)

    def _settle_product(self, func, args):
        """A product's operands laid out alike on every mesh dim, as a
        weight-stationary SPMD program lays them.  Per mesh dim, each
        operand's split is a role (batch, rows M, contraction K, columns N,
        or none).  Matching roles stand (batch with batch, K with K, M or N
        against none).  An operand that is not split where the other is
        split on batch or K takes that split itself, which needs no
        communication.  Two splits that clash are settled by replicating
        one operand there, the smaller, or always the one that is not a
        parameter: DTensor would otherwise be free to gather a parameter
        whole, or the far larger product."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        i_a, i_b = (1, 2) if func is torch.ops.aten.addmm.default else (0, 1)
        a, b = args[i_a], args[i_b]
        if not (isinstance(a, DTensor) and isinstance(b, DTensor)):
            return args
        batched = a.dim() == 3
        roles_a = {a.dim() - 2: "M", a.dim() - 1: "K", 0: "B"} if batched else {0: "M", 1: "K"}
        roles_b = {b.dim() - 2: "K", b.dim() - 1: "N", 0: "B"} if batched else {0: "K", 1: "N"}
        dim_of = ({"B": 0, "K": a.dim() - 1}, {"B": 0, "K": b.dim() - 2})
        pa, pb = list(a.placements), list(b.placements)
        param_a, param_b = (self.is_guarded_local(t._local_tensor) for t in (a, b))

        def role(p, roles):
            return "R" if p.is_replicate() else ("P" if p.is_partial() else roles[p.dim])

        for i in range(len(pa)):
            ra, rb = role(pa[i], roles_a), role(pb[i], roles_b)
            if (ra, rb) in (("R", "R"), ("B", "B"), ("K", "K"), ("M", "R"), ("R", "N"),
                            ("P", "R"), ("R", "P")):
                continue
            if ra == "P":  # a partial sum is reduced, scattered where the split needs it
                pa[i] = Shard(dim_of[0][rb]) if rb in ("B", "K") else Replicate()
                continue
            if rb == "P":
                pb[i] = Shard(dim_of[1][ra]) if ra in ("B", "K") else Replicate()
                continue
            if "R" not in (ra, rb):  # a clash: replicate one side
                drop_a = param_b or (not param_a and _nbytes(a._local_tensor)
                                     <= _nbytes(b._local_tensor))
                if drop_a:
                    pa[i], ra = Replicate(), "R"
                else:
                    pb[i], rb = Replicate(), "R"
            if ra == "R" and rb in ("B", "K"):
                pa[i] = Shard(dim_of[0][rb])
            elif rb == "R" and ra in ("B", "K"):
                pb[i] = Shard(dim_of[1][ra])
        out = list(args)
        for k, t, pl, param in ((i_a, a, pa, param_a), (i_b, b, pb, param_b)):
            if tuple(pl) != tuple(t.placements):
                if param and any(c.is_shard() and c != n for c, n in zip(t.placements, pl)):
                    raise RuntimeError(f"{func}: the product needs the parameter "
                                       f"{tuple(t.shape)} laid out anew")
                self._note(f"{func}: operands laid out alike")
                out[k] = t.redistribute(t.device_mesh, pl)
        return tuple(out)

    def is_guarded_local(self, local) -> bool:
        """Whether ``local`` holds a parameter's shard: the shard itself, a
        view of it, or autograd's saved alias of it."""
        return _storage(local) in self.guarded_storage

    def _reduce_masked(self, func, out):
        """``out`` with any masked partial (a lookup into a split vocab:
        each rank's rows, zeros elsewhere) reduced at once, by the
        all-reduce XLA issues for it.  DTensor would defer the reduction,
        and its mask no longer fits the tensor once a later view or
        reduction changes the shape."""
        from torch.distributed.tensor import DTensor, Replicate

        def reduce(t):
            if not isinstance(t, DTensor) or not any(hasattr(p, "mask_buffer")
                                                      for p in t.placements):
                return t
            self._note(f"{func}: masked partial reduced at once")
            return t.redistribute(t.device_mesh, [Replicate() if hasattr(p, "mask_buffer") else p
                                                  for p in t.placements])

        if isinstance(out, (tuple, list)):
            return type(out)(reduce(t) for t in out)
        return reduce(out)

    def _note(self, what: str) -> None:
        self.fallbacks[what] = self.fallbacks.get(what, 0) + 1

    def collective(self, kind: str, nbytes: int) -> None:
        self.collectives[kind]["count"] += 1
        self.collectives[kind]["bytes"] += int(nbytes)

    def count(self, func, args, kwargs, out) -> None:
        name = func._schema.name.split("::")[-1]
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d_functional", "_dtensor") and name in _COLLECTIVE_KIND:
            self.collective(_COLLECTIVE_KIND[name], sum(_nbytes(t) for t in _tensors(out)))
            return
        if self.reshuffling or name in _FREE or ns in ("prim", "_c10d_functional") \
                or func.is_view:
            return
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        flops, trans = self._flops(func, name, ins, outs, args, kwargs, out)
        self.flops += flops
        self.transcendentals += trans

    def _flops(self, func, name, ins, outs, args, kwargs, out):
        from torch.utils.flop_counter import flop_registry

        packet = func.overloadpacket
        if packet in flop_registry:
            return float(flop_registry[packet](*args, **kwargs, out_val=out)), 0.0
        if name in ("mv", "dot", "vdot"):
            return float(2 * ins[0].numel()), 0.0
        if name in _COPY:
            return 0.0, 0.0
        if name in _SCATTER_ADD:
            src = kwargs.get("source", kwargs.get("src"))
            if name in ("index_add", "index_add_"):
                src = args[3]
            elif name.startswith("scatter"):
                src = args[3] if len(args) > 3 else src
            elif name in ("embedding_dense_backward",):
                src = args[0]
            else:  # index_put with accumulate: the values
                src = args[2] if len(args) > 2 else kwargs.get("values")
            return float(src.numel() if isinstance(src, torch.Tensor) else 0), 0.0
        if name in _COMPOSITE:
            f, t = _COMPOSITE[name]
            n = ins[0].numel() if ins else 0
            return float(f * n), float(t * n)
        if name in ("sort", "topk", "argsort", "kthvalue", "msort"):
            x = ins[0]
            dim = args[1] if len(args) > 1 and isinstance(args[1], int) else -1
            k = x.shape[dim] if x.dim() else 1
            return float(x.numel() * max(1, math.ceil(math.log2(max(k, 2))))), 0.0
        if torch.Tag.pointwise in func.tags or name in _ELEMENTWISE:
            n = outs[0].numel() if outs else 0
            base = name.rstrip("_")
            if base in _TRANSCENDENTAL:
                return 0.0, float(n)
            if base in _TRANSCENDENTAL_PLUS_ONE:
                return float(n), float(n)
            return float(n), 0.0
        if torch.Tag.reduction in func.tags or name in (
                "sum", "mean", "amax", "amin", "max", "min", "prod", "var", "std", "var_mean",
                "std_mean", "norm", "linalg_vector_norm", "any", "all", "argmax", "argmin",
                "aminmax", "count_nonzero"):
            return float(ins[0].numel() if ins else 0), 0.0
        self.unclassified[str(func)] = self.unclassified.get(str(func), 0) + 1
        return 0.0, 0.0


@contextlib.contextmanager
def _dtensor_internals(census: Census):
    """Scope the census to the step's own work while DTensor runs (module
    docstring): its fake sharding-propagation runs are not counted, the
    local ops of a redistribution count only their collectives, and a
    shard-to-shard all-to-all is recorded as such before DTensor's CPU
    fallback rewrites it."""
    import torch.distributed.tensor._api as api
    import torch.distributed.tensor._dispatch as dispatch
    import torch.distributed.tensor._redistribute as redistribute
    import torch.distributed.tensor.placement_types as placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    def scoped(fn, attr):
        def wrapped(*a, **k):
            setattr(census, attr, getattr(census, attr) + 1)
            try:
                return fn(*a, **k)
            finally:
                setattr(census, attr, getattr(census, attr) - 1)

        return wrapped

    def all_to_all(fn):
        def wrapped(input, *a, **k):
            if not census.paused:
                census.collective("all-to-all", _nbytes(input))
            return scoped(fn, "paused")(input, *a, **k)

        return wrapped

    def reshuffle(fn):
        def wrapped(local, current, target, *a, **k):
            if census.is_guarded_local(local) and any(
                    c.is_shard() and c != t for c, t in zip(current.placements, target.placements)):
                raise RuntimeError(
                    f"{census.op}: the step lays out its sharded parameter {tuple(current.shape)} anew, "
                    f"{current.placements} -> {target.placements}, where the reference keeps it")
            return scoped(fn, "reshuffling")(local, current, target, *a, **k)

        return wrapped

    patches = [
        (ShardingPropagator, "_propagate_tensor_meta_non_cached",
         lambda fn: scoped(fn, "paused")),
        (dispatch, "redistribute_local_tensor", reshuffle),
        (redistribute, "redistribute_local_tensor", reshuffle),
        (api, "redistribute_local_tensor", reshuffle),
        (placement_types, "shard_dim_alltoall", all_to_all),
    ]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    try:
        for (obj, attr, wrap), (_, _, orig) in zip(patches, saved):
            setattr(obj, attr, wrap(orig))
        yield
    finally:
        for obj, attr, orig in saved:
            setattr(obj, attr, orig)


def _place(specs, placements, mesh, fake_mode, scalar_value: int):
    """The cell's inputs as DTensors with fake local shards: each
    ``TensorSpec`` laid out by its placements.  A 0-d integer positional
    input (a decode position, which the step reads on the host) is the
    Python int ``scalar_value``."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.configs.cells import TensorSpec

    def leaf(spec: TensorSpec, pl):
        local = list(spec.shape)
        for i, p in enumerate(pl):
            if isinstance(p, Shard):
                if local[p.dim] % mesh.size(i):
                    raise ValueError(f"dim {p.dim} of {spec.shape} does not split over mesh "
                                     f"dim {mesh.mesh_dim_names[i]} ({mesh.size(i)})")
                local[p.dim] //= mesh.size(i)
        with fake_mode:
            t = torch.empty(local, dtype=spec.dtype)
        stride = torch.empty(spec.shape, dtype=spec.dtype, device="meta").stride()
        return DTensor.from_local(t, mesh, pl, run_check=False, shape=torch.Size(spec.shape),
                                  stride=stride)

    def walk(s, p):
        if s is None:
            return None
        if isinstance(s, TensorSpec):
            return leaf(s, p)
        if isinstance(s, dict):
            return {k: walk(v, p[k]) for k, v in s.items()}
        if isinstance(s, list):
            return [walk(v, q) for v, q in zip(s, p)]
        if hasattr(s, "_fields"):
            return type(s)(*(walk(v, q) for v, q in zip(s, p)))
        return tuple(walk(v, q) for v, q in zip(s, p))

    return tuple(scalar_value if isinstance(s, TensorSpec) and s.shape == ()
                 and not s.dtype.is_floating_point else walk(s, p)
                 for s, p in zip(specs, placements))


def _local_bytes(tree) -> int:
    return sum(_nbytes(getattr(t, "_local_tensor", t)) for t in _tensors(tree))


def trace_cell(cell, placements, mesh) -> Dict[str, Any]:
    """Run ``cell.step_fn`` once on fake DTensors laid out by
    ``placements``; returns the census: ``cost``, ``memory``,
    ``collectives``, ``unclassified`` and the trace's seconds."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.shardings import register_scatter_shardings
    from repro_torch.parallel.hints import ambient_mesh

    register_scatter_shardings()
    fake = FakeTensorMode(allow_non_fake_inputs=False)
    args = _place(cell.input_specs, placements, mesh, fake,
                  int(cell.meta.get("cache_len", 1)) - 1)
    census = Census(guarded=[t for t in _tensors(args[0])
                             if any(p.is_shard() for p in t.placements)])
    t0 = time.perf_counter()
    with ambient_mesh(mesh), fake, implicit_replication(), _dtensor_internals(census), census:
        out = cell.step_fn(*args)
    seconds = time.perf_counter() - t0
    donated = [_local_bytes(args[i]) for i in cell.donate]
    out_bytes = _local_bytes(out)
    return {
        "seconds": seconds,
        "cost": {"flops": census.flops, "transcendentals": census.transcendentals,
                 "bytes accessed": census.bytes},
        "memory": {
            "argument_size_in_bytes": _local_bytes(args),
            "output_size_in_bytes": out_bytes,
            "alias_size_in_bytes": min(sum(donated), out_bytes),
        },
        "collectives": census.collectives,
        "unclassified": dict(sorted(census.unclassified.items())),
        "fallbacks": dict(sorted(census.fallbacks.items())),
    }


def run_cell(arch: str, shape: str, mesh_kind: str) -> Dict[str, Any]:
    """One cell's census record on the ``single`` or ``multi`` mesh."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.shardings import shardings_for

    spec = get_arch(arch)
    cell = spec.make_cell(shape)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape, "mesh": mesh_kind,
        "family": spec.family, "kind": cell.kind, "meta": cell.meta,
    }
    if cell.skip_reason:
        rec["status"] = "skipped"
        rec["skip_reason"] = cell.skip_reason
        return rec
    with make_production_mesh(multi_pod=(mesh_kind == "multi")) as mesh:
        try:
            got = trace_cell(cell, shardings_for(mesh, spec.family, cell), mesh)
            if got["cost"]["flops"] <= 0:
                raise RuntimeError("the trace counted no FLOPs")
        except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
            rec["status"] = "error"
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc()[-4000:]
            return rec
        rec["status"] = "ok"
        rec["lower_s"] = round(got["seconds"], 2)
        rec["memory"] = got["memory"]
        rec["cost"] = got["cost"]
        rec["collectives"] = got["collectives"]
        for key in ("unclassified", "fallbacks"):
            if got[key]:
                rec[key] = got[key]
        # the reference's scan-cost probes, trip 0 (no layers or rounds) and 1
        if cell.meta.get("scan_trip") and spec.make_probe_cell is not None:
            rec["probe"] = {}
            for trip in (0, 1):
                try:
                    pc = spec.make_probe_cell(shape, trip)
                    pcost = trace_cell(pc, shardings_for(mesh, spec.family, pc), mesh)["cost"]
                    rec["probe"][str(trip)] = {"flops": pcost["flops"],
                                               "bytes": pcost["bytes accessed"]}
                except Exception as e:  # noqa: BLE001
                    rec["probe"][str(trip)] = {"error": f"{type(e).__name__}: {e}"}
    return rec


def main() -> None:
    """Deprecated CLI shim: builds the equivalent dryrun-only RunSpec and
    runs it through :class:`repro_torch.api.session.Session` on the CPU."""
    import shutil
    import warnings

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true", help="run every assigned (arch × shape) cell")
    ap.add_argument("--include-extra", action="store_true",
                    help="also run the dhlp-bio LP cells")
    ap.add_argument("--out", default="results/dryrun.jsonl",
                    help="mirror the census JSONL here (legacy path)")
    ap.add_argument("--skip-done", action="store_true",
                    help="(deprecated) ignored — the spec-driven sweep always runs every "
                         "configured cell")
    ap.add_argument("--results-root", default="results")
    args = ap.parse_args()

    warnings.warn(
        "python -m repro_torch.launch.dryrun is a shim; use a RunSpec with a 'dryrun' section "
        "(python -m repro_torch run) instead",
        DeprecationWarning,
        stacklevel=2,
    )
    if args.skip_done:
        print("[dryrun] --skip-done is deprecated and ignored")
    if not args.all and not args.arch:
        ap.error("--arch required unless --all")

    from repro_torch.api import DryrunSpec, RunSpec, Session

    spec = RunSpec(
        dryrun=DryrunSpec(
            archs=(args.arch,) if args.arch else None,
            shapes=(args.shape,) if args.shape else None,
            mesh=args.mesh,
            include_extra=args.include_extra,
        )
    )
    session = Session(spec, results_root=args.results_root, device="cpu")
    artifacts = session.run()
    census = os.path.join(session.run_dir, "telemetry", "dryrun.jsonl")
    if args.out and os.path.exists(census):
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        shutil.copyfile(census, args.out)
        print(f"[dryrun] census mirrored to {args.out}")
    summary = next(a for a in artifacts if a.kind == "dryrun").summary()
    print(f"[dryrun] {summary['cells']} cells: {summary['statuses']}")


if __name__ == "__main__":
    main()
