"""Cells, (architecture × input shape) units, from ``repro.configs.cells``.

A :class:`Cell` names a step function and stand-ins for its positional
inputs (:class:`TensorSpec`, the port's ``jax.ShapeDtypeStruct``: a shape
and a dtype, nothing allocated), with the reference's ``kind``,
``donate`` and ``meta``.  Step kinds:

* ``train``: loss, every gradient and the AdamW update,
  ``step(params, opt_state, batch) -> (params, opt_state, loss)`` (a
  :class:`TrainStep`, which also draws the parameters and builds each
  graph's operators once, :meth:`TrainStep.prepare`);
* ``prefill`` / ``decode``: ``step(params, tokens, caches)`` /
  ``step(params, caches, token, cache_len)`` on B6;
* ``serve``: Wide & Deep scoring on B5 (``step(params, sparse, dense)``,
  retrieval ``step(params, sparse, dense, candidates)``).

``params`` is the model's parameter tree (``param_tree()``; the LM layers
a per-layer list where the reference stacks them, so its input spec is
that list too), ``opt_state`` an :class:`~repro_torch.optim.OptState`,
``batch`` a dict of tensors under the reference's keys.  The GCN and
SAGE train steps aggregate on B4 forward and backward
(``use_kernel=False``: its plain version, the yardstick), the padded CSR,
its transpose and the live rows built once per graph.  The ``dhlp-bio``
cells are built in :mod:`.dhlp_bio`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.graph.segment import segment_mean
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import recsys as recsys_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.gnn import GCNConfig
from repro_torch.models.transformer import TransformerConfig
from repro_torch.optim import OptState, adamw, make_train_step, tree_map

F32 = torch.float32
I32 = torch.int32


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


# ===================================================================== train
@dataclasses.dataclass
class TrainStep:
    """A train cell's step: ``step(params, opt_state, batch)``.

    ``loss_fn(params, batch)`` is the loss; ``init(generator, device)``
    draws a parameter tree and its optimizer state (the model's
    initialisers); ``prepare(batch)`` builds what the step needs once per
    graph (B4's padded CSR and its transpose, SAGE's hop operators),
    cached for the last graph seen (the same tensors, unmodified), so
    that its time can be kept apart from the steps'."""

    loss_fn: Callable[[Any, Dict], torch.Tensor]
    optimizer: Any
    init_params: Callable[[torch.Generator, Any], Any]
    prepare: Optional[Callable[[Dict], Any]] = None

    def __post_init__(self) -> None:
        self._step = make_train_step(self.loss_fn, self.optimizer)

    def init(self, generator: torch.Generator, device) -> Tuple[Any, OptState]:
        params = self.init_params(generator, device)
        return params, self.optimizer.init(params)

    def __call__(self, params, opt_state: OptState, batch: Dict):
        return self._step(params, opt_state, batch)


def _memo(build: Callable[[Dict], Any], keys: Tuple[str, ...]) -> Callable[[Dict], Any]:
    """``build(batch)`` computed once for the graph tensors ``batch[k]`` of
    ``keys`` and reused while the same tensor objects, unmodified, come
    back (held here, so that a new graph cannot reuse their ids)."""
    last: Dict[str, Any] = {"tensors": None}

    def get(batch: Dict):
        cur = [batch[k] for k in keys]
        hit = last["tensors"] is not None and all(
            a is b for a, b in zip(cur, last["tensors"])
        ) and [t._version for t in cur] == last["versions"]
        if not hit:
            last["tensors"] = None  # the old graph's operator goes first
            last["value"] = build(batch)
            last.update(tensors=cur, versions=[t._version for t in cur])
        return last["value"]

    return get


def _specs_of(tree):
    return tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype), tree)


def _opt_specs(param_specs) -> OptState:
    f32 = tree_map(lambda s: TensorSpec(s.shape, F32), param_specs)
    return OptState(TensorSpec((), I32), f32, f32)


def _train_cell(arch, shape_name, step: TrainStep, param_specs, batch_specs, meta) -> Cell:
    return Cell(arch=arch, shape=shape_name, kind="train", step_fn=step,
                input_specs=(param_specs, _opt_specs(param_specs), batch_specs),
                donate=(0, 1), meta=meta)


def _gen_device(generator: torch.Generator, device):
    return torch.device(device) if device is not None else generator.device


# ======================================================================= LM
def lm_cell(arch: str, cfg: TransformerConfig, shape_name: str) -> Cell:
    """The reference's ``lm_cell``: ``train_4k`` (AdamW 3e-4),
    ``prefill_32k``, ``decode_32k`` and ``long_500k`` (a noted skip for a
    config without a window)."""
    sh = LM_SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return Cell(
            arch=arch, shape=shape_name, kind="decode", step_fn=lambda *a: None,
            input_specs=(),
            skip_reason=(
                "full quadratic attention (no SWA/linear variant); "
                "524k-token serve is out of contract for this arch "
                "— see DESIGN.md §Arch-applicability"
            ),
        )
    p = tfm.param_specs(cfg)
    if shape_name == "train_4k":
        seq, batch = sh["seq"], sh["batch"]

        def init_params(gen, device):
            model = tfm.Transformer(cfg, generator=gen, device=_gen_device(gen, device),
                                    use_kernel=False)
            return model.param_tree()

        step = TrainStep(
            lambda params, b: tfm.loss_fn(cfg, params, b["tokens"], b["labels"]),
            adamw(3e-4), init_params)
        batch_specs = {"tokens": sds((batch, seq), I32), "labels": sds((batch, seq), I32)}
        return _train_cell(arch, shape_name, step, p, batch_specs, {
            "tokens": batch * seq,
            "model_flops": 6 * cfg.active_param_count() * batch * seq,
            "scan_trip": cfg.n_layers})
    if shape_name == "prefill_32k":
        seq, batch = sh["seq"], sh["batch"]

        def prefill(params, tokens, caches):
            return tfm.Transformer.from_params(cfg, params).prefill(tokens, caches)

        return Cell(
            arch=arch, shape=shape_name, kind="prefill", step_fn=prefill,
            input_specs=(p, sds((batch, seq), I32), tfm.cache_spec(cfg, batch, seq)),
            donate=(2,),
            meta={"tokens": batch * seq,
                  "model_flops": 2 * cfg.active_param_count() * batch * seq,
                  "scan_trip": cfg.n_layers})
    if shape_name in ("decode_32k", "long_500k"):
        batch = sh["batch"]
        cache_len = lm_cache_len(cfg, shape_name)

        def decode(params, caches, token, cache_len):
            return tfm.Transformer.from_params(cfg, params).decode_step(
                caches, token, int(cache_len))

        return Cell(
            arch=arch, shape=shape_name, kind="decode", step_fn=decode,
            input_specs=(p, tfm.cache_spec(cfg, batch, cache_len), sds((batch, 1), I32),
                         sds((), I32)),
            donate=(1,),
            meta={"tokens": batch, "model_flops": 2 * cfg.active_param_count() * batch,
                  "cache_len": cache_len, "scan_trip": cfg.n_layers})
    raise KeyError(f"unknown LM shape {shape_name}")


# ====================================================================== GNN
def _masked_ce(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean CE over the rows of ``mask`` (f32), the reference's ``_masked_ce``."""
    logits32 = logits.float()
    logz = torch.logsumexp(logits32, dim=-1)
    gold = torch.gather(logits32, -1, labels.long()[:, None])[:, 0]
    ce = (logz - gold) * mask
    return ce.sum() / torch.clamp(mask.sum(), min=1.0)


def _module_init(make):
    """``init_params`` of a GNN module's tree: ``make(generator, device)``."""
    return lambda gen, device: make(gen, _gen_device(gen, device)).param_tree()


def gnn_cell(arch: str, model_cfg, shape_name: str, *, use_kernel: bool = True) -> Cell:
    """The reference's ``gnn_cell`` (AdamW 1e-3); ``use_kernel=False``
    aggregates GCN and SAGE with B4's plain version on the card too."""
    sh = GNN_SHAPES[shape_name]
    opt = adamw(1e-3)
    kind_cfg = type(model_cfg).__name__
    if kind_cfg in ("GCNConfig", "GATConfig"):
        return _spmm_family_cell(arch, model_cfg, shape_name, sh, opt, use_kernel)
    if kind_cfg == "DimeNetConfig":
        return _dimenet_cell(arch, model_cfg, shape_name, sh, opt)
    if kind_cfg == "MGNConfig":
        return _mgn_cell(arch, model_cfg, shape_name, sh, opt)
    raise TypeError(kind_cfg)


def sage_config(cfg0, shape_name: str = "minibatch_lg") -> gnn_mod.SageConfig:
    """The sampled-fanout (GraphSAGE-mode) config the reference derives
    from a GCN or GAT config at ``minibatch_lg``."""
    sh = GNN_SHAPES[shape_name]
    is_gat = type(cfg0).__name__ == "GATConfig"
    return gnn_mod.SageConfig(
        name=cfg0.name, d_feat=sh["d_feat"],
        d_hidden=max(cfg0.d_hidden * (cfg0.n_heads if is_gat else 1), 64),
        n_classes=sh["n_classes"], fanouts=tuple(sh["fanouts"]),
    )


def _spmm_family_cell(arch, cfg0, shape_name, sh, opt, use_kernel) -> Cell:
    is_gat = type(cfg0).__name__ == "GATConfig"

    if shape_name == "minibatch_lg":
        # sampled-fanout execution (GraphSAGE-mode of the SpMM family)
        scfg = sage_config(cfg0, shape_name)
        nodes, _ = _union_sizes(sh)
        b = sh["batch_nodes"]
        f1, f2 = sh["fanouts"]

        def hops(batch):
            return gnn_mod.sage_hops(
                [(batch["h0_f"], batch["h0_n"], batch["h0_m"]),
                 (batch["h1_f"], batch["h1_n"], batch["h1_m"])], batch["feats"].shape[0])

        prepare = _memo(hops, ("h0_f", "h0_n", "h0_m", "h1_f", "h1_n", "h1_m"))

        def loss_fn(params, batch):
            logits = gnn_mod.sage_forward(params, batch["feats"], prepare(batch),
                                          use_kernel=use_kernel)
            return _masked_ce(logits, batch["labels"],
                              torch.ones(logits.shape[0], dtype=F32, device=logits.device))

        make = lambda gen, dev: gnn_mod.SAGE(scfg, generator=gen, device=dev)  # noqa: E731
        p = _specs_of(make(torch.Generator().manual_seed(0), "cpu").param_tree())
        batch_specs = {
            "feats": sds((nodes, sh["d_feat"]), F32),
            "h0_f": sds((b,), I32), "h0_n": sds((b, f1), I32),
            "h0_m": sds((b, f1), torch.bool),
            "h1_f": sds((b * f1,), I32), "h1_n": sds((b * f1, f2), I32),
            "h1_m": sds((b * f1, f2), torch.bool),
            "labels": sds((b,), I32),
        }
        step = TrainStep(loss_fn, opt, _module_init(make), prepare)
        return _train_cell(arch, shape_name, step, p, batch_specs,
                           {"mode": "sampled", "nodes": nodes})

    # full-graph (or batched molecule union graph) edge-list execution
    if shape_name == "molecule":
        n = pad512(sh["n_nodes"] * sh["batch"])
        e = pad512(sh["n_edges"] * sh["batch"] * 2)  # symmetrized
        num_graphs = sh["batch"]
    else:
        n, e = pad512(sh["n_nodes"]), pad512(sh["n_edges"])
        num_graphs = 0
    n_out, d_feat = sh["n_classes"], sh["d_feat"]
    cfg = dataclasses.replace(cfg0, d_feat=d_feat, n_classes=n_out)

    prepare = None
    if not is_gat:
        prepare = _memo(lambda b: gnn_mod.csr_operator(b["src"], b["dst"], b["w"], n),
                        ("src", "dst", "w"))

    def loss_fn(params, batch):
        if is_gat:
            logits = gnn_mod.gat_forward(params, batch["feats"], batch["src"], batch["dst"], n)
        else:
            op = prepare(batch)
            logits = gnn_mod.gcn_forward_csr(params, batch["feats"], op.nbr, op.wgt, op.live,
                                             op.transpose, use_kernel=use_kernel)
        if num_graphs:
            pooled = segment_mean(logits, batch["graph_ids"], num_graphs)
            return torch.mean((pooled[:, 0] - batch["targets"]) ** 2)
        return _masked_ce(logits, batch["labels"], batch["label_mask"])

    if is_gat:
        make = lambda gen, dev: gnn_mod.GAT(cfg, generator=gen, device=dev)  # noqa: E731
    else:
        make = lambda gen, dev: gnn_mod.GCN(cfg, generator=gen, device=dev)  # noqa: E731
    p = _specs_of(make(torch.Generator().manual_seed(0), "cpu").param_tree())
    batch_specs = {"feats": sds((n, d_feat), F32), "src": sds((e,), I32), "dst": sds((e,), I32)}
    if not is_gat:
        batch_specs["w"] = sds((e,), F32)
    if num_graphs:
        batch_specs["graph_ids"] = sds((n,), I32)
        batch_specs["targets"] = sds((num_graphs,), F32)
    else:
        batch_specs["labels"] = sds((n,), I32)
        batch_specs["label_mask"] = sds((n,), F32)
    step = TrainStep(loss_fn, opt, _module_init(make), prepare)
    return _train_cell(arch, shape_name, step, p, batch_specs, {"nodes": n, "edges": e})


def _dimenet_cell(arch, cfg, shape_name, sh, opt) -> Cell:
    # geometry sizes per shape; triplets are capped (the reference's DESIGN.md §8)
    if shape_name == "molecule":
        g = sh["batch"]
        n = pad512(sh["n_nodes"] * g)
        e = pad512(sh["n_edges"] * g * 2)
        t = 4 * e
    elif shape_name == "minibatch_lg":
        n, e = _union_sizes(sh)
        n, e = pad512(n), pad512(e)
        g = sh["batch_nodes"]
        t = 2 * e
    else:
        n, e = pad512(sh["n_nodes"]), pad512(sh["n_edges"])
        g = 1
        t = 2 * e

    def loss_fn(params, b):
        energy = gnn_mod.dimenet_forward(
            cfg, params, b["z"], b["pos"], b["src"], b["dst"], b["tri_kj"], b["tri_ji"],
            b["tri_mask"], b["graph_ids"], g)
        return torch.mean((energy[:, 0] - b["targets"]) ** 2)

    make = lambda gen, dev: gnn_mod.DimeNet(cfg, generator=gen, device=dev)  # noqa: E731
    p = _specs_of(make(torch.Generator().manual_seed(0), "cpu").param_tree())
    batch_specs = {
        "z": sds((n,), I32), "pos": sds((n, 3), F32), "src": sds((e,), I32),
        "dst": sds((e,), I32), "tri_kj": sds((t,), I32), "tri_ji": sds((t,), I32),
        "tri_mask": sds((t,), F32), "graph_ids": sds((n,), I32), "targets": sds((g,), F32),
    }
    return _train_cell(arch, shape_name, TrainStep(loss_fn, opt, _module_init(make)), p,
                       batch_specs, {"nodes": n, "edges": e, "triplets": t})


def _mgn_cell(arch, cfg, shape_name, sh, opt) -> Cell:
    if shape_name == "molecule":
        n = pad512(sh["n_nodes"] * sh["batch"])
        e = pad512(sh["n_edges"] * sh["batch"] * 2)
    elif shape_name == "minibatch_lg":
        n, e = _union_sizes(sh)
        n, e = pad512(n), pad512(e)
    else:
        n, e = pad512(sh["n_nodes"]), pad512(sh["n_edges"])

    def loss_fn(params, b):
        pred = gnn_mod.mgn_forward(params, b["node_feat"], b["edge_feat"], b["src"], b["dst"], n)
        return torch.mean((pred - b["targets"]) ** 2)

    make = lambda gen, dev: gnn_mod.MeshGraphNet(cfg, generator=gen, device=dev)  # noqa: E731
    p = _specs_of(make(torch.Generator().manual_seed(0), "cpu").param_tree())
    batch_specs = {
        "node_feat": sds((n, cfg.d_node_in), F32), "edge_feat": sds((e, cfg.d_edge_in), F32),
        "src": sds((e,), I32), "dst": sds((e,), I32), "targets": sds((n, cfg.d_out), F32),
    }
    return _train_cell(arch, shape_name, TrainStep(loss_fn, opt, _module_init(make)), p,
                       batch_specs, {"nodes": n, "edges": e})


# =================================================================== recsys
def recsys_param_specs(cfg: recsys_mod.WideDeepConfig) -> Dict:
    """Wide & Deep's parameter tree as specs (the 5.12 GB ``FULL`` table is
    not allocated)."""
    dims = (cfg.deep_in,) + tuple(cfg.mlp_dims) + (1,)
    dt = cfg.dtype
    return {
        "table": sds((cfg.total_vocab, cfg.embed_dim), dt),
        "wide_table": sds((cfg.total_vocab,), dt),
        "wide_dense": sds((cfg.n_dense,), dt),
        "bias": sds((), dt),
        "mlp_w": [sds((a, b), dt) for a, b in zip(dims[:-1], dims[1:])],
        "mlp_b": [sds((b,), dt) for b in dims[1:]],
    }


def recsys_cell(arch: str, cfg: recsys_mod.WideDeepConfig, shape_name: str) -> Cell:
    """The reference's ``recsys_cell``: ``train_batch`` (AdamW 1e-3, the
    plain lookups), the serve shapes and ``retrieval_cand`` on B5."""
    sh = RECSYS_SHAPES[shape_name]
    b = sh["batch"]
    p = recsys_param_specs(cfg)
    if shape_name == "train_batch":
        def init_params(gen, device):
            model = recsys_mod.WideDeep(cfg, generator=gen, device=_gen_device(gen, device))
            return model.param_tree()

        step = TrainStep(
            lambda params, bt: recsys_mod.bce_loss(
                recsys_mod.widedeep_forward(cfg, params, bt["sparse"], bt["dense"]),
                bt["labels"]),
            adamw(1e-3), init_params)
        batch_specs = {"sparse": sds((b, cfg.n_sparse), I32), "dense": sds((b, cfg.n_dense), F32),
                       "labels": sds((b,), F32)}
        return _train_cell(arch, shape_name, step, p, batch_specs, {"examples": b})

    def model(params):
        return recsys_mod.WideDeep.from_params(cfg, params)

    if shape_name == "retrieval_cand":
        def score(params, sparse_ids, dense_feats, candidates):
            return model(params).retrieval_score(np.asarray(sparse_ids.cpu()),
                                                 np.asarray(dense_feats.cpu()), candidates)

        cand = sds((pad512(sh["n_candidates"]), cfg.mlp_dims[-1]), F32)
        return Cell(
            arch=arch, shape=shape_name, kind="serve", step_fn=score,
            input_specs=(p, sds((b, cfg.n_sparse), I32), sds((b, cfg.n_dense), F32), cand),
            meta={"candidates": sh["n_candidates"]})

    def serve(params, sparse_ids, dense_feats):
        return model(params).serve(np.asarray(sparse_ids.cpu()), np.asarray(dense_feats.cpu()))

    return Cell(
        arch=arch, shape=shape_name, kind="serve", step_fn=serve,
        input_specs=(p, sds((b, cfg.n_sparse), I32), sds((b, cfg.n_dense), F32)),
        meta={"examples": b})


__all__ = [
    "Cell",
    "GNN_SHAPES",
    "LM_SHAPES",
    "RECSYS_SHAPES",
    "TensorSpec",
    "TrainStep",
    "gcn_at_shape",
    "gnn_cell",
    "lm_cache_len",
    "lm_cell",
    "pad512",
    "recsys_cell",
    "recsys_param_specs",
    "sage_config",
    "sds",
]
