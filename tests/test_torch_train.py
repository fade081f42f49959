"""The port's train steps vs the JAX reference's, on the CPU.

Loss and every gradient of one step, from ``repro``'s parameters carried
across by ``repro_torch.models.convert`` on inputs made with numpy from a
seed, at f32 ``rtol=1e-4, atol=1e-5``:

* the five LM archs at ``REDUCED`` (``loss_fn`` with remat on, with and
  without ``ce_chunk``, attention chunked and unchunked, a padded vocab),
  the port's per-layer gradients stacked as the reference's;
* the GCN, GAT, SAGE, DimeNet and MeshGraphNet train cells
  (``gnn_cell``'s step on shapes cut to a few hundred nodes in both
  packages' ``GNN_SHAPES``): the reference's loss function read from its
  step's closure; GCN and SAGE on both routes of the port (B4's wrapper
  with ``CSRAggregate``, here the plain versions; and the plain version);
* Wide & Deep ``REDUCED``'s ``make_train_step`` loss.

Then the loss over 5 AdamW steps of the LM, GCN and W&D steps, and each
cell's ``TrainStep`` against the reference's step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import cells as jax_cells
from repro.configs import registry as jax_registry
from repro.configs import wide_deep as jax_wide_deep
from repro.models import gnn as jax_gnn
from repro.models import recsys as jax_rec
from repro.models import transformer as jt
from repro.optim import adamw as jax_adamw
from repro_torch.configs import cells, registry, wide_deep
from repro_torch.models import convert
from repro_torch.models import recsys as rec
from repro_torch.models import transformer as pt
from repro_torch.optim import adamw, tree_leaves, value_and_grad

TOL = dict(rtol=1e-4, atol=1e-5)
KEY = jax.random.PRNGKey(0)
LM_ARCHS = ["granite-moe-3b-a800m", "moonshot-v1-16b-a3b", "h2o-danube-1.8b", "stablelm-1.6b",
            "minicpm3-4b"]


def _port_config(cfg):
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if cfg.moe is not None:
        fields["moe"] = pt.MoEConfig(**dataclasses.asdict(cfg.moe))
    if cfg.mla is not None:
        fields["mla"] = pt.MLAConfig(**dataclasses.asdict(cfg.mla))
    fields["dtype"] = torch.bfloat16 if cfg.dtype == jnp.bfloat16 else torch.float32
    return pt.TransformerConfig(**fields)


def _close_trees(mine, ref, tol=TOL):
    a, b = tree_leaves(mine), jax.tree.leaves(ref)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert tuple(x.shape) == tuple(np.shape(y))
        np.testing.assert_allclose(x.detach().float().numpy(), np.asarray(y, np.float32), **tol)


def _stacked(tree):
    """The port's LM tree with its per-layer list stacked as the reference's."""
    out = dict(tree)
    out["layers"] = {k: torch.stack([lp[k] for lp in tree["layers"]]) for k in tree["layers"][0]}
    return out


def _lm_case(arch, **over):
    jcfg = dataclasses.replace(jax_registry.get_arch(arch).reduced_config, **over)
    pcfg = _port_config(jcfg)
    params = jt.init_params(jcfg, KEY)
    model = convert.load_transformer(pt.Transformer(pcfg, device="cpu", use_kernel=False),
                                     jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    return jcfg, pcfg, params, model.param_tree(), toks, labels


LM_VARIANTS = {
    "plain": {},
    "ce_chunk": {"ce_chunk": 8},
    "attn_chunk": {"attn_chunk": 8, "ce_chunk": 16},
    "padded_vocab": {"vocab": 100},
}


@pytest.mark.parametrize("variant", list(LM_VARIANTS))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_loss_and_gradients_match_the_reference(arch, variant):
    jcfg, pcfg, jp, tp, toks, labels = _lm_case(arch, **LM_VARIANTS[variant])
    assert jcfg.remat and pcfg.remat
    jl, jg = jax.value_and_grad(lambda p: jt.loss_fn(jcfg, p, jnp.asarray(toks),
                                                     jnp.asarray(labels)))(jp)
    tl, tg = value_and_grad(lambda p, b: pt.loss_fn(pcfg, p, *b), tp,
                            (torch.from_numpy(toks), torch.from_numpy(labels)))
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    _close_trees(_stacked(tg), jg)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "granite-moe-3b-a800m", "minicpm3-4b"])
def test_lm_losses_over_five_steps_match_the_reference(arch):
    jcfg, pcfg, jp, tp, toks, labels = _lm_case(arch, ce_chunk=8)
    jstep = jax.jit(jt.make_train_step(jcfg, jax_adamw(3e-3)))
    opt = adamw(3e-3)
    tstep = pt.make_train_step(pcfg, opt)
    js, ts = jax_adamw(3e-3).init(jp), opt.init(tp)
    rng = np.random.default_rng(9)
    for _ in range(5):
        t = rng.integers(0, jcfg.vocab, (2, 17)).astype(np.int32)
        jb = {"tokens": jnp.asarray(t[:, :-1]), "labels": jnp.asarray(t[:, 1:])}
        tb = {"tokens": torch.from_numpy(t[:, :-1]), "labels": torch.from_numpy(t[:, 1:])}
        jp, js, jl = jstep(jp, js, jb)
        tp, ts, tl = tstep(tp, ts, tb)
        np.testing.assert_allclose(float(tl), float(jl), **TOL)


# ---------------------------------------------------------------- the cells
TINY_SHAPES = {
    "full_graph_sm": dict(n_nodes=300, n_edges=1200, d_feat=12, n_classes=5),
    "minibatch_lg": dict(n_nodes=2000, n_edges=20000, batch_nodes=8, fanouts=(3, 2),
                         d_feat=10, n_classes=4),
    "molecule": dict(n_nodes=5, n_edges=8, batch=4, d_feat=6, n_classes=1),
}


@pytest.fixture
def tiny_shapes(monkeypatch):
    for name, sh in TINY_SHAPES.items():
        monkeypatch.setitem(jax_cells.GNN_SHAPES, name, sh)
        monkeypatch.setitem(cells.GNN_SHAPES, name, sh)


def _ref_loss_fn(step):
    """The reference cell's loss function, from its train step's closure."""
    return dict(zip(step.__code__.co_freevars, (c.cell_contents for c in step.__closure__)))[
        "loss_fn"]


def _int(rng, hi, n):
    return rng.integers(0, hi, n).astype(np.int32)


def _gnn_batch(shape, specs, seed=0):
    """A batch under the cell's keys and shapes: random graph tensors."""
    rng = np.random.default_rng(seed)
    out = {}
    n = specs.get("feats", specs.get("z", specs.get("node_feat"))).shape[0]
    e = specs["src"].shape[0] if "src" in specs else 0
    for k, s in specs.items():
        if s.dtype == torch.float32:
            out[k] = rng.normal(0, 1, s.shape).astype(np.float32)
        elif s.dtype == torch.bool:
            out[k] = rng.random(s.shape) < 0.7
    if "src" in specs:
        out["src"] = _int(rng, n, e)
        out["dst"] = ((out["src"] + 1 + _int(rng, n - 1, e)) % n).astype(np.int32)
    if "w" in specs:
        out["w"] = rng.uniform(0.05, 0.5, e).astype(np.float32)
    if "label_mask" in specs:
        out["label_mask"] = (rng.random(n) < 0.5).astype(np.float32)
    if "labels" in specs:
        out["labels"] = _int(rng, TINY_SHAPES[shape]["n_classes"], specs["labels"].shape[0])
    if "graph_ids" in specs:
        g = specs["targets"].shape[0]
        out["graph_ids"] = np.sort(_int(rng, g, n))
    if "z" in specs:
        out["z"] = _int(rng, 16, n)
        t = specs["tri_kj"].shape[0]
        out["tri_kj"], out["tri_ji"] = _int(rng, e, t), _int(rng, e, t)
        out["tri_mask"] = (rng.random(t) < 0.8).astype(np.float32)
    if "h0_f" in specs:  # distinct frontiers of local ids, the seeds first
        b, f1 = specs["h0_n"].shape
        perm = rng.permutation(n).astype(np.int32)
        out["h0_f"], out["h1_f"] = perm[:b], perm[b : b + b * f1]
        out["h0_n"] = _int(rng, n, specs["h0_n"].shape)
        out["h1_n"] = _int(rng, n, specs["h1_n"].shape)
    assert set(out) == set(specs)
    return out


def _ref_params(arch, shape):
    jcfg0 = jax_registry.get_arch(arch).reduced_config
    kind = type(jcfg0).__name__
    if shape == "minibatch_lg" and kind in ("GCNConfig", "GATConfig"):
        sh = TINY_SHAPES[shape]
        is_gat = kind == "GATConfig"
        scfg = jax_gnn.SageConfig(
            name=jcfg0.name, d_feat=sh["d_feat"],
            d_hidden=max(jcfg0.d_hidden * (jcfg0.n_heads if is_gat else 1), 64),
            n_classes=sh["n_classes"], fanouts=tuple(sh["fanouts"]))
        return jax_gnn.sage_init(scfg, KEY)
    if kind in ("GCNConfig", "GATConfig"):
        sh = TINY_SHAPES[shape]
        jcfg = dataclasses.replace(jcfg0, d_feat=sh["d_feat"], n_classes=sh["n_classes"])
        init = jax_gnn.gat_init if kind == "GATConfig" else jax_gnn.gcn_init
        return init(jcfg, KEY)
    if kind == "DimeNetConfig":
        return jax_gnn.dimenet_init(jcfg0, KEY)
    return jax_gnn.mgn_init(jcfg0, KEY)


def _port_params(params, cell):
    """The reference's parameters in the port's tree (the cell draws one of
    the right layout; the loaders fill it)."""
    tree = cell.step_fn.init_params(torch.Generator().manual_seed(0), "cpu")
    flat = jax.tree.leaves(params)
    mine = tree_leaves(tree)
    assert [tuple(t.shape) for t in mine] == [tuple(np.shape(a)) for a in flat]
    with torch.no_grad():
        for t, a in zip(mine, flat):
            t.copy_(torch.from_numpy(np.array(a, np.float32)))
    return tree


GNN_CASES = [
    ("gcn-cora", "full_graph_sm", True), ("gcn-cora", "full_graph_sm", False),
    ("gcn-cora", "molecule", True), ("gcn-cora", "minibatch_lg", True),
    ("gcn-cora", "minibatch_lg", False), ("gat-cora", "full_graph_sm", True),
    ("gat-cora", "molecule", True), ("gat-cora", "minibatch_lg", True),
    ("dimenet", "molecule", True), ("meshgraphnet", "molecule", True),
    ("meshgraphnet", "full_graph_sm", True),
]


def _cells(arch, shape, use_kernel):
    jcfg0 = jax_registry.get_arch(arch).reduced_config
    pcfg0 = registry.get_arch(arch).reduced_config
    return (jax_cells.gnn_cell(arch, jcfg0, shape),
            cells.gnn_cell(arch, pcfg0, shape, use_kernel=use_kernel))


@pytest.mark.parametrize("arch,shape,use_kernel", GNN_CASES)
def test_gnn_cell_loss_and_gradients_match_the_reference(tiny_shapes, arch, shape, use_kernel):
    ref, mine = _cells(arch, shape, use_kernel)
    assert (mine.kind, mine.donate, mine.meta) == (ref.kind, ref.donate, ref.meta)
    batch = _gnn_batch(shape, mine.input_specs[2])
    jparams = _ref_params(arch, shape)
    jl, jg = jax.value_and_grad(_ref_loss_fn(ref.step_fn))(
        jparams, jax.tree.map(jnp.asarray, batch))
    tparams = _port_params(jparams, mine)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tl, tg = value_and_grad(mine.step_fn.loss_fn, tparams, tb)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    _close_trees(tg, jg)


@pytest.mark.parametrize("arch,shape", [("gcn-cora", "full_graph_sm"),
                                        ("gcn-cora", "minibatch_lg"),
                                        ("meshgraphnet", "molecule")])
def test_gnn_cell_steps_match_the_reference_over_five_steps(tiny_shapes, arch, shape):
    ref, mine = _cells(arch, shape, True)
    batch = _gnn_batch(shape, mine.input_specs[2], seed=3)
    jparams = _ref_params(arch, shape)
    jstate = jax_adamw(1e-3).init(jparams)
    tparams = _port_params(jparams, mine)
    tstate = mine.step_fn.optimizer.init(tparams)
    jb = jax.tree.map(jnp.asarray, batch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    built = mine.step_fn.prepare(tb) if mine.step_fn.prepare else None
    for _ in range(5):
        jparams, jstate, jl = ref.step_fn(jparams, jstate, jb)
        tparams, tstate, tl = mine.step_fn(tparams, tstate, tb)
        np.testing.assert_allclose(float(tl), float(jl), **TOL)
    if built is not None:  # the operators were built once for the graph
        assert mine.step_fn.prepare(tb) is built
    _close_trees(tparams, jparams, dict(rtol=1e-3, atol=1e-4))


# ------------------------------------------------------------------ recsys
def _ctr_batch(cfg, b, seed):
    rng = np.random.default_rng(seed)
    return {"sparse": _int(rng, cfg.vocab_per_field, (b, cfg.n_sparse)),
            "dense": rng.normal(0, 1, (b, cfg.n_dense)).astype(np.float32),
            "labels": (rng.random(b) < 0.3).astype(np.float32)}


def test_wide_deep_loss_gradients_and_steps_match_the_reference():
    jcfg, pcfg = jax_wide_deep.REDUCED, wide_deep.REDUCED
    jp = jax_rec.widedeep_init(jcfg, KEY)
    model = convert.load_widedeep(rec.WideDeep(pcfg, device="cpu"), jax.tree.map(np.asarray, jp))
    tp = model.param_tree()
    batch = _ctr_batch(pcfg, 64, 0)
    jb = jax.tree.map(jnp.asarray, batch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jl, jg = jax.value_and_grad(
        lambda p: jax_rec.bce_loss(jax_rec.widedeep_forward(jcfg, p, jb["sparse"], jb["dense"]),
                                   jb["labels"]))(jp)
    tl, tg = value_and_grad(
        lambda p, b: rec.bce_loss(rec.widedeep_forward(pcfg, p, b["sparse"], b["dense"]),
                                  b["labels"]), tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    _close_trees(tg, jg)
    jstep = jax_rec.make_train_step(jcfg, jax_adamw(1e-3))
    opt = adamw(1e-3)
    tstep = rec.make_train_step(pcfg, opt)
    js, ts = jax_adamw(1e-3).init(jp), opt.init(tp)
    for s in range(5):
        batch = _ctr_batch(pcfg, 64, s + 1)
        jp, js, jl = jstep(jp, js, jax.tree.map(jnp.asarray, batch))
        tp, ts, tl = tstep(tp, ts, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(tl), float(jl), **TOL)
    _close_trees(tp, jp, dict(rtol=1e-3, atol=1e-4))


def test_recsys_train_cell_step_runs_at_reduced():
    cell = cells.recsys_cell("wide-deep", wide_deep.REDUCED, "train_batch")
    params, state = cell.step_fn.init(torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _ctr_batch(wide_deep.REDUCED, 32, 0).items()}
    losses = []
    for _ in range(5):
        params, state, loss = cell.step_fn(params, state, batch)
        losses.append(float(loss))
    assert losses[-1] < losses[0] and int(state.step) == 5


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "granite-moe-3b-a800m"])
def test_reference_optimizer_state_carries_across(arch):
    """``convert.load_opt_state``: the reference's AdamW state after two
    steps (numpy leaves, the layers stacked) continues on the port's tree
    as it continues in the reference."""
    jcfg, pcfg, jp, tp, toks, labels = _lm_case(arch)
    jopt = jax_adamw(3e-3)
    jstep = jax.jit(jt.make_train_step(jcfg, jopt))
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    js = jopt.init(jp)
    for _ in range(2):
        jp, js, _ = jstep(jp, js, jb)
    model = convert.load_transformer(pt.Transformer(pcfg, device="cpu", use_kernel=False),
                                     jax.tree.map(np.asarray, jp))
    tp = model.param_tree()
    ts = convert.load_opt_state(tp, jax.tree.map(np.asarray, js))
    assert int(ts.step) == 2 and ts.step.dtype == torch.int32
    _close_trees(_stacked(ts.mu), js.mu)
    _close_trees(_stacked(ts.nu), js.nu)
    jp, js, jl = jstep(jp, js, jb)
    tp, ts, tl = pt.make_train_step(pcfg, adamw(3e-3))(
        tp, ts, {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    _close_trees(_stacked(ts.mu), js.mu)
    with pytest.raises(ValueError, match="mu"):
        convert.load_opt_state(tp, jax.tree.map(np.asarray, js._replace(mu={"embed": 0})))


def test_prepared_operator_is_rebuilt_for_a_new_graph(tiny_shapes):
    """The GCN cell builds its padded CSR and transpose once per graph:
    the same batch tensors reuse it, new or modified ones rebuild it."""
    cell = cells.gnn_cell("gcn-cora", registry.get_arch("gcn-cora").reduced_config,
                          "full_graph_sm")
    prepare = cell.step_fn.prepare
    b1 = {k: torch.from_numpy(v) for k, v in _gnn_batch("full_graph_sm",
                                                         cell.input_specs[2], 1).items()}
    op = prepare(b1)
    assert prepare(dict(b1)) is op
    b2 = {k: torch.from_numpy(v) for k, v in _gnn_batch("full_graph_sm",
                                                         cell.input_specs[2], 2).items()}
    before = prepare(b2)
    assert before is not op
    b2["w"].mul_(2.0)  # modified in place: a new operator
    after = prepare(b2)
    assert after is not before
    torch.testing.assert_close(after.wgt, 2.0 * before.wgt)
