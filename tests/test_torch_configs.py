"""The port's arch registry and the ``dhlp-bio`` step vs the JAX reference,
on the CPU.

The registry (``repro_torch.configs``) must list the reference's 11 archs
with equal families, shapes, sources and configs (dtypes mapped), and the
same cell grid.  ``dhlp-bio``'s cells must have the reference's input
specs, ``meta`` and ``donate`` with and without ``REPRO_LP_DTYPE=bf16``,
and its step must agree with the reference's at the f32 tolerance of
``tests/test_kernels.py::_tol`` (bf16 at 2e-2) on the network of
``tests/test_arch_smoke.py::TestDHLPBioSmoke``, on both of its routes:
the plain loop and the width-bucket plan of ``csr_round`` launches (their
plain version here).  The card's run of the plan is in
``test_torch_zoo_gpu.py``.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import cells as jax_cells
from repro.configs import dhlp_bio as jax_dhlp
from repro.configs import registry as jax_registry
from repro.core import HeteroNetwork
from repro.core.solver import LPConfig as JaxLPConfig
from repro_torch.configs import cells, dhlp_bio, registry
from repro_torch.kernels import launch_counts
from repro_torch.models.transformer import Transformer

F32_TOL = dict(rtol=2e-4, atol=5e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
DTYPES = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.int32): torch.int32}


def _plain(x):
    """A config as nested plain values, the reference's dtypes mapped to torch's."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, (tuple, list)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, (type, np.dtype)):  # a JAX/numpy dtype
        return DTYPES[jnp.dtype(x)]
    return x


class TestRegistry:
    def test_arch_ids_and_modules_are_the_reference(self):
        assert registry.ARCH_IDS == jax_registry.ARCH_IDS
        assert registry._MODULES == jax_registry._MODULES
        assert registry.list_archs() == jax_registry.list_archs()
        assert [f.name for f in dataclasses.fields(registry.ArchSpec)] == [
            f.name for f in dataclasses.fields(jax_registry.ArchSpec)
        ]

    @pytest.mark.parametrize("arch", jax_registry.ARCH_IDS)
    def test_arch_spec_is_the_reference(self, arch):
        mine, ref = registry.get_arch(arch), jax_registry.get_arch(arch)
        assert (mine.arch_id, mine.family, mine.shapes, mine.source) == (
            ref.arch_id, ref.family, ref.shapes, ref.source
        )
        assert _plain(mine.full_config) == _plain(ref.full_config)
        assert _plain(mine.reduced_config) == _plain(ref.reduced_config)
        assert (mine.make_probe_cell is None) == (ref.make_probe_cell is None)
        if arch in ("granite-moe-3b-a800m", "moonshot-v1-16b-a3b", "h2o-danube-1.8b",
                    "stablelm-1.6b", "minicpm3-4b", "wide-deep"):
            assert mine.full_config.param_count() == ref.full_config.param_count()

    def test_all_cells_are_the_reference(self):
        assert registry.all_cells() == jax_registry.all_cells()
        assert registry.all_cells(include_extra=True) == jax_registry.all_cells(include_extra=True)
        assert len(registry.all_cells()) == 40

    def test_unknown_arch_raises(self):
        with pytest.raises(KeyError, match="unknown arch"):
            registry.get_arch("gpt-5")

    @pytest.mark.parametrize("arch", [a for a in jax_registry.ARCH_IDS if a != "dhlp-bio"])
    def test_other_cells_raise_naming_their_queue_items(self, arch):
        """Every (arch, shape) of ``all_cells()`` builds (the queue items
        A.9.4's cells once raised for): the reference's kind, donate,
        meta and skip reason, and its input specs leaf for leaf (the
        port's per-layer LM parameters stacked as the reference's);
        ``make_probe_cell`` at 1 and 2 layers likewise."""
        spec, ref = registry.get_arch(arch), jax_registry.get_arch(arch)
        for shape in spec.shapes:
            _assert_cell_is_the_reference(spec.make_cell(shape), ref.make_cell(shape))
        if spec.make_probe_cell is not None:
            for trip in (1, 2):
                _assert_cell_is_the_reference(spec.make_probe_cell(spec.shapes[0], trip),
                                              ref.make_probe_cell(ref.shapes[0], trip))

    @pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "moonshot-v1-16b-a3b", "minicpm3-4b"])
    def test_moe_and_mla_models_build_and_run_a_forward(self, arch):
        cfg = registry.get_arch(arch).reduced_config
        model = Transformer(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 12))
        logits, caches = model(toks)
        assert caches is None and logits.shape == (2, 12, cfg.padded_vocab)
        assert bool(torch.isfinite(logits).all())


class TestCells:
    def test_cell_has_the_reference_fields(self):
        assert [f.name for f in dataclasses.fields(cells.Cell)] == [
            f.name for f in dataclasses.fields(jax_cells.Cell)
        ]

    def test_sds_is_a_shape_and_dtype(self):
        spec = cells.sds((np.int64(3), 4.0), torch.bfloat16)
        assert spec == cells.TensorSpec((3, 4), torch.bfloat16)
        ref = jax_cells.sds((np.int64(3), 4.0), jnp.bfloat16)
        assert spec.shape == ref.shape and DTYPES[jnp.dtype(ref.dtype)] == spec.dtype

    @pytest.mark.parametrize("shape", ["minibatch_lg"])
    def test_union_sizes_are_the_reference(self, shape):
        sh = cells.GNN_SHAPES[shape]
        assert cells._union_sizes(sh) == jax_cells._union_sizes(jax_cells.GNN_SHAPES[shape])
        assert cells._union_sizes(sh) == (169_984, 168_960)


def _specs(cell):
    return [(tuple(s.shape), _plain(s.dtype)) for s in cell.input_specs]


def _spec_leaves(tree):
    """(shape, dtype) of every spec leaf in flatten order; the port's list
    of per-layer LM dicts stacked as the reference's ``(L, ...)`` arrays."""
    if isinstance(tree, cells.TensorSpec):
        return [(tuple(tree.shape), tree.dtype)]
    if isinstance(tree, dict):
        if "layers" in tree and isinstance(tree["layers"], list) and "embed" in tree:
            layers = tree["layers"]
            stacked = {k: cells.TensorSpec((len(layers),) + layers[0][k].shape, layers[0][k].dtype)
                       for k in layers[0]}
            tree = dict(tree, layers=stacked)
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _spec_leaves(v)]
    raise TypeError(type(tree))


def _ref_spec_leaves(tree):
    return [(tuple(s.shape), DTYPES[jnp.dtype(s.dtype)] if jnp.dtype(s.dtype) in DTYPES
             else torch.bool) for s in jax.tree.leaves(tree)]


def _assert_cell_is_the_reference(mine, ref):
    assert (mine.arch, mine.shape, mine.kind, mine.donate, mine.meta, mine.skip_reason) == (
        ref.arch, ref.shape, ref.kind, ref.donate, ref.meta, ref.skip_reason)
    assert len(mine.input_specs) == len(ref.input_specs)
    for a, b in zip(mine.input_specs, ref.input_specs):
        assert _spec_leaves(a) == _ref_spec_leaves(b)
    if mine.kind == "train":
        assert isinstance(mine.step_fn, cells.TrainStep)
        assert set(mine.input_specs[2]) == set(ref.input_specs[2])


class TestLPCell:
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    @pytest.mark.parametrize("shape", list(jax_dhlp.LP_SHAPES))
    def test_cell_is_the_reference(self, monkeypatch, shape, dtype):
        if dtype == "bf16":
            monkeypatch.setenv("REPRO_LP_DTYPE", "bf16")
        else:
            monkeypatch.delenv("REPRO_LP_DTYPE", raising=False)
        mine = registry.get_arch("dhlp-bio").make_cell(shape)
        ref = jax_registry.get_arch("dhlp-bio").make_cell(shape)
        assert _specs(mine) == _specs(ref)
        assert mine.input_specs[2].dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
        assert (mine.arch, mine.shape, mine.kind, mine.donate, mine.meta, mine.skip_reason) == (
            ref.arch, ref.shape, ref.kind, ref.donate, ref.meta, ref.skip_reason
        )

    @pytest.mark.parametrize("rounds", [1, 2])
    def test_probe_cell_is_the_reference(self, rounds):
        mine = registry.get_arch("dhlp-bio").make_probe_cell("scale_1m", rounds)
        ref = jax_registry.get_arch("dhlp-bio").make_probe_cell("scale_1m", rounds)
        assert _specs(mine) == _specs(ref) and mine.meta == ref.meta

    def test_configs_and_shapes_are_the_reference(self):
        assert dhlp_bio.LP_SHAPES == jax_dhlp.LP_SHAPES
        assert dhlp_bio.SHAPES == jax_dhlp.SHAPES
        assert dataclasses.asdict(dhlp_bio.FULL) == dataclasses.asdict(jax_dhlp.FULL)
        assert dataclasses.asdict(dhlp_bio.REDUCED) == dataclasses.asdict(jax_dhlp.REDUCED)


@pytest.mark.parametrize(
    "module, env, value",
    [
        ("granite_moe_3b_a800m", "REPRO_MOE_CAPACITY", "1.25"),
        ("granite_moe_3b_a800m", "REPRO_MOE_GROUP", "512"),
        ("granite_moe_3b_a800m", "REPRO_MOE_PAD", "40"),
        ("minicpm3_4b", "REPRO_MLA_ABSORBED", "0"),
    ],
)
def test_config_switches_read_the_reference_environment(monkeypatch, module, env, value):
    mine = importlib.import_module(f"repro_torch.configs.{module}")
    ref = importlib.import_module(f"repro.configs.{module}")
    default = _plain(mine.FULL)
    monkeypatch.setenv(env, value)
    try:
        importlib.reload(mine)
        importlib.reload(ref)
        assert _plain(mine.FULL) == _plain(ref.FULL)
        assert _plain(mine.FULL) != default
    finally:
        monkeypatch.delenv(env)
        importlib.reload(mine)
        importlib.reload(ref)
    assert _plain(mine.FULL) == default


def _smoke_network():
    """``tests/test_arch_smoke.py::TestDHLPBioSmoke``'s network: the fused
    operator's COO triple (f32) and its node count."""
    rng = np.random.default_rng(0)
    P = []
    for ni in (8, 6, 5):
        a = (rng.random((ni, ni)) < 0.5) * rng.random((ni, ni))
        np.fill_diagonal(a, 0)
        P.append((a + a.T) / 2)
    R = {(i, j): (rng.random((P[i].shape[0], P[j].shape[0])) < 0.5).astype(float)
         for (i, j) in [(0, 1), (0, 2), (1, 2)]}
    norm = HeteroNetwork(P=P, R=R).normalize()
    coo = norm.to_coo()
    scale = JaxLPConfig().resolved_hetero_scale(3)
    alpha, beta = 0.5, 0.5
    src = np.concatenate([coo.het_src, coo.hom_src]).astype(np.int32)
    dst = np.concatenate([coo.het_dst, coo.hom_dst]).astype(np.int32)
    w = np.concatenate([alpha * beta * scale * coo.het_w, alpha * coo.hom_w]).astype(np.float32)
    return src, dst, w, norm.num_nodes


class TestLPStep:
    @pytest.fixture(scope="class")
    def case(self):
        src, dst, w, n = _smoke_network()
        rng = np.random.default_rng(1)
        Y = np.eye(n, dtype=np.float32)
        F0 = (Y + 0.1 * rng.random((n, n))).astype(np.float32)
        return src, dst, w, Y, F0

    def _reference(self, case, cfg, dtype=jnp.float32):
        src, dst, w, Y, F0 = case
        step = jax.jit(jax_dhlp.make_lp_step(cfg))
        out = step(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w, dtype),
                   jnp.asarray(Y, dtype), jnp.asarray(F0, dtype))
        return np.asarray(out.astype(jnp.float32))

    @pytest.mark.parametrize("rounds", [None, 10])
    def test_plain_step_matches_the_reference(self, case, rounds):
        cfg = dhlp_bio.REDUCED if rounds is None else dataclasses.replace(
            dhlp_bio.REDUCED, rounds_per_step=rounds)
        jcfg = dataclasses.replace(jax_dhlp.REDUCED, rounds_per_step=cfg.rounds_per_step)
        want = self._reference(case, jcfg)
        before = launch_counts()
        got = dhlp_bio.make_lp_step(cfg)(*(torch.from_numpy(a) for a in case))
        assert launch_counts() == before
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)

    @pytest.mark.parametrize("budget", [1, 7 * 192, 1 << 30])
    def test_column_chunks_are_the_same_step(self, case, budget, monkeypatch):
        """The plain step takes ``PLAIN_MESSAGE_BUDGET // E`` columns at a
        time: 1, 7 or all of them here (E = 192)."""
        t = [torch.from_numpy(a) for a in case]
        assert t[0].shape[0] == 192
        whole = dhlp_bio.lp_step_plain(dhlp_bio.REDUCED, *t)
        monkeypatch.setattr(dhlp_bio, "PLAIN_MESSAGE_BUDGET", budget)
        chunked = dhlp_bio.lp_step_plain(dhlp_bio.REDUCED, *t)
        np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-6, atol=1e-7)

    @pytest.mark.parametrize("rounds", [2, 10])
    def test_bucket_plan_matches_the_reference(self, case, rounds):
        """The card's route (plan, then csr_round per bucket), here on its
        plain version."""
        src, dst, w, Y, F0 = (torch.from_numpy(a) for a in case)
        want = self._reference(case, dataclasses.replace(jax_dhlp.REDUCED, rounds_per_step=rounds))
        plan = dhlp_bio.lp_plan(src, dst, w, Y.shape[0])
        rows = torch.cat([r for r, _, _, _ in plan.buckets])
        assert torch.equal(torch.sort(rows).values, torch.arange(Y.shape[0]))
        assert sum(int(lv.slots) for _, _, _, lv in plan.buckets) == int(np.count_nonzero(case[2]))
        cfg = dataclasses.replace(dhlp_bio.REDUCED, rounds_per_step=rounds)
        got = dhlp_bio.lp_rounds(plan, Y, F0, cfg)
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)

    def test_bf16_step_matches_the_reference(self, case):
        want = self._reference(case, jax_dhlp.REDUCED, jnp.bfloat16)
        t = [torch.from_numpy(a) for a in case]
        args = [t[0], t[1]] + [x.to(torch.bfloat16) for x in t[2:]]
        got = dhlp_bio.make_lp_step(dhlp_bio.REDUCED)(*args)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)
        plan = dhlp_bio.lp_plan(args[0], args[1], args[2], args[3].shape[0])
        assert all(wgt.dtype == torch.bfloat16 for _, _, wgt, _ in plan.buckets)
        via_plan = dhlp_bio.lp_rounds(plan, args[3], args[4], dhlp_bio.REDUCED)
        np.testing.assert_allclose(via_plan.float().numpy(), want, **BF16_TOL)

    def test_cell_step_is_the_reference_step(self, case):
        cell = registry.get_arch("dhlp-bio").make_cell("scale_1m")
        jcell = jax_registry.get_arch("dhlp-bio").make_cell("scale_1m")
        src, dst, w, Y, F0 = case
        want = np.asarray(jax.jit(jcell.step_fn)(
            jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), jnp.asarray(Y), jnp.asarray(F0)))
        got = cell.step_fn(*(torch.from_numpy(a) for a in case))
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
