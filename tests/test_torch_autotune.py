"""The port's autotune cache and sweep vs ``repro.engine.autotune``.

Mirrors ``tests/test_autotune_fused.py::TestAutotuneCache`` case for case
on the CPU (miss → sweep → hit → persisted, a corrupt file is a cold
cache, shape-class buckets, the engine consults the cache, ``autotune=
False`` uses the defaults), then holds the port's ``shape_class`` and
``network_nnz`` to ``repro``'s on a grid of sizes, and a ``kernel`` solve
at a cached ``(32, 4)`` layout to ``repro``'s ``sparse`` engine given
``block_rows=32, width_mult=4`` (equal rounds, max|ΔF| ≤ 5e-3).  The
``gpu`` cases sweep on the card and hold B1 and B3 to their plain
versions at every ``slots_per_block`` of the grid.
"""

import json

import numpy as np
import pytest
import torch

import repro.engine as re_
from repro.core.solver import LPConfig as RLPConfig
from repro.engine import autotune as ref_autotune
from repro_torch.core.solver import LPConfig
from repro_torch.data.drugnet import DrugNetSpec, make_drugnet
from repro_torch.engine import autotune, make_engine
from repro_torch.kernels.segment_reduce import (
    csr_round_op,
    csr_round_ref,
    csr_round_residual_op,
    csr_round_residual_ref,
    rows_per_block,
)

CPU = "cpu"
F32_TOL = dict(rtol=2e-4, atol=5e-4)


def _drugnet_norm():
    dn = make_drugnet(DrugNetSpec(n_drug=48, n_disease=32, n_target=24, n_clusters=6))
    return dn.network.normalize()


def _ref_drugnet_norm():
    from repro.data.drugnet import DrugNetSpec as RSpec
    from repro.data.drugnet import make_drugnet as rmake

    return rmake(RSpec(n_drug=48, n_disease=32, n_target=24, n_clusters=6)).network.normalize()


@pytest.fixture(autouse=True)
def _fresh_memo():
    autotune.clear_memo()
    yield
    autotune.clear_memo()


class TestAutotuneCache:
    def test_miss_sweep_hit_and_persistence(self, tmp_path):
        norm = _drugnet_norm()
        n, nnz = norm.num_nodes, autotune.network_nnz(norm)
        assert autotune.lookup(n, nnz, cache_dir=tmp_path, device=CPU) is None

        seen = []
        params, hit = autotune.ensure_tuned(
            norm, repeats=1, sweep_panels=False, cache_dir=tmp_path, device=CPU,
            on_time=lambda kind, cand, t: seen.append((kind, cand)),
        )
        assert not hit
        assert (params.block_rows, params.width_mult) in autotune.LAYOUT_GRID
        assert params.slots_per_block == autotune.DEFAULT_PARAMS.slots_per_block
        assert seen == [("layout", lw) for lw in autotune.LAYOUT_GRID]
        assert autotune.cache_path(tmp_path, device=CPU).exists()

        seen.clear()
        again, hit2 = autotune.ensure_tuned(
            norm, repeats=1, sweep_panels=False, cache_dir=tmp_path, device=CPU,
            on_time=lambda kind, cand, t: seen.append((kind, cand)),
        )
        assert hit2 and again == params
        assert seen == []  # a hit times nothing

        # memo dropped -> the persisted file alone must answer the lookup
        autotune.clear_memo()
        assert autotune.lookup(n, nnz, cache_dir=tmp_path, device=CPU) == params

    def test_cpu_skips_the_block_sweep(self, tmp_path):
        norm = _drugnet_norm()
        seen = []
        params, _ = autotune.ensure_tuned(
            norm, repeats=1, cache_dir=tmp_path, device=CPU,
            on_time=lambda kind, cand, t: seen.append(kind),
        )
        assert "slots_per_block" not in seen
        assert params.slots_per_block == autotune.DEFAULT_PARAMS.slots_per_block

    def test_corrupt_cache_is_cold(self, tmp_path):
        norm = _drugnet_norm()
        n, nnz = norm.num_nodes, autotune.network_nnz(norm)
        autotune.save(n, nnz, autotune.TunedParams(), cache_dir=tmp_path, device=CPU)
        autotune.cache_path(tmp_path, device=CPU).write_text("not json{")
        autotune.clear_memo()
        assert autotune.lookup(n, nnz, cache_dir=tmp_path, device=CPU) is None

    def test_shape_class_buckets_nearby_sizes(self):
        assert autotune.shape_class(1000, 8000) == autotune.shape_class(1100, 8800)
        assert autotune.shape_class(1000, 8000) != autotune.shape_class(1000, 64000)

    def test_engine_consults_cache(self, tmp_path, monkeypatch):
        monkeypatch.setattr(autotune, "DEFAULT_CACHE_DIR", tmp_path)
        norm = _drugnet_norm()
        tuned = autotune.TunedParams(block_rows=32, width_mult=4, slots_per_block=1024)
        autotune.save(norm.num_nodes, autotune.network_nnz(norm), tuned, device=CPU)
        eng = make_engine(
            "sparse", LPConfig(alg="dhlp2", seed_mode="fixed", autotune=True), device=CPU
        )
        op = eng.prepare(norm)
        assert op.payload.layout == (32, 4)
        assert op.payload.slots_per_block == 1024

    def test_explicit_kwargs_win_over_cache(self, tmp_path, monkeypatch):
        monkeypatch.setattr(autotune, "DEFAULT_CACHE_DIR", tmp_path)
        norm = _drugnet_norm()
        tuned = autotune.TunedParams(block_rows=32, width_mult=4, slots_per_block=1024)
        autotune.save(norm.num_nodes, autotune.network_nnz(norm), tuned, device=CPU)
        eng = make_engine(
            "kernel", LPConfig(alg="dhlp2", seed_mode="fixed"), device=CPU, block_rows=128
        )
        op = eng.prepare(norm)
        assert op.payload.layout == (128, 4)
        assert op.payload.slots_per_block == 1024

    def test_autotune_off_uses_defaults(self, tmp_path, monkeypatch):
        monkeypatch.setattr(autotune, "DEFAULT_CACHE_DIR", tmp_path)
        norm = _drugnet_norm()
        autotune.save(
            norm.num_nodes,
            autotune.network_nnz(norm),
            autotune.TunedParams(block_rows=32, width_mult=4, slots_per_block=4096),
            device=CPU,
        )
        eng = make_engine(
            "sparse", LPConfig(alg="dhlp2", seed_mode="fixed", autotune=False), device=CPU
        )
        op = eng.prepare(norm)
        d = autotune.DEFAULT_PARAMS
        assert op.payload.layout == (d.block_rows, d.width_mult)
        assert op.payload.slots_per_block == d.slots_per_block

    def test_file_schema_and_fingerprint(self, tmp_path):
        path = autotune.save(10, 80, autotune.TunedParams(), cache_dir=tmp_path, device=CPU)
        doc = json.loads(path.read_text())
        assert set(doc) == {"host", "entries"}
        assert doc["host"] == autotune.host_fingerprint(CPU) == path.stem
        assert "-cpu-torch" in doc["host"] and " " not in doc["host"]
        assert doc["entries"] == {autotune.shape_class(10, 80): autotune.TunedParams().to_dict()}
        assert not list(tmp_path.glob("*.tmp"))

    def test_from_dict_keeps_known_fields(self):
        d = {"block_rows": 32, "width_mult": 4, "slots_per_block": 1024, "bn": 512}
        assert autotune.TunedParams.from_dict(d) == autotune.TunedParams(32, 4, 1024)
        assert autotune.TunedParams(32, 4, 1024).to_dict() == {
            "block_rows": 32, "width_mult": 4, "slots_per_block": 1024,
        }

    def test_grids_match_the_reference(self):
        assert autotune.LAYOUT_GRID == ref_autotune.LAYOUT_GRID
        assert len(autotune.PANEL_GRID) in (3, 4)
        assert autotune.DEFAULT_PARAMS.slots_per_block in autotune.PANEL_GRID


class TestParityWithReference:
    @pytest.mark.parametrize(
        "n,nnz", [(2, 0), (104, 4878), (1000, 8000), (1100, 8800), (4396, 1211064),
                  (70000, 7e5), (3, 1e9)],
    )
    def test_shape_class_equal(self, n, nnz):
        assert autotune.shape_class(n, nnz) == ref_autotune.shape_class(n, nnz)

    def test_network_nnz_equal(self):
        assert autotune.network_nnz(_drugnet_norm()) == ref_autotune.network_nnz(
            _ref_drugnet_norm()
        )

    def test_kernel_solve_at_cached_layout_matches_repro(self, tmp_path, monkeypatch):
        monkeypatch.setattr(autotune, "DEFAULT_CACHE_DIR", tmp_path)
        norm = _drugnet_norm()
        autotune.save(
            norm.num_nodes, autotune.network_nnz(norm),
            autotune.TunedParams(block_rows=32, width_mult=4), device=CPU,
        )
        Y = np.eye(norm.num_nodes, dtype=np.float32)[:, :16]
        eng = make_engine("kernel", LPConfig(alg="dhlp2", sigma=1e-4, seed_mode="fixed"),
                          device=CPU)
        got = eng.run(norm, seeds=Y)
        assert eng.prepare(norm).payload.layout == (32, 4)
        want = re_.make_engine(
            "sparse", RLPConfig(alg="dhlp2", sigma=1e-4, seed_mode="fixed", autotune=False),
            block_rows=32, width_mult=4,
        ).run(_ref_drugnet_norm(), seeds=Y)
        assert got.outer_iters == want.outer_iters
        assert float(np.max(np.abs(got.F - want.F))) <= 5e-3

    @pytest.mark.parametrize("fused", [True, False])
    def test_slots_per_block_leaves_the_cpu_solve_unchanged(self, fused):
        norm = _drugnet_norm()
        Y = np.eye(norm.num_nodes, dtype=np.float32)[:, :8]
        cfg = LPConfig(alg="dhlp2", sigma=1e-4, seed_mode="fixed", autotune=False)
        base = make_engine("kernel", cfg, device=CPU, fused_superstep=fused).run(norm, seeds=Y)
        other = make_engine("kernel", cfg, device=CPU, fused_superstep=fused,
                            slots_per_block=1024).run(norm, seeds=Y)
        np.testing.assert_array_equal(base.F, other.F)
        assert base.outer_iters == other.outer_iters


@pytest.mark.parametrize("width", [1, 7, 33, 200, 5000])
@pytest.mark.parametrize("spb", [None, 1024, 2048, 4096])
def test_rows_per_block_sizing(width, spb):
    rpb = rows_per_block(width, spb)
    assert 1 <= rpb <= 64
    want = max(1, min(64, (2048 if spb is None else spb) // width))
    assert rpb == want
    assert rows_per_block(width) == rows_per_block(width, 2048)


def test_rows_per_block_rejects_zero():
    with pytest.raises(ValueError, match="slots_per_block"):
        rows_per_block(8, 0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("spb", [1024, 2048, 4096])
def test_round_kernels_at_each_block_size(dev, spb):
    rng = np.random.default_rng(spb)
    m, n, d, s = 300, 500, 40, 64
    nbr = torch.as_tensor(rng.integers(0, n, (m, d)).astype(np.int32), device=dev)
    wgt = torch.as_tensor((rng.random((m, d)) * (rng.random((m, d)) < 0.6)).astype(np.float32),
                          device=dev)
    F, = (torch.as_tensor(rng.random((n, s)).astype(np.float32), device=dev),)
    base, prev = (torch.as_tensor(rng.random((m, s)).astype(np.float32), device=dev)
                  for _ in range(2))
    out, delta = csr_round_residual_op(nbr, wgt, F, base, prev, c=0.25, slots_per_block=spb)
    assert delta.shape[0] == -(-m // rows_per_block(d, spb))
    want, wdelta = csr_round_residual_ref(nbr, wgt, F, base, prev, 0.25)
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(), **F32_TOL)
    np.testing.assert_allclose(delta.amax(dim=0, keepdim=True).cpu().numpy(),
                               wdelta.cpu().numpy(), **F32_TOL)
    got = csr_round_op(nbr, wgt, F, base, c=0.25, slots_per_block=spb)
    np.testing.assert_allclose(got.cpu().numpy(),
                               csr_round_ref(nbr, wgt, F, base, 0.25).cpu().numpy(), **F32_TOL)


@pytest.mark.gpu
def test_sweep_on_the_card(dev, tmp_path):
    norm = _drugnet_norm()
    seen = []
    params, hit = autotune.ensure_tuned(
        norm, repeats=1, cache_dir=tmp_path, device=dev,
        on_time=lambda kind, cand, t: seen.append((kind, cand, t)),
    )
    assert not hit
    assert [c for k, c, _ in seen if k == "slots_per_block"] == list(autotune.PANEL_GRID)
    assert params.slots_per_block in autotune.PANEL_GRID
    assert all(t > 0 for _, _, t in seen)
    assert "sm" in autotune.host_fingerprint(dev)
    assert autotune.ensure_tuned(norm, cache_dir=tmp_path, device=dev) == (params, True)
