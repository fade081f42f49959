"""The port's sharded engine (``repro_torch.parallel``, ``engine/sharded.py``)
vs the reference.

Mirrors ``tests/test_parallel.py::TestShardedLP`` and its collectives test:
one module-scoped run of 8 gloo ranks (``run_ranks``: one process each, a
300 s limit) on a ``(2, 4)`` mesh, whose results are held here to
``repro``'s dense ``HeteroLP`` at the reference's bounds (sharded < 1e-5;
stale-sync < 1e-3 with at least as many rounds; bf16 < 5e-3; DHLP-1
< 1e-5 with equal inner rounds; the ring and the scatter-gather equal to
the all-reduce).  Then the sharded cases of ``tests/test_engine_registry.py``,
``tests/test_api_spec.py`` and ``tests/test_serve.py`` in this process on
a world of one gloo rank, the CLI with ``--backend sharded``, and the
``fig34_parallelism`` suite's ``d2s1`` point on 2 gloo ranks held to
``benchmarks/baseline.json``'s strict metrics.  The ``gpu`` case runs a
solve on a world of one NCCL rank.

The rank bodies (``_*_ranks``) import nothing of ``repro``: each rank
loads this file without JAX.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.parallel.launch import run_ranks

ROOT = Path(__file__).resolve().parent.parent
HERE = str(Path(__file__).resolve())
N_TYPES = (15, 11, 8)


def _blocks(seed=2, n=N_TYPES, p=0.3):
    rng = np.random.default_rng(seed)
    P = []
    for ni in n:
        a = (rng.random((ni, ni)) < p) * rng.random((ni, ni))
        np.fill_diagonal(a, 0)
        P.append((a + a.T) / 2)
    R = {(i, j): (rng.random((n[i], n[j])) < p).astype(float)
         for (i, j) in [(0, 1), (0, 2), (1, 2)]}
    return P, R


def _lp_ranks(payload):
    """On every rank of an 8-rank world: the reference's child, ported."""
    import torch.distributed as dist

    from repro_torch.core import HeteroNetwork, LPConfig
    from repro_torch.engine import make_engine
    from repro_torch.parallel.collectives import (
        compressed_psum,
        psum_scatter_then_gather,
        ring_allreduce_ppermute,
    )
    from repro_torch.parallel.lp_sharded import ShardedHeteroLP
    from repro_torch.parallel.mesh import make_mesh

    P, R = _blocks()
    norm = HeteroNetwork(P=P, R=R).normalize()
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    cfg = LPConfig(alg="dhlp2", seed_mode="fixed", sigma=1e-6, max_iter=3000)
    out = {}
    sh = ShardedHeteroLP(cfg, device="cpu").run(norm, mesh)
    out["sharded"] = sh.F.tolist()
    out["sync_iters"] = sh.outer_iters
    out["per_column_iters"] = sh.per_column_iters.tolist()
    st = ShardedHeteroLP(cfg, stale_sync=4, device="cpu").run(norm, mesh)
    out["stale"] = st.F.tolist()
    out["stale_iters"] = st.outer_iters
    out["bf16"] = ShardedHeteroLP(cfg, compression="bf16", device="cpu").run(norm, mesh).F.tolist()
    i8 = ShardedHeteroLP(cfg, compression="int8", device="cpu").run(norm, mesh)
    out["int8"] = i8.F.tolist()
    eng = make_engine("sharded", cfg, device="cpu", devices=8)
    out["engine"] = eng.run(norm).F.tolist()
    out["engine_mesh"] = [eng.mesh().size(0), eng.mesh().size(1)]
    Y = np.eye(norm.num_nodes, dtype=np.float32)[:, :10]
    out["engine_round"] = eng.round(eng.prepare(norm), 0.5 * Y, Y).tolist()

    cfg1 = LPConfig(alg="dhlp1", sigma=1e-6, max_iter=500, max_inner=300)
    s1 = ShardedHeteroLP(cfg1, device="cpu").run(norm, mesh)
    out["dhlp1"] = s1.F.tolist()
    out["dhlp1_outer"] = s1.outer_iters
    out["dhlp1_inner"] = s1.inner_iters

    # collectives: every all-reduce variant agrees, over the world and
    # over the mesh's edge axis
    x = torch.arange(256, dtype=torch.float32).reshape(64, 4)
    local = x[dist.get_rank() * 8 : (dist.get_rank() + 1) * 8]
    a = compressed_psum(local)
    b = psum_scatter_then_gather(local)
    c = ring_allreduce_ppermute(local)
    g = mesh.get_group("model")
    d = compressed_psum(local, g)
    e = ring_allreduce_ppermute(local, g)
    f = psum_scatter_then_gather(local, g)
    out["psum_ok"] = bool(
        torch.allclose(a, b) and torch.allclose(a, c)
        and torch.allclose(a, x.reshape(8, 8, 4).sum(0))
        and torch.allclose(d, e) and torch.allclose(d, f)
    )
    return out


@pytest.fixture(scope="module")
def child_results():
    return run_ranks(f"{HERE}:_lp_ranks", 8, {}, timeout=300)


@pytest.fixture(scope="module")
def nets():
    from repro.core import HeteroNetwork

    P, R = _blocks()
    return HeteroNetwork(P=P, R=R)


def _dense(nets, **kw):
    from repro.core import HeteroLP, LPConfig

    return HeteroLP(LPConfig(**kw)).run(nets)


def _err(got, want):
    return float(np.max(np.abs(np.asarray(got) - want.F)))


class TestShardedLP:
    def test_matches_dense(self, child_results, nets):
        want = _dense(nets, alg="dhlp2", seed_mode="fixed", sigma=1e-6, max_iter=3000)
        assert _err(child_results["sharded"], want) < 1e-5
        assert child_results["sync_iters"] == want.outer_iters

    def test_stale_sync_same_fixed_point(self, child_results, nets):
        want = _dense(nets, alg="dhlp2", seed_mode="fixed", sigma=1e-6, max_iter=3000)
        assert _err(child_results["stale"], want) < 1e-3
        # staleness trades iterations for collectives
        assert child_results["stale_iters"] >= child_results["sync_iters"]

    def test_bf16_compression_bounded_error(self, child_results, nets):
        want = _dense(nets, alg="dhlp2", seed_mode="fixed", sigma=1e-6, max_iter=3000)
        assert _err(child_results["bf16"], want) < 5e-3

    def test_int8_compression_bounded_error(self, child_results, nets):
        want = _dense(nets, alg="dhlp2", seed_mode="fixed", sigma=1e-6, max_iter=3000)
        rel = _err(child_results["int8"], want) / float(np.max(np.abs(want.F)))
        assert rel < 0.05

    def test_ring_and_scatter_gather_match_psum(self, child_results):
        assert child_results["psum_ok"]

    def test_sharded_dhlp1_matches_dense(self, child_results, nets):
        want = _dense(nets, alg="dhlp1", sigma=1e-6, max_iter=500, max_inner=300)
        assert _err(child_results["dhlp1"], want) < 1e-5
        assert child_results["dhlp1_inner"] == want.inner_iters
        assert child_results["dhlp1_outer"] == want.outer_iters

    def test_engine_over_the_world(self, child_results, nets):
        assert child_results["engine_mesh"] == [1, 8]
        want = _dense(nets, alg="dhlp2", seed_mode="fixed", sigma=1e-6, max_iter=3000)
        assert _err(child_results["engine"], want) < 1e-5

    def test_engine_round_matches_dense_round(self, child_results, nets):
        from repro.core import LPConfig
        from repro.engine import make_engine

        Y = np.eye(nets.num_nodes, dtype=np.float32)[:, :10]
        dense = make_engine("dense", LPConfig(alg="dhlp2", seed_mode="fixed", sigma=1e-6,
                                              max_iter=3000))
        ref = dense.round(dense.prepare(nets), 0.5 * Y, Y)
        assert float(np.max(np.abs(np.asarray(child_results["engine_round"]) - ref))) < 1e-5


# ------------------------------------------------ one rank, in this process
@pytest.fixture(scope="module")
def world():
    """A world of one gloo rank, started by the engine, ended after the
    module (never at import)."""
    from repro_torch.parallel.mesh import destroy_owned_world

    yield
    destroy_owned_world()


@pytest.fixture(scope="module")
def bio(world):
    from repro_torch.data.drugnet import DrugNetSpec, make_drugnet

    return make_drugnet(DrugNetSpec(n_drug=40, n_disease=30, n_target=20, seed=0)).network.normalize()


@pytest.fixture(scope="module")
def seeds(bio):
    return np.eye(bio.num_nodes, dtype=np.float32)[:, :10]


class TestRegistry:
    def test_builtin_backends_registered(self):
        from repro_torch.engine import available_backends, get_backend_class

        for expected in ("dense", "sparse", "sharded", "kernel"):
            assert expected in available_backends()
        assert get_backend_class("sharded").name == "sharded"

    def test_auto_never_selects_sharded(self):
        from repro_torch.engine import select_backend

        assert {select_backend(n) for n in (10, 4096, 4097, 10**6)} == {"dense", "sparse"}

    def test_momentum_incapable_backend_rejects(self, bio):
        from repro_torch.core import LPConfig
        from repro_torch.engine import BackendUnsupported, make_engine

        with pytest.raises(BackendUnsupported, match="momentum"):
            make_engine("sharded", LPConfig(alg="dhlp2", momentum=0.2), device="cpu").prepare(bio)

    def test_sharded_rejects_oversized_mesh(self, bio):
        from repro_torch.core import LPConfig
        from repro_torch.engine import make_engine
        from repro_torch.parallel.mesh import world_size

        engine = make_engine("sharded", LPConfig(), device="cpu", devices=world_size() + 64)
        with pytest.raises(ValueError, match="devices"):
            engine.prepare(bio)


class TestEngineContract:
    @pytest.mark.parametrize("alg", ["dhlp1", "dhlp2"])
    def test_solve_matches_repro_dense(self, bio, seeds, alg):
        from repro.core import LPConfig as RCfg
        from repro.data.drugnet import DrugNetSpec, make_drugnet
        from repro.engine import make_engine as rmake
        from repro_torch.core import LPConfig
        from repro_torch.engine import make_engine

        rnorm = make_drugnet(DrugNetSpec(n_drug=40, n_disease=30, n_target=20, seed=0)
                             ).network.normalize()
        want = rmake("dense", RCfg(alg=alg, sigma=1e-4, seed_mode="fixed")).run(rnorm, seeds=seeds)
        got = make_engine("sharded", LPConfig(alg=alg, sigma=1e-4, seed_mode="fixed"),
                          device="cpu").run(bio, seeds=seeds)
        assert np.max(np.abs(got.F - want.F)) < 5e-3
        assert got.outer_iters == want.outer_iters and got.converged

    def test_round_moves_toward_fixed_point(self, bio, seeds):
        from repro_torch.core import LPConfig
        from repro_torch.engine import make_engine

        cfg = LPConfig(alg="dhlp2", sigma=1e-4, seed_mode="fixed")
        for backend in ("dense", "sparse", "kernel", "sharded"):
            engine = make_engine(backend, cfg, device="cpu")
            op = engine.prepare(bio)
            Fstar = engine.solve(op, seeds).F
            drift = np.max(np.abs(engine.round(op, Fstar, seeds) - Fstar))
            assert drift < 1e-3, backend
            d0 = np.max(np.abs(np.asarray(seeds, np.float64) - Fstar))
            d1 = np.max(np.abs(engine.round(op, seeds, seeds) - Fstar))
            assert d1 < d0, backend

    @pytest.mark.parametrize("alg", ["dhlp2", "dhlp1"])
    def test_sharded_round_matches_dense_round(self, bio, seeds, alg):
        from repro_torch.core import LPConfig
        from repro_torch.engine import make_engine

        cfg = LPConfig(alg=alg, sigma=1e-4, seed_mode="fixed")
        dense = make_engine("dense", cfg, device="cpu")
        sharded = make_engine("sharded", cfg, device="cpu")
        F = np.asarray(seeds, np.float64) * 0.5
        ref = dense.round(dense.prepare(bio), F, seeds)
        got = sharded.round(sharded.prepare(bio), F, seeds)
        assert np.max(np.abs(got - ref)) < 1e-4

    def test_warm_start_threads_through(self, bio, seeds):
        from repro_torch.core import LPConfig
        from repro_torch.engine import make_engine

        engine = make_engine("sharded", LPConfig(alg="dhlp2", sigma=1e-4, seed_mode="fixed"),
                             device="cpu")
        cold = engine.run(bio, seeds=seeds)
        warm = engine.run(bio, seeds=seeds, F0=cold.F)
        assert warm.outer_iters <= 2
        assert np.max(np.abs(warm.F - cold.F)) < 5e-3

    def test_column_chunks_equal_one_panel(self, bio, monkeypatch):
        import repro_torch.parallel.lp_sharded as lps

        rng = np.random.default_rng(0)
        e, n, s = 500, 40, 9
        src = torch.as_tensor(rng.integers(0, n, e))
        dst = torch.as_tensor(np.sort(rng.integers(0, n, e)))
        w = torch.as_tensor(rng.random(e).astype(np.float32))
        F = torch.as_tensor(rng.random((n, s)).astype(np.float32))
        whole = lps.local_aggregate(src, dst, w, F, n)
        monkeypatch.setattr(lps, "MESSAGE_BUDGET", 2 * e)
        torch.testing.assert_close(lps.local_aggregate(src, dst, w, F, n), whole)

    def test_shard_edges_matches_reference(self):
        from repro.parallel.lp_sharded import _shard_edges as ref
        from repro_torch.parallel.lp_sharded import _shard_edges

        rng = np.random.default_rng(1)
        e = 37
        args = (rng.integers(0, 9, e).astype(np.int32), np.sort(rng.integers(0, 9, e)).astype(np.int32),
                rng.random(e).astype(np.float32))
        for k in (1, 2, 4, 8):
            for got, want in zip(_shard_edges(*args, k), ref(*args, k)):
                np.testing.assert_array_equal(got, want)


def test_devices_require_sharded_backend():
    from repro_torch.api.spec import SolveSpec, SpecError

    with pytest.raises(SpecError, match="devices.*sharded"):
        SolveSpec(backend="dense", devices=2)
    assert SolveSpec(backend="sharded", devices=2).devices == 2


def test_sharded_engine_serves_and_refreshes(world):
    """Serving, and the post-delta refresh that runs ``engine.round`` on
    the mesh, work on backend='sharded' (``tests/test_serve.py:482``)."""
    from repro_torch.core import GraphDelta, HeteroNetwork, LPConfig
    from repro_torch.serve import LPServeEngine, QuerySpec, ServeConfig

    rng = np.random.default_rng(0)
    P = []
    for ni in (18, 12, 9):
        a = (rng.random((ni, ni)) < 0.35) * rng.random((ni, ni))
        np.fill_diagonal(a, 0)
        P.append((a + a.T) / 2)
    R = {(i, j): (rng.random(((18, 12, 9)[i], (18, 12, 9)[j])) < 0.3).astype(float)
         for (i, j) in [(0, 1), (0, 2), (1, 2)]}
    engine = LPServeEngine(
        HeteroNetwork(P=P, R=R),
        ServeConfig(engine="sharded", refresh_rounds=2, max_wait_s=1e-3,
                    lp=LPConfig(alg="dhlp2", seed_mode="fixed", sigma=1e-4)),
        device="cpu",
    )
    cold = engine.query(QuerySpec(entity=1, target_type=2, top_k=5))
    hit = engine.query(QuerySpec(entity=1, target_type=2, top_k=5))
    assert cold.source == "cold" and hit.source == "cache"
    engine.apply_delta(GraphDelta(assoc=[((0, 2), 1, 3, 1.0)]))
    warm = engine.query(QuerySpec(entity=1, target_type=2, top_k=5))
    assert warm.source == "warm"


def test_session_runs_sharded(world, tmp_path):
    from repro_torch.api import NetworkSpec, RunSpec, Session, SolveSpec

    spec = RunSpec(network=NetworkSpec(kind="drugnet", params={"n_drug": 40, "n_disease": 30,
                                                               "n_target": 20}),
                   solve=SolveSpec(backend="sharded", devices=1, seed_mode="fixed"))
    s = Session(spec, results_root=str(tmp_path), device="cpu")
    art = s.run(write=True, echo=lambda _l: None)[0]
    assert s.engine.name == "sharded" and s.engine.mesh().size() == 1
    assert art.backend == "sharded" and art.converged
    assert (tmp_path / s.run_id / "solve.json").is_file()


def test_cli_solves_on_sharded(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch", "run", "--network", "drugnet",
           "--backend", "sharded", "--devices", "1", "--device", "cpu",
           "--results-root", str(tmp_path), "--top-k", "5"]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=tmp_path,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[solve]" in proc.stdout
    bad = [sys.executable, "-m", "repro_torch", "run", "--network", "drugnet",
           "--backend", "sharded", "--devices", "2", "--device", "cpu", "--no-write"]
    proc = subprocess.run(bad, capture_output=True, text=True, env=env, cwd=tmp_path,
                          timeout=300)
    assert proc.returncode != 0 and "2 devices" in proc.stderr


def test_fig34_d2s1_on_gloo_ranks_meets_the_baseline():
    from repro_torch.bench.compare import compare_reports
    from repro_torch.bench.report import load_report
    from repro_torch.bench.schema import record_key
    from repro_torch.bench.suites.fig34_parallelism import records

    recs = [r.to_dict() for r in records(fast=True, device=torch.device("cpu"))]
    assert [record_key(r) for r in recs] == ["fig34_parallelism/d1s1@sharded1",
                                             "fig34_parallelism/d2s1@sharded2"]
    base = load_report(str(ROOT / "benchmarks" / "baseline.json"))
    keys = {record_key(r) for r in recs}
    base["records"] = [r for r in base["records"] if record_key(r) in keys]
    res = compare_reports(base, {"records": recs, "environment": base["environment"]},
                          gate_timing=False)  # wall times of a loaded CPU: reported only
    assert res.ok and res.compared == 2, res.regressions
    assert all(r["derived"]["iters"] == 21.0 and r["derived"]["converged"] == 1.0 for r in recs)


@pytest.mark.gpu
def test_nccl_world_of_one_matches_sparse(world):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (NCCL)")
    from repro_torch.core import LPConfig
    from repro_torch.data.drugnet import DrugNetSpec, make_drugnet
    from repro_torch.engine import make_engine
    from repro_torch.parallel.mesh import destroy_owned_world

    destroy_owned_world()  # the gloo world of the CPU cases
    norm = make_drugnet(DrugNetSpec(n_drug=40, n_disease=30, n_target=20)).network.normalize()
    cfg = LPConfig(alg="dhlp2", sigma=1e-4, seed_mode="fixed", autotune=False)
    got = make_engine("sharded", cfg, device="cuda:0").run(norm)
    want = make_engine("sparse", cfg, device="cuda:0").run(norm)
    assert got.outer_iters == want.outer_iters
    assert float(np.max(np.abs(got.F - want.F))) <= 5e-3
    destroy_owned_world()
