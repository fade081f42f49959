"""Port serve tier vs the JAX reference on the quickstart's network.

The ``streaming`` scenario at scale 0.5 (67 nodes, 8 timed deltas, one of
which adds two drug nodes) is built bit-identically by both packages.  The
same ``QuerySpec``s go through both packages' ``LPServeEngine`` on the
``dense``, ``sparse`` and ``kernel`` engines (the port on the CPU, where
the kernel engine takes its plain version; ``repro``'s kernel engine runs
Pallas in interpret mode).  Checks, at the reference's tolerances: equal
top-k lists, scores within 5e-3 (``agree_dense``, DESIGN.md §15.3), equal
per-query rounds (``per_column_iters``) and equal answer sources.
"""

import numpy as np
import pytest
import torch

import repro.core as rc
import repro.scenarios as rs
import repro.serve as rsv
import repro_torch.core as tc
import repro_torch.engine as te
import repro_torch.scenarios as ts
import repro_torch.serve as tsv

AGREE_TOL = 5e-3
SIGMA = 1e-4
ENGINES = ("dense", "sparse", "kernel")


@pytest.fixture(scope="module")
def bundles():
    # the quickstart's network, with its replay horizon and rate coupled in
    # (what the Session does for a spec with a serve.trace section)
    kw = dict(scale=0.5, seed=0, cache=False, rate_qps=30.0, horizon_s=2.0)
    return ts.generate("streaming", **kw), rs.generate("streaming", **kw)


def _configs(backend, early_exit, **kw):
    return (
        tsv.ServeConfig(
            lp=tc.LPConfig(alg="dhlp2", sigma=SIGMA, seed_mode="fixed", backend=backend),
            early_exit=early_exit,
            **kw,
        ),
        rsv.ServeConfig(
            lp=rc.LPConfig(alg="dhlp2", sigma=SIGMA, seed_mode="fixed", backend=backend),
            early_exit=early_exit,
            **kw,
        ),
    )


def _engines(bundles, backend, early_exit, **kw):
    tcfg, rcfg = _configs(backend, early_exit, **kw)
    return (
        tsv.LPServeEngine(bundles[0].network, tcfg, device="cpu"),
        rsv.LPServeEngine(bundles[1].network, rcfg),
    )


def _specs(entities, target_type=2, top_k=10):
    return (
        [tsv.QuerySpec(entity=int(e), target_type=target_type, top_k=top_k) for e in entities],
        [rsv.QuerySpec(entity=int(e), target_type=target_type, top_k=top_k) for e in entities],
    )


def _check_batch(port, ref, entities, **kw):
    """One batch through both engines' synchronous tick; the results agree."""
    tspecs, rspecs = _specs(entities, **kw)
    got = port._solve_batch(tspecs)
    want = ref._solve_batch(rspecs)
    for g, w in zip(got, want):
        assert list(g.candidates) == list(w.candidates)
        np.testing.assert_allclose(g.scores, w.scores, rtol=0, atol=AGREE_TOL)
        assert (g.rounds, g.source, g.version, g.target_offset) == (
            w.rounds,
            w.source,
            w.version,
            w.target_offset,
        )
    return got


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("backend", ENGINES)
def test_queries_match_reference(bundles, backend, early_exit):
    port, ref = _engines(bundles, backend, early_exit)
    trace = bundles[1].trace
    ents = [int(e) for e in trace.entity[:6]]
    first = _check_batch(port, ref, ents)
    assert {r.source for r in first} <= {"cold", "warm"}
    # query(): a batch of one; a repeat entity is a cache hit in both
    tq, rq = _specs(ents[:1])
    got, want = port.query(tq[0]), ref.query(rq[0])
    assert got.source == want.source == "cache" and got.rounds == want.rounds == 0
    assert list(got.candidates) == list(want.candidates)
    np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=AGREE_TOL)
    # another target type and top_k go through the same ranking
    _check_batch(port, ref, ents[:3], target_type=1, top_k=5)


@pytest.mark.parametrize(
    "backend,early_exit,refresh_rounds",
    [("dense", True, 0), ("dense", False, 2), ("sparse", True, 0), ("kernel", False, 0)],
)
def test_queries_match_after_each_delta(bundles, backend, early_exit, refresh_rounds):
    """Stale columns demote to warm starts (advanced ``refresh_rounds``
    fused rounds on the new operator) after every delta of the stream."""
    port, ref = _engines(bundles, backend, early_exit, refresh_rounds=refresh_rounds)
    ents = [int(e) for e in bundles[1].trace.entity[:4]]
    _check_batch(port, ref, ents)
    deltas = bundles[1].deltas
    assert len(deltas) == 8 and len(bundles[0].deltas) == 8
    for td_port, td_ref in zip(bundles[0].deltas, deltas):
        assert port.apply_delta(td_port.delta) == ref.apply_delta(td_ref.delta)
        assert port.state.num_nodes == ref.state.num_nodes
        _check_batch(port, ref, ents + [int(bundles[1].trace.entity[-1])])
    assert port.version == 8
    assert port.state.num_nodes == bundles[0].network.num_nodes + 2


def _replay(serve, engine, pkg, bundle):
    trace = pkg.build_trace(bundle, "diurnal", rate_qps=30.0, horizon_s=2.0, seed=0)
    report = serve.replay_trace(engine, trace, bundle.deltas, top_k=10, time_scale=2.0)
    assert report["queries"] == len(trace) > 0
    assert engine.batcher.stats.rejected == 0
    assert engine.version == len(bundle.deltas)
    return report


@pytest.fixture(scope="module")
def reference_replay(bundles):
    _, rcfg = _configs("dense", True, max_batch=32, pipeline_depth=2, cache_shards=4)
    return _replay(rsv, rsv.LPServeEngine(bundles[1].network, rcfg), rs, bundles[1])


@pytest.mark.parametrize("backend", ["dense", "kernel"])
def test_replay_answers_every_query(bundles, reference_replay, backend):
    """The quickstart's diurnal trace, replayed through the pipelined
    batcher with the delta stream interleaved, on the port's engines and
    on the reference's dense engine."""
    tcfg, _ = _configs(backend, True, max_batch=32, pipeline_depth=2, cache_shards=4)
    engine = tsv.LPServeEngine(bundles[0].network, tcfg, device="cpu")
    got = _replay(tsv, engine, ts, bundles[0])
    assert got["queries"] == reference_replay["queries"]
    assert got["deltas_applied"] == reference_replay["deltas_applied"] == 8


def test_engine_device_policy(bundles):
    net = bundles[0].network
    cfg = tsv.ServeConfig(lp=tc.LPConfig(alg="dhlp2", seed_mode="fixed", backend="sparse"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tsv.LPServeEngine(net, cfg)  # device=None means cuda:0, no fallback
    eng = te.make_engine("sparse", cfg.lp, device="cpu")
    served = tsv.LPServeEngine(net, cfg, engine=eng)
    assert served._engine is eng and eng.device.type == "cpu"
    tsv.LPServeEngine(net, cfg, engine=eng, device="cpu")
    with pytest.raises((ValueError, RuntimeError)):
        tsv.LPServeEngine(net, cfg, engine=eng, device="cuda")


def test_auto_rescale_keeps_the_device(bundles, monkeypatch):
    """A node-adding delta that moves ``auto`` across the dense/sparse
    boundary rebuilds the engine on the same device."""
    import repro_torch.engine.base as teb

    net = bundles[0].network
    monkeypatch.setattr(teb, "AUTO_DENSE_MAX_NODES", net.num_nodes)
    cfg = tsv.ServeConfig(lp=tc.LPConfig(alg="dhlp2", seed_mode="fixed"), engine="auto")
    served = tsv.LPServeEngine(net, cfg, device="cpu")
    assert served._engine.name == "dense"
    for td in bundles[0].deltas:
        served.apply_delta(td.delta)
    assert served._engine.name == "sparse"
    assert served._engine.device.type == "cpu"
    (spec,), _ = _specs([0])
    assert served.query(spec).source in ("cold", "warm")


def test_serve_config_validation_matches_reference():
    cases = [
        dict(engine="kernel", lp_backend="sparse"),
        dict(engine="nope"),
        dict(alg="dhlp1", engine="kernel"),
        dict(refresh_rounds=-1),
        dict(seed_mode="drift"),
        dict(pipeline_depth=0),
        dict(cache_shards=8, cache_columns=4),
        dict(early_exit=True, momentum=0.3),
    ]
    for case in cases:
        case = dict(case)
        lp_kw = {k: case.pop(k) for k in ("alg", "seed_mode", "momentum") if k in case}
        lp_kw.setdefault("seed_mode", "fixed")
        if "lp_backend" in case:
            lp_kw["backend"] = case.pop("lp_backend")
        msgs = []
        for core, serve in ((tc, tsv), (rc, rsv)):
            with pytest.raises(ValueError) as err:
                serve.ServeConfig(lp=core.LPConfig(**lp_kw), **case)
            msgs.append(str(err.value))
        # both registries know the same keys, so the messages are equal
        assert msgs[0] == msgs[1], case
