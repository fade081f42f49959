"""Port durability (queue A.5) vs the JAX reference.

* the kill-at-3 / resume drill of ``tests/test_ft_session.py`` on the
  port's ``dense``, ``sparse`` and ``kernel`` engines (the kernel engine
  on its plain version here): the resumed solve equals an uninterrupted
  one bit for bit (``max|Δ| == 0``) within the port, and its rankings
  equal ``repro``'s;
* guarded serving (retry, restore + replay) and the ``ft.*`` roll-up in
  the digest and the serve artifact, beside ``repro``'s;
* ``CheckpointManager``: a step one package writes restores in the other,
  both ways, and the two agree on every rejection (shape, dtype,
  structure) and on which steps they see (partial, corrupt, garbage-
  collected);
* the step guard, straggler watch and fault injector step for step;
* the committed crash-drill specs through ``python -m repro_torch run``
  and ``--resume``;
* on a card (marker ``gpu``): the kernel hook synchronizes, and B1 gives
  the same bytes across two launches and two processes, which the
  byte-identical resume rests on.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.api as ra
import repro.checkpoint as rck
import repro.ft as rft
import repro_torch.api as ta
import repro_torch.checkpoint as tck
import repro_torch.ft as tft
from repro.obs.summary import load_dir as r_load_dir
from repro.obs.summary import summarize as r_summarize
from repro_torch.launch import cli as tcli
from repro_torch.obs.summary import load_dir as t_load_dir
from repro_torch.obs.summary import render as t_render
from repro_torch.obs.summary import summarize as t_summarize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "examples", "specs")
AGREE_TOL = 5e-3


def _quiet(*_a, **_k):
    pass


def _spec_dict(run_id, backend="dense", **ft):
    return {
        "run_id": run_id,
        "network": {"kind": "scenario", "name": "streaming_chaos", "scale": 0.3, "seed": 5},
        "solve": {"alg": "dhlp2", "sigma": 1e-4, "seed_mode": "fixed", "backend": backend,
                  "top_k": 5},
        "serve": {"trace": "diurnal", "rate_qps": 60.0, "horizon_s": 1.0,
                  "time_scale": 100.0, "max_batch": 16, "top_k": 5},
        "obs": {"level": "metrics"},
        "ft": {"interval": 2, "keep_last": 3, "max_retries": 2, "backoff_s": 0.0, **ft},
    }


@pytest.fixture(scope="module")
def reference_clean(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ref"))
    spec = ra.RunSpec.from_dict(_spec_dict("clean"))
    return ra.Session(spec, results_root=root).run(sections=["solve"], echo=_quiet)[0]


# ---------------------------------------------------------- solve drill


@pytest.mark.parametrize("backend", ["dense", "sparse", "kernel"])
def test_kill_at_3_resume_is_byte_identical(tmp_path, reference_clean, backend):
    root = str(tmp_path)
    clean = ta.Session(ta.RunSpec.from_dict(_spec_dict("clean", backend)), results_root=root,
                       device="cpu").run(sections=["solve"], echo=_quiet)[0]
    spec = ta.RunSpec.from_dict(_spec_dict("chaos", backend, inject_solve_fault=[3]))
    with pytest.raises(tft.TransientWorkerError, match="step 3"):
        ta.Session(spec, results_root=root, device="cpu").run(sections=["solve"], echo=_quiet)
    # a fresh Session on the same spec and results root is the resume path
    resumed = ta.Session(spec, results_root=root, device="cpu").run(
        sections=["solve"], echo=_quiet)[0]
    assert resumed.ft["resumed_from"] == 2  # the last durable barrier before step 3
    assert clean.ft["resumed_from"] is None
    assert float(np.max(np.abs(resumed.F - clean.F))) == 0.0
    assert resumed.ranking == clean.ranking
    assert resumed.outer_iters == clean.outer_iters == reference_clean.outer_iters
    assert resumed.ranking["candidates"] == reference_clean.ranking["candidates"]
    np.testing.assert_allclose(resumed.ranking["scores"], reference_clean.ranking["scores"],
                               rtol=0, atol=AGREE_TOL)
    assert np.max(np.abs(resumed.F - reference_clean.F)) <= AGREE_TOL


def test_ft_stats_match_the_reference(tmp_path, reference_clean):
    root = str(tmp_path)
    got = ta.Session(ta.RunSpec.from_dict(_spec_dict("clean")), results_root=root,
                     device="cpu").solve()
    assert sorted(got.ft) == sorted(reference_clean.ft)
    for key in ("checkpoints", "resumed_from"):  # straggler flags are timings
        assert got.ft[key] == reference_clean.ft[key], key
    assert got.ft["ckpt_dir"] == os.path.join(root, "clean", "checkpoints", "solve")
    assert sorted(os.listdir(got.ft["ckpt_dir"])) == sorted(
        os.listdir(reference_clean.ft["ckpt_dir"]))


def test_unsupported_engine_is_rejected(tmp_path, monkeypatch):
    import repro_torch.ft.solve as ft_solve

    monkeypatch.setattr(ft_solve, "supports_checkpointed", lambda engine: False)
    session = ta.Session(ta.RunSpec.from_dict(_spec_dict("bad")), results_root=str(tmp_path),
                         device="cpu")
    with pytest.raises(ta.SpecError, match="round"):
        session.solve()


# ---------------------------------------------------------- serve drill


@pytest.mark.parametrize(
    "ft,expect",
    [({"inject_serve_fault": [1]}, {"restores": 0}),
     ({"max_retries": 1, "inject_serve_fault": [1, 2]}, {"restores": 1})],
    ids=["retry", "restore"],
)
def test_guarded_serving_matches_the_reference(tmp_path, ft, expect):
    got = ta.Session(ta.RunSpec.from_dict(_spec_dict("sv", **ft)), results_root=str(tmp_path),
                     device="cpu").run(echo=_quiet)
    want = ra.Session(ra.RunSpec.from_dict(_spec_dict("sv", **ft)),
                      results_root=str(tmp_path / "ref")).run(echo=_quiet)
    g, w = got[-1], want[-1]
    assert g.kind == w.kind == "serve"
    assert g.report["queries"] == w.report["queries"] > 0
    assert g.ft["injected_faults"] == w.ft["injected_faults"] == ft["inject_serve_fault"]
    assert g.ft["restores"] == w.ft["restores"] == expect["restores"]
    assert g.ft["retries"] >= 1 and w.ft["retries"] >= 1
    assert g.ft["checkpoints"] >= 1
    assert sorted(g.ft) == sorted(w.ft)
    assert "ft" in g.summary()


def test_digest_carries_the_ft_block_like_the_reference(tmp_path):
    for api, root in ((ta, tmp_path / "t"), (ra, tmp_path / "r")):
        kw = {"device": "cpu"} if api is ta else {}
        api.Session(api.RunSpec.from_dict(_spec_dict("digest", inject_serve_fault=[1])),
                    results_root=str(root), **kw).run(echo=_quiet)
    got = t_summarize(*t_load_dir(str(tmp_path / "t" / "digest" / "telemetry")))
    want = r_summarize(*r_load_dir(str(tmp_path / "r" / "digest" / "telemetry")))
    assert sorted(got["ft"]) == sorted(want["ft"])
    assert got["ft"]["checkpoints"] >= 1 and got["ft"]["retries"] >= 1
    assert got["ft"]["resumes"] == want["ft"]["resumes"] == 0
    assert any(line.startswith("ft:") for line in t_render(got).splitlines())
    assert got["convergence"]["supersteps"] == want["convergence"]["supersteps"]


# ------------------------------------------------------------ checkpoints


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "F": rng.random((6, 4)),
        "F_prev": rng.random((6, 4)),
        "active": rng.random(4) < 0.5,
        "col_iters": rng.integers(0, 9, 4).astype(np.int32),
        "nested": [rng.random(3).astype(np.float32), (rng.integers(0, 5, (2, 2)),)],
    }


TREES = {
    "solve_state": lambda s: {k: v for k, v in _tree(s).items() if k != "nested"},
    "nested": _tree,
    "serve_cache": lambda s: [np.arange(3, dtype=np.int64), _tree(s)["F"]],
}


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(TREES))
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_step_restores_in_the_other_package(tmp_path, name, writer):
    tree = TREES[name](3)
    src, dst = (rck, tck) if writer == "reference" else (tck, rck)
    with src.CheckpointManager(str(tmp_path)) as cm:
        cm.save(4, tree, metadata={"kind": "solve"})
    reader = dst.CheckpointManager(str(tmp_path))
    step, restored = reader.restore_latest(TREES[name](0))
    assert step == 4
    _equal_trees(restored, tree)
    leaves, meta = reader.restore_flat(4)
    assert meta == {"kind": "solve"} and len(leaves) > 0
    # both packages write the same manifest, apart from the wall time
    other = tmp_path / "other"
    with dst.CheckpointManager(str(other)) as cm:
        cm.save(4, tree, metadata={"kind": "solve"})
    manifests = [json.load(open(p / "step_00000004" / "manifest.json"))
                 for p in (tmp_path, other)]
    for m in manifests:
        m.pop("time")
    assert manifests[0] == manifests[1]


def test_tensor_leaves_are_host_copies_and_restore_to_a_device(tmp_path):
    t = torch.arange(6, dtype=torch.float64)
    cm = tck.CheckpointManager(str(tmp_path), async_write=True)
    cm.save(1, {"t": t, "a": np.ones(2)})
    t.add_(100.0)  # a live tensor changing after save must not reach the step
    cm.close()
    _, restored = tck.CheckpointManager(str(tmp_path)).restore_latest(
        {"t": torch.zeros(6, dtype=torch.float64), "a": np.zeros(2)}, device="cpu")
    assert isinstance(restored["t"], torch.Tensor) and restored["t"].device.type == "cpu"
    assert torch.equal(restored["t"], torch.arange(6, dtype=torch.float64))
    assert isinstance(restored["a"], np.ndarray)
    _, via_ref = rck.CheckpointManager(str(tmp_path)).restore_latest(
        {"t": np.zeros(6), "a": np.zeros(2)})
    np.testing.assert_array_equal(via_ref["t"], np.arange(6.0))


def _both(tmp_path, **kw):
    return [(pkg, pkg.CheckpointManager(str(tmp_path / pkg.__name__), **kw))
            for pkg in (tck, rck)]


def test_keep_last_partial_and_corrupt_steps_like_the_reference(tmp_path):
    seen = []
    for pkg, cm in _both(tmp_path, keep_last=2):
        for s in (1, 2, 3):
            cm.save(s, _tree(s))
        os.makedirs(os.path.join(cm.root, "step_00000009.tmp"))
        before = cm.steps()
        with open(os.path.join(cm.root, "step_00000003", "manifest.json"), "w") as f:
            f.write("{broken")
        step, restored = cm.restore_latest(_tree(0))
        seen.append((before, cm.steps(), step))
        _equal_trees(restored, _tree(2))
    assert seen[0] == seen[1] == ([2, 3], [2, 3], 2)  # the corrupt step is skipped


@pytest.mark.parametrize(
    "like,cast",
    [
        (lambda: {**_tree(0), "F": np.zeros((5, 4))}, False),  # shape
        (lambda: {**_tree(0), "col_iters": np.zeros(4, np.int64)}, False),  # dtype
        (lambda: {k: v for k, v in _tree(0).items() if k != "F_prev"}, False),  # leaves
        (lambda: {**_tree(0), "nested": [_tree(0)["nested"][0], _tree(0)["nested"][1][0]]},
         False),  # structure
    ],
    ids=["shape", "dtype", "leaf_count", "treedef"],
)
def test_restore_rejects_what_the_reference_rejects(tmp_path, like, cast):
    msgs = []
    for pkg, cm in _both(tmp_path):
        cm.save(1, _tree(1))
        with pytest.raises(ValueError) as err:
            cm.restore(1, like(), cast=cast)
        msgs.append(str(err.value))
        assert cm.restore_latest(like()) == (None, None)
    assert msgs[0] == msgs[1]


def test_cast_opts_in_and_async_errors_surface(tmp_path):
    for pkg, cm in _both(tmp_path, async_write=True):
        cm.save(1, _tree(1))
        cm.wait()
        like = {**_tree(0), "col_iters": np.zeros(4, np.int64)}
        restored = cm.restore(1, like, cast=True)
        assert restored["col_iters"].dtype == np.int64
        open(os.path.join(cm.root, "step_00000005.tmp"), "w").close()
        cm.save(5, _tree(5))
        with pytest.raises(OSError):
            cm.wait()
        cm.close()
        with pytest.raises(RuntimeError, match="closed"):
            cm.save(6, _tree(6))
        assert cm.steps() == [1]


# -------------------------------------------------------------- runtime


def test_step_guard_matches_the_reference_step_for_step():
    logs = []
    for pkg in (tft, rft):
        sleeps, restores = [], []
        inj = pkg.FailureInjector(fail_at=(0, 1, 2, 3, 7))
        calls = iter(range(100))
        guard = pkg.StepGuard(max_retries=2, backoff_s=0.5, sleep=sleeps.append,
                              restore_fn=lambda: restores.append(1))

        def step():
            inj.maybe_fail(next(calls))
            return "ok"

        out = [guard.run(step) for _ in range(3)]
        with pytest.raises(ValueError):
            guard.run(lambda: (_ for _ in ()).throw(ValueError("fatal")))
        logs.append((out, sleeps, restores, guard.retries, guard.restores, inj.fired))
    assert logs[0] == logs[1]
    assert logs[0][4] == 1  # the budget ran out once and the restore replayed
    for msg in ("DATA_LOSS at x", "socket closed", "shape mismatch"):
        assert tft.is_retryable(RuntimeError(msg)) == rft.is_retryable(RuntimeError(msg))


def test_straggler_watch_matches_the_reference():
    rng = np.random.default_rng(7)
    times = list(rng.lognormal(-3.0, 0.2, 40)) + [1.0, 0.05, 2.0] + list(
        rng.lognormal(-3.0, 0.2, 10))
    got = tft.StragglerWatch(alpha=0.2, threshold=2.0)
    want = rft.StragglerWatch(alpha=0.2, threshold=2.0)
    assert [got.observe(t) for t in times] == [want.observe(t) for t in times]
    assert got.slow_steps == want.slow_steps >= 2
    assert got.mean_step_time == want.mean_step_time


# --------------------------------------------------------------------- CLI


def test_crashdrill_cli_resume_equals_the_clean_twin(tmp_path, capsys):
    root = str(tmp_path)
    run = os.path.join(SPECS, "crashdrill_run.json")
    clean = os.path.join(SPECS, "crashdrill_clean.json")
    with pytest.raises(tft.TransientWorkerError):
        tcli.main(["run", run, "--device", "cpu", "--results-root", root])
    assert tcli.main(["run", "--resume", "crashdrill", "--device", "cpu",
                      "--results-root", root]) == 0
    assert "resumed_from=" in capsys.readouterr().out
    assert tcli.main(["run", clean, "--device", "cpu", "--results-root", root]) == 0
    got = json.load(open(os.path.join(root, "crashdrill", "solve.json")))
    want = json.load(open(os.path.join(root, "crashdrill-clean", "solve.json")))
    assert got["ranking"] == want["ranking"]
    assert got["outer_iters"] == want["outer_iters"]
    serve = json.load(open(os.path.join(root, "crashdrill", "serve.json")))
    assert serve["ft"]["injected_faults"] == [2] and serve["ft"]["retries"] >= 1
    assert tcli.main(["obs", "crashdrill", "--results-root", root, "--validate"]) == 0


def test_resume_refuses_what_the_reference_refuses(tmp_path, capsys):
    from repro.launch.cli import run_main as r_run_main

    root = str(tmp_path)
    # no stored spec under the run id
    assert tcli.main(["run", "--resume", "nothing", "--device", "cpu",
                      "--results-root", root]) == 2
    assert r_run_main(["--resume", "nothing", "--results-root", root]) == 2
    # a spec file beside --resume is a usage error
    spec = os.path.join(SPECS, "crashdrill_run.json")
    for main, extra in ((tcli.run_main, ["--device", "cpu"]), (r_run_main, [])):
        with pytest.raises(SystemExit) as exc:
            main(["--resume", "x", spec, "--results-root", root, *extra])
        assert exc.value.code == 2
    capsys.readouterr()
    # a stored spec without an ft section: nothing was checkpointed
    d = json.load(open(os.path.join(SPECS, "quickstart_run.json")))
    os.makedirs(os.path.join(root, "noft"))
    json.dump({**d, "run_id": "noft"}, open(os.path.join(root, "noft", "spec.json"), "w"))
    assert tcli.main(["run", "--resume", "noft", "--device", "cpu",
                      "--results-root", root]) == 2
    assert "nothing was checkpointed" in capsys.readouterr().err


# ------------------------------------------------------------ on a card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda:0")


_B1_DIGEST = """
import hashlib, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from repro_torch.core.solver import LPConfig
from repro_torch.engine import make_engine
from repro_torch.scenarios import generate
net = generate("powerlaw", scale=0.2, seed=0, cache=False).network
eng = make_engine("kernel", LPConfig(alg="dhlp2", sigma=1e-4, seed_mode="fixed"), device="cuda:0")
op = eng.prepare(net)
F = np.random.default_rng(1).random((net.num_nodes, 256))
Y = np.random.default_rng(2).random((net.num_nodes, 256))
Fn, delta = eng.round_with_residual(op, F, Y)
print(hashlib.sha256(Fn.tobytes() + delta.tobytes()).hexdigest())
"""


@pytest.mark.gpu
def test_b1_round_is_deterministic_across_launches_and_processes(dev):
    digests = [
        subprocess.run([sys.executable, "-c", _B1_DIGEST, os.path.join(ROOT, "src")],
                       capture_output=True, text=True, check=True, timeout=600).stdout.strip()
        for _ in range(2)
    ]
    assert digests[0] == digests[1]
    from repro_torch.core.solver import LPConfig
    from repro_torch.engine import make_engine
    from repro_torch.scenarios import generate

    net = generate("powerlaw", scale=0.2, seed=0, cache=False).network
    eng = make_engine("kernel", LPConfig(alg="dhlp2", sigma=1e-4, seed_mode="fixed"),
                      device=dev)
    op = eng.prepare(net)
    F = np.random.default_rng(1).random((net.num_nodes, 256))
    Y = np.random.default_rng(2).random((net.num_nodes, 256))
    a = eng.round_with_residual(op, F, Y)
    b = eng.round_with_residual(op, F, Y)
    assert a[0].tobytes() == b[0].tobytes() and a[1].tobytes() == b[1].tobytes()


@pytest.mark.gpu
def test_kernel_hook_synchronizes_the_operands_card(dev):
    from repro_torch.kernels.segment_reduce import csr_round_residual_op, live_rows
    from repro_torch.obs import Telemetry
    from repro_torch.obs import profiler as tprof

    rng = np.random.default_rng(0)
    m, n, d, s = 4096, 8192, 64, 512
    nbr = torch.from_numpy(rng.integers(0, n, (m, d)).astype(np.int32)).to(dev)
    w = rng.random((m, d)).astype(np.float32)
    wgt = torch.from_numpy(w).to(dev)
    F = torch.rand((n, s), device=dev)
    base = torch.rand((m, s), device=dev)
    tel = Telemetry("profile", run_id="hook")
    tprof.install_kernel_hook(tel)
    try:
        big = torch.rand((8192, 8192), device=dev)
        big @ big  # queued work the clock must not charge to the launch
        t0 = tprof.kernel_clock(dev)
        assert torch.cuda.current_stream(dev).query()  # the queue drained first
        out, delta = csr_round_residual_op(nbr, wgt, F, base, F[:m], c=0.25,
                                           live=live_rows(w, dev))
        assert torch.cuda.current_stream(dev).query()  # the launch finished
        assert t0 is not None
    finally:
        tprof.uninstall_kernel_hook()
    assert tel.metrics.peek("kernel.csr_round_residual.kernel.calls").value == 1
    assert tel.metrics.peek("kernel.csr_round_residual.kernel.latency_s").count == 1
    assert tel.metrics.peek("kernel.csr_round_residual.ref.calls") is None
