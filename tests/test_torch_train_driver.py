"""The port's training driver end to end on the CPU, after
``tests/test_train_driver.py``: fault injection (the retried run's final
parameters bit for bit a clean run's), resume from a checkpoint (bit for
bit an uninterrupted run), an lp-family arch pointing to ``solve``,
``Session.train``, ``python -m repro_torch run --device cpu`` on the docs'
train spec and the deprecated ``python -m repro_torch.launch.train`` shim."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro_torch.api as ta
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch.train import run_training

ROOT = Path(__file__).resolve().parent.parent
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}


def _quiet(_line):
    pass


def _final_leaves(ckpt_dir):
    mgr = CheckpointManager(str(ckpt_dir))
    step = mgr.steps()[-1]
    man = mgr.manifest(step)
    return step, [np.load(os.path.join(mgr._step_dir(step), r["file"])) for r in man["leaves"]]


def _train(tmp, **kw):
    spec = ta.TrainSpec(**kw)
    lines = []
    return run_training(spec, echo=lines.append, device="cpu"), lines


def test_retried_step_leaves_parameters_bit_equal_to_a_clean_run(tmp_path):
    common = dict(arch="gcn-cora", steps=25, log_every=24, ckpt_every=10)
    faulty, lines = _train(tmp_path, ckpt_dir=str(tmp_path / "f"), inject_fault=(12,), **common)
    clean, _ = _train(tmp_path, ckpt_dir=str(tmp_path / "c"), **common)
    assert faulty["retries"] == 1 and clean["retries"] == 0 and faulty["restores"] == 0
    assert any("retries=1" in ln for ln in lines)
    assert faulty["last_loss"] < faulty["first_loss"] * 0.5  # it still converges
    assert faulty["last_loss"] == clean["last_loss"]
    (sf, lf), (sc, lc) = _final_leaves(tmp_path / "f"), _final_leaves(tmp_path / "c")
    assert sf == sc == 24 and len(lf) == len(lc) > 0
    for a, b in zip(lf, lc):
        np.testing.assert_array_equal(a, b)


def test_resume_from_checkpoint_is_bit_equal_to_an_uninterrupted_run(tmp_path):
    common = dict(arch="wide-deep", batch=16, ckpt_every=5)
    first, _ = _train(tmp_path, steps=10, ckpt_dir=str(tmp_path / "r"), **common)
    second, lines = _train(tmp_path, steps=14, ckpt_dir=str(tmp_path / "r"), **common)
    assert not first["resumed"] and second["resumed"] and second["steps"] == 4
    assert "[train] resumed from step 9" in lines
    straight, _ = _train(tmp_path, steps=14, ckpt_dir=str(tmp_path / "s"), **common)
    assert straight["last_loss"] == second["last_loss"]
    for a, b in zip(_final_leaves(tmp_path / "r")[1], _final_leaves(tmp_path / "s")[1]):
        np.testing.assert_array_equal(a, b)


def test_lp_family_points_to_solve():
    with pytest.raises(ta.SpecError, match="solve"):
        _train(None, arch="dhlp-bio", steps=1)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "gat-cora"])
def test_session_train_returns_the_artifact(tmp_path, arch):
    spec = ta.RunSpec(train=ta.TrainSpec(arch=arch, steps=4, batch=2, seq=16, log_every=1))
    art = ta.Session(spec, results_root=str(tmp_path), device="cpu").train(echo=_quiet)
    assert (art.kind, art.arch, art.steps, art.retries, art.resumed) == (
        "train", arch, 4, 0, False)
    assert np.isfinite([art.first_loss, art.last_loss]).all()
    assert art.summary()["family"] == ("lm" if arch == "stablelm-1.6b" else "gnn")


def test_cli_runs_the_docs_train_spec_and_resumes(tmp_path):
    spec = {"run_id": "train-demo",
            "train": {"arch": "gcn-cora", "steps": 12, "batch": 4, "inject_fault": [5],
                      "ckpt_dir": str(tmp_path / "ck")}}
    path = tmp_path / "train.json"
    path.write_text(json.dumps(spec))
    cmd = [sys.executable, "-m", "repro_torch", "run", str(path), "--device", "cpu",
           "--results-root", str(tmp_path / "res")]
    out = subprocess.run(cmd, capture_output=True, text=True, env=ENV, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "retries=1" in out.stdout and "[train] gcn-cora (gnn): 12 steps" in out.stdout
    art = json.loads((tmp_path / "res" / "train-demo" / "train.json").read_text())
    assert art["retries"] == 1 and art["resumed"] is False
    spec["train"]["steps"] = 15
    path.write_text(json.dumps(spec))
    out = subprocess.run(cmd, capture_output=True, text=True, env=ENV, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[train] resumed from step 11" in out.stdout
    art = json.loads((tmp_path / "res" / "train-demo" / "train.json").read_text())
    assert art["resumed"] is True and art["steps"] == 3


def test_the_deprecated_shim_runs_and_refuses_lp(tmp_path):
    base = [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu"]
    out = subprocess.run(base + ["--arch", "h2o-danube-1.8b", "--steps", "3", "--seq", "16",
                                 "--batch", "2", "--log-every", "1"],
                         capture_output=True, text=True, env=ENV, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "DeprecationWarning" in out.stderr and "[train] artifact: train" in out.stdout
    assert out.stdout.count("[train] step") == 3
    bad = subprocess.run(base + ["--arch", "dhlp-bio", "--steps", "1"], capture_output=True,
                         text=True, env=ENV, timeout=300)
    assert bad.returncode == 2 and "solve" in bad.stdout
