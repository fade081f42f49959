"""The port's device policy and its independence from JAX and ``repro``."""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.core.solver import HeteroLP, LPConfig
from repro_torch.device import resolve_device
from repro_torch.engine import make_engine
from repro_torch.scenarios import generate

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def no_cuda(monkeypatch):
    """Pretend the machine has no card, whatever it has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def net():
    return generate("bio_tri", scale=0.1, seed=0, cache=False).network


def test_default_device_without_cuda_raises(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")


def test_explicit_cpu_resolves(no_cuda):
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


@pytest.mark.parametrize("backend", ["dense", "sparse", "kernel"])
def test_entry_points_need_an_explicit_cpu(no_cuda, net, backend):
    cfg = LPConfig(alg="dhlp2", seed_mode="fixed", autotune=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_engine(backend, cfg).run(net)
    res = make_engine(backend, cfg, device="cpu").run(net)
    assert res.F.shape == (net.num_nodes, net.num_nodes)


def test_heterolp_needs_an_explicit_cpu(no_cuda, net):
    cfg = LPConfig(backend="dense", use_kernel=True, seed_mode="fixed")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HeteroLP(cfg).run(net)
    assert HeteroLP(cfg, device="cpu").run(net).converged


def _port_modules():
    pkg = Path(repro_torch.__file__).parent
    names = ["repro_torch"]
    for info in pkgutil.walk_packages([str(pkg)], prefix="repro_torch."):
        names.append(info.name)
    return names


def test_no_module_imports_jax_or_repro():
    """Import every module of the port, and chip_smoke.py, with JAX and
    ``repro`` blocked.  A subprocess: this worker has imported both."""
    modules = _port_modules()
    assert len(modules) > 20
    assert {
        "repro_torch.data.drugnet",
        "repro_torch.eval.cv",
        "repro_torch.eval.metrics",
        "repro_torch.scenarios.evaluate",
        "repro_torch.configs.cells",
        "repro_torch.configs.gcn_cora",
        "repro_torch.configs.wide_deep",
        "repro_torch.data.graphs",
        "repro_torch.data.recsys",
        "repro_torch.graph.segment",
        "repro_torch.graph.structures",
        "repro_torch.kernels.embedding_bag.ops",
        "repro_torch.kernels.flash_attention.ops",
        "repro_torch.configs.h2o_danube_1_8b",
        "repro_torch.configs.stablelm_1_6b",
        "repro_torch.models.transformer",
        "repro_torch.models.convert",
        "repro_torch.models.gnn",
        "repro_torch.models.recsys",
        "repro_torch.configs.registry",
        "repro_torch.configs.dhlp_bio",
        "repro_torch.configs.gat_cora",
        "repro_torch.configs.dimenet",
        "repro_torch.configs.meshgraphnet",
        "repro_torch.configs.granite_moe_3b_a800m",
        "repro_torch.configs.minicpm3_4b",
        "repro_torch.configs.moonshot_v1_16b_a3b",
        "repro_torch.graph.sampler",
        "repro_torch.graph.partition",
        "repro_torch.optim.optimizers",
        "repro_torch.optim.schedules",
        "repro_torch.optim.step",
        "repro_torch.data.lm",
        "repro_torch.launch.train",
        "repro_torch.bench.suites.lp_on_graph",
    } <= set(modules)
    code = "\n".join(
        [
            "import importlib, sys",
            "import importlib.abc",
            "class Block(importlib.abc.MetaPathFinder):",
            "    def find_spec(self, name, path=None, target=None):",
            "        if name == 'repro' or name.startswith('repro.'):",
            "            raise ImportError('blocked: ' + name)",
            "sys.modules['jax'] = None",
            "sys.meta_path.insert(0, Block())",
            f"for m in {modules!r}:",
            "    importlib.import_module(m)",
            "import runpy",
            f"runpy.run_path({str(ROOT / 'chip_smoke.py')!r}, run_name='chip_smoke')",
            "bad = [m for m, mod in sys.modules.items() if mod is not None",
            "       and m.split('.')[0] in ('jax', 'jaxlib', 'repro')]",
            "assert not bad, bad",
            "print('ok', len(sys.modules))",
        ]
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", code],
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_chip_smoke_alone_fails_without_result(tmp_path):
    """In a directory holding only the script it must fail, printing no result."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"],
        cwd=tmp_path,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_without_cuda_fails_without_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")],
        cwd=ROOT,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
