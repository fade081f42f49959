"""The port's activation-sharding hints vs ``repro.parallel.hints``, on the
CPU.

Meshes are fabricated: the reference's ``_resolve`` / ``_axes_size`` read
``mesh.axis_names`` and ``mesh.shape``, the port's a ``DeviceMesh``'s
``mesh_dim_names`` and ``size(i)``; both get the same axis names and
sizes.  ``shard_hint`` returns its input with no mesh or a mesh of size-1
axes, checks the spec's rank, and raises ``NotImplementedError`` naming
ROADMAP A.9.5 where the reference would shard.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro.parallel import hints as jax_hints
from repro_torch.configs import registry
from repro_torch.models.transformer import Transformer, init_cache
from repro_torch.parallel import hints

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class PortMesh:
    def __init__(self, sizes):
        self.mesh_dim_names = tuple(sizes)
        self._sizes = tuple(sizes.values())

    def size(self, i):
        return self._sizes[i]


class JaxMesh:
    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)


MESHES = [
    {"data": 2, "model": 4},
    {"pod": 2, "data": 3, "model": 1},
    {"model": 8},
    {"data": 16},
    {"x": 2, "y": 2},
    {"pod": 1, "data": 1, "model": 1},
]
AXES = [None, hints.BATCH, hints.TP, "data", "model", "pod", "x", "absent"]


@pytest.fixture
def mesh_guard():
    yield
    hints.set_ambient_mesh(None)


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "x".join(f"{k}{v}" for k, v in s.items()))
def test_resolve_and_axes_size_are_the_reference(sizes):
    assert (hints.BATCH, hints.TP) == (jax_hints.BATCH, jax_hints.TP)
    mine, ref = PortMesh(sizes), JaxMesh(sizes)
    for axis in AXES:
        r = hints._resolve(axis, mine)
        assert r == jax_hints._resolve(axis, ref), axis
        assert hints._axes_size(r, mine) == jax_hints._axes_size(r, ref), axis


def test_no_mesh_returns_the_input():
    x = torch.zeros(3, 4)
    assert hints.get_ambient_mesh() is None
    assert hints.shard_hint(x, hints.BATCH, None, hints.TP) is x  # the reference checks no rank
    assert jax_hints.shard_hint(np.zeros((3, 4)), hints.BATCH, None, hints.TP).shape == (3, 4)


def test_size_one_axes_return_the_input_and_check_the_rank(mesh_guard):
    hints.set_ambient_mesh(PortMesh({"pod": 1, "data": 1, "model": 1}))
    x = torch.zeros(4, 6, 8)
    assert hints.shard_hint(x, hints.BATCH, None, hints.TP) is x
    with pytest.raises(ValueError, match="spec rank 2 != array rank 3"):
        hints.shard_hint(x, hints.BATCH, None)


def test_axes_that_do_not_divide_are_dropped(mesh_guard):
    hints.set_ambient_mesh(PortMesh({"data": 3, "model": 5}))
    x = torch.zeros(4, 7)
    assert hints.shard_hint(x, hints.BATCH, hints.TP) is x  # 4 % 3, 7 % 5: both dropped


def test_a_wider_mesh_raises_naming_a95(mesh_guard):
    hints.set_ambient_mesh(PortMesh({"data": 2, "model": 4}))
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.9\.5"):
        hints.shard_hint(torch.zeros(4, 8), hints.BATCH, hints.TP)


def test_the_mesh_is_per_thread(mesh_guard):
    hints.set_ambient_mesh(PortMesh({"data": 1}))
    seen = []
    t = threading.Thread(target=lambda: seen.append(hints.get_ambient_mesh()))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and seen == [None]
    assert hints.get_ambient_mesh() is not None


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "minicpm3-4b"])
def test_the_models_hint_where_the_reference_does(mesh_guard, arch):
    """A one-device mesh leaves the forward as it was; a wider one reaches
    a hint and raises (the models call ``shard_hint`` on their path)."""
    cfg = registry.get_arch(arch).reduced_config
    model = Transformer(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 16))
    want = model.prefill(toks, init_cache(cfg, 2, 16, device="cpu"))[0]
    hints.set_ambient_mesh(PortMesh({"data": 1, "model": 1}))
    assert torch.equal(model.prefill(toks, init_cache(cfg, 2, 16, device="cpu"))[0], want)
    hints.set_ambient_mesh(PortMesh({"data": 2, "model": 1}))
    with pytest.raises(NotImplementedError, match=r"A\.9\.5"):
        model.prefill(toks, init_cache(cfg, 2, 16, device="cpu"))


def test_hints_and_the_models_import_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.parallel.hints, repro_torch.models.transformer\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
