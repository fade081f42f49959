"""The port's elastic re-mesh vs ``tests/test_elastic.py``.

A checkpoint written here (one process, no world) is restored by 8 gloo
ranks (``run_ranks``, one process each, a 300 s limit) as ``DTensor``
leaves on an 8-device mesh (``CheckpointManager.restore_latest(...,
shardings=...)``) with the same step and checksum; int8
``grad_allreduce`` over 4 ranks stays within the reference's relative
error (< 0.05; stochastic rounding cannot match JAX's bit for bit).  Then
``ElasticController.plan`` against ``repro``'s on a grid of device counts,
and ``remesh`` end to end on a world of one rank in this process: the
restored state equal to the saved one, the telemetry counters recorded.

The rank bodies import nothing of ``repro``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.parallel.launch import run_ranks

HERE = str(Path(__file__).resolve())


def _restore_ranks(payload):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.parallel.mesh import MeshSharding, make_mesh

    cm = CheckpointManager(payload["root"])
    like = {"w": torch.zeros((64, 32)), "b": torch.zeros((32,))}
    mesh = make_mesh((8,), ("data",), device="cpu")
    sh = {"w": MeshSharding(mesh, (Shard(0),)), "b": MeshSharding(mesh, (Replicate(),))}
    step, restored = cm.restore_latest(like, shardings=sh)
    w = restored["w"]
    return {
        "step": step,
        "n_shards": mesh.size(),
        "local_rows": int(w.to_local().shape[0]),
        "checksum": float(w.full_tensor().sum()),
        "b_checksum": float(restored["b"].full_tensor().sum()),
        "is_sharded": any(isinstance(p, Shard) for p in w.placements),
    }


def _int8_ranks(payload):
    import torch.distributed as dist

    from repro_torch.parallel.collectives import grad_allreduce

    rank, k = dist.get_rank(), dist.get_world_size()
    g = np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32)
    local = torch.from_numpy(g[rank * 4 : (rank + 1) * 4])
    gen = torch.Generator().manual_seed(rank)
    out = grad_allreduce({"g": local}, compression="int8", generator=gen)["g"]
    want = torch.from_numpy(g.reshape(k, 4, 8).sum(axis=0))
    rel = torch.tensor([float((out - want).abs().max() / (want.abs().max() + 1e-9))])
    dist.all_reduce(rel, op=dist.ReduceOp.MAX)
    return {"rel_err": float(rel)}


class TestElasticRestore:
    def test_single_device_save_multi_device_restore(self, tmp_path):
        rng = np.random.default_rng(1)
        tree = {"w": torch.from_numpy(rng.random((64, 32)).astype(np.float32)),
                "b": torch.from_numpy(rng.random(32).astype(np.float32))}
        cm = CheckpointManager(str(tmp_path))
        cm.save(42, tree)
        cm.wait()
        out = run_ranks(f"{HERE}:_restore_ranks", 8, {"root": str(tmp_path)}, timeout=300)
        assert out["step"] == 42
        assert out["n_shards"] == 8 and out["local_rows"] == 8
        assert out["is_sharded"] is True
        np.testing.assert_allclose(out["checksum"], float(tree["w"].sum()), rtol=1e-6)
        np.testing.assert_allclose(out["b_checksum"], float(tree["b"].sum()), rtol=1e-6)


class TestInt8Collective:
    def test_int8_allreduce_bounded_error(self):
        out = run_ranks(f"{HERE}:_int8_ranks", 4, {}, timeout=300)
        assert out["rel_err"] < 0.05


@pytest.mark.parametrize("healthy,current", [(8, 8), (7, 8), (5, 8), (4, 8), (3, 4), (1, 2),
                                             (6, 2), (2, 1)])
def test_controller_plans_like_the_reference(healthy, current):
    from repro.ft import ElasticController as RController
    from repro_torch.ft import ElasticController

    got, want = ElasticController(), RController()
    assert got.plan(healthy, current) == want.plan(healthy, current)
    assert got.history == want.history


def test_controller_refuses_below_minimum():
    from repro_torch.ft import ElasticController

    with pytest.raises(RuntimeError, match="minimum"):
        ElasticController(min_devices=4).plan(2, 8)


@pytest.fixture
def world():
    from repro_torch.parallel.mesh import destroy_owned_world

    yield
    destroy_owned_world()


def test_remesh_round_trip_onto_a_one_device_mesh(world, tmp_path):
    from repro_torch.ft import remesh
    from repro_torch.obs import Telemetry
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.parallel.mesh import MeshSharding, make_mesh

    F = torch.from_numpy(np.random.default_rng(3).random((40, 10)).astype(np.float32))
    tel = Telemetry("metrics")
    tree = {"F": F, "it": torch.tensor(7)}
    mesh = {}

    def make_shardings(k):
        mesh["m"] = make_mesh((k,), ("data",), device="cpu")
        return {"F": MeshSharding(mesh["m"], (Shard(0),)),
                "it": MeshSharding(mesh["m"], (Replicate(),))}

    cm = CheckpointManager(str(tmp_path))
    out, plan = remesh(cm, tree, healthy_devices=1, current_devices=2,
                       make_shardings=make_shardings, step=5, telemetry=tel)
    assert plan == {"from": 2, "to": 1, "action": "checkpoint-restore-reshard"}
    assert mesh["m"].size() == 1
    assert torch.equal(out["F"].full_tensor(), F) and int(out["it"].full_tensor()) == 7
    assert cm.manifest(5)["metadata"] == {"elastic": plan}
    assert tel.metrics.peek("ft.remeshes").value == 1
    assert tel.metrics.peek("ft.mesh_devices").value == 1
    same, none = remesh(cm, tree, healthy_devices=2, current_devices=2)
    assert none is None and same is tree


def test_remesh_without_shardings_restores_the_template(tmp_path):
    from repro.ft import remesh as rremesh
    from repro_torch.ft import remesh

    F = np.random.default_rng(4).random((6, 3)).astype(np.float32)
    out, plan = remesh(CheckpointManager(str(tmp_path / "t")), {"F": torch.from_numpy(F)},
                       healthy_devices=3, current_devices=4)
    import jax.numpy as jnp
    from repro.checkpoint import CheckpointManager as RManager

    rout, rplan = rremesh(RManager(str(tmp_path / "r")), {"F": jnp.asarray(F)},
                          healthy_devices=3, current_devices=4)
    assert plan == rplan
    np.testing.assert_array_equal(out["F"].numpy(), np.asarray(rout["F"]))
