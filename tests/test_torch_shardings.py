"""The port's production meshes and family placements against the
reference's ``repro.launch.mesh`` / ``repro.launch.shardings``.

The reference's side runs in a subprocess with 512 fabricated host
devices (``--xla_force_host_platform_device_count=512``, which must be set
before JAX starts): for cells of every family on both production meshes
it prints each input leaf's ``PartitionSpec``.  The port's specs
(:func:`specs_for`) must equal them leaf for leaf (an LM layer leaf is the
reference's stacked leaf without its layer axis), and the port's DTensor
placements must be the specs inverted here independently: mesh dim ``i``
is ``Shard(d)`` when tensor dim ``d`` lists mesh axis ``i``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs import get_arch
from repro_torch.configs.cells import TensorSpec
from repro_torch.launch.mesh import data_axes, make_production_mesh
from repro_torch.launch.shardings import Spec, shardings_for, specs_for

ROOT = Path(__file__).resolve().parent.parent
CELLS = [("granite-moe-3b-a800m", "train_4k"), ("h2o-danube-1.8b", "decode_32k"),
         ("minicpm3-4b", "prefill_32k"), ("gcn-cora", "full_graph_sm"),
         ("wide-deep", "train_batch"), ("wide-deep", "serve_p99"), ("dhlp-bio", "scale_1m")]
MESHES = ["single", "multi"]

_REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from repro.configs import get_arch
from repro.launch.mesh import make_production_mesh
from repro.launch.shardings import shardings_for


def key(k):
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


out = {}
for mesh_kind in ("single", "multi"):
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    for arch, shape in json.loads(sys.argv[1]):
        spec = get_arch(arch)
        cell = spec.make_cell(shape)
        leaves = jax.tree_util.tree_flatten_with_path(shardings_for(mesh, spec.family, cell))[0]
        shapes = jax.tree_util.tree_leaves(cell.input_specs)
        out[f"{arch}/{shape}@{mesh_kind}"] = {
            "/".join(key(k) for k in path): [
                list(a) if isinstance(a, tuple) else a
                for a in tuple(s.spec) + (None,) * (len(sd.shape) - len(s.spec))]
            for (path, s), sd in zip(leaves, shapes)}
# the LP step's HLO: where its all-reduce sits, and what the census makes of it
import re
from repro.launch.dryrun import collective_census
spec = get_arch("dhlp-bio")
cell = spec.make_cell("scale_1m")
mesh = make_production_mesh()
with mesh:
    hlo = jax.jit(cell.step_fn, in_shardings=shardings_for(mesh, "lp", cell),
                  donate_argnums=cell.donate).lower(*cell.input_specs).compile().as_text()
comp, homes = None, []
for line in hlo.splitlines():
    m = re.match(r"^(ENTRY\s+)?%?([\w.\-]+)\s*\(.*\{\s*$", line)
    if m:
        comp = m.group(2)
    elif " all-reduce(" in line or "all-reduce-start(" in line:
        homes.append(comp)
out["lp_hlo"] = {"census": collective_census(hlo)["all-reduce"], "homes": homes,
                 "bodies": re.findall(r"body=%?([\w.\-]+)", hlo)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_specs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REFERENCE, json.dumps(CELLS)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.splitlines()[-1])


def _flat(tree, path=()):
    """(path, leaf) pairs with the reference's path keys; a port LM layer
    ``layers/<i>/<name>`` is keyed ``layers/<name>`` with its index."""
    if tree is None:
        return []
    placements = isinstance(tree, tuple) and tree and all(hasattr(x, "is_shard") for x in tree)
    if placements or isinstance(tree, (Spec, TensorSpec)) or not isinstance(tree, (dict, list,
                                                                                    tuple)):
        return [(path, tree)]
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif hasattr(tree, "_fields"):
        items = list(zip(tree._fields, tree))
    else:
        items = [(str(i), v) for i, v in enumerate(tree)]
    return [pair for k, v in items for pair in _flat(v, path + (str(k),))]


def _unstack(path):
    """A port layer leaf's key in the reference's stacked tree, and its layer."""
    if "layers" in path:
        i = path.index("layers")
        if i + 1 < len(path) and path[i + 1].isdigit():
            return "/".join(path[:i + 1] + path[i + 2:]), int(path[i + 1])
    return "/".join(path), None


def _axes(a):
    return tuple(a) if isinstance(a, list) else a


@pytest.mark.parametrize("mesh_kind", MESHES)
@pytest.mark.parametrize("arch,shape", CELLS)
def test_placements_are_the_references_partition_specs(reference_specs, arch, shape, mesh_kind):
    from torch.distributed.tensor import Replicate, Shard

    want = reference_specs[f"{arch}/{shape}@{mesh_kind}"]
    spec = get_arch(arch)
    cell = spec.make_cell(shape)
    with make_production_mesh(multi_pod=mesh_kind == "multi") as mesh:
        specs = specs_for(mesh, spec.family, cell)
        placed = shardings_for(mesh, spec.family, cell)
        names = mesh.mesh_dim_names
        assert data_axes(mesh) == (("pod", "data") if mesh_kind == "multi" else ("data",))
    got_specs = _flat(specs)
    got_placed = dict(_flat(placed))
    assert len(got_specs) == len(_flat(cell.input_specs))
    seen = set()
    for path, s in got_specs:
        ref_key, layer = _unstack(path)
        ref = [_axes(a) for a in want[ref_key]]
        if layer is not None:
            ref = ref[1:]  # the stacked leaf's layer axis
        assert list(s) == ref, (path, s, ref)
        seen.add(ref_key)
        inverted = [Replicate()] * len(names)
        for d, axes in enumerate(ref):
            for a in (axes,) if isinstance(axes, str) else (axes or ()):
                inverted[names.index(a)] = Shard(d)
        assert tuple(got_placed[path]) == tuple(inverted), path
    assert seen == set(want)


def test_layouts_shard_what_the_reference_shards():
    """Spot checks of the rules: granite's experts over ``model``
    (expert-parallel, 48 padded experts over 16), the GQA cache's batch
    over data and sequence over model, the multi-pod batch over
    ``("pod", "data")``, the LP edges over model and seeds over data."""
    from torch.distributed.tensor import Replicate, Shard

    granite = get_arch("granite-moe-3b-a800m").make_cell("train_4k")
    danube = get_arch("h2o-danube-1.8b").make_cell("decode_32k")
    lp = get_arch("dhlp-bio").make_cell("scale_1m")
    with make_production_mesh(multi_pod=True) as mesh:
        p, o, b = shardings_for(mesh, "lm", granite)
        assert p["layers"][0]["w_up"] == (Replicate(), Replicate(), Shard(0))
        assert o.mu["layers"][3]["w_up"] == p["layers"][3]["w_up"] and o.step == (Replicate(),) * 3
        assert b["tokens"] == (Shard(0), Shard(0), Replicate())
        cache = shardings_for(mesh, "lm", danube)[1]
        assert cache == (Shard(2), Shard(2), Shard(3))
    with make_production_mesh() as mesh:
        src, _, _, y, _ = shardings_for(mesh, "lp", lp)
        assert (src, y) == ((Replicate(), Shard(0)), (Shard(1), Replicate()))


def test_the_reference_census_counts_the_lp_loops_all_reduce_once(reference_specs):
    """A reference quirk the port does not imitate (ROADMAP C): the LP
    step's one all-reduce sits in its ``fori_loop``'s body, so it runs
    every round, but the reference's census files it at top level (the
    body's name holds neither "body" nor "while"), once.  The port's
    eager census counts the 10 rounds' 10 all-reduces."""
    lp = reference_specs["lp_hlo"]
    assert lp["census"] == {"count": 1, "bytes": 54_272_000, "loop_count": 0, "loop_bytes": 0}
    assert len(lp["homes"]) == 1 and lp["homes"][0] in lp["bodies"]
    assert "body" not in lp["homes"][0] and "while" not in lp["homes"][0]
