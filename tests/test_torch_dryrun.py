"""The port's dry run and roofline suite on the CPU, against the reference's.

* The roofline functions (``repro_torch.bench.roofline``) against
  ``benchmarks/roofline.py``'s on the committed census sample and on
  synthetic records: the per-device counts are equal, and the times are
  those counts over the H100 peaks of ``PEAKS``.
* The census (``repro_torch.launch.dryrun``) counts each rank's local
  program on the 16×16 production mesh: a sharded matmul's per-rank FLOPs,
  and ``dhlp-bio`` ``scale_1m@single`` within 5 % of the reference
  sample's corrected FLOPs per device, one all-reduce of 54,272,000 B a
  round and no all-gather.
* Every LM cell (REDUCED widths at the cell's shapes): the probe
  extrapolation ``f(0) + L·(f(1) − f(0))`` equals the full trace's FLOPs,
  since eager layers are identical; the full ``h2o-danube-1.8b``
  ``train_4k`` cell's useful-FLOPs ratio from its probes.
* The fake world is destroyed after an error, and refused beside a real one.
* ``Session.dryrun`` writes the reference's artifact format, and its
  census goes through the roofline suite with the card's terms.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.bench import roofline as port_roofline
from repro_torch.configs import get_arch
from repro_torch.configs.cells import Cell, lm_cell, sds
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.shardings import shardings_for

ROOT = Path(__file__).resolve().parent.parent
SAMPLE = ROOT / "benchmarks" / "data" / "dryrun_sample.jsonl"
sys.path.insert(0, str(ROOT / "benchmarks"))
import roofline as ref_roofline  # noqa: E402

STRICT = ("flops_per_device", "hbm_bytes_per_device", "collective_bytes_per_device")
LM_ARCHS = ["h2o-danube-1.8b", "stablelm-1.6b", "granite-moe-3b-a800m", "moonshot-v1-16b-a3b",
            "minicpm3-4b"]


# ------------------------------------------------------------------ roofline
def _synthetic(**over):
    rec = {
        "arch": "a", "shape": "s", "mesh": "single", "kind": "train", "status": "ok",
        "meta": {"scan_trip": 4, "model_flops": 1e12},
        "cost": {"flops": 1e9, "bytes accessed": 1e9},
        "probe": {"0": {"flops": 2e8, "bytes": 1e8}, "1": {"flops": 4e8, "bytes": 3e8}},
        "collectives": {"all-reduce": {"count": 1, "bytes": 1e6, "loop_count": 2,
                                       "loop_bytes": 5e5}},
        "memory": {"temp_size_in_bytes": int(1e9), "argument_size_in_bytes": int(1e8)},
    }
    rec.update(over)
    return rec


RECORDS = [json.loads(line) for line in SAMPLE.read_text().splitlines()] + [
    _synthetic(),
    _synthetic(probe=None, mesh="multi", dtype="bfloat16"),
    _synthetic(meta={"scan_trip": None}, memory={}),
    _synthetic(probe={"0": {"flops": 1.0, "bytes": 2.0}, "1": {"error": "x"}}),
    _synthetic(memory={"temp_size_in_bytes": int(9e10), "argument_size_in_bytes": 0}),
]


@pytest.mark.parametrize("rec", RECORDS, ids=[f"{r['shape']}@{r['mesh']}#{i}"
                                              for i, r in enumerate(RECORDS)])
def test_roofline_counts_match_the_reference_and_terms_use_the_card(rec):
    assert port_roofline.corrected_costs(rec) == ref_roofline.corrected_costs(rec)
    assert port_roofline.collective_bytes(rec) == ref_roofline.collective_bytes(rec)
    got, want = port_roofline.analyze(rec), ref_roofline.analyze(rec)
    assert {k: got[k] for k in STRICT} == {k: want[k] for k in STRICT}
    assert (got["chips"], got.get("useful_flops_ratio")) == (want["chips"],
                                                             want.get("useful_flops_ratio"))
    peaks = port_roofline.PEAKS["h100_sxm"]
    flops_peak = peaks["bf16_flops"] if rec.get("dtype") == "bfloat16" else peaks["flops"]
    assert got["t_compute_s"] == got["flops_per_device"] / flops_peak
    assert got["t_memory_s"] == got["hbm_bytes_per_device"] / peaks["bytes_per_s"]
    assert got["t_collective_s"] == got["collective_bytes_per_device"] / peaks["link_bytes_per_s"]
    if "fits_hbm_16g" in want:
        mem = rec["memory"]
        assert got["fits_hbm"] == (mem["temp_size_in_bytes"] + mem["argument_size_in_bytes"]
                                   < 80e9)
        assert "fits_hbm_16g" not in got


def test_roofline_load_reads_both_formats(tmp_path):
    tel = tmp_path / "dryrun.jsonl"
    with open(tel, "w") as f:
        f.write(json.dumps({"kind": "meta", "schema": 1}) + "\n")
        for r in RECORDS[:3]:
            f.write(json.dumps({"kind": "event", "name": "dryrun.cell", "attrs": r}) + "\n")
        f.write("not json\n")
    for path in (SAMPLE, tel):
        assert port_roofline.load(str(path)) == ref_roofline.load(str(path))
    assert port_roofline.load(str(tel)) == RECORDS[:3]
    assert port_roofline.analyze({"status": "error"}) is None


# ------------------------------------------------------------------- census
def test_a_sharded_matmul_counts_each_ranks_product():
    """x ``Shard(0)`` on ``data``, w ``Shard(1)`` on ``model``: each rank
    multiplies [256, 2048] by [2048, 512]."""
    from torch.distributed.tensor import Replicate, Shard

    cell = Cell(arch="mm", shape="s", kind="serve", step_fn=lambda w, x: x @ w,
                input_specs=(sds((2048, 8192), torch.float32), sds((4096, 2048), torch.float32)))
    with make_production_mesh() as mesh:
        got = dryrun.trace_cell(cell, ((Replicate(), Shard(1)), (Shard(0), Replicate())), mesh)
    assert got["cost"]["flops"] == 2 * 256 * 2048 * 512 == 536_870_912
    assert got["cost"]["bytes accessed"] == 4 * (256 * 2048 + 2048 * 512 + 256 * 512)
    assert all(c["count"] == 0 for c in got["collectives"].values())
    assert got["memory"]["argument_size_in_bytes"] == 4 * (256 * 2048 + 2048 * 512)


def test_dhlp_bio_scale_1m_census_matches_the_reference_sample():
    sample = next(r for r in RECORDS[:3] if r["shape"] == "scale_1m" and r["mesh"] == "single")
    rec = dryrun.run_cell("dhlp-bio", "scale_1m", "single")
    assert rec["status"] == "ok", rec.get("traceback")
    assert set(sample) - set(rec) == {"compile_s", "hlo_bytes"}
    want = ref_roofline.corrected_costs(sample)["flops"]
    assert want == 568_920_240
    got = port_roofline.corrected_costs(rec)["flops"]
    assert abs(got / want - 1) < 0.05
    assert got == rec["cost"]["flops"]  # the probes extrapolate the eager rounds exactly
    col = rec["collectives"]
    assert col["all-reduce"] == {"count": 10, "bytes": 10 * 54_272_000, "loop_count": 0,
                                 "loop_bytes": 0}
    assert col["all-gather"]["count"] == col["all-to-all"]["count"] == 0
    for k in ("argument_size_in_bytes", "output_size_in_bytes", "alias_size_in_bytes"):
        assert rec["memory"][k] == sample["memory"][k]
    assert "temp_size_in_bytes" not in rec["memory"] and "fallbacks" not in rec


LM_CELLS = [(a, s) for a in LM_ARCHS for s in get_arch(a).shapes
            if not lm_cell(a, get_arch(a).reduced_config, s).skip_reason]


@pytest.fixture(scope="class")
def production_mesh():
    with make_production_mesh() as mesh:
        yield mesh


class TestLMProbes:
    @pytest.mark.parametrize("arch,shape", LM_CELLS)
    def test_lm_probes_extrapolate_the_full_trace(self, production_mesh, arch, shape):
        """Eager layers are identical, so ``f(0) + L·(f(1) − f(0))`` is the
        full trace's FLOPs and bytes exactly (REDUCED widths at the cell's
        shapes; the full widths are the same code)."""
        cfg = get_arch(arch).reduced_config

        def cost(n_layers):
            cell = lm_cell(arch, dataclasses.replace(cfg, n_layers=n_layers), shape)
            return dryrun.trace_cell(cell, shardings_for(production_mesh, "lm", cell),
                                     production_mesh)["cost"]

        try:
            full, p0, p1 = cost(cfg.n_layers), cost(0), cost(1)
        except RuntimeError as e:
            # minicpm3's absorbed MLA splits kv_b's heads over the model
            # axis unevenly: the census refuses to gather the parameter
            assert arch == "minicpm3-4b" and shape != "train_4k"
            assert "sharded parameter" in str(e)
            return
        assert full["flops"] > 0
        for k in ("flops", "bytes accessed"):
            assert p0[k] + cfg.n_layers * (p1[k] - p0[k]) == full[k]

    def test_an_lm_train_cells_useful_flops_ratio(self, production_mesh):
        """``h2o-danube-1.8b`` ``train_4k`` at full width, its FLOPs from the
        trip-0/1 probes as the roofline suite extrapolates them: the model's
        6·N·T over the counted work of 256 ranks (attention, rematerialised
        layers and the optimizer are the rest)."""
        spec = get_arch("h2o-danube-1.8b")
        cell = spec.make_cell("train_4k")
        probe = {}
        for trip in (0, 1):
            pc = spec.make_probe_cell("train_4k", trip)
            cost = dryrun.trace_cell(pc, shardings_for(production_mesh, "lm", pc),
                                     production_mesh)["cost"]
            probe[str(trip)] = {"flops": cost["flops"], "bytes": cost["bytes accessed"]}
        rec = {"arch": cell.arch, "shape": "train_4k", "mesh": "single", "status": "ok",
               "meta": cell.meta, "cost": {}, "probe": probe, "collectives": {}}
        ratio = port_roofline.analyze(rec)["useful_flops_ratio"]
        assert 0.5 < ratio <= 1.05


def test_the_fake_world_is_destroyed_after_an_error_and_refused_beside_one():
    with pytest.raises(ZeroDivisionError):
        with make_host_mesh((2, 2), ("data", "model")):
            assert dist.get_world_size() == 4
            raise ZeroDivisionError
    assert not dist.is_initialized()
    from repro_torch.parallel.mesh import destroy_owned_world, ensure_world

    ensure_world("cpu")  # a real world: one gloo rank
    try:
        with pytest.raises(RuntimeError, match="one exists \\(backend gloo, 1 ranks\\)"):
            with make_production_mesh():
                pass
        assert dist.get_backend() == "gloo"
    finally:
        destroy_owned_world()
    assert not dist.is_initialized()
    rec = dryrun.run_cell("gcn-cora", "molecule", "single")  # its CSR is built from data
    assert rec["status"] == "error" and "Traceback" in rec["traceback"]
    assert not dist.is_initialized()


def test_session_dryrun_writes_the_census_and_the_suite_reads_it(tmp_path, monkeypatch):
    import repro.obs as ro

    from repro_torch.api import DryrunSpec, RunSpec, Session
    from repro_torch.bench.suites import roofline as suite

    spec = RunSpec(dryrun=DryrunSpec(archs=("dhlp-bio",), shapes=("scale_1m",), mesh="both"))
    session = Session(spec, results_root=str(tmp_path), device="cpu")
    (art,) = session.run(echo=lambda *_: None)
    assert art.summary()["statuses"] == {"ok": 2} and len(art.cells) == 2
    run_dir = tmp_path / spec.resolved_run_id()
    census = run_dir / "telemetry" / "dryrun.jsonl"
    assert (run_dir / "dryrun.json").exists()
    ro.validate_file(str(census))  # the reference's schema
    assert ref_roofline.load(str(census)) == port_roofline.load(str(census))
    monkeypatch.setenv("REPRO_DRYRUN_ARTIFACTS", str(census))
    recs = suite.records(device="cpu")
    assert [(r.name, r.backend) for r in recs] == [("dhlp-bio/scale_1m", "single"),
                                                    ("dhlp-bio/scale_1m", "multi")]
    for r, cell in zip(recs, art.cells):
        assert r.params["artifact"] == "live" and r.params["peak_model"] == "h100_sxm"
        assert r.derived["collective_bytes_per_device"] == cell["collectives"]["all-reduce"]["bytes"]
        assert r.derived["t_memory_s"] == r.derived["hbm_bytes_per_device"] / 3.35e12
