"""B5 ``embedding_bag``: the launch plan, its schedule and the in-place MLP input, on the CPU.

The CUDA kernel (``src/repro_torch/csrc/embedding_bag.cu``) runs only on
a card (``tests/test_torch_gpu.py``).  What surrounds it is checked here:

* :func:`bag_plan`, the wrapper's pure choice of regime, vector width and
  lanes from D, K, the dtype, the addresses and the output row stride;
* a plain emulation of each regime's schedule (warp tiles walked by a
  persistent grid, ``kRowsInFlight`` bags a lane handed over by shuffles,
  the ids of the next step loaded one step ahead, the slots regime's id
  vectors and fixed xor tree), which must write every (bag, column) of a
  strided ``out`` exactly once and agree with the plain version at the
  f32 tolerance of ``tests/test_kernels.py::_tol``;
* the strided ``out`` on the CPU route;
* Wide & Deep's deep input written in place, bit for bit the reference's
  concatenation, and serving against ``repro`` with a padded MLP input.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import wide_deep as jax_wide_deep
from repro.models import recsys as jax_recsys
from repro_torch.configs import cells, wide_deep
from repro_torch.data.recsys import CTRDataConfig, sample_ctr_batch
from repro_torch.kernels import launch_counts
from repro_torch.kernels.embedding_bag import (
    BagPlan,
    bag_plan,
    embedding_bag_op,
    embedding_bag_ref,
    launch_plan,
)
from repro_torch.kernels.embedding_bag.ops import SLOT_VECS
from repro_torch.models.convert import load_widedeep
from repro_torch.models.recsys import WideDeep, make_retrieval_scorer, make_serve

F32_TOL = dict(rtol=2e-4, atol=5e-4)
ELEM = {"f32": 4, "bf16": 2}
A = 1 << 20  # a 16-byte aligned address


def _plan(d, k, dtype="f32", *, table=A, out=A, ld=None, idx=A, w=A):
    return bag_plan(d, k, ELEM[dtype], table_ptr=table, out_ptr=out,
                    ld=d if ld is None else ld, idx_ptr=idx, w_ptr=w)


# ------------------------------------------------------------ the plan
@pytest.mark.parametrize(
    "d,k,dtype,kw,want",
    [
        (32, 1, "f32", {}, BagPlan("vector", 4, 8)),  # the deep lookup
        (32, 1, "bf16", {}, BagPlan("vector", 8, 4)),
        (16, 3, "f32", {}, BagPlan("vector", 4, 4)),
        (16, 3, "bf16", {}, BagPlan("vector", 8, 2)),
        (64, 40, "f32", {}, BagPlan("vector", 4, 16)),
        (128, 1, "f32", {}, BagPlan("vector", 4, 32)),
        (256, 1, "f32", {}, BagPlan("vector", 4, 32)),  # 64 chunks: two a lane
        (8, 1, "bf16", {}, BagPlan("vector", 8, 1)),
        (36, 1, "f32", {}, BagPlan("scalar", 1, 32)),  # 9 chunks: not a power of two
        (36, 1, "bf16", {}, BagPlan("scalar", 1, 32)),  # 72 bytes
        (200, 3, "f32", {}, BagPlan("scalar", 1, 32)),  # 50 chunks
        (5, 2, "f32", {}, BagPlan("scalar", 1, 8)),
        (12, 2, "bf16", {}, BagPlan("scalar", 1, 16)),  # 24 bytes
        (32, 1, "f32", {"table": A + 4}, BagPlan("scalar", 1, 32)),  # storage offset
        (32, 1, "bf16", {"table": A + 2}, BagPlan("scalar", 1, 32)),
        (32, 1, "f32", {"out": A + 8}, BagPlan("scalar", 1, 32)),
        (32, 1, "f32", {"ld": 1293}, BagPlan("scalar", 1, 32)),  # the unpadded MLP row
        (32, 1, "f32", {"ld": 1296}, BagPlan("vector", 4, 8)),  # padded to 16 bytes
        (32, 1, "bf16", {"ld": 1300}, BagPlan("scalar", 1, 32)),
        (32, 1, "bf16", {"ld": 1296}, BagPlan("vector", 8, 4)),
        (32, 5, "f32", {"idx": A + 4, "w": A + 4}, BagPlan("vector", 4, 8)),  # ids never vectorised
        (1, 40, "f32", {}, BagPlan("slots", 4, 4)),  # the wide lookup
        (1, 40, "bf16", {"w": A + 8}, BagPlan("slots", 4, 4)),
        (1, 40, "bf16", {"w": A + 2}, BagPlan("slots", 1, 16)),
        (1, 40, "f32", {"idx": A + 4}, BagPlan("slots", 1, 16)),
        (1, 40, "f32", {"w": A + 8}, BagPlan("slots", 1, 16)),
        (4, 42, "f32", {}, BagPlan("slots", 1, 16)),  # K not a multiple of 4
        (3, 7, "f32", {}, BagPlan("slots", 1, 2)),
        (2, 1, "f32", {}, BagPlan("slots", 1, 1)),
        (1, 0, "f32", {}, BagPlan("slots", 4, 1)),  # empty bags
        (1, 4 * SLOT_VECS * 32 * 2, "f32", {}, BagPlan("slots", 4, 32)),  # lanes cap at a warp
    ],
)
def test_bag_plan_follows_width_alignment_and_slots(d, k, dtype, kw, want):
    assert _plan(d, k, dtype, **kw) == want


def test_launch_plan_reads_the_tensors_addresses():
    big = torch.zeros(33 * 32 + 1)
    assert big.data_ptr() % 16 == 0
    idx, w = torch.zeros((10, 1), dtype=torch.int32), torch.ones(10, 1)
    regime = lambda t, out: launch_plan(t, idx, w, out).regime  # noqa: E731
    aligned, shifted = big[: 33 * 32].view(33, 32), big[1:].view(33, 32)  # a storage offset
    assert [regime(t, torch.empty(10, 32)) for t in (aligned, shifted)] == ["vector", "scalar"]
    padded, unpadded = torch.empty(5, 1296), torch.empty(5, 1293)  # the MLP input's rows
    assert [regime(aligned, buf[:, :64].view(5, 2, 32)) for buf in (padded, unpadded)] == [
        "vector", "scalar"]


# ------------------------------------------------ the kernels' schedules
def _inputs(v, d, b, k, seed, weights="random"):
    rng = np.random.default_rng(seed)
    tab = rng.standard_normal((v, d)).astype(np.float32)
    idx = rng.integers(0, v, (b, k)).astype(np.int32)
    w = (rng.random((b, k)) if weights == "random" else np.ones((b, k))).astype(np.float32)
    return tab, idx, w


def _out_offset(bag, g, ld, d):
    return (bag // g) * ld + (bag % g) * d


def _emulate_rows(tab, idx, w, plan, *, g, ld, rows_in_flight=8, tile_ids=1, grid_warps=3):
    """``bag_rows_kernel``'s loops in plain numpy: returns the flat output
    (NaN where nothing was written) and how often each element was written."""
    b, k = idx.shape
    d = tab.shape[1]
    lanes, vec = plan.lanes, plan.vec
    gpw, tile = 32 // lanes, 32 * tile_ids
    per_group = tile_ids * lanes
    chunks = -(-d // (lanes * vec))
    tiles = -(-b // tile)
    size = _out_offset(b - 1, g, ld, d) + d
    out = np.full(size, np.nan, np.float32)
    writes = np.zeros(size, np.int64)

    def load_step(t, kk):  # what the lanes hold: bag t * tile + i * 32 + lane, slot kk
        bags = t * tile + np.arange(tile)
        live = bags < b
        ids = np.where(live, idx[np.minimum(bags, b - 1), kk], 0)
        return ids, np.where(live, w[np.minimum(bags, b - 1), kk], 0.0).astype(np.float32)

    for warp in range(grid_warps):
        t = warp
        if t >= tiles:
            continue
        held = load_step(t, 0) if k > 0 else None
        while t < tiles:
            bag0 = t * tile
            for c in range(chunks):
                last_chunk = c + 1 == chunks
                for j0 in range(0, per_group, rows_in_flight):
                    last_pass = last_chunk and j0 + rows_in_flight >= per_group
                    acc = {}
                    for kk in range(k):
                        assert np.array_equal(held[0], load_step(t, kk)[0])  # one step ahead
                        for lane in range(32):
                            group, sub = divmod(lane, lanes)
                            col = (c * lanes + sub) * vec
                            for u in range(rows_in_flight):
                                src = (j0 + u) * gpw + group
                                if col < d and j0 + u < per_group and bag0 + src < b:
                                    row = tab[held[0][src], col : col + vec]
                                    prev = acc.get((src, col), np.zeros(vec, np.float32))
                                    acc[src, col] = (held[1][src] * row + prev).astype(np.float32)
                        nt, nk = t, kk + 1
                        if nk == k:
                            nk = 0
                            if last_pass:
                                nt = t + grid_warps
                        if (nt != t or nk != kk) and nt < tiles:
                            held = load_step(nt, nk)
                    for lane in range(32):
                        group, sub = divmod(lane, lanes)
                        col = (c * lanes + sub) * vec
                        for u in range(rows_in_flight):
                            src = (j0 + u) * gpw + group
                            if col < d and j0 + u < per_group and bag0 + src < b:
                                at = _out_offset(bag0 + src, g, ld, d) + col
                                out[at : at + vec] = acc.get((src, col), np.zeros(vec, np.float32))
                                writes[at : at + vec] += 1
            t += grid_warps
    return out, writes


def _emulate_slots(tab, idx, w, plan, *, g, ld):
    """``bag_slots_kernel`` in plain numpy: each lane's partial sums over
    its id vectors in ascending order, a batch at a time, then the fixed
    xor tree."""
    b, k = idx.shape
    d = tab.shape[1]
    lanes, kv = plan.lanes, plan.vec
    batch = min(8, max(1, 32 // (kv * {1: 1, 2: 2}.get(d, 4))))  # the kernel's SB
    nvec = k // kv
    size = _out_offset(b - 1, g, ld, d) + d
    out = np.full(size, np.nan, np.float32)
    writes = np.zeros(size, np.int64)
    for bag in range(b):
        part = np.zeros((lanes, d), np.float32)
        for sub in range(lanes):
            for v0 in range(sub, nvec, batch * lanes):
                for s in range(batch):
                    vi = v0 + s * lanes
                    if vi < nvec:
                        for e in range(kv):
                            slot = vi * kv + e
                            part[sub] = (w[bag, slot] * tab[idx[bag, slot]] + part[sub]).astype(
                                np.float32)
        off = lanes // 2
        while off:
            part = part + part[np.arange(lanes) ^ off]
            off //= 2
        at = _out_offset(bag, g, ld, d)
        out[at : at + d] = part[0]
        writes[at : at + d] += 1
    return out, writes


def _check_schedule(out, writes, want, g, ld):
    b, d = want.shape
    at = np.array([_out_offset(i, g, ld, d) for i in range(b)])[:, None] + np.arange(d)
    assert (writes[at] == 1).all(), "a (bag, column) written other than once"
    mask = np.ones(out.shape, bool)
    mask[at] = False
    assert (writes[mask] == 0).all() and np.isnan(out[mask]).all()  # the padding stays
    np.testing.assert_allclose(out[at], want, **F32_TOL)


@pytest.mark.parametrize(
    "d,b,k,g,ld_pad",
    [
        (32, 1, 1, 1, 0),
        (32, 31, 1, 1, 0),
        (32, 33, 3, 1, 0),
        (32, 32 * 8 + 1, 1, 1, 0),
        (32, 40 * 7 - 3, 1, 40, 16),  # the strided out: G = 40, a padded row
        (16, 70, 40, 5, 4),
        (64, 45, 2, 3, 0),
        (256, 9, 2, 1, 0),  # two chunks a lane
    ],
)
def test_rows_schedule_writes_each_bag_once_vector(d, b, k, g, ld_pad):
    tab, idx, w = _inputs(300, d, b, k, seed=d + b + k)
    plan = _plan(d, k, ld=g * d + ld_pad)
    assert plan.regime == "vector"
    out, writes = _emulate_rows(tab, idx, w, plan, g=g, ld=g * d + ld_pad)
    want = embedding_bag_ref(*(torch.from_numpy(a) for a in (tab, idx, w))).numpy()
    _check_schedule(out, writes, want, g, g * d + ld_pad)


@pytest.mark.parametrize(
    "d,b,k,kw,rows_in_flight,tile_ids,grid_warps",
    [
        (36, 33, 3, {}, 8, 1, 2),  # scalar: two column chunks, four passes of 8
        (5, 40, 1, {}, 8, 1, 1),
        (32, 70, 1, {"table": A + 4}, 8, 1, 2),  # scalar at D = 32
        (32, 70, 2, {}, 1, 1, 3),  # one row in flight
        (32, 70, 1, {}, 4, 1, 2),
        (32, 130, 1, {}, 16, 2, 2),  # 16 rows in flight: tiles of 64 bags
        (200, 10, 3, {}, 8, 1, 4),
    ],
)
def test_rows_schedule_writes_each_bag_once_variants(d, b, k, kw, rows_in_flight, tile_ids,
                                                      grid_warps):
    tab, idx, w = _inputs(97, d, b, k, seed=d * b + k)
    plan = _plan(d, k, **kw)
    out, writes = _emulate_rows(tab, idx, w, plan, g=1, ld=d, rows_in_flight=rows_in_flight,
                                tile_ids=tile_ids, grid_warps=grid_warps)
    want = embedding_bag_ref(*(torch.from_numpy(a) for a in (tab, idx, w))).numpy()
    _check_schedule(out, writes, want, 1, d)


@pytest.mark.parametrize(
    "d,b,k,kw,g,ld_pad",
    [
        (1, 50, 40, {}, 1, 0),  # the wide lookup: 4 lanes, 2 or 3 id vectors each
        (1, 33, 40, {"idx": A + 4}, 1, 0),  # scalar ids: 16 lanes
        (3, 20, 7, {}, 1, 0),
        (4, 9, 300, {}, 3, 2),  # 75 id vectors: 32 lanes, a strided out
        (2, 5, 0, {}, 1, 0),  # empty bags: zeros
    ],
)
def test_slots_schedule_writes_each_bag_once(d, b, k, kw, g, ld_pad):
    tab, idx, w = _inputs(64, d, b, k, seed=b + k)
    plan = _plan(d, k, **kw)
    assert plan.regime == "slots"
    out, writes = _emulate_slots(tab, idx, w, plan, g=g, ld=g * d + ld_pad)
    want = embedding_bag_ref(*(torch.from_numpy(a) for a in (tab, idx, w))).numpy()
    _check_schedule(out, writes, want, g, g * d + ld_pad)


def test_weight_one_is_an_exact_gather_in_the_schedule():
    tab, idx, w = _inputs(500, 32, 97, 1, seed=3, weights="ones")
    out, _ = _emulate_rows(tab, idx, w, _plan(32, 1), g=1, ld=32)
    assert np.array_equal(out.reshape(97, 32), tab[idx[:, 0]])


# --------------------------------------------- the strided out, CPU route
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_strided_out_on_the_cpu_route(dtype):
    tab, idx, w = (torch.from_numpy(a) for a in _inputs(200, 32, 6 * 40, 1, seed=4))
    tab, w = tab.to(dtype), w.to(dtype)
    buf = torch.full((6, 1296), float("nan"), dtype=dtype)
    view = buf[:, :1280].view(6, 40, 32)
    before = launch_counts()
    got = embedding_bag_op(tab, idx, w, out=view)
    assert got is view and launch_counts() == before
    assert torch.equal(buf[:, :1280].reshape(240, 32), embedding_bag_ref(tab, idx, w))
    assert torch.isnan(buf[:, 1280:]).all()


# --------------------------------------------- Wide & Deep's MLP input
def _widedeep(cfg, seed=0):
    params = jax.tree.map(np.asarray, jax_recsys.widedeep_init(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    params["wide_table"] = rng.normal(0, 0.1, params["wide_table"].shape).astype(np.float32)
    params["wide_dense"] = rng.normal(0, 0.1, params["wide_dense"].shape).astype(np.float32)
    params["bias"] = np.asarray(0.3, np.float32)
    params["mlp_b"] = [rng.normal(0, 0.1, b.shape).astype(np.float32) for b in params["mlp_b"]]
    mine = dataclasses.replace(wide_deep.REDUCED, n_dense=cfg.n_dense)
    return params, mine


# REDUCED's MLP input is 68 wide (16-byte rows already); with FULL's 13
# dense features it is 77, padded to 80 as FULL's 1,293 is to 1,296
PADDED = dataclasses.replace(jax_wide_deep.REDUCED, n_dense=13)


@pytest.mark.parametrize("jcfg", [jax_wide_deep.REDUCED, PADDED], ids=["reduced", "padded"])
def test_deep_input_in_place_equals_the_concatenation(jcfg, monkeypatch):
    params, cfg = _widedeep(jcfg)
    kernel = load_widedeep(WideDeep(cfg, device="cpu"), params)
    plain = load_widedeep(WideDeep(cfg, device="cpu", use_kernel=False), params)
    batch = sample_ctr_batch(CTRDataConfig(cfg.n_sparse, cfg.n_dense, cfg.vocab_per_field), 37)
    rows, dense = kernel.rows(batch["sparse"]), kernel._dense(batch["dense"])
    want = plain._deep_in(rows, dense)

    def no_cat(*args, **kw):
        raise AssertionError("the kernel path concatenated the deep input")

    monkeypatch.setattr(torch, "cat", no_cat)
    got = kernel._deep_in(rows, dense)
    assert got.shape == (37, cfg.deep_in) and got.stride() == (-(-cfg.deep_in // 4) * 4, 1)
    assert torch.equal(got, want)


def test_padded_serve_and_retrieval_match_the_reference():
    params, cfg = _widedeep(PADDED, seed=1)
    model = load_widedeep(WideDeep(cfg, device="cpu"), params)
    batch = sample_ctr_batch(CTRDataConfig(cfg.n_sparse, cfg.n_dense, cfg.vocab_per_field), 64)
    jp = jax.tree.map(jnp.asarray, params)
    want = np.asarray(jax_recsys.make_serve(PADDED)(
        jp, jnp.asarray(batch["sparse"]), jnp.asarray(batch["dense"])))
    np.testing.assert_allclose(
        make_serve(model)(batch["sparse"], batch["dense"]).numpy(), want, **F32_TOL)
    cand = np.random.default_rng(6).random((cells.pad512(700), 16)).astype(np.float32)
    want = np.asarray(jax_recsys.make_retrieval_scorer(PADDED)(
        jp, jnp.asarray(batch["sparse"][:1]), jnp.asarray(batch["dense"][:1]),
        jnp.asarray(cand)))
    got = make_retrieval_scorer(model)(batch["sparse"][:1], batch["dense"][:1],
                                       torch.from_numpy(cand))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
