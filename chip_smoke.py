#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

1. device: card name, ``nvidia-smi`` name and power limit, TF32 off;
2. build: every CUDA kernel of the port, one ``nvcc`` per source, in
   parallel, beside a scratch copy of ``lp_round`` without its hi·lo and
   lo·hi products (a planted fault, under ``build/``); prints the build
   time (in all and per source) and the ``-Xptxas -v`` report;
3. kernels vs their plain PyTorch versions at their paths' shapes
   (``powerlaw`` scenario, scale 1.0, seed 0: 4,396 nodes, S = 4,396
   seed columns), with CUDA-event timings, bounds and library yardsticks:
   ``csr_round_residual`` on the fused plan's buckets, ``lp_round`` on
   the dense operator (f32 on its 3xTF32 tensor-core regime, bf16 on its
   one-product regime; in f32 also against an f64 product, where its
   error may be at most ``B2_F64_FACTOR`` times the plain f32 product's
   and the planted one-product copy must fail that gate; the issued
   TF32 rate, both bounds and the pre-pass's share of the time are
   printed), ``csr_round`` on every bucket of the legacy
   block-rows layout; both round kernels take each bucket's live row
   lengths (the pad slots skipped and the F bytes gathered per round are
   printed), and the f32 gate must reject each of them given two planted
   faults (every row one live slot short; the pad slot left out while the
   F row the pads name holds NaN);
4. the main path: the all-sources DHLP-2 fixed-seed solve on the
   ``kernel`` engine and on the torch-op ``sparse`` engine, which must
   agree (equal rounds, max|ΔF| ≤ 5e-3, same top-10 candidates);
5. the dense ``lp_round`` kernel solve (``backend="dense",
   use_kernel=True``), which must agree with phase 4;
6. the legacy ``fused_superstep=False`` DHLP-2 solve on ``kernel``
   (through ``csr_round``, one launch per bucket and round) and on
   ``sparse``, both held to phase 4's fused kernel-engine result;
7. DHLP-1 on the blocked-CSR engines: the recovery problem (10 % of the
   drug–target edges hidden, 32 seed rows) on ``sparse`` fused, ``sparse``
   legacy and ``dense``, then the all-sources solve on ``sparse`` fused
   and ``dense``, which must agree (max|ΔF| ≤ 5e-3, equal rounds);
8. the model slice's kernels vs their plain versions at their paths'
   shapes, with timings, bounds and library yardsticks: ``csr_aggregate``
   at both GCN layers on ``ogb_products`` (M = N = 2,449,029, D = 89,
   S = 100 and 16; f32, and bf16 at S = 100) on the operator's live row
   lengths (also timed over all D slots; the slots and GB of F rows it
   gathers printed; a NaN in the F row the pads name must reach the
   plain version's rows), ``embedding_bag`` at the
   deep and wide lookups of Wide & Deep ``FULL`` at ``serve_bulk`` (each
   with the launch plan the wrapper picked), the deep lookup written into
   the padded MLP input (timed beside the ``torch.cat`` it replaces), and
   one ragged launch (the deep bags minus 17, K = 3, random weights) held
   to the plain version and ``F.embedding_bag``;
9. GCN (``gcn-cora`` at ``ogb_products`` widths) full-graph inference:
   graph build on host and device, then the forward on the kernel path
   (two ``csr_aggregate`` launches, both given the live row lengths) and
   on the plain path, which must
   agree at f32 ``rtol=2e-4, atol=5e-4``;
10. Wide & Deep ``FULL`` serving: ``serve_p99``, ``serve_bulk`` and
    ``retrieval_cand`` on the kernel path (two ``embedding_bag`` launches
    per serve call, one per retrieval call) and on the plain path, at the
    same tolerance; the deep input written in place must equal the plain
    path's ``torch.cat`` bit for bit, and the traced ``serve_bulk`` call
    must hold no concatenation kernel; peak device memory with the 5.12 GB
    table resident;
10a. ``flash_attention`` vs its plain version at the transformer path's
    shapes (``h2o-danube-1.8b`` prefill_32k and decode_32k layer launches
    and an 8k f32 one, a ``stablelm-1.6b`` 4k one; phase 17's
    ``granite-moe-3b-a800m`` prefill_32k and decode_32k layers, D = 64
    with 24 query heads over 8 KV heads, and ``moonshot-v1-16b-a3b``'s
    8k prefill and batch-32 decode layers, D = 128, 16 / 16), bf16 held at
    ``rtol=2e-2, atol=1e-5`` (one unit in the last place); at each shape
    the same gate must reject the kernel given planted faults (window one
    short, the last 64 live keys dropped, KV heads of the next group);
    each row names the kernel's regime (bf16 prefill or decode on the
    tensor cores, f32 on the CUDA cores), with timings, bounds, the rate
    of live pairs and of issued tensor-core work, and
    ``scaled_dot_product_attention`` as the library yardstick (its
    backend named, and each fused backend also timed alone);
10b. ``h2o-danube-1.8b`` at full width in f32: prefill of 8,192 tokens and
    16 decode steps, kernel path vs plain path at ``rtol=2e-4, atol=5e-4``;
10c. ``h2o-danube-1.8b`` ``FULL`` serving in bf16 on the kernel path:
    ``prefill_32k`` (batch 1) and ``decode_32k`` (batch 128, a 4,096-slot
    cache filled by 3,968-token prefills, 64 greedy steps), walls, tokens/s,
    peak memory, one traced call of each, and the plain prefill's gap;
11. the normal entry point: (a) ``python -m repro_torch run`` on
    ``examples/specs/quickstart_run.json`` as it is (its ``obs`` section
    too), as a subprocess on the card (artifacts under
    ``results/chip_smoke/``), then ``python -m repro_torch obs quickstart
    --validate``: the four telemetry artifacts and no live segment,
    schema-valid, one ``solve.residual`` sample per superstep; its solve
    ranking and rounds equal to an in-process CPU ``Session`` of the
    same spec and its recovery metrics within 5e-3; (b) the serve
    configuration ``powerlaw_serve_kernel`` (``SERVE_SPEC``: phase 4's
    network, the ``kernel`` engine, recovery eval, a 2 s diurnal trace of
    352 queries at 200 qps) through ``Session.run``: the solve held to the
    torch-op ``sparse`` engine (equal rounds and top-10, max|ΔF| ≤ 5e-3),
    every query answered and none rejected, ``csr_round_residual``
    launched by serve's early-exit loop, 64 queries one by one on the
    ``kernel`` and ``sparse`` serve engines with equal top-10 lists, rounds
    and sources; ``csr_round_residual`` at each width the early-exit loop
    pads to (1 to 32 columns) on every bucket of the plan, through
    ``out=`` slices as ``_plan_round`` launches it, held to its plain
    version at the f32 tolerance; stage times, qps, latency percentiles
    and one traced replay; (c) ``powerlaw_obs_kernel``, the same spec with
    the quickstart's ``obs`` section: the observed solve (a host loop of
    ``engine.round``, B1 on every bucket each superstep) held to phase 4
    (equal supersteps and top-10, max|ΔF| ≤ 5e-3), the SLO-watched replay
    answering 352 / 352, the telemetry valid and ``metrics.prom``
    lint-clean; (d) ``powerlaw_profile_kernel`` at ``obs.level
    "profile"`` through ``Session.run``, and the same solve on the legacy
    layout through ``observed_solve`` under the kernel hook and
    ``profile_phase``: the hook's B1 (B3) calls equal to the plan's 19
    (the layout's 47) buckets × supersteps and to the B1 (B3) kernels in
    the Chrome trace; (e) ``powerlaw_crashdrill_kernel``, the spec with
    ``crashdrill_run.json``'s ``ft`` section: the first run dies at
    superstep 3, ``python -m repro_torch run --resume`` completes it, and
    its final F equals a clean checkpointed run's bit for bit, with the
    serve fault retried and every query answered;
12. the bench harness (``bench_phase``) on the card through the CLI:
    (a) ``python -m repro_torch run examples/specs/bench_ci.json``, every
    ported suite's fast pass, its ``BENCH_torch_ci.json`` valid and held
    to ``benchmarks/baseline.json`` on every strict metric of the 52
    record keys the port emits on one card, the 13 it does not emit
    exactly the listed ones (``bench_not_emitted``: the suites not ported,
    XLA's records, and the ``sharded`` points that need more cards); (b)
    ``python -m repro_torch bench --full
    --only kernels``, B2, B4, B5 and B6 at the reference's full sizes each
    within the f32 tolerance of its plain version, timed beside it; (c)
    the ``serve/obs_overhead`` record (obs off / metrics / streaming);
13. the autotune sweep and the sharded engine at full width (phase 4's
    network): (a) ``ensure_tuned`` cold into a fresh directory at S =
    4,396, each layout's torch-op round and each ``slots_per_block``'s B1
    round timed and printed, a second call a hit that times nothing, the
    ``kernel`` solve with ``autotune=True`` (fused, and legacy through B3)
    on the tuned layout held to phase 4 (equal rounds, max|ΔF| ≤ 5e-3,
    top-10), then B1 on every bucket of the tuned plan at every
    ``slots_per_block`` of the grid and B3 on every bucket of the tuned
    legacy layout held to their plain versions at the f32 tolerance;
    (b) the ``sharded`` engine on a world of one NCCL rank: the DHLP-2
    all-sources solve held to phase 4, ``stale_sync=4`` within 1e-3 of
    it with no fewer rounds, bf16 compression within 5e-3, DHLP-1 held to
    phase 7's ``sparse`` solve with equal rounds, ``python -m repro_torch
    run --backend sharded --devices 1``, 64 queries served on ``sharded``
    with the ``kernel`` serve engine's top-10 lists, a ``remesh`` of the
    solve's state onto a one-device mesh, bit for bit; wall per round
    beside B1's;
14. the kernel list, printed after phases 15, 17 and 18 have run: launches of each
    kernel on its path (phases 4-5, 11 (b)-(e) and 13 (a) for
    ``csr_round_residual``, phases 4-5 for ``lp_round``, phases 6, 11 (d),
    13 (a) and 15 (a, b) for ``csr_round``, phases 9 and 15 (c) for
    ``csr_aggregate``, phase 10 for ``embedding_bag``, phases 10c and
    17 (a, d) for ``flash_attention``; all must be non-zero, and so must phase 15's
    ``csr_round`` and ``csr_aggregate``), with the phase 3, 8 and 10a
    measurements (``csr_round_residual``'s error also over phases 11 and
    13's shapes, ``csr_round``'s over phases 13 and 15's,
    ``csr_aggregate``'s over phase 15's);
15. the paper's own arch and the rest of the GNN zoo at full size, each
    sub-phase's seconds and peak device memory printed: (a) ``dhlp-bio``
    (``get_arch("dhlp-bio").make_cell``) at ``scale_1m`` and ``scale_20m``
    (53,000 / 240,000 nodes, 1 M / 20 M ``powerlaw_graph`` edges, S =
    4,096, α = 0.5, 10 rounds a step) in f32: the operator α·D^-1/2 A
    D^-1/2, Y the identity on the first S nodes, F0 = Y; the host build
    and the width-bucket plan timed (buckets, padding ratio and the widest
    row printed); the cell's step through ``csr_round`` held to the plain
    step (``scatter_spmm`` in column chunks) at ``F32_TOL``; ``csr_round``
    on every bucket held to its plain version at ``F32_TOL`` (all S
    columns at ``scale_1m``, 512 at ``scale_20m``) and the planted faults
    rejected there; its time per round (CUDA events, median) beside the
    widest bucket's share, the bounds (the HBM floor of the live gathers
    among them) and ``torch.addmm`` over the CSR operator; (b) the
    ``scale_1m`` step with ``REPRO_LP_DTYPE=bf16`` held to (a)'s f32 step
    at ``BF16_TOL``; (c) GAT at ``full_graph_sm`` and ``ogb_products``,
    SAGE at ``minibatch_lg`` (``erdos_renyi``, ``NeighborSampler`` fanouts
    (15, 10) from 1,024 seeds; ``csr_aggregate`` at both hops held to its
    plain version at ``F32_TOL``, the logits to the plain path), DimeNet at
    ``molecule`` and MeshGraphNet at ``molecule`` and at ``minibatch_lg``'s
    padded union sizes: every output finite, at ``full_graph_sm`` and
    ``molecule`` held to the same module on the CPU at ``rtol=1e-4,
    atol=1e-5``, every forward timed;
16. the result line;
17. the MoE and MLA models (run before phase 14), each sub-phase's seconds
    and peak device memory printed, every cut of a published cell named
    in its log line: (a) ``granite-moe-3b-a800m`` ``FULL`` in bf16 on the
    kernel route (48 padded experts stored): ``prefill_32k`` at batch 1
    (cut from 32) and ``decode_32k`` at batch 128 with a 4,096-slot cache
    (cut from 32,768) filled by 3,968-token prefills in groups of 16, then
    64 greedy steps; walls, tokens/s, one traced call of each, the MoE
    FFN's share of a prefill (CUDA events around each layer's FFN);
    ``flash_attention`` launched ``n_layers`` times a call, exactly; at
    layer 0 of the real prefill the MoE dispatch by index held to the
    one-hot einsum version on the same routing (bf16 at ``BF16_TOL``, f32
    at ``F32_TOL``) and the routing to its invariants (no padded expert,
    ``keep`` drops exactly the choices past the capacity, a slot holds at
    most one token); (b) granite at full width in f32, a 2,048-token
    prefill and 8 steps, kernel route vs plain route layer by layer with
    each layer fed the plain route's input: attention at ``F32_TOL``, the
    MoE output at ``F32_TOL`` on every token routed alike, a top-k that
    differs allowed only where the plain route's k-th and (k+1)-th
    probabilities are within ``TIE_GAP`` (the count printed); (c)
    ``minicpm3-4b`` ``FULL`` in bf16, absorbed MLA on the plain route:
    prefill of 8,192 tokens at batch 1 (cut from 32 x 32,768), decode at
    batch 128 on a 4,096-slot latent cache filled by 512-token prompts,
    32 steps, every logit finite; in f32 at full width and 2 layers,
    absorbed vs naive on the card at ``F32_TOL`` and the card vs the CPU at
    ``rtol=1e-4, atol=1e-5``; (d) ``moonshot-v1-16b-a3b`` at full width
    with 8 of its 48 layers: prefill of 8,192 tokens, decode at batch 32
    (cut from 128) on 4,096 slots, B6 at D = 128, 64 experts top-6.

18. training (run before phase 14), each sub-phase's seconds and peak
    device memory printed, every cut of a published cell named in its log
    line: (a) ``csr_aggregate``'s backward on the transposed operators
    (``ogb_products`` at S = 16, SAGE's two hops at S = 64) held to its
    plain version at ``F32_TOL``, the planted faults rejected, timed beside
    the plain version, ``torch.sparse.mm`` on the transposed CSR and the
    byte bound; (b) the GNN train cells at the reference's full sizes
    through ``get_arch(a).make_cell(s).step_fn`` on random data at the
    cells' shapes: ``gcn-cora`` at ``full_graph_sm``, ``molecule`` and
    ``ogb_products``, ``gat-cora`` at ``full_graph_sm`` and
    ``ogb_products``, the SAGE derivations at ``minibatch_lg``, ``dimenet``
    and ``meshgraphnet`` at ``molecule``; GCN and SAGE one step on the
    kernel route (B4 2 + 1 and 2 + 2 launches) against B4's plain version
    (loss and every gradient at ``F32_TOL``), then 20 timed steps with the
    loss falling; at ``full_graph_sm`` and ``molecule`` the card against
    the CPU at ``rtol=1e-4, atol=1e-5`` (MeshGraphNet against an f64 run
    of its step on the card instead, ROADMAP C.3; its leaves that miss it
    element for element in norm, ``‖Δ‖₂ ≤ 1e-3·‖g‖₂``); every loss and
    gradient finite;
    (c) ``wide-deep`` ``FULL`` at ``train_batch`` (65,536), 5 steps; (d)
    ``h2o-danube-1.8b`` and ``granite-moe-3b-a800m`` ``FULL`` at
    ``train_4k``'s 4,096 tokens with the batch cut to what fits
    (``LM_TRAIN_BATCHES``), 3 steps, walls, tokens/s and 6·N·tokens over
    the bf16 peak (not gated); (e) ``python -m repro_torch run`` on
    docs/runspec.md's train example with a ``ckpt_dir``: one retry, the
    final checkpoint bit for bit a clean run's, and a longer rerun resumed.
19. the dry run (run before phase 14; it launches no kernel: each cell's
    step is traced on fake tensors laid out as DTensors over the 16×16 and
    2×16×16 production meshes, on the host's CPU), the sweep's seconds
    printed: (a) ``python -m repro_torch run`` with a ``dryrun`` section,
    ``dhlp-bio`` at ``scale_1m`` and ``scale_20m`` on both meshes, every
    record ``ok``, one all-reduce of N × (local seed columns) × 4 B a round
    and no all-gather, ``scale_1m@single`` within 5 % of the reference
    sample's 568,920,240 FLOPs per device; (b) that census through the
    ``roofline`` suite (``REPRO_DRYRUN_ARTIFACTS``), its terms on this
    card's peaks; (c) one cell per other family by ``run_cell``
    (``DRYRUN_FAMILY_CELLS``), each ``ok`` with FLOPs counted.

Phases 4, 6, 7, 9, 10, 10c, 11 and 17 (a) each also trace calls with
``torch.profiler`` (after one untraced warm-up call).

It imports nothing of JAX or of the JAX package ``repro``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12  # bf16 tensor cores, dense
PEAK_TF32_FLOPS = 495e12  # TF32 tensor cores, dense
PEAK_BYTES = 3.35e12  # HBM3
F32_TOL = dict(rtol=2e-4, atol=5e-4)  # tests/test_kernels.py::_tol
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# B6 vs its plain version in bf16: both score, softmax and sum in f32 and
# round only the output, so they differ by at most one unit in the last
# place (2**-7 of the value); atol covers f32 summation order near zero.
FLASH_BF16_TOL = dict(rtol=2e-2, atol=1e-5)
# B2 against an f64 product: its max|Δ| may be at most this many times
# that of the plain version (an f32 product, TF32 off) on the same inputs
B2_F64_FACTOR = 4.0
# B2's hi.lo and lo.hi products; the planted one-product variant drops them
B2_LO_PRODUCTS = (
    "          wgmma_tf32(acc, hi, desc_sw128(fl + 32 * kk), 1);\n",
    "          wgmma_tf32(acc, lo, desc_sw128(fh + 32 * kk), 1);\n",
)
AGREE_TOL = 5e-3  # the agree_dense gate (DESIGN.md §15.3)
TIE_EPS = 1e-5
N_DRUGS_CHECKED = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def smi_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, *, warmup: int = 2, iters: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_close(np, name, got, want, tol, *, quiet: bool = False) -> float:
    """``got`` finite and within ``tol`` of ``want`` (numpy's ``allclose``
    rule, on the tensors' device); returns max|Δ|."""
    import torch

    got = got.float()
    want = want.float().to(got.device)
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        fail(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} or non-finite values")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got, want, **tol):
        fail(f"{name}: kernel disagrees with its plain version, max|Δ|={err}")
    if not quiet:
        log(f"  {name}: max|Δ| vs plain = {err:.3e} (rtol={tol['rtol']}, atol={tol['atol']})")
    return err


def bound(ops: float, nbytes: float, peak_flops: float = PEAK_F32_FLOPS):
    t_ops = ops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def wall_s(torch, fn, *, iters: int) -> list:
    """Host-clock seconds of each of ``iters`` calls, each ended by a
    synchronize (what a caller waits for)."""
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def union_us(intervals) -> float:
    """Length of the union of ``(start, stop)`` intervals (µs): the
    device's busy time."""
    busy, end = 0.0, None
    for start, stop in sorted(intervals):
        if end is None or start > end:
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy


def trace_solve(torch, label: str, fn):
    """Run ``fn`` twice under ``torch.profiler``, recording the second
    run; print its wall time, the device's busy time (the union of its
    kernel and copy intervals) and the eight device entries that took the
    most time.  Returns the traced wall (s), the busy time (µs) and the
    device time (µs) and count of each entry by name.

    The first run is the profiler's warm-up step: the device events of
    the first milliseconds after the profiler starts can be lost (a
    call's first kernels and copies were missing from one-step traces).
    Only device-side kernels and copies count: a CPU op's
    ``self_device_time_total`` repeats the time of the kernels it
    launched, so summing both would count that time twice.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    log(f"== profile: {label} under torch.profiler")
    recorded = []
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
        schedule=schedule(wait=0, warmup=1, active=1),
        on_trace_ready=lambda p: recorded.append(list(p.events())),
    ) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        t_p = time.perf_counter() - t0
        prof.step()
    if not recorded:
        fail(f"profile of {label}: the profiler recorded no step")
    # the step's own annotation spans the whole step on the device timeline
    events = [e for e in recorded[0] if e.device_type != DeviceType.CPU
              and not e.name.startswith("ProfilerStep")]
    busy_us = union_us((e.time_range.start, e.time_range.end) for e in events)
    by_name = {}
    for e in events:
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + e.time_range.elapsed_us(), count + 1)
    log(f"  traced wall {t_p:.3f} s, device busy {busy_us / 1e3:.1f} ms "
        f"(busy share {busy_us / (t_p * 1e6):.3f}; {len(events)} device events)")
    for name, (total, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"    {total / 1e3:9.2f} ms  x{count:<5d} {name[:70]}")
    return t_p, busy_us, by_name


# B6 at the transformer path's shapes, sequence-major (B, L, H, D) as the
# model hands them over: label, B, Hq, Hkv, Lq, Lk, D, window, q_offset, dtype
FLASH_SHAPES = (
    ("h2o-danube-1.8b prefill_32k layer", 1, 32, 8, 32768, 32768, 80, 4096, 0, "bf16"),
    ("h2o-danube-1.8b decode_32k layer", 128, 32, 8, 1, 4096, 80, 4096, 4000, "bf16"),
    ("stablelm-1.6b prefill 4k layer", 1, 32, 32, 4096, 4096, 64, None, 0, "bf16"),
    ("h2o-danube-1.8b prefill 8k layer", 1, 32, 8, 8192, 8192, 80, 4096, 0, "f32"),
    ("granite-moe-3b-a800m prefill_32k layer", 1, 24, 8, 32768, 32768, 64, None, 0, "bf16"),
    ("granite-moe-3b-a800m decode_32k layer", 128, 24, 8, 1, 4096, 64, None, 4000, "bf16"),
    ("moonshot-v1-16b-a3b prefill 8k layer", 1, 16, 16, 8192, 8192, 128, None, 0, "bf16"),
    ("moonshot-v1-16b-a3b decode layer", 32, 16, 16, 1, 4096, 128, None, 4000, "bf16"),
)


def live_pairs(np, lq, lk, q_offset, window) -> int:
    """(q, k) pairs a causal, optionally windowed, attention computes."""
    qp = np.arange(lq, dtype=np.int64) + q_offset
    hi = np.minimum(lk - 1, qp)
    lo = np.maximum(0, qp - window + 1) if window else np.zeros_like(qp)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def device_kernel_names(torch, fn) -> list:
    """Names of the device kernels one call of ``fn`` runs."""
    return sorted(device_times(torch, fn))


def device_times(torch, fn) -> dict:
    """Device time (µs) by kernel name of one call of ``fn``, recorded in
    the second of two profiled steps (``trace_solve``'s warm-up: the first
    step's device events can be lost)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    recorded = []
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
        schedule=schedule(wait=0, warmup=1, active=1),
        on_trace_ready=lambda p: recorded.append(list(p.events())),
    ) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    if not recorded:
        fail("profile of a kernel call: the profiler recorded no step")
    times = {}
    for e in recorded[0]:
        if e.device_type != DeviceType.CPU and not e.name.startswith("ProfilerStep"):
            times[e.name] = times.get(e.name, 0.0) + e.time_range.elapsed_us()
    return times


def start_variant(common, source, edits, tag):
    """Start ``nvcc`` on a scratch copy of ``csrc/<source>`` with each
    ``(old, new)`` text edit applied (a planted fault or a tuning variant),
    under ``build/variants/<tag>/``, which git ignores.  Returns what
    :func:`finish_variant` takes."""
    text = (common.CSRC_DIR / source).read_text()
    for old, new in edits:
        if old not in text:
            fail(f"variant {tag}: {source} no longer has {old.strip()!r}")
        text = text.replace(old, new)
    scratch = ROOT / "build" / "variants" / tag
    scratch.mkdir(parents=True, exist_ok=True)
    for header in common._local_headers(source):
        (scratch / header).write_bytes((common.CSRC_DIR / header).read_bytes())
    (scratch / source).write_text(text)
    so = scratch / (Path(source).stem + ".so")
    proc = subprocess.Popen([common.find_nvcc(), *common.NVCC_FLAGS, "-o", str(so),
                             str(scratch / source)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return tag, proc, so


def finish_variant(common, started):
    """Wait for a :func:`start_variant` build; its library."""
    tag, proc, so = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        fail(f"variant {tag}: nvcc failed:\n{out}")
    return common.BuiltLibrary(so, out)


def with_library(ops, lib, fn):
    """``fn()`` with ``ops``' kernel library swapped for ``lib``."""
    shipped = ops.load_library
    ops.load_library = lambda source: lib
    try:
        return fn()
    finally:
        ops.load_library = shipped


def b2_f64_errors(torch, A, F, base, c, runs) -> dict:
    """max|Δ| against an f64 product ``c·base + A @ F`` of each ``(label,
    fn)`` in ``runs`` (each returns ``lp_round``'s output on these inputs)."""
    want = c * base.double() + A.double() @ F.double()
    errs = {}
    for label, fn in runs:
        got = fn()
        torch.cuda.synchronize()
        errs[label] = float((got.double() - want).abs().max())
        del got
    del want
    return errs


def sdpa_backend(torch, names, args) -> str:
    """The SDPA backend from its kernels' names (cuDNN's contain "flash"
    too), else, where the profiler recorded no kernel, from PyTorch's own
    dispatch (``torch._fused_sdp_choice`` under the same ``sdpa_kernel``)."""
    joined = " ".join(names).lower()
    for key, label in (("cudnn", "cudnn"), ("flash", "flash"), ("fmha", "efficient"),
                       ("efficient", "efficient")):
        if key in joined:
            return label
    if names:
        return "math"
    from torch.nn.attention import SDPBackend

    try:
        choice = SDPBackend(torch._fused_sdp_choice(*args[:3], attn_mask=args[3],
                                                    is_causal=args[4]))
    except (AttributeError, RuntimeError, TypeError, ValueError) as exc:
        return f"not recorded by the profiler ({type(exc).__name__})"
    return {"CUDNN_ATTENTION": "cudnn", "FLASH_ATTENTION": "flash",
            "EFFICIENT_ATTENTION": "efficient"}.get(choice.name, choice.name.lower()) + (
        ", from dispatch: the profiler recorded no kernel")


# B6's tensor-core tiles, as csrc/flash_attention.cu sets them (kPreGroups,
# kDecWarps, kDecKeys): rows per block and keys per stage of each regime
B6_TILES = {"prefill": (192, 64), "decode": (16, 128)}


def b6_mma_flops(np, regime, lq, lk, group, d, window, q_offset) -> float:
    """Tensor-core operations one (batch, KV head) of a bf16 launch issues:
    every row of every tile against every key of every stage it visits,
    2 D for Q.K^T and 2 x 2 D for P_hi.V and P_lo.V per (row, key)."""
    bq, bk = B6_TILES[regime]
    rows = lq * group
    row0 = np.arange(0, rows, bq, dtype=np.int64)
    last = np.minimum(rows, row0 + bq) - 1
    k_end = np.minimum(lk, q_offset + last // group + 1)
    k_begin = np.maximum(0, q_offset + row0 // group - window + 1) if window else 0 * row0
    stages = np.where(k_end > k_begin, (k_end - k_begin + bk - 1) // bk, 0)
    return float(stages.sum()) * bq * bk * 6.0 * d


def gate_rejects_faults(torch, tag, want, tol, q, k, v, window, q_offset) -> None:
    """The kernel given planted faults must fail the gate it just passed:
    the window one key short (where the window binds), the last 64 live
    keys dropped, and each query head reading the next group's KV head.
    Each stands for a kernel bug of that kind (a wrong window edge, a
    skipped key tile, a GQA index mix-up)."""
    from repro_torch.kernels.flash_attention import gqa_attention_op

    lq, lk, hkv = q.shape[1], k.shape[1], k.shape[2]
    live = min(lk, q_offset + lq)
    faults = [("last 64 live keys dropped", k[:, :live - 64], v[:, :live - 64], window)]
    if window and q_offset + lq > window:
        faults.append(("window - 1", k, v, window - 1))
    if hkv > 1:
        faults.append(("KV heads of the next group", torch.roll(k, 1, dims=2),
                       torch.roll(v, 1, dims=2), window))
    for name, kf, vf, wf in faults:
        got = gqa_attention_op(q, kf, vf, window=wf, q_offset=q_offset, layout="blhd")
        g, w = got.float(), want.float()
        bad = ~torch.isclose(g, w, **tol)
        err = float((g - w).abs().max())
        if not bad.any():
            fail(f"{tag}: the gate passed a planted fault ({name}), max|Δ|={err}")
        log(f"    planted fault '{name}': rejected, max|Δ| = {err:.3e}, "
            f"{int(bad.sum())} of {bad.numel()} values outside the gate")
        del got, g, w, bad


def flash_kernel_phase(torch, np, dev) -> dict:
    """B6 against its plain version at the serving path's shapes, with
    CUDA-event times, the bound and one ``scaled_dot_product_attention``
    call as the library yardstick (timed only; the port never calls it)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import gqa_attention_op, gqa_attention_ref, regime

    fused = [getattr(SDPBackend, n) for n in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION",
                                              "CUDNN_ATTENTION") if hasattr(SDPBackend, n)]
    gen = torch.Generator(device=dev).manual_seed(14)
    rows = []
    for label, b, hq, hkv, lq, lk, d, window, q_offset, dt in FLASH_SHAPES:
        dtype, tol = ((torch.bfloat16, FLASH_BF16_TOL) if dt == "bf16"
                      else (torch.float32, F32_TOL))
        q = torch.randn((b, lq, hq, d), generator=gen, device=dev).to(dtype)
        kv = torch.randn((2, b, lk, hkv, d), generator=gen, device=dev).to(dtype)
        k, v = kv[0], kv[1]  # cache slices, as the model passes them
        tag = (f"flash_attention {dt} {label} (B={b}, Hq={hq}, Hkv={hkv}, Lq={lq}, Lk={lk}, "
               f"D={d}, window={window}, q_offset={q_offset})")

        def kern():
            return gqa_attention_op(q, k, v, window=window, q_offset=q_offset, layout="blhd")

        def plain():  # query chunks: a 32k prompt's whole score matrix does not fit
            return gqa_attention_ref(q, k, v, window=window, q_offset=q_offset,
                                     layout="blhd", chunk=2048)

        out_k = kern()
        torch.cuda.synchronize()
        want = plain()
        err = check_close(np, tag, out_k, want, tol)
        if not torch.equal(out_k, kern()):
            fail(f"{tag}: two launches gave different bytes")
        gate_rejects_faults(torch, tag, want, tol, q, k, v, window, q_offset)
        del want
        # the library yardstick on (B, H, L, D) views, KV heads repeated
        g = hq // hkv
        qh = q.transpose(1, 2)
        kh = k.transpose(1, 2).repeat_interleave(g, dim=1)
        vh = v.transpose(1, 2).repeat_interleave(g, dim=1)
        if window is None and q_offset == 0 and lq == lk:
            mask, causal = None, True
        else:
            qp = torch.arange(lq, device=dev)[:, None] + q_offset
            kp = torch.arange(lk, device=dev)[None, :]
            mask = kp <= qp
            if window:
                mask &= kp > qp - window
            causal = False

        def lib(backends=fused):
            with sdpa_kernel(backends):
                return torch.nn.functional.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask, is_causal=causal)

        heavy = lq * lk >= 2**26
        reps = 3 if heavy else 20
        try:
            lib_out = lib()
            torch.cuda.synchronize()
            names = device_kernel_names(torch, lib)
            with sdpa_kernel(fused):
                backend = sdpa_backend(torch, names, (qh, kh, vh, mask, causal))
            log(f"    SDPA kernels: {'; '.join(n[:90] for n in names) or 'none recorded'}")
        except RuntimeError as exc:  # no fused backend takes this call
            lib_out, backend = None, f"unavailable ({str(exc).splitlines()[0][:120]})"
        if lib_out is not None:
            # SDPA's fused kernels round P to bf16: the looser bf16 gate
            check_close(np, tag + " vs scaled_dot_product_attention", out_k,
                        lib_out.transpose(1, 2), BF16_TOL if dt == "bf16" else tol)
        del out_k, lib_out
        each = {}  # every fused backend alone
        for bk in fused:
            try:
                lib([bk])
                each[bk.name] = f"{cuda_ms(torch, lambda: lib([bk]), warmup=1, iters=reps):.4f} ms"
            except RuntimeError as exc:
                each[bk.name] = f"unavailable ({str(exc).splitlines()[0][:60]})"
        log("    SDPA by backend alone: " + "; ".join(f"{n} {t}" for n, t in each.items()))
        ms = cuda_ms(torch, kern, warmup=1, iters=reps)
        plain_ms = cuda_ms(torch, plain, warmup=1, iters=2 if heavy else 5)
        lib_ms = (cuda_ms(torch, lib, warmup=1, iters=reps)
                  if not backend.startswith("unavailable") else None)
        pairs = live_pairs(np, lq, lk, q_offset, window) * b * hq
        esize = 2 if dt == "bf16" else 4
        read_keys = min(lk, q_offset + lq)  # keys past the last query are never read
        nbytes = esize * d * (2.0 * b * lq * hq + 2.0 * b * read_keys * hkv)
        bms, by = bound(4.0 * d * pairs, nbytes,
                        PEAK_BF16_FLOPS if dt == "bf16" else PEAK_F32_FLOPS)
        reg = regime(dtype, lq * g)
        mma = ", CUDA cores"
        if dt == "bf16":
            issued = b * hkv * b6_mma_flops(np, reg, lq, lk, g, d, window, q_offset)
            mma = f", tensor cores {issued / ms / 1e9:.2f} TFLOP/s issued"
        log(f"    regime {reg}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA ({backend}) "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound {bms:.4f} ms ({by}); "
            f"{pairs / 1e6:.1f} M live (q, k) pairs, {4.0 * d * pairs / ms / 1e9:.2f} TFLOP/s "
            f"of live pairs{mma}; {nbytes / ms / 1e6:.1f} GB/s")
        rows.append(dict(label=label, dtype=dt, regime=reg, err=err, ms=ms, plain_ms=plain_ms,
                         lib_ms=lib_ms, backend=backend, bound_ms=bms, by=by))
        del q, kv, k, v, kh, vh, mask
        torch.cuda.empty_cache()
    return {"rows": rows, "err": max(r["err"] for r in rows)}


AGREE_PROMPT, AGREE_STEPS = 8192, 16  # f32 agreement: prompt past the 4,096 window
DECODE_PROMPT, DECODE_STEPS, DECODE_GROUP = 3968, 64, 16  # decode_32k fill and steps


def transformer_agreement_phase(torch, np, dev) -> None:
    """h2o-danube-1.8b at full width in f32: a prefill of 8,192 tokens into
    an 8,208-slot cache, then 16 decode steps fed the same tokens, on the
    kernel path and on the plain path; the logits must agree at f32
    ``rtol=2e-4, atol=5e-4``."""
    import dataclasses

    from repro_torch.configs import h2o_danube_1_8b
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import (
        Transformer, init_cache, make_decode_step, make_prefill)

    cfg = dataclasses.replace(h2o_danube_1_8b.FULL, dtype=torch.float32)
    t0 = time.perf_counter()
    model = Transformer(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    log(f"  {cfg.name} f32: {cfg.param_count()} parameters made on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (1, AGREE_PROMPT + AGREE_STEPS))
    prefill, decode_step = make_prefill(model), make_decode_step(model)

    def run():
        caches = init_cache(cfg, 1, AGREE_PROMPT + AGREE_STEPS, device=dev)
        out = [prefill(toks[:, :AGREE_PROMPT], caches)[0]]
        for i in range(AGREE_STEPS):
            pos = AGREE_PROMPT + i
            out.append(decode_step(caches, toks[:, pos:pos + 1], pos)[0])
        return torch.stack(out)

    got = {}
    for use_kernel in (True, False):
        model.use_kernel = use_kernel
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got[use_kernel] = run()
        torch.cuda.synchronize()
        n = launch_counts()["flash_attention"]
        log(f"  {'kernel' if use_kernel else 'plain'} path: prefill + {AGREE_STEPS} steps in "
            f"{time.perf_counter() - t0:.3f} s wall, {n} flash_attention launches")
        want = cfg.n_layers * (1 + AGREE_STEPS) if use_kernel else 0
        if n != want or sum(launch_counts().values()) != n:
            fail(f"{'kernel' if use_kernel else 'plain'} path launched {launch_counts()}, "
                 f"expected {want} flash_attention")
    check_close(np, f"{cfg.name} f32 logits (prefill {AGREE_PROMPT} + {AGREE_STEPS} steps), "
                "kernel path vs plain path", got[True], got[False], F32_TOL)
    del model, got
    torch.cuda.empty_cache()


def transformer_serving_phase(torch, np, dev) -> dict:
    """h2o-danube-1.8b FULL in bf16 on the kernel path: ``prefill_32k``
    (batch cut from 32 to 1) and ``decode_32k`` (128 sequences, the
    4,096-slot SWA cache filled by prefills of 3,968-token prompts in
    groups of 16 rows, then 64 greedy steps).  The launch counts are read
    over exactly those calls; traces and the plain run come after."""
    from repro_torch.configs import cells, h2o_danube_1_8b
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import (
        Transformer, init_cache, make_decode_step, make_prefill)

    cfg = h2o_danube_1_8b.FULL
    rng = np.random.default_rng(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = Transformer(cfg, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    torch.cuda.synchronize()
    log(f"  {cfg.name} bf16: {cfg.param_count()} parameters "
        f"({(torch.cuda.memory_allocated() - mem0) / 1e9:.2f} GB) made on the card in "
        f"{time.perf_counter() - t0:.2f} s ({mem0 / 1e9:.2f} GB allocated before)")
    prefill, decode_step = make_prefill(model), make_decode_step(model)
    res = {}

    # (a) prefill_32k at batch 1
    seq = cells.LM_SHAPES["prefill_32k"]["seq"]
    p_toks = rng.integers(0, cfg.vocab, (1, seq))
    p_caches = init_cache(cfg, 1, cells.lm_cache_len(cfg, "prefill_32k"), device=dev)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = prefill(p_toks, p_caches)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    res["prefill_launches"] = launch_counts()["flash_attention"]
    walls = sorted(wall_s(torch, lambda: prefill(p_toks, p_caches), iters=3))
    res["prefill_wall"] = walls[len(walls) // 2]
    res["prefill_peak_gb"] = (torch.cuda.max_memory_allocated() - mem0) / 1e9
    log(f"== phase 10c (a): prefill_32k, B = 1 x {seq} tokens: first call {t_first:.3f} s, "
        f"then {', '.join(f'{t:.4f}' for t in walls)} s; median {res['prefill_wall']:.4f} s, "
        f"{seq / res['prefill_wall']:.0f} tokens/s; {res['prefill_launches']} flash_attention "
        f"launches in the first call; peak device memory {res['prefill_peak_gb']:.2f} GB since "
        "the model was made")
    if logits.shape != (1, cfg.padded_vocab) or not torch.isfinite(logits).all():
        fail(f"prefill_32k logits: shape {tuple(logits.shape)} or non-finite values")

    # (b) decode_32k: fill the 4,096-slot cache, then 64 greedy steps
    batch = cells.LM_SHAPES["decode_32k"]["batch"]
    slots = cells.lm_cache_len(cfg, "decode_32k")
    del p_caches
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    caches = init_cache(cfg, batch, slots, device=dev)
    d_toks = rng.integers(0, cfg.vocab, (batch, DECODE_PROMPT))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last = []
    for g in range(0, batch, DECODE_GROUP):
        lg, _ = prefill(d_toks[g:g + DECODE_GROUP], caches[:, :, g:g + DECODE_GROUP])
        last.append(lg)
    torch.cuda.synchronize()
    t_fill = time.perf_counter() - t0
    tok = torch.cat(last).argmax(-1, keepdim=True)
    before_steps = launch_counts()["flash_attention"]
    steps = []
    for i in range(DECODE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, _ = decode_step(caches, tok, DECODE_PROMPT + i)
        tok = lg.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    counts = launch_counts()
    res["launches"] = counts["flash_attention"]
    res["decode_launches"] = res["launches"] - before_steps
    want = cfg.n_layers * (1 + len(walls) + batch // DECODE_GROUP + DECODE_STEPS)
    if res["launches"] != want or sum(counts.values()) != res["launches"]:
        fail(f"serving launched {counts}, expected {want} flash_attention")
    if not torch.isfinite(lg).all() or tok.shape != (batch, 1):
        fail("decode_32k: non-finite logits")
    srt = sorted(steps)
    res["step_wall"] = srt[len(srt) // 2]
    res["peak_gb"] = (torch.cuda.max_memory_allocated() - mem0) / 1e9
    log(f"== phase 10c (b): decode_32k, B = {batch}, cache {slots} slots "
        f"({caches.numel() * caches.element_size() / 1e9:.2f} GB): fill ({batch // DECODE_GROUP} "
        f"prefills of {DECODE_GROUP} x {DECODE_PROMPT}) {t_fill:.3f} s; {DECODE_STEPS} greedy "
        f"steps at positions {DECODE_PROMPT}-{DECODE_PROMPT + DECODE_STEPS - 1}: median "
        f"{res['step_wall'] * 1e3:.3f} ms, min {srt[0] * 1e3:.3f}, max {srt[-1] * 1e3:.3f} ms "
        f"per step, {batch / res['step_wall']:.0f} tokens/s; {res['decode_launches']} "
        f"flash_attention launches over the steps; peak device memory {res['peak_gb']:.2f} GB "
        "since the model was made")
    log(f"  decode_32k: first 8 sequences' last tokens {tok[:8, 0].tolist()}")

    # where the time goes: one traced decode step and one traced prefill
    t_p, busy, by_name = trace_solve(
        torch, "decode_32k step", lambda: decode_step(caches, tok, DECODE_PROMPT + DECODE_STEPS))
    b6 = sum(t for name, (t, _) in by_name.items() if "flash_fwd" in name)
    log(f"  flash_attention share of the traced decode step: {b6 / (t_p * 1e6):.3f} of wall, "
        f"{b6 / busy:.3f} of device busy")
    del caches
    torch.cuda.empty_cache()
    p_caches = init_cache(cfg, 1, seq, device=dev)
    t_p, busy, by_name = trace_solve(torch, "prefill_32k", lambda: prefill(p_toks, p_caches))
    b6 = sum(t for name, (t, _) in by_name.items() if "flash_fwd" in name)
    log(f"  flash_attention share of the traced prefill: {b6 / (t_p * 1e6):.3f} of wall, "
        f"{b6 / busy:.3f} of device busy")

    # the plain path once, for the logit gap (printed, not gated: bf16 over 24 layers)
    model.use_kernel = False
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain, _ = prefill(p_toks, p_caches)
    torch.cuda.synchronize()
    model.use_kernel = True
    gap = float((logits.float() - plain.float()).abs().max())
    log(f"  prefill_32k plain path {time.perf_counter() - t0:.3f} s; logits max|Δ| kernel vs "
        f"plain {gap:.4e} (logit scale {float(plain[:, :cfg.vocab].float().abs().max()):.3f}; not gated)")
    del model, p_caches, logits, plain
    torch.cuda.empty_cache()
    return res


def top10_lists(np, topk_exclusive, extract_outputs, F, norm, known):
    scores = extract_outputs(F, norm).interactions[(0, 2)]
    out = []
    for d in range(N_DRUGS_CHECKED):
        keep = scores[d][~known[d]]
        top = np.sort(keep)[::-1]
        near_tie = top.size > 10 and abs(top[9] - top[10]) <= TIE_EPS
        out.append((tuple(topk_exclusive(scores[d], 10, known[d])), near_tie))
    return out


def compare_top10(a, b, what):
    ties = []
    for d, ((la, tie_a), (lb, tie_b)) in enumerate(zip(a, b)):
        if la != lb:
            if not (tie_a or tie_b):
                fail(f"{what}: drug {d} top-10 differs: {la} vs {lb}")
            ties.append(d)
    log(f"  {what}: top-10 lists of drugs 0-{N_DRUGS_CHECKED - 1} identical"
        + (f" except near-ties (10th/11th within {TIE_EPS}) at drugs {ties}" if ties else ""))


def gather_counts(buckets):
    """Slots the round kernels touch in one round over ``(nbr, wgt, live)``
    buckets: the live slots, and the slots gathered (the live ones plus one
    pad for each row that has pads)."""
    live_slots = gathered = 0
    for nbr, _, live in buckets:
        live_slots += live.slots
        gathered += live.slots + int((live.lengths < nbr.shape[1]).sum())
    return live_slots, gathered


def agrees(np, got, want, tol) -> tuple:
    """The f32 gate with NaN: the same NaN positions and every other value
    within ``tol``.  Returns ``(ok, max|Δ| over finite pairs)``."""
    import torch

    got = got.float()
    want = want.float().to(got.device)
    both = torch.isfinite(got) & torch.isfinite(want)
    err = float((got[both] - want[both]).abs().max()) if bool(both.any()) else 0.0
    ok = torch.equal(torch.isnan(got), torch.isnan(want)) and torch.allclose(
        got, want, equal_nan=True, **tol)
    return ok, err


def round_fault_checks(torch, np, tag, nbr, live, F, launch, plain) -> None:
    """B1/B3 given planted faults must fail the f32 gate against the plain
    version: every row one live slot short, and the pad slot left out (its
    id pointed elsewhere) while the F row the pads name holds NaN; the
    kernel as it is must put that NaN in the same rows as the plain version.
    ``launch(nbr, live, F)`` runs the kernel, ``plain(F)`` the plain version."""
    from repro_torch.kernels.segment_reduce import LiveRows

    d = nbr.shape[1]
    short = LiveRows((live.lengths - 1).clamp_min(0), 0)
    ok, err = agrees(np, launch(nbr, short, F), plain(F), F32_TOL)
    if ok:
        fail(f"{tag}: the gate accepted every row one live slot short (max|Δ| {err:.3e})")
    log(f"  {tag}: planted fault 'live - 1 on every row' rejected (max|Δ| {err:.3e})")
    padded = torch.nonzero(live.lengths < d)[:, 0]
    if padded.numel() == 0:
        fail(f"{tag}: no row has a pad to plant a NaN behind")
    r = int(padded[0])
    pad_id = int(nbr[r, int(live.lengths[r])])
    F_nan = F.clone()
    F_nan[pad_id] = float("nan")
    want = plain(F_nan)
    ok, err = agrees(np, launch(nbr, live, F_nan), want, F32_TOL)
    nan_rows = int(torch.isnan(want).any(dim=1).sum())
    if not ok:
        fail(f"{tag}: with NaN in F row {pad_id} the kernel's NaN rows differ from the "
             f"plain version's ({nan_rows} rows) or its values do (max|Δ| {err:.3e})")
    pads = torch.arange(d, device=nbr.device)[None, :] >= live.lengths[:, None]
    elsewhere = torch.where(pads, (pad_id + 1) % F.shape[0], nbr)
    ok, _ = agrees(np, launch(elsewhere, live, F_nan), want, F32_TOL)
    if ok:
        fail(f"{tag}: the gate accepted the pad slot left out with NaN in its F row")
    log(f"  {tag}: NaN in pad-named F row {pad_id} reaches the same {nan_rows} rows as the "
        f"plain version; planted fault 'pad slot left out' rejected")
    del F_nan


# Phase 11: the serve configuration at full size (PERF.md §4), run through
# the port's normal entry point on the `kernel` engine
SERVE_SPEC = {
    "run_id": "powerlaw_serve_kernel",
    "network": {"kind": "scenario", "name": "powerlaw", "scale": 1.0, "seed": 0},
    "solve": {"alg": "dhlp2", "sigma": 1e-4, "seed_mode": "fixed", "backend": "kernel",
              "top_k": 10},
    "eval": {"protocol": "recovery", "holdout_frac": 0.15, "max_entities": 16},
    "serve": {"trace": "diurnal", "rate_qps": 200.0, "horizon_s": 2.0, "time_scale": 1.0,
              "max_batch": 32, "top_k": 10},
}
SERVE_QUERIES = 352  # the diurnal trace at 200 qps over 2 s, seed 0, on powerlaw
SYNC_QUERIES = 64  # sent one by one to the kernel and sparse serve engines
# the early-exit loop's padded column widths at max_batch 32 (powers of two)
SERVE_WIDTHS = tuple(1 << i for i in range(SERVE_SPEC["serve"]["max_batch"].bit_length()))
CLI_DEVICE = "cuda"  # the device phase 11 (a) hands to `python -m repro_torch run`


def serve_width_checks(torch, np, serve) -> float:
    """Phase 11 (b): B1 at every width the serve engine's early-exit loop
    gives it (``SERVE_WIDTHS``), on every bucket of the kernel engine's
    plan, held to ``csr_round_residual_ref`` at ``F32_TOL``: each bucket
    launched as ``_plan_round`` launches it (its rows written through
    ``out=`` into a slice of one buffer), then one whole ``_plan_round``
    (rows and the per-column residual).  Returns the worst error."""
    from repro_torch.engine.sparse import _plan_round
    from repro_torch.kernels.segment_reduce import (
        csr_round_residual_op,
        csr_round_residual_ref,
        vector_width,
    )

    eng = serve._engine
    buckets, perm, _ = eng._fused_plan(eng.prepare(serve.state.norm))
    c = (1.0 - eng.config.alpha) ** 2
    n = int(perm.numel())
    rng = np.random.default_rng(19)
    worst = 0.0
    for s in SERVE_WIDTHS:
        F = torch.as_tensor(rng.random((n, s), dtype=np.float32), device=perm.device)[perm]
        base = torch.as_tensor(rng.random((n, s), dtype=np.float32), device=perm.device)[perm]
        Fn = torch.empty_like(F)
        want_rows, want_d, err_b, off = [], [], 0.0, 0
        for nbr, wgt, live in buckets:
            m = nbr.shape[0]
            sl = slice(off, off + m)
            _, dl = csr_round_residual_op(nbr, wgt, F, base[sl], F[sl], c=c, out=Fn[sl],
                                          live=live)
            o_p, d_p = csr_round_residual_ref(nbr, wgt, F, base[sl], F[sl], c)
            tag = f"csr_round_residual serve width {s} bucket {nbr.shape[0]}x{nbr.shape[1]}"
            err_b = max(err_b, check_close(np, tag, Fn[sl], o_p, F32_TOL, quiet=True),
                        check_close(np, tag + " delta", dl.amax(dim=0, keepdim=True), d_p,
                                    F32_TOL, quiet=True))
            want_rows.append(o_p)
            want_d.append(d_p)
            off += m
        got, got_d = _plan_round(buckets, F, base, c=c, use_kernel=True, storage="f32")
        tag = f"csr_round_residual serve width {s}, _plan_round over {len(buckets)} buckets"
        err = max(err_b, check_close(np, tag, got, torch.cat(want_rows), F32_TOL, quiet=True),
                  check_close(np, tag + " delta", got_d, torch.cat(want_d).amax(dim=0),
                              F32_TOL, quiet=True))
        log(f"  csr_round_residual at serve width {s} (vec {vector_width(F)}): each of "
            f"{len(buckets)} buckets through out= and one _plan_round, rows and residual "
            f"max|Δ| vs plain {err:.3e} (rtol={F32_TOL['rtol']}, atol={F32_TOL['atol']})")
        worst = max(worst, err)
    return worst


OUT_ROOT = ROOT / "results" / "chip_smoke"  # phase 11's run directories (git ignores results/)
TEL_FILES = ["events.jsonl", "metrics.jsonl", "metrics.prom", "summary.json"]


def quiet(_line) -> None:
    pass


def run_cli(args, *, timeout=600, env=None):
    """``python -m repro_torch <args>`` from the checkout (``env`` added to
    the environment); returns the finished process and its wall (s),
    process start included."""
    import os

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", *args], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(SRC), **(env or {})}, capture_output=True,
        text=True, timeout=timeout,
    )
    return proc, time.perf_counter() - t0


def fresh_run_dir(run_id) -> Path:
    """``OUT_ROOT/run_id`` emptied: a stale checkpoint would turn a first
    run into a resumed one."""
    import shutil

    path = OUT_ROOT / run_id
    shutil.rmtree(path, ignore_errors=True)
    OUT_ROOT.mkdir(parents=True, exist_ok=True)
    return path


def check_telemetry(run_dir: Path, what: str) -> dict:
    """The run's telemetry directory: exactly the four artifacts (no live
    segment left), schema-valid, ``metrics.prom`` lint-clean, and one
    ``solve.residual`` sample per ``solve.supersteps``.  Returns the
    digest."""
    from repro_torch.obs import lint_openmetrics, validate_dir
    from repro_torch.obs.summary import load_dir, summarize

    tel_dir = run_dir / "telemetry"
    names = sorted(n for n in tel_dir.iterdir() if n.is_file())
    if [n.name for n in names] != TEL_FILES:
        fail(f"{what}: telemetry holds {[n.name for n in names]}, expected {TEL_FILES}")
    counts = validate_dir(str(tel_dir))
    problems = lint_openmetrics((tel_dir / "metrics.prom").read_text())
    if problems:
        fail(f"{what}: metrics.prom fails the OpenMetrics lint: {problems}")
    digest = summarize(*load_dir(str(tel_dir)))
    steps = digest["counters"].get("solve.supersteps")
    conv = digest.get("convergence", {})
    if not steps or conv.get("supersteps") != steps:
        fail(f"{what}: {conv.get('supersteps')} solve.residual samples for "
             f"solve.supersteps {steps}")
    log(f"  {what} telemetry: {' '.join(TEL_FILES)}, schema ok "
        f"({' '.join(f'{k}:{v}' for k, v in sorted(counts.items()))}), metrics.prom lint-clean; "
        f"solve.residual {steps} samples for {steps} supersteps, "
        f"{conv['first_residual']:.3e} -> {conv['last_residual']:.3e}")
    return digest


def quickstart_cli_check(np) -> None:
    """Phase 11 (a): ``python -m repro_torch run`` on the committed
    quickstart spec as it is (its ``obs`` section: level ``metrics``, a
    0.25 s streaming flush, OpenMetrics export, an SLO block), as a
    subprocess on ``CLI_DEVICE``, then ``python -m repro_torch obs
    quickstart --validate``.  The telemetry must be whole and valid
    (``check_telemetry``), and the run equal to an in-process CPU
    ``Session`` of the same spec: solve ranking and ``outer_iters``,
    recovery metrics within ``AGREE_TOL``, queries and deltas replayed."""
    from repro_torch.api import RunSpec, Session

    spec_path = ROOT / "examples" / "specs" / "quickstart_run.json"
    spec = json.loads(spec_path.read_text())
    run_dir = fresh_run_dir(spec["run_id"])
    proc, wall = run_cli(["run", str(spec_path), "--device", CLI_DEVICE,
                          "--results-root", str(OUT_ROOT)])
    if proc.returncode != 0:
        fail(f"python -m repro_torch run exited {proc.returncode}: {proc.stderr[-2000:]}")
    log(f"  python -m repro_torch run examples/specs/quickstart_run.json --device {CLI_DEVICE}: "
        f"exit 0 in {wall:.1f} s (process start included)")
    for line in proc.stdout.splitlines():
        if "wrote" not in line:
            log(f"    {line}")
    obs, obs_wall = run_cli(["obs", spec["run_id"], "--validate", "--results-root",
                             str(OUT_ROOT)])
    if obs.returncode != 0:
        fail(f"python -m repro_torch obs {spec['run_id']} --validate exited "
             f"{obs.returncode}: {obs.stderr[-2000:]}")
    log(f"  python -m repro_torch obs {spec['run_id']} --validate: exit 0 in {obs_wall:.1f} s")
    for line in obs.stdout.splitlines()[:4]:
        log(f"    {line}")
    solve = json.loads((run_dir / "solve.json").read_text())
    digest = check_telemetry(run_dir, "quickstart")
    if digest["convergence"]["supersteps"] != solve["outer_iters"]:
        fail(f"quickstart: {digest['convergence']['supersteps']} supersteps in the telemetry, "
             f"{solve['outer_iters']} in solve.json")
    ev = json.loads((run_dir / "eval.json").read_text())
    serve = json.loads((run_dir / "serve.json").read_text())
    arts = {a.kind: a for a in Session(RunSpec.from_dict(spec), device="cpu").run(write=False)}
    want_s, want_e = arts["solve"], arts["eval"]
    if (solve["ranking"]["candidates"] != want_s.ranking["candidates"]
            or solve["outer_iters"] != want_s.outer_iters):
        fail(f"quickstart solve: {solve['ranking']['candidates']} in {solve['outer_iters']} "
             f"rounds vs the CPU Session's {want_s.ranking['candidates']} in "
             f"{want_s.outer_iters}")
    gaps = {k: abs(ev["metrics"][k] - v) for k, v in want_e.metrics.items()}
    if max(gaps.values()) > AGREE_TOL:
        fail(f"quickstart recovery metrics differ from the CPU Session's: {gaps}")
    want_r = arts["serve"].report
    if (serve["report"]["queries"] != want_r["queries"]
            or serve["report"]["deltas_applied"] != want_r["deltas_applied"]):
        fail(f"quickstart replay: {serve['report']['queries']} queries, "
             f"{serve['report']['deltas_applied']} deltas vs the CPU Session's "
             f"{want_r['queries']}, {want_r['deltas_applied']}")
    log(f"  equal to the CPU Session: top-{len(solve['ranking']['candidates'])} "
        f"{solve['ranking']['candidates']}, {solve['outer_iters']} rounds; recovery metrics "
        f"max|Δ| {max(gaps.values()):.2e}; {want_r['queries']} queries and "
        f"{want_r['deltas_applied']} deltas replayed by both; watchdog "
        f"{serve['slo'].get('windows')} windows, {serve['slo'].get('breaches')} breaches")


def trace_device_stats(path: Path) -> dict:
    """A Chrome trace (``torch.profiler``'s export) read back: device
    kernels by name (count, µs), the union of the device's kernel, copy
    and set intervals (µs) and the span of the ``phase:*`` range (µs)."""
    trace = json.loads(path.read_text())
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    kernels, intervals, phase_us = {}, [], 0.0
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat == "kernel":
            n, us = kernels.get(e["name"], (0, 0.0))
            kernels[e["name"]] = (n + 1, us + float(e.get("dur", 0.0)))
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            intervals.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))))
        if cat == "user_annotation" and e.get("name", "").startswith("phase:"):
            phase_us = max(phase_us, float(e.get("dur", 0.0)))
    return {"kernels": kernels, "busy_us": union_us(intervals), "phase_us": phase_us}


def round_kernel_launches(kernels: dict, residual: bool) -> tuple:
    """B1 (``residual``) or B3 entries of ``trace_device_stats``: the
    shared template ``csr_round::round_kernel<T, Out, VEC, kResidual, ...>``."""
    flag = ", true," if residual else ", false,"
    hits = [(n, us) for name, (n, us) in kernels.items()
            if "csr_round::round_kernel" in name and flag in name]
    return sum(n for n, _ in hits), sum(us for _, us in hits)


def obs_phase(torch, np, dev, bundle, main_solve, serve_qps) -> int:
    """Phase 11 (c): ``powerlaw_obs_kernel``, ``SERVE_SPEC`` with the
    quickstart's ``obs`` section verbatim, through ``Session.run`` (written
    under ``OUT_ROOT``): the observed solve on B1 held to phase 4's
    ``engine.run`` (equal supersteps and top-10, max|ΔF| ≤ ``AGREE_TOL``),
    352 / 352 queries answered, the telemetry whole and valid.  Prints the
    watchdog's windows and breaches and the replay qps beside (b)'s.
    Returns B1's launches."""
    from repro_torch.api import RunSpec, Session
    from repro_torch.core import extract_outputs, topk_exclusive
    from repro_torch.kernels import launch_counts, reset_launch_counts

    quick = json.loads((ROOT / "examples" / "specs" / "quickstart_run.json").read_text())
    spec = {**SERVE_SPEC, "run_id": "powerlaw_obs_kernel", "obs": quick["obs"]}
    run_dir = fresh_run_dir(spec["run_id"])
    session = Session(RunSpec.from_dict(spec), results_root=str(OUT_ROOT), device=dev,
                      bundle=bundle)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wrote = []  # (host clock, line) of each file the run writes
    arts = {a.kind: a for a in session.run(
        echo=lambda line: wrote.append((time.perf_counter(), line.rsplit("/", 1)[-1])))}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    log(f"  Session.run (obs level metrics, 0.25 s flush, SLO): {wall:.3f} s; solve "
        f"{arts['solve'].seconds:.3f} s (observed, host f64 loop), eval "
        f"{arts['eval'].seconds:.3f} s, serve {arts['serve'].seconds:.3f} s; launches {counts}")
    log("  host clock at each written file, from the start of the run: " + ", ".join(
        f"{name} {t - t0:.2f} s" for t, name in wrote))
    if counts["csr_round_residual"] <= 0:
        fail("powerlaw_obs_kernel launched csr_round_residual no time")
    others = {k: v for k, v in counts.items() if k != "csr_round_residual" and v}
    if others:
        fail(f"powerlaw_obs_kernel launched other kernels: {others}")
    res = arts["solve"]
    gap = float(np.max(np.abs(res.F - main_solve.F)))
    log(f"  observed solve: {res.outer_iters} supersteps (engine.run {main_solve.outer_iters}), "
        f"max|ΔF| vs phase 4's engine.run {gap:.3e} (gate {AGREE_TOL}), "
        f"{res.seconds / res.outer_iters * 1e3:.1f} ms a superstep")
    if res.outer_iters != main_solve.outer_iters or gap > AGREE_TOL or not res.converged:
        fail(f"observed solve vs engine.run: {res.outer_iters} vs {main_solve.outer_iters} "
             f"supersteps, max|ΔF| {gap}, converged {res.converged}")
    known = bundle.network.R[(0, 2)] > 0
    compare_top10(
        top10_lists(np, topk_exclusive, extract_outputs, res.F, session.norm, known),
        top10_lists(np, topk_exclusive, extract_outputs, main_solve.F, session.norm, known),
        "observed solve vs engine.run")
    r = arts["serve"].report
    if r["queries"] != SERVE_QUERIES:
        fail(f"powerlaw_obs_kernel replay answered {r['queries']} of {SERVE_QUERIES}")
    digest = check_telemetry(run_dir, "powerlaw_obs_kernel")
    if digest["convergence"]["supersteps"] != res.outer_iters:
        fail("powerlaw_obs_kernel: the telemetry's supersteps differ from the solve's")
    slo = arts["serve"].slo
    log(f"  replay: {r['queries']} / {SERVE_QUERIES} answered, {r['qps']:.1f} qps at level "
        f"metrics (phase 11 (b), level off: {serve_qps:.1f}), p50 {r['p50'] * 1e3:.2f} ms, "
        f"p99 {r['p99'] * 1e3:.2f} ms; watchdog {slo['windows']} windows, {slo['breaches']} "
        f"breaches, {slo['recoveries']} recoveries, degradation level "
        f"{slo['degradation_level']} (not gated)")
    return counts["csr_round_residual"]


def profiled_solve_check(np, tag, res, metrics, trace_dir, launches, residual, buckets,
                         main_solve, phase3_ms, wall) -> None:
    """Phase 11 (d), one profiled solve: the hook's calls of B1
    (``residual``) or B3 = the wrapper's launches = the kernels in the
    Chrome trace = ``buckets`` × supersteps, and the solve held to phase 4.
    Prints the hooked launch times beside phase 3's and the trace's device
    busy share."""
    name = "csr_round_residual" if residual else "csr_round"
    calls = metrics.peek(f"kernel.{name}.kernel.calls")
    hist = metrics.peek(f"kernel.{name}.kernel.latency_s")
    stats = trace_device_stats(trace_dir / "profile" / "solve" / "trace.json")
    in_trace, trace_us = round_kernel_launches(stats["kernels"], residual)
    want = buckets * res.outer_iters
    gap = float(np.max(np.abs(res.F - main_solve.F)))
    log(f"  {tag}: {res.outer_iters} supersteps in {wall:.3f} s, max|ΔF| vs phase 4 {gap:.3e}; "
        f"hook kernel.{name}.kernel.calls {calls.value if calls else 0}, launches "
        f"{launches[name]}, {name} kernels in the trace {in_trace} (expected {buckets} x "
        f"{res.outer_iters} = {want})")
    if calls is None or not calls.value == launches[name] == in_trace == want:
        fail(f"{tag}: hook calls, launches and trace kernels differ from {want}")
    if res.outer_iters != main_solve.outer_iters or gap > AGREE_TOL:
        fail(f"{tag}: {res.outer_iters} supersteps vs {main_solve.outer_iters}, max|ΔF| {gap}")
    if any(n for k, n in launches.items() if k != name):
        fail(f"{tag}: other kernels launched: {launches}")
    mean_ms = hist.total / hist.count * 1e3
    log(f"    a hooked launch (host clock, synchronized at both ends): p50 "
        f"{hist.percentile(0.5) * 1e3:.3f} ms (a log bucket edge), mean {mean_ms:.4f} ms, "
        f"x {buckets} = {mean_ms * buckets:.3f} ms a round against phase 3's "
        f"{phase3_ms:.4f} ms (CUDA events); trace: {name} device {trace_us / 1e3:.2f} ms, "
        f"device busy {stats['busy_us'] / 1e3:.1f} ms of the {stats['phase_us'] / 1e6:.3f} s "
        f"phase (busy share {stats['busy_us'] / max(stats['phase_us'], 1.0):.3f})")


def profile_check(torch, np, dev, bundle, main_solve, b1_ms, b3_ms) -> dict:
    """Phase 11 (d): ``powerlaw_profile_kernel`` (the network and solve of
    ``SERVE_SPEC``, ``obs.level = "profile"``) through ``Session.run``, then
    the same solve on a ``fused_superstep=False`` kernel engine through
    ``observed_solve`` with the kernel hook installed, inside
    ``profile_phase`` (``profiled_solve_check`` on each: B1 on the plan's
    19 buckets, B3 on the legacy layout's 47).  Returns the launches."""
    from repro_torch.api import RunSpec, Session
    from repro_torch.engine import make_engine
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs import Telemetry
    from repro_torch.obs.profiler import install_kernel_hook, profile_phase, uninstall_kernel_hook
    from repro_torch.obs.solve import observed_solve

    spec = {"run_id": "powerlaw_profile_kernel", "network": SERVE_SPEC["network"],
            "solve": SERVE_SPEC["solve"], "obs": {"level": "profile"}}
    run_dir = fresh_run_dir(spec["run_id"])
    session = Session(RunSpec.from_dict(spec), results_root=str(OUT_ROOT), device=dev,
                      bundle=bundle)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = session.run(echo=quiet)[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fused = launch_counts()
    check_telemetry(run_dir, "powerlaw_profile_kernel")
    plan = session.engine.prepare(session.norm).payload.plan[0]
    profiled_solve_check(np, "fused plan, B1", res, session.telemetry.metrics,
                         run_dir / "telemetry", fused, True, len(plan), main_solve, b1_ms, wall)

    legacy_dir = fresh_run_dir("powerlaw_profile_kernel_legacy") / "telemetry"
    engine = make_engine("kernel", session.lp_config(), device=dev, fused_superstep=False)
    tel = Telemetry("profile", run_id="powerlaw_profile_kernel_legacy")
    reset_launch_counts()
    install_kernel_hook(tel)
    try:
        with profile_phase(tel, str(legacy_dir), "solve", dev):
            t0 = time.perf_counter()
            legacy = observed_solve(engine, session.norm, telemetry=tel)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        uninstall_kernel_hook()
    legacy_counts = launch_counts()
    tel.flush(str(legacy_dir))
    check_telemetry(legacy_dir.parent, "powerlaw_profile_kernel_legacy")
    layout = engine.prepare(session.norm).payload.fused[0]
    profiled_solve_check(np, "legacy layout, B3", legacy, tel.metrics, legacy_dir,
                         legacy_counts, False, len(layout), main_solve, b3_ms, wall)
    return {"csr_round_residual": fused["csr_round_residual"],
            "csr_round": legacy_counts["csr_round"]}


def crashdrill_phase(torch, np, dev, bundle, main_solve) -> int:
    """Phase 11 (e): ``powerlaw_crashdrill_kernel``, ``SERVE_SPEC`` with
    ``crashdrill_run.json``'s ``ft`` section and ``obs.level = "metrics"``.
    The first ``Session.run`` dies at superstep 3 (``TransientWorkerError``);
    ``python -m repro_torch run --resume`` completes it.  Gates: resumed
    from a durable step; the final F (its last checkpoint) equal bit for
    bit to a clean checkpointed run's on the card, with equal rankings and
    scores; the serve fault at batch 2 retried, every query answered,
    ``ft.*`` in the digest and the serve artifact.  Returns B1's launches
    in this process."""
    from repro_torch.api import RunSpec, Session
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.ft import TransientWorkerError
    from repro_torch.kernels import launch_counts, reset_launch_counts

    ft = json.loads((ROOT / "examples" / "specs" / "crashdrill_run.json").read_text())["ft"]
    spec = {**SERVE_SPEC, "run_id": "powerlaw_crashdrill_kernel", "obs": {"level": "metrics"},
            "ft": ft}
    clean_spec = {**spec, "run_id": "powerlaw_crashdrill_kernel_clean",
                  "ft": {k: v for k, v in ft.items() if not k.startswith("inject")}}
    run_dir = fresh_run_dir(spec["run_id"])
    fresh_run_dir(clean_spec["run_id"])
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        Session(RunSpec.from_dict(spec), results_root=str(OUT_ROOT), device=dev,
                bundle=bundle).run(echo=quiet)
        fail("the crash drill's first run did not die at its injected fault")
    except TransientWorkerError as e:
        log(f"  first run: TransientWorkerError ({e}) after {time.perf_counter() - t0:.2f} s; "
            f"durable steps {CheckpointManager(str(run_dir / 'checkpoints' / 'solve')).steps()}")
    proc, wall = run_cli(["run", "--resume", spec["run_id"], "--device", CLI_DEVICE,
                          "--results-root", str(OUT_ROOT)])
    if proc.returncode != 0:
        fail(f"run --resume exited {proc.returncode}: {proc.stderr[-2000:]}")
    solve = json.loads((run_dir / "solve.json").read_text())
    log(f"  python -m repro_torch run --resume {spec['run_id']} --device {CLI_DEVICE}: exit 0 "
        f"in {wall:.1f} s; solve ft {solve['ft']}")
    if solve["ft"].get("resumed_from") is None:
        fail("the resumed run did not resume from a checkpoint")
    t0 = time.perf_counter()
    clean = Session(RunSpec.from_dict(clean_spec), results_root=str(OUT_ROOT), device=dev,
                    bundle=bundle).run(["solve"], write=False)[0]
    log(f"  clean checkpointed solve: {clean.outer_iters} supersteps in "
        f"{time.perf_counter() - t0:.2f} s, ft {dict(clean.ft, ckpt_dir='...')}")
    counts = launch_counts()
    manager = CheckpointManager(str(run_dir / "checkpoints" / "solve"))
    last = manager.steps()[-1]
    leaves, meta = manager.restore_flat(last)
    final_F = leaves[0]  # the state's leaves in key order: F, F_prev, active, col_iters
    diff = float(np.max(np.abs(final_F - clean.F)))
    log(f"  resumed final F (checkpoint step {last}) vs the clean run's: max|Δ| {diff} "
        f"(gate == 0); vs phase 4's engine.run {float(np.max(np.abs(clean.F - main_solve.F))):.3e}")
    if last != clean.outer_iters or final_F.shape != clean.F.shape or diff != 0.0:
        fail(f"resumed solve: last step {last} vs {clean.outer_iters} supersteps, max|Δ| {diff}")
    if solve["ranking"] != clean.ranking or solve["outer_iters"] != clean.outer_iters:
        fail(f"resumed ranking {solve['ranking']} vs the clean run's {clean.ranking}")
    serve = json.loads((run_dir / "serve.json").read_text())
    sft, queries = serve["ft"], serve["report"]["queries"]
    retried = sft.get("injected_faults") == ft["inject_serve_fault"] and sft.get("retries", 0) >= 1
    if queries != SERVE_QUERIES or not retried:
        fail(f"resumed serve: {queries} queries, ft {sft}")
    digest = check_telemetry(run_dir, "powerlaw_crashdrill_kernel (resumed)")
    if not digest.get("ft") or digest["ft"]["resumes"] != 1 or digest["ft"]["retries"] < 1:
        fail(f"resumed run's digest ft block: {digest.get('ft')}")
    log(f"  rankings and scores equal; serve {queries} / {SERVE_QUERIES} answered, ft "
        f"{dict(sft, ckpt_dir='...')}; digest ft {digest['ft']}")
    if counts["csr_round_residual"] <= 0:
        fail("the crash drill launched csr_round_residual no time in this process")
    return counts["csr_round_residual"]


def entry_point_phase(torch, np, dev, bundle, main_solve, b1_ms, b3_ms) -> dict:
    """Phase 11: the port's normal entry point.  (a) the quickstart through
    the CLI, telemetry and all; (b) ``powerlaw_serve_kernel`` through
    ``Session.run`` on ``bundle`` (phase 4's network): the solve held to the
    torch-op ``sparse`` engine, the replay of its 352 queries (B1 launched
    through serve's early-exit loop), 64 queries one by one on the
    ``kernel`` and ``sparse`` serve engines, B1 at each of the loop's widths
    held to its plain version, and one replay traced; (c) the observed solve
    and the SLO-watched replay (``obs_phase``); (d) the profile level
    (``profile_check``); (e) the crash drill (``crashdrill_phase``).
    ``main_solve`` is phase 4's ``engine.run`` result, ``b1_ms``/``b3_ms``
    phase 3's round times.  Returns B1's launches in the serve stage and
    in (c)-(e), B3's in (d), and B1's worst error at the serve widths."""
    from repro_torch.api import RunSpec, Session
    from repro_torch.core import extract_outputs, topk_exclusive
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.scenarios import build_trace
    from repro_torch.serve import QuerySpec, replay_trace

    quickstart_cli_check(np)

    log("== phase 11 (b): powerlaw_serve_kernel through Session.run on the kernel engine")
    spec = RunSpec.from_dict(SERVE_SPEC)
    sv = spec.serve
    trace = build_trace(bundle, sv.trace, rate_qps=sv.rate_qps, horizon_s=sv.horizon_s,
                        seed=spec.network.seed)
    if len(trace) != SERVE_QUERIES:
        fail(f"the {sv.trace} trace holds {len(trace)} queries, expected {SERVE_QUERIES}")
    session = Session(spec, device=dev, bundle=bundle)
    # the spec's sections in their order, with the launch counts read
    # between the solve/eval stages and the serve stage
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    arts = {a.kind: a for a in session.run(["solve", "eval"], write=False)}
    torch.cuda.synchronize()
    before = launch_counts()["csr_round_residual"]
    arts.update((a.kind, a) for a in session.run(["serve"], write=False))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    b1_serve = counts["csr_round_residual"] - before
    log(f"  Session.run: {wall:.3f} s; solve {arts['solve'].seconds:.3f} s, eval "
        f"{arts['eval'].seconds:.3f} s, serve {arts['serve'].seconds:.3f} s; launches {counts}")
    if counts["csr_round_residual"] <= 0 or b1_serve <= 0:
        fail(f"csr_round_residual launched {counts['csr_round_residual']} times in the run, "
             f"{b1_serve} in the serve stage")
    others = {k: v for k, v in counts.items() if k != "csr_round_residual" and v}
    if others:
        fail(f"the kernel-engine session launched other kernels: {others}")

    # the solve against the torch-op sparse engine on the card
    res = arts["solve"]
    sparse_spec = RunSpec.from_dict({**SERVE_SPEC, "solve": {**SERVE_SPEC["solve"],
                                                             "backend": "sparse"}})
    sparse_session = Session(sparse_spec, device=dev, bundle=bundle)
    want = sparse_session.solve()
    if launch_counts() != counts:
        fail("the torch-op sparse session launched a CUDA kernel of the port")
    n = bundle.network.num_nodes
    if res.F.shape != (n, n) or not np.isfinite(res.F).all() or not res.converged:
        fail(f"Session solve: shape {res.F.shape}, converged {res.converged}")
    gap = float(np.max(np.abs(res.F - want.F)))
    log(f"  solve: {res.outer_iters} rounds (sparse {want.outer_iters}); max|ΔF| vs sparse "
        f"{gap:.3e} (gate {AGREE_TOL}); top-{len(res.ranking['candidates'])} of drug 0 "
        f"{res.ranking['candidates']}")
    if res.outer_iters != want.outer_iters or gap > AGREE_TOL:
        fail(f"Session solve vs sparse: {res.outer_iters} vs {want.outer_iters} rounds, "
             f"max|ΔF| {gap}")
    if res.ranking["candidates"] != want.ranking["candidates"]:
        fail(f"Session solve ranking {res.ranking['candidates']} vs sparse "
             f"{want.ranking['candidates']}")
    known = bundle.network.R[(0, 2)] > 0
    compare_top10(top10_lists(np, topk_exclusive, extract_outputs, res.F, session.norm, known),
                  top10_lists(np, topk_exclusive, extract_outputs, want.F, session.norm, known),
                  "Session solve, kernel vs sparse")
    m = arts["eval"].metrics
    log(f"  eval: recovery_auc {m['recovery_auc']:.6f}, aupr {m['recovery_aupr']:.6f}, "
        f"{int(m['outer_iters'])} rounds, {int(m['eval_entities'])} entities")
    if not 0.5 < m["recovery_auc"] <= 1.0:
        fail(f"recovery_auc {m['recovery_auc']}")

    # the replay: every query answered; its submits block on a full queue,
    # so a rejected or failed query would have raised out of the replay
    r = arts["serve"].report
    log(f"  replay: {r['queries']} / {len(trace)} queries answered, 0 rejected, "
        f"{r['qps']:.1f} qps (offered {r['offered_qps']:.1f}), achieved/offered "
        f"{r['achieved_vs_offered']:.3f}, mean batch {r['mean_batch_size']:.2f} in "
        f"{r['batches']} batches, mean rounds {r['mean_rounds']:.2f}, sources {r['sources']}")
    log(f"  latency p50 {r['p50'] * 1e3:.2f} ms, p95 {r['p95'] * 1e3:.2f} ms, p99 "
        f"{r['p99'] * 1e3:.2f} ms; csr_round_residual launches in the serve stage {b1_serve}")
    if r["queries"] != len(trace):
        fail(f"replay answered {r['queries']} of {len(trace)} queries")

    # 64 queries one by one on the kernel and sparse serve engines
    kernel_serve = session.serve_engine()
    sparse_serve = sparse_session.serve_engine()
    worst, t_k, t_s, rounds = 0.0, 0.0, 0.0, 0
    for i in range(SYNC_QUERIES):
        q = QuerySpec(entity=int(trace.entity[i]), target_type=int(trace.target_type[i]),
                      top_k=sv.top_k)
        t0 = time.perf_counter()
        got = kernel_serve.query(q)
        t_k += time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = sparse_serve.query(q)
        t_s += time.perf_counter() - t0
        rounds += got.rounds
        gap = float(np.max(np.abs(got.scores - ref.scores))) if got.scores.size else 0.0
        worst = max(worst, gap)
        if (list(got.candidates) != list(ref.candidates) or gap > AGREE_TOL
                or (got.rounds, got.source) != (ref.rounds, ref.source)):
            fail(f"query {i} (entity {q.entity}): kernel {list(got.candidates)} in "
                 f"{got.rounds} rounds ({got.source}) vs sparse {list(ref.candidates)} in "
                 f"{ref.rounds} ({ref.source}), scores max|Δ| {gap}")
    log(f"  {SYNC_QUERIES} queries one by one: kernel and sparse serve engines give equal "
        f"top-{sv.top_k} lists, rounds and sources; scores max|Δ| {worst:.2e} (gate "
        f"{AGREE_TOL}); {t_k:.3f} s on kernel, {t_s:.3f} s on sparse for {rounds} early-exit "
        f"rounds ({t_k / max(rounds, 1) * 1e3:.2f} / {t_s / max(rounds, 1) * 1e3:.2f} ms a "
        f"round, host clock, cache hits included)")
    b1_err = serve_width_checks(torch, np, kernel_serve)

    # one replay traced, after a warm-up replay (each on a fresh serve engine)
    t_p, busy_us, by_name = trace_solve(
        torch, "powerlaw_serve_kernel replay (2 s of diurnal trace)",
        lambda: replay_trace(session.serve_engine(), trace, (), top_k=sv.top_k,
                             time_scale=sv.time_scale))
    b1_items = [tc for k, tc in by_name.items() if "csr_round::round_kernel" in k]
    replay_b1_ms = sum(t for t, _ in b1_items) / 1e3
    b1_n = sum(c for _, c in b1_items)
    htod = [(t, c) for k, (t, c) in by_name.items() if k.startswith("Memcpy HtoD")]
    dtoh = [(t, c) for k, (t, c) in by_name.items() if k.startswith("Memcpy DtoH")]
    log(f"  traced replay: B1 x{b1_n} {replay_b1_ms:.2f} ms; HtoD x{sum(c for _, c in htod)} "
        f"{sum(t for t, _ in htod) / 1e3:.2f} ms, DtoH x{sum(c for _, c in dtoh)} "
        f"{sum(t for t, _ in dtoh) / 1e3:.2f} ms (the early-exit loop's per-round copies); "
        f"busy {busy_us / 1e3:.1f} ms of {t_p:.3f} s")
    del session, sparse_session, kernel_serve, sparse_serve, arts, want, res

    log("== phase 11 (c): powerlaw_obs_kernel, the observed solve and the SLO-watched replay")
    b1_obs = obs_phase(torch, np, dev, bundle, main_solve, r["qps"])
    log("== phase 11 (d): powerlaw_profile_kernel, the profile level and the kernel hook")
    prof = profile_check(torch, np, dev, bundle, main_solve, b1_ms, b3_ms)
    log("== phase 11 (e): powerlaw_crashdrill_kernel, kill at superstep 3 and run --resume")
    b1_crash = crashdrill_phase(torch, np, dev, bundle, main_solve)
    return {"serve_b1": b1_serve + b1_obs + prof["csr_round_residual"] + b1_crash,
            "b3": prof["csr_round"], "b1_err": b1_err}


# phase 12: the bench pass's host class (the port's baseline_h100.json was
# taken under it), and the reference baseline's records the port does not
# emit, with the queue item or the cards each waits for
BENCH_HOST_CLASS = "h100-1card-sandbox"
BENCH_NOT_PORTED = {
    # XLA's route through the oracles: the port's torch_ref records are
    # their counterparts, under another backend key
    "kernels/lp_round_ref_512x256@xla_ref": "-",
    "kernels/csr_aggregate_ref_512x16@xla_ref": "-",
    "kernels/embedding_bag_ref_b4096@xla_ref": "-",
    "kernels/attention_ref_l256@xla_ref": "-",
}


def bench_not_emitted(cards: int) -> dict:
    """The baseline keys a bench pass on ``cards`` cards does not emit:
    ``BENCH_NOT_PORTED``, the ``fig34_parallelism`` points that need more
    cards, and the ``lp_matrix`` columns that need a world of more ranks
    (the pass runs as one process: a world of one rank)."""
    out = dict(BENCH_NOT_PORTED)
    for k in (1, 2):
        if k > cards:
            out[f"fig34_parallelism/d{k}s1@sharded{k}"] = f"needs {k} GPUs"
    for k in (2, 4):
        out[f"lp_matrix/dhlp2_sharded{k}@sharded{k}"] = f"needs {k} GPUs"
    return out


def bench_report(path: Path, proc, what: str) -> dict:
    """The report a bench pass wrote, validated under the port's schema,
    with no failed suite and no error record."""
    from repro_torch.bench.report import load_report
    from repro_torch.bench.schema import record_key

    if proc.returncode != 0:
        fail(f"{what} exited {proc.returncode}: {proc.stderr[-3000:]}")
    if not path.is_file():
        fail(f"{what} wrote no {path.name}")
    doc = load_report(str(path))
    bad = [record_key(r) for r in doc["records"] if r.get("error") is not None]
    if bad or doc.get("errors"):
        fail(f"{what}: error records {bad}, failed suites {doc.get('errors')}")
    return doc


def bench_phase() -> None:
    """Phase 12: the bench harness on ``CLI_DEVICE``, through the CLI with
    ``BENCH_HOST_CLASS`` set.  (a) ``run examples/specs/bench_ci.json``:
    every ported suite's fast pass, a ``skipped`` line for each suite not
    ported, ``BENCH_torch_ci.json`` valid with no error; its records held
    to ``benchmarks/baseline.json`` (the reference's CPU records) restricted
    to the keys the port emits on every strict metric, and the keys it does
    not emit exactly ``bench_not_emitted(cards)``; the timing findings printed,
    not gated (a CPU baseline against a card).  (b) ``bench --full --only
    kernels``: every ``cuda`` record (B2, B4, B5, B6 at the reference's
    full sizes) within the f32 tolerance of its plain version, its median
    printed beside the ``torch_ref`` median.  (c) the ``serve/obs_overhead``
    record's three qps and two overhead fractions."""
    from repro_torch.bench.compare import compare_reports
    from repro_torch.bench.driver import NOT_PORTED_SUITES
    from repro_torch.bench.report import load_report
    from repro_torch.bench.schema import record_key

    env = {"BENCH_HOST_CLASS": BENCH_HOST_CLASS}
    log("== phase 12 (a): python -m repro_torch run examples/specs/bench_ci.json")
    ci_path = ROOT / "BENCH_torch_ci.json"
    ci_path.unlink(missing_ok=True)
    proc, wall = run_cli(["run", "examples/specs/bench_ci.json", "--device", CLI_DEVICE],
                         env=env, timeout=900)
    doc = bench_report(ci_path, proc, "run examples/specs/bench_ci.json")
    lines = proc.stdout.splitlines()
    for suite, item in NOT_PORTED_SUITES.items():
        if f"skipped {suite}: not ported (ROADMAP {item})" not in lines:
            fail(f"the bench pass printed no skipped line for {suite} ({item})")
    envd = doc["environment"]
    log(f"  exit 0 in {wall:.1f} s (process start included), {len(doc['records'])} records; "
        f"environment: {envd['device_kind']} x{envd['device_count']}, backend "
        f"{envd['backend']}, sm_{envd.get('compute_capability')}, {envd.get('sm_count')} SMs, "
        f"{envd.get('power_limit')}, host_class {envd['host_class']}")
    for line in lines:
        if line.startswith(("skipped", "lp_matrix:", "fig34_parallelism:", "[bench]")):
            log(f"    {line}")
    base = load_report(str(ROOT / "benchmarks" / "baseline.json"))
    got = {record_key(r) for r in doc["records"]}
    absent = {record_key(r) for r in base["records"]} - got
    listed = bench_not_emitted(envd["device_count"])
    if absent != set(listed):
        fail(f"baseline keys not emitted: {sorted(absent - set(listed))} missing "
             f"beyond the listed ones; {sorted(set(listed) - absent)} listed but emitted")
    base["records"] = [r for r in base["records"] if record_key(r) in got]
    res = compare_reports(base, doc)
    n_strict = sum(len(r.get("strict", [])) for r in base["records"])
    if not res.ok or res.compared != len(base["records"]):
        for f in res.regressions:
            log(f"    [{f.kind}] {f.key} {f.metric}: {f.baseline} -> {f.candidate} {f.detail}")
        fail(f"the bench pass against benchmarks/baseline.json: {len(res.regressions)} "
             f"regressions over {res.compared} records")
    log(f"  {res.compared} records ({n_strict} strict metrics) held to benchmarks/baseline.json "
        f"restricted to the emitted keys: PASS; the {len(absent)} keys not emitted are "
        f"exactly the listed ones ({sorted(set(listed.values()))}); new keys {res.new_keys}")
    for key in sorted(got & {record_key(r) for r in base["records"]}):
        if key.startswith(("fig34_parallelism/", "lp_matrix/dhlp2_sharded",
                           "kernel_variants/drugnet_autotuned",
                           "kernel_variants/autotune_cache")):
            r = next(x for x in doc["records"] if record_key(x) == key)
            log(f"    {key}: " + ", ".join(f"{m} {r['derived'][m]:g}" for m in r["strict"]))
    log(f"  timing vs the reference's CPU baseline (not gated, env_match={res.env_match}): "
        f"{len(res.warnings)} slower beyond 30 %, {len(res.improvements)} faster beyond 30 %")
    base_s = {record_key(r): r["stats"]["median_s"] for r in base["records"]}
    for r in doc["records"]:
        key = record_key(r)
        ref = f"{base_s[key] * 1e3:.3f} ms" if key in base_s else "-"
        log(f"    {key}: median {r['stats']['median_s'] * 1e3:.3f} ms (reference CPU {ref})")
    # the port's own card baseline, as `python -m repro_torch.bench.compare`
    # holds it: every key and strict metric gated, wall times reported
    mine = compare_reports(load_report(str(SRC / "repro_torch" / "bench" / "baseline_h100.json")),
                           doc, gate_timing=False)
    if not mine.ok:
        for f in mine.regressions:
            log(f"    [{f.kind}] {f.key} {f.metric}: {f.baseline} -> {f.candidate} {f.detail}")
        fail(f"the bench pass against baseline_h100.json: {len(mine.regressions)} regressions")
    log(f"  against the port's baseline_h100.json: PASS on {mine.compared} records "
        f"(env_match={mine.env_match}); wall times reported, not gated: "
        f"{sum(f.kind == 'timing' for f in mine.warnings)} slower and "
        f"{len(mine.improvements)} faster beyond 30 %")

    log("== phase 12 (b): python -m repro_torch bench --full --only kernels")
    full_path = ROOT / "BENCH_torch_kernels_full.json"
    full_path.unlink(missing_ok=True)
    proc, wall_b = run_cli(["bench", "--full", "--only", "kernels", "--device", CLI_DEVICE,
                            "--label", "kernels_full"], env=env, timeout=600)
    full = bench_report(full_path, proc, "bench --full --only kernels")
    refs = {r["name"]: r for r in full["records"] if r["backend"] == "torch_ref"}
    cuda = [r for r in full["records"] if r["backend"] == "cuda"]
    if len(refs) != 4 or len(cuda) != (4 if CLI_DEVICE != "cpu" else 0):
        fail(f"bench --full --only kernels: {len(refs)} torch_ref and {len(cuda)} cuda records")
    log(f"  exit 0 in {wall_b:.1f} s (process start included)")
    for r in cuda:
        d = r["derived"]
        if d["agree_ref"] != 1.0:
            fail(f"kernels/{r['name']}@cuda: max|Δ| {d['max_abs_diff_vs_ref']:.3e} vs its plain "
                 "version, outside rtol=2e-4, atol=5e-4")
        ref = refs[r["name"]]["stats"]["median_s"]
        log(f"    {r['name']}: kernel {r['stats']['median_s'] * 1e3:.4f} ms, plain "
            f"{ref * 1e3:.4f} ms ({d['speedup_vs_ref']:.2f}x), max|Δ| "
            f"{d['max_abs_diff_vs_ref']:.3e}, agree_ref 1 ({r['params']})")

    log("== phase 12 (c): serve/obs_overhead, the batched burst at obs off / metrics / streaming")
    ab = next(r for r in doc["records"] if record_key(r) == "serve/obs_overhead@dense")
    d = ab["derived"]
    log(f"  qps_off {d['qps_off']:.1f}, qps_metrics {d['qps_metrics']:.1f}, qps_streaming "
        f"{d['qps_streaming']:.1f}; overhead_frac {d['overhead_frac']:.4f}, "
        f"overhead_frac_streaming {d['overhead_frac_streaming']:.4f} "
        f"({ab['params']['queries']} queries a burst, best of 5)")


def lp_on_graph_launches(torch, dev) -> tuple:
    """Phase 12 (d): the ``lp_on_graph`` suite's fast pass in this process
    on the card, its strict metrics held to ``benchmarks/baseline.json``
    as in (a); returns its GCN's B4 (forward, backward) launches: 60 AdamW
    steps, 2 + 1 a step, and the final forward's 2."""
    from repro_torch.bench.compare import compare_reports
    from repro_torch.bench.report import load_report
    from repro_torch.bench.schema import record_key
    from repro_torch.bench.suites import lp_on_graph
    from repro_torch.kernels import launch_counts, reset_launch_counts

    log("== phase 12 (d): the lp_on_graph suite in this process (B4 launches counted)")
    reset_launch_counts()
    recs = [r.to_dict() for r in lp_on_graph.records(fast=True, device=dev)]
    counts = launch_counts()
    got = (counts["csr_aggregate"], counts["csr_aggregate_backward"])
    if got != (2 * 60 + 2, 60):
        fail(f"lp_on_graph: B4 launched {got} (forward, backward), expected (122, 60)")
    base = load_report(str(ROOT / "benchmarks" / "baseline.json"))
    keys = {record_key(r) for r in recs}
    base["records"] = [r for r in base["records"] if record_key(r) in keys]
    res = compare_reports(base, {"environment": {}, "records": recs})
    if not res.ok or res.compared != 3:
        fail(f"lp_on_graph in process vs benchmarks/baseline.json: {res.regressions}")
    for r in recs:
        log(f"    {record_key(r)}: " + ", ".join(f"{m} {r['derived'][m]:g}" for m in r["strict"])
            + f" (strict gate PASS); {r['stats']['median_s'] * 1e3:.1f} ms")
    log(f"  B4 launches: {got[0]} forward, {got[1]} backward")
    return got


# phase 13: the autotune sweep and the sharded engine.  In-process phases
# read the autotune cache under AUTOTUNE_DIR (emptied at the start); the
# CLI phases run from the checkout, whose results/autotune is emptied too.
AUTOTUNE_DIR = ROOT / "build" / "chip_smoke_autotune"
SHARDED_SERVE_QUERIES = 64  # drugs 0-63, one by one, on sharded and kernel


def tuned_kernel_gates(torch, np, n, plan, legacy, params, s=None) -> tuple:
    """Phase 13 (a): B1 on every bucket of the tuned fused ``plan`` at each
    ``slots_per_block`` of the sweep's grid, and B3 on every bucket of the
    ``legacy`` layout (if any) at the winning one, against their plain
    versions at ``F32_TOL`` (S = ``s``, default n).  Returns (B1's, B3's)
    max|Δ|."""
    from repro_torch.engine.autotune import PANEL_GRID
    from repro_torch.kernels.segment_reduce import (
        csr_round_op,
        csr_round_ref,
        csr_round_residual_op,
        csr_round_residual_ref,
    )

    gen = torch.Generator(device=plan[1].device).manual_seed(13)
    F, base, prev = (torch.rand((n, s or n), generator=gen, device=plan[1].device)
                     for _ in range(3))
    b1 = b3 = 0.0
    for spb in PANEL_GRID:
        off = 0
        for nbr, wgt, live in plan[0]:
            m = nbr.shape[0]
            sl = slice(off, off + m)
            got, got_d = csr_round_residual_op(nbr, wgt, F, base[sl], prev[sl], c=0.25,
                                               live=live, slots_per_block=spb)
            want, want_d = csr_round_residual_ref(nbr, wgt, F, base[sl], prev[sl], 0.25)
            tag = f"csr_round_residual tuned plan ({m}x{nbr.shape[1]}, slots_per_block {spb})"
            b1 = max(b1, check_close(np, tag, got, want, F32_TOL, quiet=True))
            check_close(np, tag + " delta", got_d.amax(dim=0, keepdim=True), want_d, F32_TOL,
                        quiet=True)
            off += m
    for rows, nbr, wgt, live in legacy or ():
        got = csr_round_op(nbr, wgt, F, base[rows], c=0.25, live=live,
                           slots_per_block=params.slots_per_block)
        want = csr_round_ref(nbr, wgt, F, base[rows], 0.25)
        b3 = max(b3, check_close(
            np, f"csr_round tuned legacy layout ({nbr.shape[0]}x{nbr.shape[1]})", got, want,
            F32_TOL, quiet=True))
    torch.cuda.synchronize()
    return b1, b3


def autotune_phase(torch, np, dev, net, main_solve, top_main) -> dict:
    """Phase 13 (a): ``ensure_tuned`` cold into ``AUTOTUNE_DIR`` at S = n,
    each candidate's time and the winner printed; a second call is a hit
    that times nothing; the ``kernel`` solve with ``autotune=True`` carries
    the tuned layout and block sizing and agrees with phase 4 (equal
    rounds, max|ΔF| ≤ 5e-3, top-10), and so does the legacy solve on the
    tuned layout; then B1 and B3 at every shape the sweep and these solves
    launched (``tuned_kernel_gates``).  Returns the launches and errors."""
    from repro_torch.core import extract_outputs, topk_exclusive
    from repro_torch.core.solver import LPConfig
    from repro_torch.engine import autotune, make_engine
    from repro_torch.kernels import launch_counts, reset_launch_counts

    n = net.num_nodes
    norm = net.normalize()
    cfg = LPConfig(alg="dhlp2", alpha=0.5, sigma=1e-4, seed_mode="fixed", autotune=True)
    seen = []
    reset_launch_counts()
    t0 = time.perf_counter()
    params, hit = autotune.ensure_tuned(
        norm, alpha=cfg.alpha, hetero_scale=cfg.resolved_hetero_scale(norm.num_types), s=n,
        repeats=2, cache_dir=AUTOTUNE_DIR, device=dev,
        on_time=lambda kind, cand, t: seen.append((kind, cand, t)))
    t_sweep = time.perf_counter() - t0
    if hit:
        fail("ensure_tuned hit a cache in the fresh directory")
    log(f"  ensure_tuned cold at S = {n}: {t_sweep:.1f} s, key {autotune.host_fingerprint(dev)} / "
        f"{autotune.shape_class(n, autotune.network_nnz(norm))}")
    for kind, cand, t in seen:
        log(f"    {kind} {cand}: {t * 1e3:.4f} ms a round")
    if len([k for k, _, _ in seen if k == "layout"]) != len(autotune.LAYOUT_GRID) or \
            [c for k, c, _ in seen if k == "slots_per_block"] != list(autotune.PANEL_GRID):
        fail(f"the sweep timed {seen}")
    log(f"  winner: {params.to_dict()}")
    seen.clear()
    again = autotune.ensure_tuned(norm, s=n, cache_dir=AUTOTUNE_DIR, device=dev,
                                  on_time=lambda *a: seen.append(a))
    if again != (params, True) or seen:
        fail(f"the second ensure_tuned: {again}, timed {seen}")
    log("  a second ensure_tuned: a hit, nothing timed")

    results = {}
    for name, kw in (("fused", {}), ("legacy", {"fused_superstep": False})):
        eng = make_engine("kernel", cfg, device=dev, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.run(net)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pay = eng.prepare(net).payload
        if pay.layout != (params.block_rows, params.width_mult) or \
                pay.slots_per_block != params.slots_per_block:
            fail(f"tuned {name} solve: payload layout {pay.layout}, slots_per_block "
                 f"{pay.slots_per_block}, tuned {params}")
        gap = float(np.max(np.abs(res.F - main_solve.F)))
        log(f"  tuned kernel {name} solve: layout {pay.layout}, slots_per_block "
            f"{pay.slots_per_block}, {res.outer_iters} rounds in {wall:.3f} s; max|ΔF| vs "
            f"phase 4 {gap:.3e} (gate {AGREE_TOL})")
        if res.outer_iters != main_solve.outer_iters or gap > AGREE_TOL or not res.converged:
            fail(f"tuned {name} solve vs phase 4: {res.outer_iters} vs "
                 f"{main_solve.outer_iters} rounds, max|ΔF| {gap}")
        known = net.R[(0, 2)] > 0
        compare_top10(top_main, top10_lists(np, topk_exclusive, extract_outputs, res.F, norm,
                                            known), f"tuned kernel {name} vs phase 4")
        results[name] = pay
    counts = launch_counts()
    b1_err, b3_err = tuned_kernel_gates(torch, np, n, results["fused"].plan,
                                        results["legacy"].fused[0], params)
    log(f"  B1 on every tuned-plan bucket at slots_per_block {list(autotune.PANEL_GRID)}: "
        f"max|Δ| {b1_err:.3e}; B3 on every bucket of the tuned legacy layout: max|Δ| "
        f"{b3_err:.3e} (rtol={F32_TOL['rtol']}, atol={F32_TOL['atol']})")
    # the bench pass's sweep (kernel_variants/autotune_cache, phase 12) runs
    # B1 on the 104-node drugnet's plan at S = 8: the same gate there
    from repro_torch.data.drugnet import DrugNetSpec, make_drugnet

    small = make_drugnet(DrugNetSpec(n_drug=48, n_disease=32, n_target=24, n_clusters=6))
    small_plan = make_engine("kernel", LPConfig(alg="dhlp2", seed_mode="fixed", autotune=False),
                             device=dev).prepare(small.network).payload.plan
    small_err, _ = tuned_kernel_gates(torch, np, small.network.num_nodes, small_plan, None,
                                      params, s=8)
    b1_err = max(b1_err, small_err)
    log(f"  B1 on every bucket of the bench sweep's drugnet plan (S = 8) at every "
        f"slots_per_block: max|Δ| {small_err:.3e}")
    log(f"  launches in phase 13 (a): {counts}")
    return {"b1": counts["csr_round_residual"], "b3": counts["csr_round"],
            "b1_err": b1_err, "b3_err": b3_err}


def sharded_phase(torch, np, dev, net, main_solve, dhlp1_solve, top_main, b1_ms) -> None:
    """Phase 13 (b): the sharded engine on a world of one NCCL rank: the
    DHLP-2 all-sources solve held to phase 4 (equal rounds, ≤ 5e-3,
    top-10), ``stale_sync=4`` within 1e-3 of it with at least its rounds,
    ``compression="bf16"`` within 5e-3 of phase 4, DHLP-1 held to phase
    7's ``sparse`` solve (equal rounds, ≤ 5e-3); ``python -m repro_torch
    run --backend sharded --devices 1``; 64 queries served on ``sharded``
    with the ``kernel`` serve engine's top-10; a ``remesh`` round-trip of
    the solve's state onto a one-device mesh; wall per round beside B1's."""
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import extract_outputs, topk_exclusive
    from repro_torch.core.solver import LPConfig
    from repro_torch.engine import make_engine
    from repro_torch.ft import remesh
    from repro_torch.parallel.lp_sharded import ShardedHeteroLP
    from torch.distributed.tensor import Shard

    from repro_torch.parallel.mesh import MeshSharding, destroy_owned_world, make_mesh
    from repro_torch.serve import LPServeEngine, QuerySpec, ServeConfig

    norm = net.normalize()
    known = net.R[(0, 2)] > 0
    cfg = LPConfig(alg="dhlp2", alpha=0.5, sigma=1e-4, seed_mode="fixed", autotune=False)
    eng = make_engine("sharded", cfg, device=dev)
    try:
        op = eng.prepare(net)
        mesh = eng.mesh()
        log(f"  world: {dist.get_world_size()} rank, backend {dist.get_backend()}, mesh "
            f"{tuple(mesh.mesh.shape)} {mesh.mesh_dim_names}; {op.payload.arrays[0].numel()} "
            f"edges on this rank")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.run(net)
        wall = time.perf_counter() - t0
        gap = float(np.max(np.abs(res.F - main_solve.F)))
        log(f"  sharded DHLP-2 all-sources: {res.outer_iters} rounds in {wall:.3f} s "
            f"({wall / res.outer_iters * 1e3:.2f} ms a round, B1's fused round {b1_ms:.4f} ms: "
            f"{wall / res.outer_iters * 1e3 / b1_ms:.1f}x); max|ΔF| vs phase 4 {gap:.3e}")
        if res.outer_iters != main_solve.outer_iters or gap > AGREE_TOL or not res.converged:
            fail(f"sharded vs phase 4: {res.outer_iters} vs {main_solve.outer_iters} rounds, "
                 f"max|ΔF| {gap}")
        compare_top10(top_main, top10_lists(np, topk_exclusive, extract_outputs, res.F, norm,
                                            known), "sharded vs phase 4")
        stale = ShardedHeteroLP(cfg, stale_sync=4, device=dev).run(norm, mesh)
        gap_st = float(np.max(np.abs(stale.F - res.F)))
        log(f"  stale_sync=4: {stale.outer_iters} rounds, max|ΔF| vs the synchronous solve "
            f"{gap_st:.3e} (gate 1e-3)")
        if gap_st > 1e-3 or stale.outer_iters < res.outer_iters:
            fail(f"stale_sync=4: max|ΔF| {gap_st}, {stale.outer_iters} rounds")
        bf = ShardedHeteroLP(cfg, compression="bf16", device=dev).run(norm, mesh)
        gap_bf = float(np.max(np.abs(bf.F - main_solve.F)))
        log(f"  compression bf16: {bf.outer_iters} rounds, max|ΔF| vs phase 4 {gap_bf:.3e} "
            f"(gate {AGREE_TOL})")
        if gap_bf > AGREE_TOL:
            fail(f"bf16 compression: max|ΔF| {gap_bf}")
        del stale, bf
        cfg1 = LPConfig(alg="dhlp1", alpha=0.5, sigma=1e-4, autotune=False)
        t0 = time.perf_counter()
        r1 = make_engine("sharded", cfg1, device=dev).run(net)
        wall1 = time.perf_counter() - t0
        gap1 = float(np.max(np.abs(r1.F - dhlp1_solve.F)))
        log(f"  sharded DHLP-1 all-sources: {r1.outer_iters} outer / {r1.inner_iters} inner "
            f"rounds in {wall1:.3f} s (phase 7 sparse: {dhlp1_solve.outer_iters} / "
            f"{dhlp1_solve.inner_iters}); max|ΔF| {gap1:.3e}")
        if (r1.outer_iters, r1.inner_iters) != (dhlp1_solve.outer_iters, dhlp1_solve.inner_iters) \
                or gap1 > AGREE_TOL:
            fail(f"sharded DHLP-1 vs phase 7: rounds {(r1.outer_iters, r1.inner_iters)}, "
                 f"max|ΔF| {gap1}")
        del r1

        run_dir = fresh_run_dir("sharded_drugnet")
        proc, wall_cli = run_cli(["run", "--network", "drugnet", "--backend", "sharded",
                                  "--devices", "1", "--device", CLI_DEVICE, "--top-k", "10",
                                  "--run-id", "sharded_drugnet", "--results-root",
                                  str(OUT_ROOT)])
        if proc.returncode != 0:
            fail(f"run --backend sharded --devices 1 exited {proc.returncode}: "
                 f"{proc.stderr[-2000:]}")
        solve_doc = json.loads((run_dir / "solve.json").read_text())
        if solve_doc.get("backend") != "sharded" or not solve_doc.get("converged"):
            fail(f"run --backend sharded: solve.json {solve_doc}")
        log(f"  python -m repro_torch run --network drugnet --backend sharded --devices 1: exit 0 "
            f"in {wall_cli:.1f} s, {solve_doc['outer_iters']} rounds, top-10 of drug 0 "
            f"{solve_doc['ranking']['candidates']}")

        sv = dict(lp=LPConfig(alg="dhlp2", seed_mode="fixed", sigma=1e-4, autotune=False),
                  max_batch=32)
        served = {name: LPServeEngine(net, ServeConfig(engine=name, **sv), device=dev)
                  for name in ("sharded", "kernel")}
        t_q = {name: 0.0 for name in served}
        for d in range(SHARDED_SERVE_QUERIES):
            got = {}
            for name, engine in served.items():
                t0 = time.perf_counter()
                got[name] = engine.query(QuerySpec(entity=d, target_type=2, top_k=10))
                t_q[name] += time.perf_counter() - t0
            if list(got["sharded"].candidates) != list(got["kernel"].candidates):
                fail(f"drug {d}: sharded serve top-10 {list(got['sharded'].candidates)} vs "
                     f"kernel {list(got['kernel'].candidates)}")
        log(f"  {SHARDED_SERVE_QUERIES} queries one by one: sharded and kernel serve engines "
            f"give equal top-10 lists; {t_q['sharded'] / SHARDED_SERVE_QUERIES * 1e3:.2f} vs "
            f"{t_q['kernel'] / SHARDED_SERVE_QUERIES * 1e3:.2f} ms a query")

        state = torch.as_tensor(res.F, dtype=torch.float32, device=dev)
        meshes = []

        def to_mesh(k):
            meshes.append(make_mesh((k,), ("data",), device=dev))
            return {"F": MeshSharding(meshes[-1], (Shard(0),))}

        cm = CheckpointManager(str(fresh_run_dir("sharded_remesh")))
        out, plan = remesh(cm, {"F": state}, healthy_devices=1, current_devices=2,
                           make_shardings=to_mesh, step=res.outer_iters)
        back = out["F"].full_tensor()
        if plan["to"] != 1 or meshes[0].size() != 1 or not torch.equal(back, state):
            fail(f"remesh onto a 1-device mesh: plan {plan}, equal {torch.equal(back, state)}")
        log(f"  remesh {plan}: the solve's state restored as a DTensor on "
            f"{out['F'].device_mesh}, bit-identical")
    finally:
        destroy_owned_world()


# Phase 15: the dhlp-bio step at the paper's Table 5-6 scales (B3) and the
# rest of the GNN zoo at FULL width (B4 in SAGE).  Runs before phase 14's
# kernel list, which counts its launches.
DHLP_SCALES = ("scale_1m", "scale_20m")
# columns of the per-bucket B3 gate (None: all S): at scale_20m the plain
# version's gathers of the hub bucket cannot be held whole
DHLP_GATE_COLS = {"scale_1m": None, "scale_20m": 512}
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)  # a module on the card vs the same module on the CPU
ZOO_ITERS = 5  # timed calls per measurement (CUDA events, one pair a call; the median)


def event_median_ms(torch, fn, *, iters: int = ZOO_ITERS) -> float:
    """Median device time of ``fn`` over ``iters`` calls, one CUDA event
    pair a call, after one untimed call."""
    import statistics

    fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(statistics.median(times))


class SubPhase:
    """Logs a sub-phase's seconds and its peak ``max_memory_allocated``."""

    def __init__(self, torch, label: str):
        self.torch, self.label = torch, label

    def __enter__(self):
        self.torch.cuda.synchronize()
        self.torch.cuda.empty_cache()
        self.torch.cuda.reset_peak_memory_stats()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.torch.cuda.synchronize()
            log(f"  [{self.label}: {time.perf_counter() - self.t0:.1f} s, peak device memory "
                f"{self.torch.cuda.max_memory_allocated() / 1e9:.2f} GB]")
        return False


def same_as_cpu(np, name, got, want) -> float:
    """The module on the card against the same module on the CPU: finite, of
    the same shape, within ``MODEL_TOL``."""
    got = got.float().cpu().numpy()
    want = want.float().cpu().numpy()
    if got.shape != want.shape or not np.isfinite(got).all():
        fail(f"{name}: shape {got.shape} vs {want.shape} or non-finite values on the card")
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    if not np.allclose(got, want, **MODEL_TOL):
        fail(f"{name}: the card disagrees with the CPU, max|Δ|={err}")
    log(f"  {name}: max|Δ| card vs CPU = {err:.3e} (rtol={MODEL_TOL['rtol']}, "
        f"atol={MODEL_TOL['atol']})")
    return err


def f64_row_sums(torch, nbr, wgt, live, F, base, c, rows, chunk: int = 1 << 18):
    """``c·base + Σ_k wgt·F[nbr]`` of the given rows of a bucket, in f64
    (their live slots, ``chunk`` at a time)."""
    out = torch.empty((len(rows), F.shape[1]), dtype=torch.float64, device=F.device)
    for i, r in enumerate(rows):
        acc = c * base[r].double()
        for k0 in range(0, int(live.lengths[r]), chunk):
            k1 = min(k0 + chunk, int(live.lengths[r]))
            acc += wgt[r, k0:k1].double() @ F[nbr[r, k0:k1].long()].double()
        out[i] = acc
    return out


def dhlp_bio_phase(torch, np, dev, shape: str, *, bf16: bool) -> dict:
    """Phase 15 (a) at one ``LP_SHAPES`` point (and (b), the bf16 step, when
    ``bf16``): the ``powerlaw_graph`` network, the operator α·D^-1/2 A
    D^-1/2, Y the identity on the first S nodes and F0 = Y; the cell's step
    through B3 held to the plain step (``scatter_spmm`` in column chunks) at
    ``F32_TOL``; B3 on every bucket held to ``csr_round_ref`` and the
    planted faults rejected; B3's time per round beside its bounds, the
    widest bucket's share and ``torch.addmm`` over the CSR operator."""
    from repro_torch.configs import dhlp_bio
    from repro_torch.configs.registry import get_arch
    from repro_torch.graph.segment import gcn_norm
    from repro_torch.graph.structures import powerlaw_graph
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.segment_reduce import LiveRows, csr_round_op, csr_round_ref

    cfg = dhlp_bio.FULL
    sh = dhlp_bio.LP_SHAPES[shape]
    n, e, s = sh["num_nodes"], sh["num_edges"], sh["seeds"]
    beta2 = (1.0 - cfg.alpha) ** 2
    res = {}
    with SubPhase(torch, f"{shape} network and plan"):
        t0 = time.perf_counter()
        g = powerlaw_graph(n, e, seed=0, device=dev)
        src, dst = (torch.from_numpy(a).to(dev) for a in (g.src, g.dst))
        w = cfg.alpha * gcn_norm(src, dst, torch.ones(e, device=dev), n)
        Y = torch.zeros((n, s), device=dev)
        Y[torch.arange(s, device=dev), torch.arange(s, device=dev)] = 1.0
        torch.cuda.synchronize()
        t_host = time.perf_counter() - t0
        deg = np.bincount(g.dst, minlength=n)
        nnz = int(torch.count_nonzero(w))
        log(f"  {shape}: powerlaw_graph({n}, {e}, seed=0) and the operator in {t_host:.2f} s "
            f"(numpy draws on the host, the sort and D^-1/2 A D^-1/2 on the card); "
            f"{nnz} nonzero weights; node {int(deg.argmax())} has the most in-edges, "
            f"{int(deg.max())}; S = {s}")
        t0 = time.perf_counter()
        plan = dhlp_bio.lp_plan(src, dst, w, n)
        torch.cuda.synchronize()
        t_plan = time.perf_counter() - t0
        buckets = plan.buckets
        widths = [int(nbr.shape[1]) for _, nbr, _, _ in buckets]
        wi = int(np.argmax(widths))
        live_slots = sum(lv.slots for _, _, _, lv in buckets)
        slots = sum(int(nbr.numel()) for _, nbr, _, _ in buckets)
        _, gathered = gather_counts([(nbr, wgt, lv) for _, nbr, wgt, lv in buckets])
        log(f"  plan (BlockedCSR.from_edges on the host, the legacy upload): {t_plan:.2f} s; "
            f"{len(buckets)} buckets, {slots} slots, padding ratio {1 - live_slots / slots:.4f}; "
            f"{live_slots} live slots (nonzeros {nnz}); widest bucket {wi}: "
            f"{buckets[wi][1].shape[0]} x {widths[wi]}, its longest row "
            f"{int(buckets[wi][3].lengths.max())} live slots")
        if live_slots != nnz:
            fail(f"{shape} plan: {live_slots} live slots for {nnz} nonzero weights")

    with SubPhase(torch, f"{shape} step through B3, held to the plain step"):
        cell = get_arch("dhlp-bio").make_cell(shape)
        args = (src, dst, w, Y, Y.clone())
        got_specs = [(tuple(a.shape), a.dtype) for a in args]
        want_specs = [(sp.shape, sp.dtype) for sp in cell.input_specs]
        if got_specs != want_specs:
            fail(f"{shape}: inputs {got_specs}, the cell's specs {want_specs}")
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = cell.step_fn(*args)
        torch.cuda.synchronize()
        t_step = time.perf_counter() - t0
        counts = launch_counts()
        want_launches = cfg.rounds_per_step * len(buckets)
        if counts["csr_round"] != want_launches or sum(counts.values()) != want_launches:
            fail(f"{shape} step launched {counts}, expected {want_launches} csr_round")
        res["b3"] = counts["csr_round"]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        plain = dhlp_bio.lp_step_plain(cfg, *args)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end) / cfg.rounds_per_step
        err = check_close(np, f"dhlp-bio {shape} step ({cfg.rounds_per_step} rounds) through "
                          "B3 vs the plain step", out, plain, F32_TOL)
        del plain
        log(f"  the cell's step: {t_step:.2f} s wall (plan build and {cfg.rounds_per_step} rounds, "
            f"{res['b3']} csr_round launches); plain step {plain_ms:.2f} ms a round "
            f"(scatter_spmm in chunks of {max(1, dhlp_bio.PLAIN_MESSAGE_BUDGET // e)} columns)")

    with SubPhase(torch, f"{shape} B3 on every bucket, planted faults"):
        cols = DHLP_GATE_COLS[shape] or s
        gen = torch.Generator(device=dev).manual_seed(15)
        Fg = torch.rand((n, cols), generator=gen, device=dev)
        Yg = Y[:, :cols].contiguous()
        bucket_err = 0.0
        for rows, nbr, wgt, live in buckets:
            got = csr_round_op(nbr, wgt, Fg, Yg[rows], c=beta2, live=live)
            torch.cuda.synchronize()
            bucket_err = max(bucket_err, check_close(
                np, f"csr_round {shape} bucket {nbr.shape[0]}x{nbr.shape[1]}", got,
                csr_round_ref(nbr, wgt, Fg, Yg[rows], beta2), F32_TOL, quiet=True))
        log(f"  csr_round f32 on all {len(buckets)} buckets (S = {cols}): max|Δ| vs plain "
            f"{bucket_err:.3e} (rtol={F32_TOL['rtol']}, atol={F32_TOL['atol']})")
        rows, nbr, wgt, live = buckets[wi]
        base_w = Yg[rows]
        longest = torch.argsort(live.lengths, descending=True)[:4].tolist()
        exact = f64_row_sums(torch, nbr, wgt, live, Fg, base_w, beta2, longest)
        k_err = float((csr_round_op(nbr, wgt, Fg, base_w, c=beta2, live=live)[longest].double()
                       - exact).abs().max())
        p_err = float((csr_round_ref(nbr, wgt, Fg, base_w, beta2)[longest].double()
                       - exact).abs().max())
        log(f"  widest bucket, its {len(longest)} longest rows ({int(live.lengths[longest[0]])} "
            f"slots and down) vs an f64 sum: kernel max|Δ| {k_err:.3e}, plain {p_err:.3e} "
            f"(values up to {float(exact.abs().max()):.3f})")
        short = LiveRows((live.lengths - 1).clamp_min(0), 0)
        ok, s_err = agrees(np, csr_round_op(nbr, wgt, Fg, base_w, c=beta2, live=short),
                           csr_round_ref(nbr, wgt, Fg, base_w, beta2), F32_TOL)
        if ok:
            fail(f"csr_round {shape} widest bucket: the gate accepted every row one live slot "
                 "short")
        log(f"  csr_round {shape} widest bucket: planted fault 'live - 1 on every row' rejected "
            f"(max|Δ| {s_err:.3e})")
        # both planted faults on the bucket of the most rows: in the widest one
        # every row names node 0, the pads' id, among its live slots, so a NaN
        # in F row 0 reaches every row through a live slot as well
        rows, nbr, wgt, live = max(buckets, key=lambda b: b[1].shape[0])
        base_m = Yg[rows]
        round_fault_checks(
            torch, np, f"csr_round {shape} bucket of the most rows ({nbr.shape[0]}x"
            f"{nbr.shape[1]}, S = {cols})", nbr, live, Fg,
            lambda nb, lv, F_: csr_round_op(nb, wgt, F_, base_m, c=beta2, live=lv),
            lambda F_: csr_round_ref(nbr, wgt, F_, base_m, beta2),
        )
        del Fg, Yg, base_w, base_m
    res["err"] = max(err, bucket_err)

    with SubPhase(torch, f"{shape} B3 timed"):
        F = out
        bases = [Y[r] for r, _, _, _ in buckets]
        bucket_out = torch.empty_like(F)
        offs = np.cumsum([0] + [int(nbr.shape[0]) for _, nbr, _, _ in buckets])

        def b3_round():
            for i, (_, nbr, wgt, live) in enumerate(buckets):
                csr_round_op(nbr, wgt, F, bases[i], c=beta2, live=live,
                             out=bucket_out[int(offs[i]):int(offs[i + 1])])

        rows, nbr, wgt, live = buckets[wi]
        ms = event_median_ms(torch, b3_round)
        wide_ms = event_median_ms(torch, lambda: csr_round_op(
            nbr, wgt, F, bases[wi], c=beta2, live=live,
            out=bucket_out[int(offs[wi]):int(offs[wi + 1])]))
        a_csr = torch.sparse_coo_tensor(torch.stack([dst.long(), src.long()]), w, (n, n),
                                        check_invariants=True).coalesce().to_sparse_csr()
        lib_ms = event_median_ms(torch, lambda: torch.addmm(Y, a_csr, F, beta=beta2))
        del a_csr, bases, bucket_out
        bound_ms, by = bound(2.0 * nnz * s, 4.0 * n * s * 3 + 8.0 * live_slots + 4.0 * n)
        floor_ms = 4.0 * gathered * s / PEAK_BYTES * 1e3
        log(f"  csr_round per round ({len(buckets)} launches, S = {s}): {ms:.4f} ms median of "
            f"{ZOO_ITERS}; the widest bucket alone {wide_ms:.4f} ms ({wide_ms / ms:.3f} of the "
            f"round); plain {plain_ms:.4f} ms; torch.addmm(CSR) {lib_ms:.4f} ms; bound "
            f"{bound_ms:.4f} ms ({by}); HBM floor of the live gathers ({gathered} slots x S x "
            f"4 B = {4.0 * gathered * s / 1e9:.2f} GB) {floor_ms:.4f} ms, {ms / floor_ms:.2f}x")
    res.update(ms=ms, wide_ms=wide_ms, plain_ms=plain_ms, lib_ms=lib_ms, bound_ms=bound_ms,
               floor_ms=floor_ms, buckets=len(buckets))

    if bf16:
        import dataclasses
        import os

        with SubPhase(torch, f"{shape} bf16 step (REPRO_LP_DTYPE=bf16)"):
            old = os.environ.get("REPRO_LP_DTYPE")
            os.environ["REPRO_LP_DTYPE"] = "bf16"
            try:
                cell = get_arch("dhlp-bio").make_cell(shape)
            finally:
                if old is None:
                    os.environ.pop("REPRO_LP_DTYPE")
                else:
                    os.environ["REPRO_LP_DTYPE"] = old
            bf = (src, dst) + tuple(x.to(torch.bfloat16) for x in (w, Y, Y))
            if [sp.dtype for sp in cell.input_specs] != [a.dtype for a in bf]:
                fail(f"{shape} bf16 cell specs {cell.input_specs}")
            reset_launch_counts()
            out_bf = cell.step_fn(*bf)
            torch.cuda.synchronize()
            n_bf = launch_counts()["csr_round"]
            if out_bf.dtype != torch.bfloat16 or n_bf != want_launches:
                fail(f"{shape} bf16 step: dtype {out_bf.dtype}, {n_bf} csr_round launches")
            res["b3"] += n_bf
            check_close(np, f"dhlp-bio {shape} bf16 step through B3 vs (a)'s f32 step", out_bf,
                        out, BF16_TOL)
            plan_bf = dhlp_bio.lp_plan(src, dst, bf[2], n)
            one = dataclasses.replace(cfg, rounds_per_step=1)
            ms_bf = event_median_ms(torch, lambda: dhlp_bio.lp_rounds(plan_bf, bf[3], out_bf, one))
            log(f"  bf16 round ({len(plan_bf.buckets)} csr_round launches and the row gathers "
                f"around them) {ms_bf:.4f} ms")
            del out_bf, plan_bf
    return res


def gnn_zoo_phase(torch, np, dev) -> dict:
    """Phase 15 (c): GAT at ``full_graph_sm`` and ``ogb_products``; SAGE
    (the configs of ``gat-cora`` and ``gcn-cora``) at ``minibatch_lg``,
    sampled from ``erdos_renyi`` with B4 at both hops held to its plain
    version; DimeNet and MeshGraphNet at ``molecule``, MeshGraphNet at
    ``minibatch_lg``'s padded union sizes.  Every output finite; at
    ``full_graph_sm`` and ``molecule`` held to the same module on the CPU
    at ``MODEL_TOL``; each forward timed.  Returns B4's launches and error."""
    import copy
    import dataclasses

    from repro_torch.configs import cells, dimenet, gat_cora, gcn_cora, meshgraphnet
    from repro_torch.configs.cells import pad512
    from repro_torch.data.graphs import mesh_rollout_batch, molecule_batch
    from repro_torch.graph.sampler import CSRAdjacency, NeighborSampler, relabel_to_local
    from repro_torch.graph.structures import erdos_renyi
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.segment_reduce import csr_aggregate_op, csr_aggregate_ref
    from repro_torch.models import gnn

    res = {"b4": 0, "b4_err": 0.0}

    def on_card_and_cpu(name, model_cpu, *args):
        """The forward on the card (no kernel launch), held to the CPU; timed."""
        model = copy.deepcopy(model_cpu).to(dev)
        dargs = [a.to(dev) if torch.is_tensor(a) else a for a in args]
        reset_launch_counts()
        got = model(*dargs)
        torch.cuda.synchronize()
        if sum(launch_counts().values()):
            fail(f"{name}: launched {launch_counts()}, expected no kernel of the port")
        same_as_cpu(np, name, got, model_cpu(*args))
        log(f"    forward {event_median_ms(torch, lambda: model(*dargs)):.4f} ms "
            f"(median of {ZOO_ITERS})")

    def finite(name, out, shape):
        if tuple(out.shape) != shape or not bool(torch.isfinite(out).all()):
            fail(f"{name}: output {tuple(out.shape)} (expected {shape}) or non-finite values")

    with SubPhase(torch, "GAT full_graph_sm"):
        sh = cells.GNN_SHAPES["full_graph_sm"]
        n, e = pad512(sh["n_nodes"]), pad512(sh["n_edges"])
        cfg = dataclasses.replace(gat_cora.FULL, d_feat=sh["d_feat"], n_classes=sh["n_classes"])
        g = erdos_renyi(n, e, seed=0, device=dev)
        feats = np.random.default_rng(0).normal(0, 1, (n, sh["d_feat"])).astype(np.float32)
        model = gnn.GAT(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        log(f"  GAT {cfg.name} at full_graph_sm: {n} nodes, {e} edges (erdos_renyi, seed 0)")
        on_card_and_cpu("GAT full_graph_sm logits", model, torch.from_numpy(feats),
                        torch.from_numpy(g.src), torch.from_numpy(g.dst))

    with SubPhase(torch, "GAT ogb_products"):
        sh = cells.GNN_SHAPES["ogb_products"]
        n, e = pad512(sh["n_nodes"]), pad512(sh["n_edges"])
        cfg = dataclasses.replace(gat_cora.FULL, d_feat=sh["d_feat"], n_classes=sh["n_classes"])
        t0 = time.perf_counter()
        g = erdos_renyi(n, e, seed=0, device=dev)
        src, dst = (torch.from_numpy(a).to(dev) for a in (g.src, g.dst))
        del g
        torch.cuda.synchronize()
        log(f"  GAT at ogb_products: erdos_renyi({n}, {e}, seed=0) built in "
            f"{time.perf_counter() - t0:.1f} s (numpy draws on the host, the sort on the card)")
        gen = torch.Generator(device=dev).manual_seed(0)
        feats = torch.randn((n, sh["d_feat"]), generator=gen, device=dev)
        model = gnn.GAT(cfg, generator=gen, device=dev)
        reset_launch_counts()
        out = model(feats, src, dst)
        torch.cuda.synchronize()
        finite("GAT ogb_products logits", out, (n, sh["n_classes"]))
        ms = event_median_ms(torch, lambda: model(feats, src, dst), iters=3)
        log(f"    logits {tuple(out.shape)} finite; forward {ms:.4f} ms (median of 3; "
            f"messages added in chunks of {gnn.GAT_EDGE_CHUNK} edges)")
        del out, feats, src, dst, model

    with SubPhase(torch, "SAGE minibatch_lg"):
        sh = cells.GNN_SHAPES["minibatch_lg"]
        t0 = time.perf_counter()
        g = erdos_renyi(sh["n_nodes"], sh["n_edges"], seed=0, device=dev)
        adj = CSRAdjacency.from_edgelist(g, device=dev)
        del g
        t_graph = time.perf_counter() - t0
        t0 = time.perf_counter()
        sampler = NeighborSampler(adj, sh["fanouts"], seed=0)
        seeds = np.random.default_rng(0).choice(sh["n_nodes"], sh["batch_nodes"], replace=False)
        all_nodes, hops_np = relabel_to_local(sampler.sample(seeds))
        t_sample = time.perf_counter() - t0
        del adj, sampler
        u = int(all_nodes.shape[0])
        log(f"  erdos_renyi({sh['n_nodes']}, {sh['n_edges']}, seed=0) and its CSR adjacency in "
            f"{t_graph:.1f} s; NeighborSampler fanouts {tuple(sh['fanouts'])} from "
            f"{sh['batch_nodes']} seeds in {t_sample:.2f} s: {u} nodes (the cell pads to "
            f"{cells._union_sizes(sh)[0]}), hops "
            + ", ".join(f"{h[1].shape[0]}x{h[1].shape[1]}" for h in hops_np))
        hops = [tuple(torch.from_numpy(x).to(dev) for x in h) for h in hops_np]
        gen = torch.Generator(device=dev).manual_seed(0)
        feats = torch.randn((u, sh["d_feat"]), generator=gen, device=dev)
        real_op = gnn.csr_aggregate_op
        for arch, cfg0 in (("gat-cora", gat_cora.FULL), ("gcn-cora", gcn_cora.FULL)):
            is_gat = arch == "gat-cora"
            scfg = gnn.SageConfig(
                name=cfg0.name, d_feat=sh["d_feat"],
                d_hidden=max(cfg0.d_hidden * (cfg0.n_heads if is_gat else 1), 64),
                n_classes=sh["n_classes"], fanouts=tuple(sh["fanouts"]))
            model = gnn.SAGE(scfg, generator=gen, device=dev)
            calls = []

            def recording(nbr, wgt, F, **kw):  # keeps each hop's operands for the B4 gate
                calls.append((nbr, wgt, F))
                return real_op(nbr, wgt, F, **kw)

            gnn.csr_aggregate_op = recording
            reset_launch_counts()
            try:
                logits = model(feats, hops)
                torch.cuda.synchronize()
            finally:
                gnn.csr_aggregate_op = real_op
            counts = launch_counts()
            if counts["csr_aggregate"] != len(hops) or sum(counts.values()) != len(hops):
                fail(f"SAGE {arch}: launched {counts}, expected {len(hops)} csr_aggregate")
            res["b4"] += counts["csr_aggregate"]
            finite(f"SAGE {arch} logits", logits, (sh["batch_nodes"], sh["n_classes"]))
            for k, (nbr, wgt, F) in enumerate(calls):
                tag = (f"csr_aggregate SAGE {arch} hop {len(calls) - 1 - k} "
                       f"({nbr.shape[0]}x{nbr.shape[1]}, S={F.shape[1]})")
                res["b4_err"] = max(res["b4_err"], check_close(
                    np, tag, csr_aggregate_op(nbr, wgt, F), csr_aggregate_ref(nbr, wgt, F),
                    F32_TOL))
                log(f"    kernel {event_median_ms(torch, lambda: csr_aggregate_op(nbr, wgt, F)):.4f}"
                    f" ms, plain {event_median_ms(torch, lambda: csr_aggregate_ref(nbr, wgt, F)):.4f}"
                    " ms")
            model.use_kernel = False
            check_close(np, f"SAGE {arch} logits, kernel path vs plain path", logits,
                        model(feats, hops), F32_TOL)
            model.use_kernel = True
            log(f"    SAGE {arch} (d_hidden {scfg.d_hidden}) forward "
                f"{event_median_ms(torch, lambda: model(feats, hops)):.4f} ms")
        del feats, hops, calls, logits, model

    with SubPhase(torch, "DimeNet molecule"):
        sh = cells.GNN_SHAPES["molecule"]
        b = molecule_batch(sh["batch"], nodes_per=sh["n_nodes"], edges_per=sh["n_edges"], seed=0)
        n = int(b["z"].shape[0])
        cap = 4 * pad512(sh["n_edges"] * sh["batch"] * 2)
        kj, ji, mask = gnn.build_triplets(b["src"], b["dst"], n, max_triplets=cap)
        log(f"  DimeNet FULL at molecule: molecule_batch({sh['batch']}): {n} nodes, "
            f"{b['src'].shape[0]} edges, {int(mask.sum())} triplets padded to the cell's {cap}")
        model = gnn.DimeNet(dimenet.FULL, generator=torch.Generator().manual_seed(0),
                            device="cpu")
        args = [torch.from_numpy(a) for a in (b["z"], b["pos"], b["src"], b["dst"], kj, ji,
                                              mask, b["graph_ids"])]
        on_card_and_cpu("DimeNet molecule energies", model, *args, sh["batch"])

    with SubPhase(torch, "MeshGraphNet molecule and minibatch_lg"):
        mol = cells.GNN_SHAPES["molecule"]
        for shape, (n, e) in (
            ("molecule", (pad512(mol["n_nodes"] * mol["batch"]),
                          pad512(mol["n_edges"] * mol["batch"] * 2))),
            ("minibatch_lg", tuple(pad512(x) for x in cells._union_sizes(
                cells.GNN_SHAPES["minibatch_lg"]))),
        ):
            b = mesh_rollout_batch(n, e, seed=0)
            args = [torch.from_numpy(b[k]) for k in ("node_feat", "edge_feat", "src", "dst")]
            model = gnn.MeshGraphNet(meshgraphnet.FULL, generator=torch.Generator().manual_seed(0),
                                     device="cpu")
            log(f"  MeshGraphNet FULL at {shape}: mesh_rollout_batch({n}, {e})")
            if shape == "molecule":
                on_card_and_cpu(f"MeshGraphNet {shape} outputs", model, *args)
                continue
            model = model.to(dev)
            dargs = [a.to(dev) for a in args]
            out = model(*dargs)
            torch.cuda.synchronize()
            finite(f"MeshGraphNet {shape} outputs", out, (n, meshgraphnet.FULL.d_out))
            log(f"    outputs {tuple(out.shape)} finite; forward "
                f"{event_median_ms(torch, lambda: model(*dargs)):.4f} ms")
    return res


def zoo_phase(torch, np, dev) -> dict:
    """Phase 15: (a) ``dhlp-bio`` at ``DHLP_SCALES`` in f32, (b) its bf16
    step at the first, (c) the GNN zoo.  Returns B3's and B4's launches on
    these paths and their errors."""
    smi = smi_name_and_limit()
    out = {"b3": 0, "b3_err": 0.0}
    for i, shape in enumerate(DHLP_SCALES):
        log(f"== phase 15 (a{', b' if i == 0 else ''}): dhlp-bio at {shape} ({smi})")
        r = dhlp_bio_phase(torch, np, dev, shape, bf16=(i == 0))
        out["b3"] += r["b3"]
        out["b3_err"] = max(out["b3_err"], r["err"])
        out[shape] = r
    log(f"== phase 15 (c): the GNN zoo at FULL width ({smi})")
    out.update(gnn_zoo_phase(torch, np, dev))
    return out


# phase 17: the MoE and MLA models (queue A.9.3).  Each cut of a published
# cell is a constant here, named in the phase's log lines.
MOE_PREFILL_BATCH = 1  # prefill_32k at batch 1, cut from 32
MOE_DECODE_SLOTS = 4096  # decode_32k's cache, cut from 32,768 slots
MOE_AGREE_PROMPT, MOE_AGREE_STEPS = 2048, 8  # (b): the f32 layer-by-layer comparison
TIE_GAP = 1e-5  # (b): a top-k may differ only where p_k - p_(k+1) is below this
MLA_PREFILL = 8192  # (c): prefill at batch 1, cut from 32 x 32,768
MLA_DECODE_PROMPT, MLA_DECODE_STEPS = 512, 32  # (c): decode at batch 128, 4,096 slots
MLA_AGREE_LAYERS, MLA_AGREE_PROMPT, MLA_AGREE_STEPS = 2, 64, 4  # (c): f32 at full width
MOONSHOT_LAYERS = 8  # (d): depth cut from 48
MOONSHOT_PREFILL, MOONSHOT_DECODE_BATCH, MOONSHOT_STEPS = 8192, 32, 32


def flash_launches(torch, what: str, want: int) -> int:
    """B6's launches since the last reset: ``want``, and no other kernel's."""
    from repro_torch.kernels import launch_counts

    counts = launch_counts()
    n = counts["flash_attention"]
    if n != want or sum(counts.values()) != n:
        fail(f"{what}: launched {counts}, expected {want} flash_attention")
    return n


def make_lm(torch, cfg, dev, seed: int):
    """The model on the card from a seed; logs its parameters and bytes."""
    from repro_torch.models.transformer import Transformer

    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = Transformer(cfg, generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    torch.cuda.synchronize()
    log(f"  {cfg.name} ({cfg.n_layers} layers, {str(cfg.dtype).split('.')[-1]}): "
        f"{cfg.param_count()} parameters, {(torch.cuda.memory_allocated() - mem0) / 1e9:.2f} GB "
        f"stored (padded experts and vocab), made on the card in {time.perf_counter() - t0:.2f} s")
    return model


def lm_walls(torch, label, fn, tokens: int, iters: int) -> float:
    """Median wall of ``iters`` calls after the one already made; logs
    tokens/s."""
    walls = sorted(wall_s(torch, fn, iters=iters))
    med = walls[len(walls) // 2]
    log(f"  {label}: {', '.join(f'{t:.4f}' for t in walls)} s; median {med:.4f} s, "
        f"{tokens / med:.0f} tokens/s")
    return med


def decode_run(torch, np, model, prefill, decode_step, caches, batch, prompt, group, steps, rng,
               batch_slice):
    """Fill ``caches`` by prefills of ``group`` rows of ``prompt`` tokens,
    then ``steps`` greedy steps: the fill seconds, each step's seconds and
    the last logits."""
    cfg = model.cfg
    toks = rng.integers(0, cfg.vocab, (batch, prompt))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last = [prefill(toks[g:g + group], batch_slice(caches, g, g + group))[0]
            for g in range(0, batch, group)]
    torch.cuda.synchronize()
    t_fill = time.perf_counter() - t0
    tok = torch.cat(last).argmax(-1, keepdim=True)
    walls = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, _ = decode_step(caches, tok, prompt + i)
        tok = lg.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    if not torch.isfinite(lg[:, :cfg.vocab]).all() or tok.shape != (batch, 1):
        fail(f"{cfg.name} decode: non-finite logits")
    return t_fill, walls, tok


def log_steps(label, walls, batch) -> float:
    srt = sorted(walls)
    med = srt[len(srt) // 2]
    log(f"  {label}: {len(walls)} greedy steps, median {med * 1e3:.3f} ms, min "
        f"{srt[0] * 1e3:.3f}, max {srt[-1] * 1e3:.3f} ms per step, {batch / med:.0f} tokens/s")
    return med


def gqa_slice(caches, a, b):
    return caches[:, :, a:b]


def mla_slice(caches, a, b):
    return caches[:, a:b]


def moe_dispatch_checks(torch, np, cfg, lp, x) -> float:
    """At one layer's FFN input ``x`` of a real prefill: the index dispatch
    held to the one-hot einsum version on the same routing (bf16 at
    ``BF16_TOL``, then the layer in f32 at ``F32_TOL``), and the routing
    held to its invariants.  Returns the bf16 max|Δ|."""
    import dataclasses
    import types

    from repro_torch.models import transformer as tf

    moe = cfg.moe
    errs = {}
    for dtype, tol in ((cfg.dtype, BF16_TOL), (torch.float32, F32_TOL)):
        c = dataclasses.replace(cfg, dtype=dtype)
        p = types.SimpleNamespace(**{n: getattr(lp, n).to(dtype) for n in
                                     ("router", "w_gate", "w_up", "w_down")})
        xt = tf._group(c, x.to(dtype))
        r = tf._route(c, p, xt)
        tag = f"{cfg.name} MoE dispatch {str(dtype).split('.')[-1]} at layer 0 of the prefill"
        errs[dtype] = check_close(np, f"{tag}, index vs one-hot einsums",
                                  tf._dispatch_index(c, p, xt, r),
                                  tf._dispatch_plain(c, p, xt, r), tol)
        n_g, g_sz, k = r.gate_idx.shape
        if int(r.gate_idx.max()) >= moe.num_experts:
            fail(f"{tag}: a padded expert was chosen")
        if not torch.equal(r.keep, r.pos < r.cap):
            fail(f"{tag}: keep is not pos < cap")
        group = torch.arange(n_g, device=x.device)[:, None, None]
        kept = ((r.gate_idx * n_g + group) * r.cap + r.pos)[r.keep]
        if kept.unique().numel() != kept.numel():
            fail(f"{tag}: a (g, e, c) slot holds two tokens")
        load = torch.zeros((n_g, moe.padded_experts), dtype=torch.long, device=x.device)
        load.scatter_add_(1, r.gate_idx.reshape(n_g, -1), torch.ones_like(r.gate_idx).reshape(
            n_g, -1))
        if int(r.keep.sum()) != int(load.clamp_max(r.cap).sum()):
            fail(f"{tag}: keep does not drop exactly the choices past the capacity")
        log(f"    routing: {n_g} groups of {g_sz}, capacity {r.cap}, "
            f"{int((~r.keep).sum())} of {r.keep.numel()} choices dropped, no padded expert, "
            "each slot at most one token")
        del xt, r, p
    return errs[cfg.dtype]


def moe_share_ms(torch, fn):
    """Run ``fn`` with CUDA events around each MoE FFN call: (the call's
    device span, the MoE FFNs' summed spans) in ms."""
    from repro_torch.models import transformer as tf

    real = tf._moe_ffn
    marks = []

    def timed(*a, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*a, **kw)
        end.record()
        marks.append((start, end))
        return out

    tf._moe_ffn = timed
    try:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    finally:
        tf._moe_ffn = real
    return start.elapsed_time(end), sum(a.elapsed_time(b) for a, b in marks)


def granite_serving(torch, np, dev) -> dict:
    """(a) granite-moe-3b-a800m FULL in bf16 on the kernel route."""
    from repro_torch.configs import cells, granite_moe_3b_a800m
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import transformer as tf
    from repro_torch.models.transformer import init_cache, make_decode_step, make_prefill

    cfg = granite_moe_3b_a800m.FULL
    rng = np.random.default_rng(17)
    res = {}
    with SubPhase(torch, "17 (a) model"):
        model = make_lm(torch, cfg, dev, 17)
    prefill, decode_step = make_prefill(model), make_decode_step(model)
    seq = cells.LM_SHAPES["prefill_32k"]["seq"]
    with SubPhase(torch, "17 (a) prefill_32k"):
        p_toks = rng.integers(0, cfg.vocab, (MOE_PREFILL_BATCH, seq))
        p_caches = init_cache(cfg, MOE_PREFILL_BATCH, seq, device=dev)
        seen = []
        real = tf._moe_ffn

        def keep_first(c, lp, x, *a, **kw):  # layer 0's FFN input, for the dispatch checks
            if not seen:
                seen.append((lp, x.clone()))
            return real(c, lp, x, *a, **kw)

        reset_launch_counts()
        tf._moe_ffn = keep_first
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = prefill(p_toks, p_caches)
            torch.cuda.synchronize()
        finally:
            tf._moe_ffn = real
        log(f"  prefill_32k (batch {MOE_PREFILL_BATCH}, cut from 32) x {seq} tokens: first call "
            f"{time.perf_counter() - t0:.3f} s")
        res["wall"] = lm_walls(torch, "prefill_32k walls", lambda: prefill(p_toks, p_caches),
                               MOE_PREFILL_BATCH * seq, 3)
        res["launches"] = flash_launches(torch, "granite prefill_32k", cfg.n_layers * 4)
        if logits.shape != (MOE_PREFILL_BATCH, cfg.padded_vocab) or not torch.isfinite(
                logits[:, :cfg.vocab]).all():
            fail(f"granite prefill_32k logits: shape {tuple(logits.shape)} or non-finite values")
        res["moe_err"] = moe_dispatch_checks(torch, np, cfg, *seen[0])
        del seen
        span, moe = moe_share_ms(torch, lambda: prefill(p_toks, p_caches))
        log(f"  MoE FFN share of one prefill_32k call (CUDA events around each layer's FFN): "
            f"{moe:.2f} of {span:.2f} ms, {moe / span:.3f}")
        res["moe_share"] = moe / span
        t_p, busy, by_name = trace_solve(torch, "granite prefill_32k",
                                         lambda: prefill(p_toks, p_caches))
        b6 = sum(t for name, (t, _) in by_name.items() if "flash_fwd" in name)
        log(f"  flash_attention share of the traced prefill: {b6 / busy:.3f} of device busy")
        del p_caches, logits
    batch = cells.LM_SHAPES["decode_32k"]["batch"]
    with SubPhase(torch, "17 (a) decode_32k"):
        caches = init_cache(cfg, batch, MOE_DECODE_SLOTS, device=dev)
        reset_launch_counts()
        t_fill, walls, tok = decode_run(torch, np, model, prefill, decode_step, caches, batch,
                                        DECODE_PROMPT, DECODE_GROUP, DECODE_STEPS, rng, gqa_slice)
        res["launches"] += flash_launches(
            torch, "granite decode_32k", cfg.n_layers * (batch // DECODE_GROUP + DECODE_STEPS))
        log(f"  decode_32k: batch {batch}, cache {MOE_DECODE_SLOTS} slots (cut from 32,768; "
            f"{caches.numel() * caches.element_size() / 1e9:.2f} GB), filled by "
            f"{batch // DECODE_GROUP} prefills of {DECODE_GROUP} x {DECODE_PROMPT} in "
            f"{t_fill:.3f} s")
        res["step"] = log_steps("decode_32k", walls, batch)
        t_p, busy, by_name = trace_solve(torch, "granite decode_32k step", lambda: decode_step(
            caches, tok, DECODE_PROMPT + DECODE_STEPS))
        b6 = sum(t for name, (t, _) in by_name.items() if "flash_fwd" in name)
        log(f"  flash_attention share of the traced decode step: {b6 / busy:.3f} of device busy")
        del caches
    del model
    return res


def granite_agreement(torch, np, dev) -> None:
    """(b) granite at full width in f32, kernel route vs plain route layer
    by layer, each layer's input the plain route's."""
    import dataclasses

    from repro_torch.configs import granite_moe_3b_a800m
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import rms_norm

    cfg = dataclasses.replace(granite_moe_3b_a800m.FULL, dtype=torch.float32)
    model = make_lm(torch, cfg, dev, 18)
    moe, k = cfg.moe, cfg.moe.top_k
    n = MOE_AGREE_PROMPT + MOE_AGREE_STEPS
    toks = torch.as_tensor(np.random.default_rng(18).integers(0, cfg.vocab, (1, n)), device=dev)
    caches = {r: tf.init_cache(cfg, 1, n, device=dev) for r in (True, False)}
    errs = {"attention": 0.0, "moe": 0.0}
    flips = tokens = knock_on = 0
    gaps = []
    calls = [(0, MOE_AGREE_PROMPT)] + [(p, p + 1) for p in range(MOE_AGREE_PROMPT, n)]
    for a, b in calls:
        x = model.embed[toks[:, a:b]]
        q_pos = torch.arange(b - a, device=dev) + a
        for i, lp in enumerate(model.layers):
            h = rms_norm(x, lp.norm_attn)
            att = {r: tf._attention(cfg, lp, h, q_pos, caches[r][i], a, r) for r in (True, False)}
            errs["attention"] = max(errs["attention"], check_close(
                np, f"layer {i} attention at {a}", att[True], att[False], F32_TOL, quiet=True))
            out, route = {}, {}
            for r in (True, False):
                f_in = rms_norm(x + att[r], lp.norm_ffn)
                route[r] = tf._route(cfg, lp, tf._group(cfg, f_in))
                out[r] = tf._moe_ffn(cfg, lp, f_in).reshape(-1, cfg.d_model)
            # each token's choices in expert order: the order among its top-k
            # changes only the summation order of its output
            (ik, kk), (ip, kp) = ((r.gate_idx.sort(-1), r.keep) for r in (route[True],
                                                                          route[False]))
            same_set = (ik.values == ip.values).all(-1)
            same = (same_set & (kk.gather(-1, ik.indices) == kp.gather(-1, ip.indices)).all(-1)
                    ).reshape(-1)
            tokens += same_set.numel()
            if not bool(same_set.all()):  # top-k flips: only at near-ties of the plain route
                xt = tf._group(cfg, rms_norm(x + att[False], lp.norm_ffn))
                logits = (xt @ lp.router).float()
                logits[..., moe.num_experts:] = -1e30
                p = torch.softmax(logits, -1).sort(-1, descending=True).values
                gap = (p[..., k - 1] - p[..., k])[~same_set]
                gaps += gap.tolist()
                flips += int((~same_set).sum())
                if float(gap.max()) >= TIE_GAP:
                    fail(f"layer {i} at {a}: a top-k differs where p_k - p_(k+1) = "
                         f"{float(gap.max()):.3e} >= {TIE_GAP}")
            # a flip moves later choices in its group's queues: those tokens'
            # keep may differ although their top-k does not
            moved = int((same_set.reshape(-1) & ~same).sum())
            if moved and bool(same_set.all()):
                fail(f"layer {i} at {a}: {moved} tokens kept other choices with no top-k flip")
            knock_on += moved
            if bool(same.any()):
                errs["moe"] = max(errs["moe"], check_close(
                    np, f"layer {i} MoE at {a}", out[True][same], out[False][same], F32_TOL,
                    quiet=True))
            x = x + att[False] + out[False].reshape(x.shape)
    log(f"  {cfg.name} f32, prefill {MOE_AGREE_PROMPT} + {MOE_AGREE_STEPS} steps, "
        f"{cfg.n_layers} layers each fed the plain route's input: attention max|Δ| kernel vs "
        f"plain {errs['attention']:.3e}, MoE max|Δ| on equal routing {errs['moe']:.3e} "
        f"(rtol={F32_TOL['rtol']}, atol={F32_TOL['atol']}); top-k flips {flips} of {tokens} "
        f"token-layers (every one at p_k - p_(k+1) < {TIE_GAP}: {gaps[:8]}), {knock_on} "
        "token-layers with the same top-k but another keep after a flip (not compared)")
    del model, caches


def minicpm3_serving(torch, np, dev) -> None:
    """(c) minicpm3-4b FULL in bf16, MLA absorbed on the plain route; then
    in f32 at full width and 2 layers, absorbed vs naive on the card and
    the card vs the CPU."""
    import dataclasses

    from repro_torch.configs import minicpm3_4b
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models.transformer import (
        Transformer, init_cache, make_decode_step, make_prefill)

    cfg = minicpm3_4b.FULL
    if not cfg.mla_absorbed:
        fail("minicpm3-4b: REPRO_MLA_ABSORBED=0 is set; phase 17 (c) serves the absorbed path")
    rng = np.random.default_rng(19)
    with SubPhase(torch, "17 (c) model"):
        model = make_lm(torch, cfg, dev, 19)
    prefill, decode_step = make_prefill(model), make_decode_step(model)
    with SubPhase(torch, "17 (c) prefill"):
        p_toks = rng.integers(0, cfg.vocab, (1, MLA_PREFILL))
        p_caches = init_cache(cfg, 1, MLA_PREFILL, device=dev)
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = prefill(p_toks, p_caches)
        torch.cuda.synchronize()
        log(f"  prefill batch 1 x {MLA_PREFILL} (cut from 32 x 32,768), absorbed MLA on the "
            f"plain route: first call {time.perf_counter() - t0:.3f} s")
        lm_walls(torch, "prefill walls", lambda: prefill(p_toks, p_caches), MLA_PREFILL, 1)
        flash_launches(torch, "minicpm3 prefill", 0)
        if not torch.isfinite(logits[:, :cfg.vocab]).all():
            fail("minicpm3 prefill: non-finite logits")
        del p_caches, logits
    batch = 128
    with SubPhase(torch, "17 (c) decode"):
        caches = init_cache(cfg, batch, MOE_DECODE_SLOTS, device=dev)
        t_fill, walls, _ = decode_run(torch, np, model, prefill, decode_step, caches, batch,
                                      MLA_DECODE_PROMPT, DECODE_GROUP, MLA_DECODE_STEPS, rng,
                                      mla_slice)
        flash_launches(torch, "minicpm3 decode", 0)
        log(f"  decode: batch {batch}, latent cache {MOE_DECODE_SLOTS} slots (cut from 32,768; "
            f"{caches.numel() * caches.element_size() / 1e9:.2f} GB), filled by "
            f"{batch // DECODE_GROUP} prefills of {DECODE_GROUP} x {MLA_DECODE_PROMPT} in "
            f"{t_fill:.3f} s")
        log_steps("decode", walls, batch)
        del caches
    del model
    with SubPhase(torch, "17 (c) f32 agreement"):
        c32 = dataclasses.replace(cfg, dtype=torch.float32, n_layers=MLA_AGREE_LAYERS)
        card = make_lm(torch, c32, dev, 20)
        host = Transformer(c32, generator=torch.Generator().manual_seed(0), device="cpu")
        host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
        n = MLA_AGREE_PROMPT + MLA_AGREE_STEPS
        toks = np.random.default_rng(20).integers(0, cfg.vocab, (2, n))

        def run(m, absorbed):
            m.cfg = dataclasses.replace(c32, mla_absorbed=absorbed)
            caches = init_cache(m.cfg, 2, n, device=m.device)
            out = [m.prefill(toks[:, :MLA_AGREE_PROMPT], caches)[0]]
            for p in range(MLA_AGREE_PROMPT, n):
                out.append(m.decode_step(caches, toks[:, p:p + 1], p)[0])
            return torch.stack(out), caches

        got, c_abs = run(card, True)
        naive, c_naive = run(card, False)
        check_close(np, f"{cfg.name} f32 {MLA_AGREE_LAYERS} layers, absorbed vs naive logits",
                    got, naive, F32_TOL)
        check_close(np, f"{cfg.name} f32 {MLA_AGREE_LAYERS} layers, absorbed vs naive latent "
                    "caches", c_abs, c_naive, F32_TOL)
        want, c_host = run(host, True)
        same_as_cpu(np, f"{cfg.name} f32 {MLA_AGREE_LAYERS} layers absorbed logits", got, want)
        same_as_cpu(np, f"{cfg.name} f32 {MLA_AGREE_LAYERS} layers latent cache", c_abs, c_host)
        del card, host


def moonshot_serving(torch, np, dev) -> dict:
    """(d) moonshot-v1-16b-a3b at full width, depth cut to 8 layers, bf16
    on the kernel route."""
    import dataclasses

    from repro_torch.configs import moonshot_v1_16b_a3b
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models.transformer import init_cache, make_decode_step, make_prefill

    cfg = dataclasses.replace(moonshot_v1_16b_a3b.FULL, n_layers=MOONSHOT_LAYERS)
    rng = np.random.default_rng(21)
    with SubPhase(torch, "17 (d) model"):
        model = make_lm(torch, cfg, dev, 21)
    prefill, decode_step = make_prefill(model), make_decode_step(model)
    res = {}
    with SubPhase(torch, "17 (d) prefill"):
        p_toks = rng.integers(0, cfg.vocab, (1, MOONSHOT_PREFILL))
        p_caches = init_cache(cfg, 1, MOONSHOT_PREFILL, device=dev)
        reset_launch_counts()
        logits, _ = prefill(p_toks, p_caches)
        torch.cuda.synchronize()
        lm_walls(torch, f"prefill batch 1 x {MOONSHOT_PREFILL} (depth cut from 48 to "
                 f"{MOONSHOT_LAYERS})", lambda: prefill(p_toks, p_caches), MOONSHOT_PREFILL, 3)
        res["launches"] = flash_launches(torch, "moonshot prefill", cfg.n_layers * 4)
        if not torch.isfinite(logits[:, :cfg.vocab]).all():
            fail("moonshot prefill: non-finite logits")
        del p_caches, logits
    with SubPhase(torch, "17 (d) decode"):
        batch = MOONSHOT_DECODE_BATCH
        caches = init_cache(cfg, batch, MOE_DECODE_SLOTS, device=dev)
        reset_launch_counts()
        t_fill, walls, _ = decode_run(torch, np, model, prefill, decode_step, caches, batch,
                                      DECODE_PROMPT, DECODE_GROUP, MOONSHOT_STEPS, rng, gqa_slice)
        res["launches"] += flash_launches(
            torch, "moonshot decode", cfg.n_layers * (batch // DECODE_GROUP + MOONSHOT_STEPS))
        log(f"  decode: batch {batch} (cut from 128), cache {MOE_DECODE_SLOTS} slots (cut from "
            f"32,768; {caches.numel() * caches.element_size() / 1e9:.2f} GB), filled by "
            f"{batch // DECODE_GROUP} prefills of {DECODE_GROUP} x {DECODE_PROMPT} in "
            f"{t_fill:.3f} s")
        log_steps("decode", walls, batch)
        del caches
    del model
    return res


def moe_mla_phase(torch, np, dev) -> dict:
    """Phase 17: (a) granite serving, (b) granite's f32 layer-by-layer
    agreement, (c) minicpm3, (d) moonshot.  Returns B6's launches on the
    serving paths of (a) and (d) and the MoE dispatch's error."""
    smi = smi_name_and_limit()
    log(f"== phase 17 (a): granite-moe-3b-a800m FULL, bf16, kernel route ({smi})")
    a = granite_serving(torch, np, dev)
    log(f"== phase 17 (b): granite-moe-3b-a800m full width, f32, kernel vs plain route ({smi})")
    with SubPhase(torch, "17 (b)"):
        granite_agreement(torch, np, dev)
    log(f"== phase 17 (c): minicpm3-4b FULL, bf16, absorbed MLA on the plain route ({smi})")
    minicpm3_serving(torch, np, dev)
    log(f"== phase 17 (d): moonshot-v1-16b-a3b full width, {MOONSHOT_LAYERS} layers, bf16 "
        f"({smi})")
    d = moonshot_serving(torch, np, dev)
    return {"launches": a["launches"] + d["launches"], "moe_err": a["moe_err"]}


# phase 18: training (queue A.9.4).  Runs before phase 14's kernel list,
# which counts B4's forward and backward launches here.  Each cut of a
# published cell is a constant, named in its log line.
TRAIN_STEPS = 20  # (b): timed steps of the GCN and SAGE cells
TRAIN_STEPS_OTHER = 5  # (b): steps of the GAT, DimeNet and MeshGraphNet cells; (c) W&D
LM_TRAIN_STEPS = 3  # (d)
LM_TRAIN_SEQ = 4096  # train_4k's sequence, not cut
LM_TRAIN_BATCHES = {"h2o-danube-1.8b": (8, 4, 2), "granite-moe-3b-a800m": (4, 2, 1)}  # cut from 256
CLI_TRAIN_STEPS, CLI_TRAIN_FAULT, CLI_RESUME_STEPS = 12, 5, 15  # (e): docs/runspec.md's example
# (b): MeshGraphNet's f32 gradients are held to an f64 run of the same
# step on the card (ROADMAP C.3: an f32 run on either side rounds its MLP
# activations, and the 15 LayerNorm'd residual blocks amplify that past
# MODEL_TOL; tools/train_grad_precision.py --bisect); a leaf still past it
# element for element is held in norm at this rtol: a wrong or missing
# term shows at O(1)
MGN_GRAD_NORM_RTOL = 1e-3


def tree_close(torch, np, name, got, want, tol) -> float:
    """Two trees of tensors (or a loss) leaf for leaf: finite, within ``tol``."""
    from repro_torch.optim import tree_leaves

    err = 0.0
    for i, (a, b) in enumerate(zip(tree_leaves(got), tree_leaves(want))):
        a, b = a.detach().float(), b.detach().float().to(a.device)
        if not bool(torch.isfinite(a).all()):
            fail(f"{name}: leaf {i} holds non-finite values")
        err = max(err, float((a - b).abs().max()) if a.numel() else 0.0)
        if tuple(a.shape) != tuple(b.shape) or not torch.allclose(a, b, **tol):
            fail(f"{name}: leaf {i} {tuple(a.shape)} differs, max|Δ| {err:.3e}")
    return err


def all_finite(torch, name, loss, grads) -> None:
    from repro_torch.optim import tree_leaves

    if not bool(torch.isfinite(loss)) or not all(bool(torch.isfinite(g).all())
                                                 for g in tree_leaves(grads)):
        fail(f"{name}: a non-finite loss or gradient")


def train_run(torch, name, step, params, state, batch, steps) -> tuple:
    """``steps`` train steps: each loss and wall (host clock to a
    synchronize); the loss must fall.  Returns (params, state, walls)."""
    losses, walls = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))  # synchronizes
        walls.append(time.perf_counter() - t0)
    if not all(np_isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"{name}: losses {losses} not finite or not falling")
    w = sorted(walls[1:]) or walls
    log(f"    {steps} steps: loss {losses[0]:.5f} -> {losses[-1]:.5f}; wall per step "
        f"{walls[0] * 1e3:.2f} ms first, median of the rest {w[len(w) // 2] * 1e3:.3f} ms")
    return params, state, walls


def np_isfinite(x: float) -> bool:
    return x == x and abs(x) != float("inf")


def gnn_train_batch(torch, np, dev, cell, shape, graph=None, seed=0) -> dict:
    """A batch under the cell's keys at its shapes, on the card: the graph
    ``(src, dst)`` given or drawn at random, GCN weights ``gcn_norm``'s,
    features and targets standard normal, labels uniform, half the nodes
    labelled; SAGE's hops drawn at random (not sampled from a graph) with
    distinct frontiers of local ids, 90 % of the slots live; DimeNet's
    batch real molecules (:func:`dimenet_batch`)."""
    from repro_torch.configs import cells
    from repro_torch.graph.segment import gcn_norm

    specs = cell.input_specs[2]
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for k, s in specs.items():
        if s.dtype == torch.float32:
            out[k] = torch.randn(s.shape, generator=gen, device=dev)
    n = next(iter(specs.values())).shape[0]
    if "src" in specs:
        e = specs["src"].shape[0]
        if graph is not None:
            out["src"], out["dst"] = graph
        else:
            out["src"] = torch.randint(0, n, (e,), generator=gen, device=dev, dtype=torch.int32)
            off = torch.randint(1, n, (e,), generator=gen, device=dev, dtype=torch.int32)
            out["dst"] = ((out["src"] + off) % n).int()
    if "w" in specs:
        out["w"] = gcn_norm(out["src"], out["dst"], torch.ones(e, device=dev), n)
    if "labels" in specs:
        n_cls = cells.GNN_SHAPES[shape]["n_classes"]
        out["labels"] = torch.randint(0, n_cls, specs["labels"].shape, generator=gen,
                                      device=dev, dtype=torch.int32)
    if "label_mask" in specs:
        out["label_mask"] = (torch.rand(n, generator=gen, device=dev) < 0.5).float()
    if "graph_ids" in specs:
        g = specs["targets"].shape[0]
        out["graph_ids"] = torch.sort(torch.randint(0, g, (n,), generator=gen, device=dev,
                                                    dtype=torch.int32)).values
    if "z" in specs:
        return dimenet_batch(torch, np, dev, specs)
    if "h0_f" in specs:
        b, f1 = specs["h0_n"].shape
        perm = torch.randperm(n, generator=gen, device=dev).int()
        out["h0_f"], out["h1_f"] = perm[:b].contiguous(), perm[b: b + b * f1].contiguous()
        for k in ("h0", "h1"):
            shp = specs[f"{k}_n"].shape
            out[f"{k}_n"] = torch.randint(0, n, shp, generator=gen, device=dev, dtype=torch.int32)
            out[f"{k}_m"] = torch.rand(shp, generator=gen, device=dev) < 0.9
    return out


def dimenet_batch(torch, np, dev, specs) -> dict:
    """DimeNet's ``molecule`` batch from ``molecule_batch`` (its geometry
    and targets): the 128 molecules' edges both ways fill the cell's
    16,384 edges, the nodes past the 3,840 real ones are isolated (graph
    127, species 0: no edge reaches them, their energy is 0), the
    triplets ``build_triplets``' capped at the cell's 65,536."""
    from repro_torch.data.graphs import molecule_batch
    from repro_torch.models.gnn import build_triplets

    n, e, t = specs["z"].shape[0], specs["src"].shape[0], specs["tri_kj"].shape[0]
    g = specs["targets"].shape[0]
    b = molecule_batch(g, nodes_per=30, edges_per=64, seed=0)
    src, dst = np.concatenate([b["src"], b["dst"]]), np.concatenate([b["dst"], b["src"]])
    if src.shape[0] != e or b["z"].shape[0] > n:
        fail(f"dimenet batch: {src.shape[0]} edges / {b['z'].shape[0]} nodes for the cell's {e} / {n}")
    kj, ji, mask = build_triplets(src, dst, b["z"].shape[0], max_triplets=t)

    def pad(a, fill):
        out = np.full((n,) + a.shape[1:], fill, a.dtype)
        out[: a.shape[0]] = a
        return out

    arrays = {"z": pad(b["z"], 0), "pos": pad(b["pos"], 0.0), "src": src, "dst": dst,
              "tri_kj": kj, "tri_ji": ji, "tri_mask": mask.astype(np.float32),
              "graph_ids": pad(b["graph_ids"], g - 1), "targets": b["targets"]}
    log(f"  DimeNet molecule batch: molecule_batch({g}): {b['z'].shape[0]} nodes padded to {n}, "
        f"{e} directed edges, {int(mask.sum())} triplets in the cell's {t}")
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in arrays.items()}


def b4_backward_checks(torch, np, tag, t, G) -> dict:
    """B4 on a transposed operator ``t`` (``CSRTranspose``) against its
    plain version at ``F32_TOL``, the planted faults rejected there, timed
    beside the plain version and ``torch.sparse.mm`` on the transposed CSR,
    with the byte bound.  Returns the numbers for the kernel list."""
    from repro_torch.kernels.segment_reduce import csr_aggregate_op, csr_aggregate_ref

    m, d = (int(x) for x in t.nbr.shape)
    s = int(G.shape[1])
    t0 = time.perf_counter()
    out = csr_aggregate_op(t.nbr, t.wgt, G, live=t.live)
    torch.cuda.synchronize()
    err = check_close(np, f"{tag} (M={m}, D={d}, S={s}, {t.live.slots} live slots)", out,
                      csr_aggregate_ref(t.nbr, t.wgt, G), F32_TOL)
    round_fault_checks(torch, np, tag, t.nbr, t.live, G,
                       lambda nbr, live, F: csr_aggregate_op(nbr, t.wgt, F, live=live),
                       lambda F: csr_aggregate_ref(t.nbr, t.wgt, F))
    keep = t.wgt != 0
    a_t = torch.sparse_coo_tensor(
        torch.stack([torch.nonzero(keep)[:, 0], t.nbr[keep].long()]), t.wgt[keep],
        (m, int(G.shape[0])), check_invariants=True).coalesce().to_sparse_csr()
    del keep
    check_close(np, f"{tag} vs torch.sparse.mm(Aᵀ as CSR)", out, torch.sparse.mm(a_t, G), F32_TOL)
    ms = cuda_ms(torch, lambda: csr_aggregate_op(t.nbr, t.wgt, G, live=t.live))
    plain_ms = cuda_ms(torch, lambda: csr_aggregate_ref(t.nbr, t.wgt, G), warmup=1, iters=2)
    lib_ms = cuda_ms(torch, lambda: torch.sparse.mm(a_t, G))
    # G read and the output written once, the live (nbr, wgt) slots, the lengths
    bms, by = bound(2.0 * t.live.slots * s, 4.0 * (int(G.shape[0]) + m) * s
                    + 8.0 * t.live.slots + 4.0 * m)
    log(f"    kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.sparse.mm(Aᵀ CSR) "
        f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by}); these checks {time.perf_counter() - t0:.1f} s")
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "lib_ms": lib_ms, "bound_ms": bms,
            "by": by}


def kernel_vs_plain_step(torch, np, name, cell, plain_cell, params, batch, fwd, bwd) -> None:
    """One step's loss and every gradient on the kernel route (B4 forward
    and backward, exactly ``fwd`` and ``bwd`` launches) against the same
    step on B4's plain version, at ``F32_TOL``."""
    from repro_torch.kernels import launch_counts
    from repro_torch.optim import value_and_grad

    before = launch_counts()
    t0 = time.perf_counter()
    loss, grads = value_and_grad(cell.step_fn.loss_fn, params, batch)
    torch.cuda.synchronize()
    t_kernel = time.perf_counter() - t0
    after = launch_counts()
    got = (after["csr_aggregate"] - before["csr_aggregate"],
           after["csr_aggregate_backward"] - before["csr_aggregate_backward"])
    if got != (fwd, bwd) or sum(after.values()) - sum(before.values()) != fwd + bwd:
        fail(f"{name}: a step launched {got} (forward, backward) B4, expected {(fwd, bwd)}")
    all_finite(torch, name, loss, grads)
    t0 = time.perf_counter()
    p_loss, p_grads = value_and_grad(plain_cell.step_fn.loss_fn, params, batch)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    e1 = tree_close(torch, np, f"{name} loss, kernel vs plain", loss, p_loss, F32_TOL)
    e2 = tree_close(torch, np, f"{name} gradients, kernel vs plain", grads, p_grads, F32_TOL)
    log(f"  {name}: B4 {fwd} forward + {bwd} backward launches a step; loss {float(loss):.6f}, "
        f"kernel vs plain route max|Δ| loss {e1:.3e}, gradients {e2:.3e} (F32_TOL); loss and "
        f"gradients {t_kernel:.2f} s on the kernel route, {t_plain:.2f} s on the plain (first "
        "calls)")


def card_vs_cpu_step(torch, np, name, cell, params, batch, norm_rtol=None, f64=False) -> None:
    """One step's loss and gradients on the card against the same cell on
    the CPU (the plain versions) at ``MODEL_TOL``, element for element;
    with ``f64``, against the same step on the card with every tensor in
    f64 instead (MeshGraphNet, ROADMAP C.3: the CPU's f32 run is no
    better founded than the card's).  With ``norm_rtol``, a gradient leaf
    past that is held in norm instead, ``‖card − ref‖₂ ≤ norm_rtol ·
    ‖ref‖₂``; such leaves are counted and their largest differences
    printed."""
    from repro_torch.optim import tree_leaves, tree_map, value_and_grad

    loss, grads = value_and_grad(cell.step_fn.loss_fn, params, batch)
    if f64:
        ref = "card f64"
        up = lambda t: t.detach().double() if t.is_floating_point() else t  # noqa: E731
        c_loss, c_grads = value_and_grad(cell.step_fn.loss_fn, tree_map(up, params),
                                         {k: up(v) for k, v in batch.items()})
        c_loss, c_grads = c_loss.cpu(), tree_map(lambda t: t.detach().cpu().float(), c_grads)
    else:
        ref = "CPU"
        cpu = lambda t: t.detach().cpu().clone()  # noqa: E731
        c_loss, c_grads = value_and_grad(cell.step_fn.loss_fn, tree_map(cpu, params),
                                         {k: v.cpu() for k, v in batch.items()})
    all_finite(torch, f"{name} card", loss, grads)
    e1 = tree_close(torch, np, f"{name} loss, card vs {ref}", loss, c_loss, MODEL_TOL)
    pairs = [(a.detach().cpu(), b) for a, b in zip(tree_leaves(grads), tree_leaves(c_grads))]
    e2 = max(float((a - b).abs().max()) for a, b in pairs)
    missed = [i for i, (a, b) in enumerate(pairs) if not torch.allclose(a, b, **MODEL_TOL)]
    if missed and norm_rtol is None:
        i = missed[0]
        fail(f"{name}: gradient leaf {i} {tuple(pairs[i][0].shape)} card vs {ref} max|Δ| "
             f"{float((pairs[i][0] - pairs[i][1]).abs().max()):.3e}")
    worst, worst_i = 0.0, None
    for i in missed:
        g, c = pairs[i]
        rel = float(torch.linalg.vector_norm(g - c) / torch.linalg.vector_norm(c).clamp_min(1e-30))
        if rel > worst:
            worst, worst_i = rel, i
        if rel > norm_rtol:
            fail(f"{name}: gradient leaf {i} {tuple(g.shape)} card vs {ref} ‖Δ‖/‖g‖ {rel:.3e} "
                 f"(max|Δ| {float((g - c).abs().max()):.3e})")
    tail = ""
    if missed:
        g, c = pairs[worst_i]
        tail = (f"; {len(missed)} of {len(pairs)} leaves past it element for element (C.3), "
                f"held in norm: ‖Δ‖/‖g‖ at most {worst:.3e} (leaf {worst_i} "
                f"{tuple(g.shape)}, max|Δ| {float((g - c).abs().max()):.3e} of max|g| "
                f"{float(c.abs().max()):.3e}; gate {norm_rtol})")
    log(f"  {name}: card vs {ref} max|Δ| loss {e1:.3e}, gradients {e2:.3e} "
        f"(rtol=1e-4, atol=1e-5){tail}")


def gnn_train_phase(torch, np, dev) -> dict:
    """Phase 18 (a)-(b): the GNN train cells at the reference's full sizes
    through ``get_arch(a).make_cell(s).step_fn``, with B4's backward on the
    transposed operators checked at ``ogb_products`` and SAGE's hops."""
    import dataclasses

    from repro_torch.configs import cells, gat_cora, gcn_cora, get_arch
    from repro_torch.configs.cells import pad512
    from repro_torch.graph.structures import erdos_renyi
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import gnn
    from repro_torch.optim import value_and_grad

    res = {"b4_bwd": None}
    reset_launch_counts()

    def cell_pair(arch, shape):
        cfg0 = {"gcn-cora": gcn_cora.FULL, "gat-cora": gat_cora.FULL}[arch]
        return get_arch(arch).make_cell(shape), cells.gnn_cell(arch, cfg0, shape, use_kernel=False)

    def init(cell, seed=0):
        return cell.step_fn.init(torch.Generator(device=dev).manual_seed(seed), dev)

    # ---- ogb_products: one erdos_renyi graph at the cell's padded counts
    sh = cells.GNN_SHAPES["ogb_products"]
    n, e = pad512(sh["n_nodes"]), pad512(sh["n_edges"])
    t0 = time.perf_counter()
    g = erdos_renyi(n, e, seed=0, device=dev)
    ogb = tuple(torch.from_numpy(a).to(dev) for a in (g.src, g.dst))
    del g
    torch.cuda.synchronize()
    log(f"  ogb_products graph: erdos_renyi({n}, {e}, seed=0) in "
        f"{time.perf_counter() - t0:.1f} s (the cells' padded node and edge counts)")

    for arch, shape, graph in (("gcn-cora", "full_graph_sm", None), ("gcn-cora", "molecule", None),
                               ("gcn-cora", "ogb_products", ogb)):
        with SubPhase(torch, f"GCN {shape} training"):
            cell, plain = cell_pair(arch, shape)
            batch = gnn_train_batch(torch, np, dev, cell, shape, graph)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            op = cell.step_fn.prepare(batch)
            torch.cuda.synchronize()
            m, d = (int(x) for x in op.nbr.shape)
            log(f"  gcn-cora {shape} (cell meta {cell.meta}): padded CSR {m} x {d} and its "
                f"transpose {tuple(op.transpose.nbr.shape)} built on the card once, in "
                f"{time.perf_counter() - t0:.2f} s ({op.live.slots} live slots)")
            params, state = init(cell)
            kernel_vs_plain_step(torch, np, f"GCN {shape} step", cell, plain, params, batch, 2, 1)
            if shape == "ogb_products":
                G = torch.randn((n, 16), generator=torch.Generator(device=dev).manual_seed(1),
                                device=dev)
                log("== phase 18 (a): csr_aggregate's backward at ogb_products (the transposed "
                    "GCN operator, S = 16: layer 2's gradient)")
                res["b4_bwd"] = b4_backward_checks(torch, np, "csr_aggregate backward (Aᵀ) "
                                                   "ogb_products", op.transpose, G)
                del G
            else:
                card_vs_cpu_step(torch, np, f"GCN {shape} step", cell, params, batch)
            train_run(torch, f"GCN {shape}", cell.step_fn, params, state, batch, TRAIN_STEPS)
            del op, batch, params, state

    for shape, graph in (("full_graph_sm", None), ("ogb_products", ogb)):
        with SubPhase(torch, f"GAT {shape} training"):
            cell = get_arch("gat-cora").make_cell(shape)
            batch = gnn_train_batch(torch, np, dev, cell, shape, graph)
            params, state = init(cell)
            before = launch_counts()
            loss, grads = value_and_grad(cell.step_fn.loss_fn, params, batch)
            all_finite(torch, f"GAT {shape} step", loss, grads)
            if launch_counts() != before:
                fail(f"GAT {shape}: launched a kernel of the port")
            del grads
            if shape == "full_graph_sm":
                card_vs_cpu_step(torch, np, f"GAT {shape} step", cell, params, batch)
            log(f"  gat-cora {shape} (cell meta {cell.meta}): loss {float(loss):.6f}, every "
                f"gradient finite; edge chunks of {gnn.GAT_EDGE_CHUNK} checkpointed")
            train_run(torch, f"GAT {shape}", cell.step_fn, params, state, batch,
                      TRAIN_STEPS_OTHER)
            del batch, params, state
    del ogb

    for arch in ("gat-cora", "gcn-cora"):
        with SubPhase(torch, f"SAGE ({arch}) minibatch_lg training"):
            cell, plain = cell_pair(arch, "minibatch_lg")
            batch = gnn_train_batch(torch, np, dev, cell, "minibatch_lg")
            hops = cell.step_fn.prepare(batch)
            log(f"  SAGE from {arch} at minibatch_lg (cell meta {cell.meta}): random hops at the "
                f"cell's padded sizes, "
                + ", ".join(f"{h.nbr.shape[0]}x{h.nbr.shape[1]} (transpose "
                            f"{tuple(h.transpose.nbr.shape)})" for h in hops))
            params, state = init(cell)
            kernel_vs_plain_step(torch, np, f"SAGE {arch} step", cell, plain, params, batch, 2, 2)
            if arch == "gcn-cora":
                G = torch.randn((batch["feats"].shape[0], 64),
                                generator=torch.Generator(device=dev).manual_seed(2), device=dev)
                for k, h in enumerate(hops):
                    G_k = G[: h.nbr.shape[0]].contiguous()
                    log(f"  csr_aggregate's backward on SAGE hop {k}'s transpose")
                    r = b4_backward_checks(torch, np, f"csr_aggregate backward (Aᵀ) SAGE hop {k}",
                                           h.transpose, G_k)
                    res["b4_bwd"]["err"] = max(res["b4_bwd"]["err"], r["err"])
            train_run(torch, f"SAGE {arch}", cell.step_fn, params, state, batch, TRAIN_STEPS)
            del batch, params, state, hops

    for arch in ("dimenet", "meshgraphnet"):
        with SubPhase(torch, f"{arch} molecule training"):
            cell = get_arch(arch).make_cell("molecule")
            batch = gnn_train_batch(torch, np, dev, cell, "molecule")
            params, state = init(cell)
            mgn = arch == "meshgraphnet"
            card_vs_cpu_step(torch, np, f"{arch} molecule step", cell, params, batch,
                             norm_rtol=MGN_GRAD_NORM_RTOL if mgn else None, f64=mgn)
            train_run(torch, f"{arch} molecule", cell.step_fn, params, state, batch,
                      TRAIN_STEPS_OTHER)
            del batch, params, state
    counts = launch_counts()
    res["b4_fwd"], res["b4_bwd_launches"] = counts["csr_aggregate"], counts["csr_aggregate_backward"]
    return res


# phase 19: the dry run (queue A.9.5)
DRYRUN_SPEC = {"dryrun": {"archs": ["dhlp-bio"], "shapes": ["scale_1m", "scale_20m"],
                          "mesh": "both"}}
DRYRUN_FAMILY_CELLS = (("h2o-danube-1.8b", "decode_32k"), ("granite-moe-3b-a800m", "decode_32k"),
                       ("meshgraphnet", "molecule"), ("wide-deep", "train_batch"))
DHLP_SAMPLE_FLOPS = 568_920_240  # benchmarks/data/dryrun_sample.jsonl, scale_1m@single


def census_line(rec: dict) -> str:
    cols = ", ".join(f"{k} {c['count']} x / {c['bytes']:,} B" for k, c in rec["collectives"].items()
                     if c["count"])
    fb = sum((rec.get("fallbacks") or {}).values())
    return (f"{rec['arch']}/{rec['shape']}@{rec['mesh']}: {rec['cost']['flops']:,.0f} FLOPs, "
            f"{rec['cost']['bytes accessed']:,.0f} B accessed per device; {cols or 'no collective'}"
            f"; {fb} fallbacks; traced in {rec['lower_s']} s")


def dryrun_phase() -> None:
    """Phase 19 (see the module docstring)."""
    from repro_torch.bench.roofline import load
    from repro_torch.launch.dryrun import run_cell

    t0 = time.perf_counter()
    log("== phase 19 (a): python -m repro_torch run with a dryrun section (dhlp-bio, both meshes)")
    spec_path = OUT_ROOT / "dryrun_spec.json"
    OUT_ROOT.mkdir(parents=True, exist_ok=True)
    spec_path.write_text(json.dumps(DRYRUN_SPEC))
    proc, wall = run_cli(["run", str(spec_path), "--device", CLI_DEVICE, "--results-root",
                          str(OUT_ROOT)], timeout=600)
    if proc.returncode != 0:
        fail(f"run with a dryrun section exited {proc.returncode}: {proc.stderr[-3000:]}")
    census = sorted(OUT_ROOT.glob("dryrun-*/telemetry/dryrun.jsonl"),
                    key=lambda p: p.stat().st_mtime)[-1]
    recs = load(str(census))
    if sorted((r["shape"], r["mesh"], r["status"]) for r in recs) != [
            (s, m, "ok") for s in ("scale_1m", "scale_20m") for m in ("multi", "single")]:
        fail(f"the dhlp-bio census: {[(r['shape'], r['mesh'], r['status']) for r in recs]}")
    for r in recs:
        cols, meta = r["collectives"], r["meta"]
        s_local = meta["seeds"] // (16 if r["mesh"] == "single" else 32)
        per_round = meta["nodes"] * s_local * 4
        if (cols["all-reduce"]["count"], cols["all-reduce"]["bytes"]) != (
                meta["rounds"], meta["rounds"] * per_round) or cols["all-gather"]["count"]:
            fail(f"dhlp-bio/{r['shape']}@{r['mesh']}: collectives {cols}, expected one all-reduce "
                 f"of {per_round:,} B a round and no all-gather")
        log(f"  {census_line(r)}")
    one = next(r for r in recs if (r["shape"], r["mesh"]) == ("scale_1m", "single"))
    ratio = one["cost"]["flops"] / DHLP_SAMPLE_FLOPS
    if abs(ratio - 1) >= 0.05:
        fail(f"dhlp-bio scale_1m@single: {one['cost']['flops']:,.0f} FLOPs per device, "
             f"{ratio:.4f} of the reference sample's {DHLP_SAMPLE_FLOPS:,}")
    log(f"  exit 0 in {wall:.1f} s (process start included); scale_1m@single at {ratio:.4f} of the "
        f"reference sample's FLOPs (gate: within 5 %), all-reduces of {54_272_000:,} B a round")

    log("== phase 19 (b): that census through the roofline suite (REPRO_DRYRUN_ARTIFACTS)")
    proc, wall = run_cli(["bench", "--only", "roofline", "--device", CLI_DEVICE, "--no-write"],
                         env={"REPRO_DRYRUN_ARTIFACTS": str(census)}, timeout=300)
    rows = [ln for ln in proc.stdout.splitlines() if ln.startswith("roofline/")]
    if proc.returncode != 0 or "suites=1 records=4 failures=0" not in proc.stderr or len(rows) != 4:
        fail(f"bench --only roofline on the live census: exit {proc.returncode}, "
             f"{proc.stderr[-2000:]}")
    for ln in rows:
        log(f"    {ln}")

    log("== phase 19 (c): one cell per other family through run_cell on the single mesh")
    for arch, shape in DRYRUN_FAMILY_CELLS:
        rec = run_cell(arch, shape, "single")
        if rec["status"] != "ok" or rec["cost"]["flops"] <= 0:
            fail(f"{arch}/{shape}: status {rec['status']}, {rec.get('error')}")
        log(f"  {census_line(rec)}")
    log(f"  phase 19: the sweep took {time.perf_counter() - t0:.1f} s")


def recsys_train_phase(torch, np, dev) -> None:
    """Phase 18 (c): Wide & Deep ``FULL`` at ``train_batch``, not cut."""
    from repro_torch.configs import get_arch, wide_deep
    from repro_torch.data.recsys import CTRDataConfig, sample_ctr_batch

    with SubPhase(torch, "wide-deep FULL train_batch"):
        cell = get_arch("wide-deep").make_cell("train_batch")
        b = cell.meta["examples"]
        cfg = wide_deep.FULL
        dcfg = CTRDataConfig(cfg.n_sparse, cfg.n_dense, cfg.vocab_per_field, seed=0)
        params, state = cell.step_fn.init(torch.Generator(device=dev).manual_seed(0), dev)
        batches = [{k: torch.from_numpy(v).to(dev) for k, v in sample_ctr_batch(dcfg, b, s).items()}
                   for s in range(TRAIN_STEPS_OTHER)]
        losses, walls = [], []
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, loss = cell.step_fn(params, state, batch)
            losses.append(float(loss))
            walls.append(time.perf_counter() - t0)
        if not all(np_isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            fail(f"wide-deep train_batch: losses {losses}")
        log(f"  wide-deep FULL train_batch ({b} examples, the {cfg.total_vocab} x "
            f"{cfg.embed_dim} table's gradient dense, plain lookups): losses "
            + ", ".join(f"{x:.5f}" for x in losses) + "; walls "
            + ", ".join(f"{w * 1e3:.1f}" for w in walls) + " ms")
        del params, state, batches


def lm_train_phase(torch, np, dev) -> dict:
    """Phase 18 (d): ``h2o-danube-1.8b`` and ``granite-moe-3b-a800m``
    ``FULL`` at ``train_4k``'s sequence, the batch cut to the first of
    ``LM_TRAIN_BATCHES`` that fits."""
    from repro_torch.configs import get_arch
    from repro_torch.data.lm import LMDataConfig, sample_batch

    out = {}
    for arch, batches in LM_TRAIN_BATCHES.items():
        cell = get_arch(arch).make_cell("train_4k")
        cfg = get_arch(arch).full_config
        for batch in batches:
            try:
                with SubPhase(torch, f"{arch} FULL train_4k batch {batch}"):
                    params, state = cell.step_fn.init(torch.Generator(device=dev).manual_seed(0),
                                                      dev)
                    dcfg = LMDataConfig(vocab=cfg.vocab, batch=batch, seq_len=LM_TRAIN_SEQ)
                    losses, walls = [], []
                    for s in range(LM_TRAIN_STEPS):
                        b = {k: torch.from_numpy(v).to(dev)
                             for k, v in sample_batch(dcfg, s).items()}
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        params, state, loss = cell.step_fn(params, state, b)
                        losses.append(float(loss))
                        walls.append(time.perf_counter() - t0)
                    tokens = batch * LM_TRAIN_SEQ
                    best = min(walls)
                    mfu = 6.0 * cfg.active_param_count() * tokens / best / PEAK_BF16_FLOPS
                    if not all(np_isfinite(x) for x in losses):
                        fail(f"{arch} train_4k: losses {losses}")
                    log(f"  {arch} FULL train_4k: seq {LM_TRAIN_SEQ}, batch {batch} (cut from "
                        f"256; {batches[:batches.index(batch)] or 'none'} did not fit before), "
                        f"bf16 parameters, f32 AdamW moments, layers checkpointed, attention on "
                        f"the plain route: losses " + ", ".join(f"{x:.4f}" for x in losses)
                        + "; walls " + ", ".join(f"{w:.3f}" for w in walls)
                        + f" s; {tokens / best:,.0f} tokens/s at the best step; "
                        f"6·N_active·tokens / step time = {mfu:.3f} of the bf16 peak (not gated)")
                    out[arch] = {"batch": batch, "walls": walls}
                    del params, state, b
                break
            except torch.cuda.OutOfMemoryError:
                params = state = b = None
                torch.cuda.empty_cache()
                log(f"  {arch} train_4k at batch {batch} did not fit in device memory")
        if arch not in out:
            fail(f"{arch} train_4k: no batch of {batches} fit")
        torch.cuda.empty_cache()
    return out


def train_cli_phase(torch, np) -> None:
    """Phase 18 (e): ``python -m repro_torch run`` on docs/runspec.md's
    train example (``gcn-cora``, ``inject_fault [5]``) with a ``ckpt_dir``:
    one retry, final parameters bit for bit a clean run's; then more steps
    resume from the checkpoint."""
    import shutil

    from repro_torch.checkpoint import CheckpointManager

    root = OUT_ROOT / "train"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)

    def run(name, steps, faults):
        spec = {"run_id": f"train-{name}", "train": {
            "arch": "gcn-cora", "steps": steps, "batch": 4, "inject_fault": faults,
            "ckpt_dir": str(root / name / "ckpt")}}
        path = root / f"{name}.json"
        path.write_text(json.dumps(spec))
        proc, wall = run_cli(["run", str(path), "--device", CLI_DEVICE, "--results-root",
                              str(root / "results")], timeout=300)
        if proc.returncode != 0:
            fail(f"train CLI {name}: exit {proc.returncode}: {proc.stderr[-2000:]}")
        art = json.loads((root / "results" / f"train-{name}" / "train.json").read_text())
        log(f"  {name}: exit 0 in {wall:.1f} s; " + next(
            ln for ln in proc.stdout.splitlines() if ln.startswith("[train] gcn-cora")))
        return art

    def final(name):
        mgr = CheckpointManager(str(root / name / "ckpt"))
        s = mgr.steps()[-1]
        return s, [np.load(Path(mgr._step_dir(s)) / r["file"]) for r in mgr.manifest(s)["leaves"]]

    faulty = run("fault", CLI_TRAIN_STEPS, [CLI_TRAIN_FAULT])
    clean = run("clean", CLI_TRAIN_STEPS, [])
    if (faulty["retries"], clean["retries"]) != (1, 0):
        fail(f"train CLI: retries {faulty['retries']} / {clean['retries']}, expected 1 / 0")
    (sf, lf), (sc, lc) = final("fault"), final("clean")
    if sf != sc or len(lf) != len(lc) or not all(np.array_equal(a, b) for a, b in zip(lf, lc)):
        fail("train CLI: the retried run's final parameters differ from the clean run's")
    log(f"  the retried run's final checkpoint (step {sf}, {len(lf)} leaves) equals the clean "
        "run's bit for bit")
    resumed = run("fault", CLI_RESUME_STEPS, [CLI_TRAIN_FAULT])
    if not resumed["resumed"] or resumed["steps"] != CLI_RESUME_STEPS - CLI_TRAIN_STEPS:
        fail(f"train CLI: the second run did not resume ({resumed})")
    log(f"  a second run of {CLI_RESUME_STEPS} steps resumed from step {sf} "
        f"(resumed: true, {resumed['steps']} steps)")


def training_phase(torch, np, dev) -> dict:
    """Phase 18: training, each sub-phase's seconds and peak memory printed."""
    smi = smi_name_and_limit()
    log(f"== phase 18 (a, b): the GNN train cells at the reference's full sizes ({smi})")
    out = gnn_train_phase(torch, np, dev)
    log(f"== phase 18 (c): wide-deep FULL at train_batch ({smi})")
    recsys_train_phase(torch, np, dev)
    log(f"== phase 18 (d): h2o-danube-1.8b and granite-moe-3b-a800m FULL at train_4k ({smi})")
    out["lm"] = lm_train_phase(torch, np, dev)
    log(f"== phase 18 (e): python -m repro_torch run on the docs' train spec ({smi})")
    train_cli_phase(torch, np)
    return out


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.core import extract_outputs, topk_exclusive
    from repro_torch.core.solver import HeteroLP, LPConfig
    from repro_torch.engine import make_engine
    from repro_torch.kernels import SOURCES, launch_counts, reset_launch_counts
    from repro_torch.kernels import common
    from repro_torch.kernels.common import build_all
    from repro_torch.kernels.lp_blockspmm import lp_round_op, lp_round_ref, ops as lp_ops
    from repro_torch.kernels.lp_blockspmm import regime as lp_regime
    from repro_torch.kernels.segment_reduce import (
        csr_round_op,
        csr_round_ref,
        csr_round_residual_op,
        csr_round_residual_ref,
        rows_per_block,
    )
    from repro_torch.scenarios import generate, make_recovery_problem, solve_recovery
    from repro_torch.configs import cells, gcn_cora, wide_deep
    from repro_torch.data.graphs import planted_partition_graph
    from repro_torch.data.recsys import CTRDataConfig, sample_ctr_batch
    from repro_torch.kernels.embedding_bag import embedding_bag_op, embedding_bag_ref, launch_plan
    from repro_torch.kernels.segment_reduce import csr_aggregate_op, csr_aggregate_ref
    from repro_torch.models import gnn as gnn_module
    from repro_torch.models.gnn import GCN, gcn_adjacency_live
    from repro_torch.models.recsys import WideDeep, make_retrieval_scorer, make_serve

    import shutil

    from repro_torch.engine import autotune as autotune_mod

    t_script = time.perf_counter()
    # no phase reads an autotune cache left by an earlier run: the CLI
    # phases' (under the checkout) and the in-process phases' are emptied
    shutil.rmtree(ROOT / "results" / "autotune", ignore_errors=True)
    shutil.rmtree(AUTOTUNE_DIR, ignore_errors=True)
    AUTOTUNE_DIR.mkdir(parents=True)
    autotune_mod.DEFAULT_CACHE_DIR = AUTOTUNE_DIR
    autotune_mod.clear_memo()
    # ------------------------------------------------------------ 1. device
    log("== phase 1: device")
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = smi_name_and_limit()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}; device {kind}")
    log(f"  nvidia-smi: {smi}")

    # ------------------------------------------------------------- 2. build
    log("== phase 2: build")
    t0 = time.perf_counter()
    planted = start_variant(common, lp_ops.SOURCE, [(line, "") for line in B2_LO_PRODUCTS],
                            "lp_round_one_product")
    libs = build_all(list(SOURCES))
    one_product = finish_variant(common, planted)
    log(f"  built {len(libs)} kernel libraries and the planted one-product lp_round in "
        f"{time.perf_counter() - t0:.1f} s (one nvcc per source, in parallel)")
    log("  nvcc wall per source: " + ", ".join(
        f"{src} {f'{lib.seconds:.1f} s' if lib.seconds else 'built earlier'}"
        for src, lib in libs.items()))
    for src, lib in libs.items():
        for line in lib.log.splitlines():
            if "ptxas info" in line and ("registers" in line or "Compiling" in line
                                         or "bytes" in line):
                log(f"  [{src}] {line.strip()}")

    # ----------------------------------------- main-path network and inputs
    t0 = time.perf_counter()
    bundle = generate("powerlaw", scale=1.0, seed=0, cache=False)
    net = bundle.network
    n = net.num_nodes
    log(f"  powerlaw scale=1.0 seed=0: {n} nodes {net.sizes}, "
        f"{net.num_edges} edges, generated in {time.perf_counter() - t0:.1f} s")
    cfg = LPConfig(alg="dhlp2", alpha=0.5, sigma=1e-4, seed_mode="fixed", autotune=False)
    t0 = time.perf_counter()
    kernel_engine = make_engine("kernel", cfg, device=dev)
    op = kernel_engine.prepare(net)
    buckets, perm, rank = op.payload.plan
    nnz = sum(int(torch.count_nonzero(w)) for _, w, _ in buckets)
    slots = sum(int(nb.numel()) for nb, _, _ in buckets)
    widths = [int(nb.shape[1]) for nb, _, _ in buckets]
    log(f"  kernel plan: {len(buckets)} buckets, {slots} slots, nnz {nnz}, "
        f"widths {min(widths)}..{max(widths)}, built in {time.perf_counter() - t0:.1f} s")

    # -------------------------------------- 3. kernels vs plain versions
    log("== phase 3: kernels vs plain versions at main-path shapes")
    s = n  # all-sources solve: one seed column per node
    gen = torch.Generator(device=dev).manual_seed(0)
    F = torch.rand((n, s), generator=gen, device=dev)
    base = torch.rand((n, s), generator=gen, device=dev)
    prev = torch.rand((n, s), generator=gen, device=dev)
    c = 0.25
    offsets = np.cumsum([0] + [int(nb.shape[0]) for nb, _, _ in buckets])

    def rows(i):
        return slice(int(offsets[i]), int(offsets[i + 1]))

    sizes = [int(nb.numel()) for nb, _, _ in buckets]
    picks = {"largest": int(np.argmax(sizes)), "smallest": int(np.argmin(sizes))}
    b1_err = 0.0
    for storage, sdt, tol in (("f32", torch.float32, F32_TOL), ("bf16", torch.bfloat16, BF16_TOL)):
        Fq = F.to(sdt)
        for label, i in picks.items():
            nbr, wgt, live = buckets[i]
            wq = wgt.to(sdt)
            sl = rows(i)
            out_k, d_k = csr_round_residual_op(nbr, wq, Fq, base[sl], prev[sl], c=c, live=live)
            torch.cuda.synchronize()
            out_p, d_p = csr_round_residual_ref(nbr, wq, Fq, base[sl], prev[sl], c)
            torch.cuda.synchronize()
            tag = f"csr_round_residual {storage} {label} bucket ({nbr.shape[0]}x{nbr.shape[1]}, S={s})"
            err = check_close(np, tag, out_k, out_p, tol)
            check_close(np, tag + " delta", d_k.amax(dim=0, keepdim=True), d_p, tol)
            if storage == "f32":
                b1_err = max(b1_err, err)
            ms_k = cuda_ms(torch, lambda: csr_round_residual_op(
                nbr, wq, Fq, base[sl], prev[sl], c=c, live=live))
            log(f"    kernel {ms_k:.4f} ms")
    i = picks["largest"]
    nbr, wgt, live = buckets[i]
    sl = rows(i)
    round_fault_checks(
        torch, np, "csr_round_residual largest bucket", nbr, live, F,
        lambda nb, lv, F_: csr_round_residual_op(nb, wgt, F_, base[sl], prev[sl], c=c, live=lv)[0],
        lambda F_: csr_round_residual_ref(nbr, wgt, F_, base[sl], prev[sl], c)[0],
    )

    def b1_round():
        outs, deltas = [], []
        for i, (nbr, wgt, live) in enumerate(buckets):
            sl = rows(i)
            o, d = csr_round_residual_op(nbr, wgt, F, base[sl], prev[sl], c=c, live=live)
            outs.append(o)
            deltas.append(d)
        return torch.cat(outs), torch.cat(deltas).amax(dim=0)

    def b1_round_plain():
        outs, deltas = [], []
        for i, (nbr, wgt, _) in enumerate(buckets):
            sl = rows(i)
            o, d = csr_round_residual_ref(nbr, wgt, F, base[sl], prev[sl], c)
            outs.append(o)
            deltas.append(d)
        return torch.cat(outs), torch.cat(deltas).amax(dim=0)

    o1, d1 = b1_round()
    o2, d2 = b1_round()
    torch.cuda.synchronize()
    if not (torch.equal(o1, o2) and torch.equal(d1, d2)):
        fail("csr_round_residual: two launches gave different bytes")
    log("  csr_round_residual: two full rounds are byte-identical")
    op_, dp_ = b1_round_plain()
    b1_err = max(b1_err, check_close(np, "csr_round_residual full round f32", o1, op_, F32_TOL))
    check_close(np, "csr_round_residual full round f32 delta", d1, dp_, F32_TOL)
    del o1, o2, op_, dp_

    # library yardstick: one cuSPARSE CSR product c*base + A@F (no residual)
    idx_r, idx_c, vals = [], [], []
    for i, (nbr, wgt, _) in enumerate(buckets):
        keep = wgt != 0
        idx_r.append(torch.nonzero(keep)[:, 0] + int(offsets[i]))
        idx_c.append(nbr[keep].long())
        vals.append(wgt[keep].float())
    A_csr = torch.sparse_coo_tensor(
        torch.stack([torch.cat(idx_r), torch.cat(idx_c)]),
        torch.cat(vals),
        (n, n),
        check_invariants=True,
    ).coalesce().to_sparse_csr()
    lib_out = torch.addmm(base, A_csr, F, beta=c)
    o1, _ = b1_round()
    check_close(np, "csr_round_residual vs torch.addmm(CSR)", o1, lib_out, F32_TOL)
    del o1, lib_out
    b1_ms = cuda_ms(torch, b1_round)
    b1_plain_ms = cuda_ms(torch, b1_round_plain, warmup=1, iters=3)
    b1_lib_ms = cuda_ms(torch, lambda: torch.addmm(base, A_csr, F, beta=c))
    live_slots, gathered = gather_counts(buckets)
    grid_rows = sum(-(-int(nb.shape[0]) // rows_per_block(-(-lv.slots // int(nb.shape[0]))))
                    for nb, _, lv in buckets)
    b1_bound, b1_by = bound(
        2.0 * nnz * s,
        4.0 * n * s * 4 + 8.0 * live_slots + 4.0 * n + 4.0 * grid_rows * s,
    )
    b1_l2 = 4.0 * gathered * s
    log(f"  csr_round_residual full round ({len(buckets)} buckets): "
        f"kernel {b1_ms:.4f} ms, plain {b1_plain_ms:.4f} ms, "
        f"torch.addmm(CSR) {b1_lib_ms:.4f} ms, bound {b1_bound:.4f} ms ({b1_by})")
    log(f"    {slots} slots: {live_slots} live, {gathered - live_slots} pads gathered, "
        f"{slots - gathered} pads skipped; {b1_l2 / 1e9:.2f} GB of F rows gathered from L2 "
        f"or HBM per round, {b1_l2 / b1_ms / 1e9:.1f} TB/s")
    del A_csr

    solver = HeteroLP(LPConfig(backend="dense", use_kernel=True, sigma=1e-4,
                               seed_mode="fixed"), device=dev)
    norm = op.norm
    A_eff, beta2 = solver.operator_arrays(norm)["fused"]
    b2_reg = lp_regime(F.dtype)
    out_k = lp_round_op(A_eff, F, base, c=c)
    torch.cuda.synchronize()
    out_p = lp_round_ref(A_eff, F, base, c)
    torch.cuda.synchronize()
    b2_err = check_close(np, f"lp_round f32 {b2_reg} (N={n}, S={s})", out_k, out_p, F32_TOL)
    o2 = lp_round_op(A_eff, F, base, c=c)
    torch.cuda.synchronize()
    if not torch.equal(out_k, o2):
        fail("lp_round: two launches gave different bytes")
    del out_k, out_p, o2
    Aq, Fq, bq = (x.to(torch.bfloat16) for x in (A_eff, F, base))
    check_close(np, f"lp_round bf16 {lp_regime(Fq.dtype)} (N={n}, S={s})",
                lp_round_op(Aq, Fq, bq, c=c), lp_round_ref(Aq, Fq, bq, c), BF16_TOL)
    del Aq, Fq, bq
    # the f64 gate: the kernel within B2_F64_FACTOR x the f32 product's error,
    # and the same gate must reject the kernel without its hi.lo and lo.hi products
    errs = b2_f64_errors(torch, A_eff, F, base, c, (
        ("plain", lambda: lp_round_ref(A_eff, F, base, c)),
        ("kernel", lambda: lp_round_op(A_eff, F, base, c=c)),
        ("one product", lambda: with_library(
            lp_ops, one_product, lambda: lp_round_op(A_eff, F, base, c=c))),
    ))
    gate = B2_F64_FACTOR * errs["plain"]
    log(f"  lp_round f64 gate: max|Δ| vs A.double() @ F.double(): plain (f32 addmm, TF32 off) "
        f"{errs['plain']:.3e}, kernel {errs['kernel']:.3e} "
        f"({errs['kernel'] / errs['plain']:.2f}x), one-product variant "
        f"{errs['one product']:.3e} ({errs['one product'] / errs['plain']:.1f}x); "
        f"gate {B2_F64_FACTOR:g}x = {gate:.3e}")
    if errs["kernel"] > gate:
        fail(f"lp_round: max|Δ| vs f64 {errs['kernel']:.3e} > {gate:.3e}")
    if errs["one product"] <= gate:
        fail("lp_round: the f64 gate accepted the planted one-product variant")
    log("  lp_round: planted fault 'hi.hi product only' rejected by the f64 gate")
    b2_ms = cuda_ms(torch, lambda: lp_round_op(A_eff, F, base, c=c), iters=5)
    b2_plain_ms = cuda_ms(torch, lambda: lp_round_ref(A_eff, F, base, c), iters=5)
    b2_lib_ms = cuda_ms(torch, lambda: torch.addmm(base, A_eff, F, beta=c), iters=5)
    b2_ops = 2.0 * n * n * s
    b2_bytes = 4.0 * (n * n + 3 * n * s)
    # the least time at f32 accuracy: three TF32 products on the tensor cores
    b2_bound, b2_by = bound(3 * b2_ops, b2_bytes, PEAK_TF32_FLOPS)
    b2_f32_bound, _ = bound(b2_ops, b2_bytes)
    parts = device_times(torch, lambda: lp_round_op(A_eff, F, base, c=c))
    pre_us = sum(t for name, t in parts.items() if "split_f" in name or "pad_a" in name)
    log(f"  lp_round ({b2_reg}): kernel {b2_ms:.4f} ms, plain {b2_plain_ms:.4f} ms, "
        f"torch.addmm {b2_lib_ms:.4f} ms; bound {b2_bound:.4f} ms ({b2_by}, three TF32 "
        f"products at {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s), f32 CUDA-core bound "
        f"{b2_f32_bound:.4f} ms; {3 * b2_ops / b2_ms / 1e9:.1f} TFLOP/s of TF32 products "
        f"issued; pre-pass {pre_us / 1e3:.4f} ms of {sum(parts.values()) / 1e3:.4f} ms "
        f"profiled ({pre_us / max(sum(parts.values()), 1e-9):.3f})")

    # csr_round on the legacy (fused_superstep=False) block-rows layout
    t0 = time.perf_counter()
    legacy_engine = make_engine("kernel", cfg, device=dev, fused_superstep=False)
    lbuckets, _ = legacy_engine.prepare(net).payload.fused
    lnnz = sum(int(torch.count_nonzero(w)) for _, _, w, _ in lbuckets)
    lslots = sum(int(nb.numel()) for _, nb, _, _ in lbuckets)
    lwidths = [int(nb.shape[1]) for _, nb, _, _ in lbuckets]
    log(f"  legacy layout: {len(lbuckets)} buckets, {lslots} slots, nnz {lnnz}, "
        f"widths {min(lwidths)}..{max(lwidths)}, built in {time.perf_counter() - t0:.1f} s")
    lbase = [base[rows] for rows, _, _, _ in lbuckets]
    loffsets = np.cumsum([0] + [int(nb.shape[0]) for _, nb, _, _ in lbuckets])
    lout = torch.empty_like(F)
    b3_err = 0.0
    for i, (_, nbr, wgt, live) in enumerate(lbuckets):
        out_k = csr_round_op(nbr, wgt, F, lbase[i], c=c, live=live)
        torch.cuda.synchronize()
        out_p = csr_round_ref(nbr, wgt, F, lbase[i], c)
        got = out_k.cpu().numpy()
        want = out_p.cpu().numpy()
        err = float(np.max(np.abs(got - want)))
        if not (np.isfinite(got).all() and np.allclose(got, want, **F32_TOL)):
            fail(f"csr_round f32 bucket {i} ({nbr.shape[0]}x{nbr.shape[1]}): "
                 f"kernel disagrees with its plain version, max|Δ|={err}")
        b3_err = max(b3_err, err)
    log(f"  csr_round f32, all {len(lbuckets)} legacy buckets (S={s}): "
        f"max|Δ| vs plain = {b3_err:.3e} (rtol={F32_TOL['rtol']}, atol={F32_TOL['atol']})")
    widest = int(np.argmax(lwidths))
    _, nbr, wgt, live = lbuckets[widest]
    Fq, wq = F.to(torch.bfloat16), wgt.to(torch.bfloat16)
    out_k = csr_round_op(nbr, wq, Fq, lbase[widest], c=c, live=live)
    torch.cuda.synchronize()
    check_close(np, f"csr_round bf16 widest bucket ({nbr.shape[0]}x{nbr.shape[1]}, S={s})",
                out_k, csr_round_ref(nbr, wq, Fq, lbase[widest], c), BF16_TOL)
    del Fq, wq, out_k
    round_fault_checks(
        torch, np, "csr_round widest legacy bucket", nbr, live, F,
        lambda nb, lv, F_: csr_round_op(nb, wgt, F_, lbase[widest], c=c, live=lv),
        lambda F_: csr_round_ref(nbr, wgt, F_, lbase[widest], c),
    )

    def b3_round():
        for i, (_, nbr, wgt, live) in enumerate(lbuckets):
            csr_round_op(nbr, wgt, F, lbase[i], c=c, live=live,
                         out=lout[int(loffsets[i]):int(loffsets[i + 1])])
        return lout

    def b3_round_plain():
        return torch.cat([csr_round_ref(nbr, wgt, F, lbase[i], c)
                          for i, (_, nbr, wgt, _) in enumerate(lbuckets)])

    first = b3_round().clone()
    torch.cuda.synchronize()
    if not torch.equal(first, b3_round()):
        fail("csr_round: two launches gave different bytes")
    log(f"  csr_round: two full legacy rounds ({len(lbuckets)} launches each) are byte-identical")
    # library yardstick: one cuSPARSE CSR product c*base + A_bucket@F per bucket
    lcsr = []
    for _, nbr, wgt, _ in lbuckets:
        keep = wgt != 0
        lcsr.append(torch.sparse_coo_tensor(
            torch.stack([torch.nonzero(keep)[:, 0], nbr[keep].long()]),
            wgt[keep], (nbr.shape[0], n), check_invariants=True,
        ).coalesce().to_sparse_csr())

    def b3_round_lib():
        return [torch.addmm(lbase[i], a, F, beta=c) for i, a in enumerate(lcsr)]

    check_close(np, "csr_round full legacy round vs torch.addmm(CSR) per bucket",
                first, torch.cat(b3_round_lib()), F32_TOL)
    del first
    b3_ms = cuda_ms(torch, b3_round)
    b3_plain_ms = cuda_ms(torch, b3_round_plain, warmup=1, iters=3)
    b3_lib_ms = cuda_ms(torch, b3_round_lib)
    llive, lgathered = gather_counts([(nb, w, lv) for _, nb, w, lv in lbuckets])
    b3_bound, b3_by = bound(2.0 * lnnz * s, 4.0 * n * s * 3 + 8.0 * llive + 4.0 * n)
    b3_l2 = 4.0 * lgathered * s
    log(f"  csr_round full legacy round ({len(lbuckets)} buckets): "
        f"kernel {b3_ms:.4f} ms, plain {b3_plain_ms:.4f} ms, "
        f"torch.addmm(CSR) x{len(lcsr)} {b3_lib_ms:.4f} ms, bound {b3_bound:.4f} ms ({b3_by})")
    log(f"    {lslots} slots: {llive} live, {lgathered - llive} pads gathered, "
        f"{lslots - lgathered} pads skipped; {b3_l2 / 1e9:.2f} GB of F rows gathered from L2 "
        f"or HBM per round, {b3_l2 / b3_ms / 1e9:.1f} TB/s")
    del F, base, prev, lbase, lout, lcsr
    torch.cuda.empty_cache()

    # --------------------------------------------------- 4. the main path
    log("== phase 4: DHLP-2 fixed-seed all-sources solve, kernel vs sparse")
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_k = kernel_engine.run(net)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    log(f"  kernel engine: {res_k.outer_iters} rounds, {t_k:.3f} s wall "
        f"({t_k / res_k.outer_iters * 1e3:.2f} ms per round, solve to numpy F)")
    t0 = time.perf_counter()
    res_s = make_engine("sparse", cfg, device=dev).run(net)
    torch.cuda.synchronize()
    t_s = time.perf_counter() - t0
    log(f"  sparse engine: {res_s.outer_iters} rounds, {t_s:.3f} s wall "
        f"({t_s / res_s.outer_iters * 1e3:.2f} ms per round)")
    for res, name in ((res_k, "kernel"), (res_s, "sparse")):
        if res.F.shape != (n, n) or not np.isfinite(res.F).all() or not res.converged:
            fail(f"{name} solve: shape {res.F.shape}, finite={np.isfinite(res.F).all()}, "
                 f"converged={res.converged}")
    if res_k.outer_iters != res_s.outer_iters:
        fail(f"outer_iters differ: kernel {res_k.outer_iters} vs sparse {res_s.outer_iters}")
    if not np.array_equal(res_k.per_column_iters, res_s.per_column_iters):
        fail("per_column_iters differ between kernel and sparse")
    gap = float(np.max(np.abs(res_k.F - res_s.F)))
    log(f"  kernel vs sparse: max|ΔF| = {gap:.3e} (gate {AGREE_TOL})")
    if gap > AGREE_TOL:
        fail(f"kernel vs sparse max|ΔF| {gap} > {AGREE_TOL}")
    known = net.R[(0, 2)] > 0
    top_k = top10_lists(np, topk_exclusive, extract_outputs, res_k.F, norm, known)
    top_s = top10_lists(np, topk_exclusive, extract_outputs, res_s.F, norm, known)
    compare_top10(top_k, top_s, "kernel vs sparse")
    del res_s

    # ------------------------------------------- 5. the dense kernel solve
    log("== phase 5: dense lp_round solve (backend=dense, use_kernel=True)")
    t0 = time.perf_counter()
    res_d = solver.run(norm)
    torch.cuda.synchronize()
    t_d = time.perf_counter() - t0
    log(f"  dense use_kernel: {res_d.outer_iters} rounds, {t_d:.3f} s wall "
        f"({t_d / res_d.outer_iters * 1e3:.2f} ms per round)")
    if not np.isfinite(res_d.F).all() or res_d.outer_iters != res_k.outer_iters:
        fail(f"dense solve: finite={np.isfinite(res_d.F).all()}, "
             f"outer_iters {res_d.outer_iters} vs {res_k.outer_iters}")
    gap_d = float(np.max(np.abs(res_d.F - res_k.F)))
    log(f"  dense use_kernel vs kernel engine: max|ΔF| = {gap_d:.3e} (gate {AGREE_TOL})")
    if gap_d > AGREE_TOL:
        fail(f"dense vs kernel max|ΔF| {gap_d} > {AGREE_TOL}")
    compare_top10(top_k, top10_lists(np, topk_exclusive, extract_outputs, res_d.F, norm, known),
                  "dense use_kernel vs kernel")
    counts = launch_counts()
    del res_d
    trace_solve(torch, "dense lp_round solve", lambda: solver.run(norm))

    # ------------------- where the time goes: one traced kernel-engine solve
    trace_solve(torch, "kernel-engine solve", lambda: kernel_engine.run(net))

    # ------------------------------------------ 6. the legacy DHLP-2 loops
    log("== phase 6: legacy fused_superstep=False DHLP-2 solve, kernel and sparse")
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_lk = legacy_engine.run(net)
    torch.cuda.synchronize()
    t_lk = time.perf_counter() - t0
    legacy_counts = launch_counts()
    want_launches = len(lbuckets) * res_lk.outer_iters
    log(f"  kernel legacy: {res_lk.outer_iters} rounds, {t_lk:.3f} s wall "
        f"({t_lk / res_lk.outer_iters * 1e3:.2f} ms per round); launches {legacy_counts}")
    if legacy_counts["csr_round"] != want_launches:
        fail(f"csr_round launched {legacy_counts['csr_round']} times, expected "
             f"{len(lbuckets)} buckets x {res_lk.outer_iters} rounds = {want_launches}")
    if legacy_counts["csr_round_residual"] or legacy_counts["lp_round"]:
        fail(f"the legacy kernel loop launched other kernels: {legacy_counts}")
    t0 = time.perf_counter()
    res_ls = make_engine("sparse", cfg, device=dev, fused_superstep=False).run(net)
    torch.cuda.synchronize()
    t_ls = time.perf_counter() - t0
    log(f"  sparse legacy: {res_ls.outer_iters} rounds, {t_ls:.3f} s wall "
        f"({t_ls / res_ls.outer_iters * 1e3:.2f} ms per round)")
    if launch_counts() != legacy_counts:
        fail("the torch-op sparse legacy loop launched a CUDA kernel of the port")
    for res, name in ((res_lk, "kernel legacy"), (res_ls, "sparse legacy")):
        if res.F.shape != (n, n) or not np.isfinite(res.F).all() or not res.converged:
            fail(f"{name} solve: shape {res.F.shape}, finite={np.isfinite(res.F).all()}, "
                 f"converged={res.converged}")
        if res.outer_iters != res_k.outer_iters:
            fail(f"{name}: {res.outer_iters} rounds vs fused kernel {res_k.outer_iters}")
        if not np.array_equal(res.per_column_iters, res_k.per_column_iters):
            fail(f"{name}: per_column_iters differ from the fused kernel engine's")
        gap = float(np.max(np.abs(res.F - res_k.F)))
        log(f"  {name} vs fused kernel: max|ΔF| = {gap:.3e} (gate {AGREE_TOL})")
        if gap > AGREE_TOL:
            fail(f"{name} vs fused kernel max|ΔF| {gap} > {AGREE_TOL}")
        compare_top10(top_k, top10_lists(np, topk_exclusive, extract_outputs, res.F, norm, known),
                      f"{name} vs fused kernel")
    del res_lk, res_ls  # phase 4's res_k stays: phase 11 holds the observed solves to it
    trace_solve(torch, "legacy kernel-engine solve", lambda: legacy_engine.run(net))

    # ------------------------------------- 7. DHLP-1 on blocked-CSR engines
    log("== phase 7: DHLP-1 on sparse (fused and legacy) and dense")
    cfg1 = LPConfig(alg="dhlp1", alpha=0.5, sigma=1e-4, autotune=False)
    problem = make_recovery_problem(bundle, holdout_frac=0.1, max_entities=32, seed=0)
    log(f"  recovery problem: pair {problem.pair}, {problem.Y.shape[1]} seed rows, "
        f"{problem.num_heldout} held-out edges")
    reset_launch_counts()
    dhlp1 = {}
    for name, backend, kw in (("sparse fused", "sparse", {}),
                              ("sparse legacy", "sparse", {"fused_superstep": False}),
                              ("dense", "dense", {})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve_recovery(problem, backend, lp=cfg1, device=dev, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not np.isfinite(res.F).all() or not res.converged or res.inner_iters <= 0:
            fail(f"DHLP-1 {name}: finite={np.isfinite(res.F).all()}, "
                 f"converged={res.converged}, inner_iters={res.inner_iters}")
        m = problem.metrics(res.F)
        log(f"  {name}: recovery_auc {m['recovery_auc']:.6f}, aupr {m['recovery_aupr']:.6f}, "
            f"{res.outer_iters} outer / {res.inner_iters} inner rounds, {wall:.3f} s wall")
        dhlp1[name] = res
    for name in ("sparse fused", "sparse legacy"):
        gap = float(np.max(np.abs(dhlp1[name].F - dhlp1["dense"].F)))
        log(f"  DHLP-1 recovery {name} vs dense: max|ΔF| = {gap:.3e} (gate {AGREE_TOL})")
        if gap > AGREE_TOL or dhlp1[name].outer_iters != dhlp1["dense"].outer_iters:
            fail(f"DHLP-1 recovery {name} vs dense: max|ΔF| {gap}, outer_iters "
                 f"{dhlp1[name].outer_iters} vs {dhlp1['dense'].outer_iters}")
    del dhlp1
    alls = {}
    for name, backend in (("sparse fused", "sparse"), ("dense", "dense")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = make_engine(backend, cfg1, device=dev).run(net)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if res.F.shape != (n, n) or not np.isfinite(res.F).all() or not res.converged:
            fail(f"DHLP-1 all-sources {name}: shape {res.F.shape}, "
                 f"finite={np.isfinite(res.F).all()}, converged={res.converged}")
        log(f"  DHLP-1 all-sources {name}: {res.outer_iters} outer / {res.inner_iters} inner "
            f"rounds, {wall:.3f} s wall")
        alls[name] = res
    gap = float(np.max(np.abs(alls["sparse fused"].F - alls["dense"].F)))
    log(f"  DHLP-1 all-sources sparse fused vs dense: max|ΔF| = {gap:.3e} (gate {AGREE_TOL})")
    if gap > AGREE_TOL or alls["sparse fused"].outer_iters != alls["dense"].outer_iters:
        fail(f"DHLP-1 all-sources sparse vs dense: max|ΔF| {gap}, outer_iters "
             f"{alls['sparse fused'].outer_iters} vs {alls['dense'].outer_iters}")
    log(f"  launches on the DHLP-1 path (torch-op engines): {launch_counts()}")
    dhlp1_main = alls["sparse fused"]  # phase 13 holds the sharded DHLP-1 solve to it
    del alls
    dhlp1_engine = make_engine("sparse", cfg1, device=dev)
    dhlp1_engine.prepare(net)
    trace_solve(torch, "DHLP-1 all-sources sparse fused solve", lambda: dhlp1_engine.run(net))

    # --------------------------- 8. model-slice kernels vs plain versions
    log("== phase 8: csr_aggregate and embedding_bag vs plain versions")
    torch.cuda.empty_cache()
    gcfg = cells.gcn_at_shape(gcn_cora.FULL, "ogb_products")
    gsh = cells.GNN_SHAPES["ogb_products"]
    t0 = time.perf_counter()
    data = planted_partition_graph(gsh["n_nodes"], gsh["n_edges"], gsh["n_classes"],
                                   gsh["d_feat"], seed=0, device=dev)
    t_gen = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nbr, wgt, glive = gcn_adjacency_live(data.edges, device=dev)
    feats = torch.from_numpy(data.feats).to(dev)
    torch.cuda.synchronize()
    t_adj = time.perf_counter() - t0
    gn, gd = (int(x) for x in nbr.shape)
    g_nnz = data.edges.num_edges
    log(f"  ogb_products planted graph: {gn} nodes, {gsh['n_edges']} drawn edges, "
        f"{g_nnz} after symmetrizing and self-loops; generated in {t_gen:.1f} s "
        "(numpy draws on the host, deduplication on the card)")
    log(f"  GCN operator D^-1/2 A D^-1/2 as padded CSR ({gn} x {gd}, {gn * gd} slots, "
        f"{1 - g_nnz / (gn * gd):.3f} padding), built on the card in {t_adj:.2f} s "
        "(upload, normalise, sort, pack)")
    gen = torch.Generator(device=dev).manual_seed(0)
    h16 = torch.rand((gn, gcfg.d_hidden), generator=gen, device=dev)

    b4_live, b4_gathered = gather_counts([(nbr, wgt, glive)])
    log(f"  live lengths: {b4_live} live slots of {gn * gd}; {b4_gathered - b4_live} rows "
        f"gather their first pad, {gn * gd - b4_gathered} pad slots skipped")

    def b4_bound(s_):  # F read and out written once, the live nbr/wgt slots, the lengths
        return bound(2.0 * g_nnz * s_, 4.0 * gn * s_ * 2 + 8.0 * b4_live + 4.0 * gn)

    b4 = {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "lib_ms": 0.0, "bound_ms": 0.0, "all_ms": 0.0}
    keep = wgt != 0
    a_csr = torch.sparse_coo_tensor(
        torch.stack([torch.nonzero(keep)[:, 0], nbr[keep].long()]), wgt[keep], (gn, gn),
        check_invariants=True,
    ).coalesce().to_sparse_csr()
    del keep
    for label, F_ in (("layer 1", feats), ("layer 2", h16)):
        s_ = int(F_.shape[1])
        out_k = csr_aggregate_op(nbr, wgt, F_, live=glive)
        torch.cuda.synchronize()
        out_p = csr_aggregate_ref(nbr, wgt, F_)
        tag = f"csr_aggregate f32 {label} with live (M={gn}, D={gd}, S={s_})"
        b4["err"] = max(b4["err"], check_close(np, tag, out_k, out_p, F32_TOL))
        if not torch.equal(out_k, csr_aggregate_op(nbr, wgt, F_, live=glive)):
            fail(f"{tag}: two launches gave different bytes")
        check_close(np, tag + " vs torch.sparse.mm(CSR)", out_k, torch.sparse.mm(a_csr, F_),
                    F32_TOL)
        check_close(np, f"csr_aggregate f32 {label} without live", csr_aggregate_op(nbr, wgt, F_),
                    out_p, F32_TOL)
        del out_k, out_p
        ms = cuda_ms(torch, lambda: csr_aggregate_op(nbr, wgt, F_, live=glive))
        all_ms = cuda_ms(torch, lambda: csr_aggregate_op(nbr, wgt, F_))
        plain_ms = cuda_ms(torch, lambda: csr_aggregate_ref(nbr, wgt, F_), warmup=1, iters=2)
        lib_ms = cuda_ms(torch, lambda: torch.sparse.mm(a_csr, F_))
        bms, by = b4_bound(s_)
        rows_gb = 4.0 * b4_gathered * s_ / 1e9
        log(f"    kernel {ms:.4f} ms (all {gd} slots: {all_ms:.4f} ms), plain {plain_ms:.4f} ms, "
            f"torch.sparse.mm(CSR) {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
        log(f"    {b4_gathered} slots gathered, {rows_gb:.2f} GB of F rows, "
            f"{rows_gb / ms:.2f} TB/s; those gathers from HBM alone would take "
            f"{rows_gb * 1e9 / PEAK_BYTES * 1e3:.4f} ms (F is {4.0 * gn * s_ / 1e9:.2f} GB)")
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("lib_ms", lib_ms),
                         ("bound_ms", bms), ("all_ms", all_ms)):
            b4[key] += val
    b4["by"] = by
    # a NaN in the F row the pads name (node 0) reaches the rows that have pads
    h_nan = h16.clone()
    h_nan[0] = float("nan")
    want = csr_aggregate_ref(nbr, wgt, h_nan)
    ok, err = agrees(np, csr_aggregate_op(nbr, wgt, h_nan, live=glive), want, F32_TOL)
    nan_rows = int(torch.isnan(want).any(dim=1).sum())
    if not ok:
        fail(f"csr_aggregate with live: NaN in F row 0 reaches other rows than in the plain "
             f"version ({nan_rows} rows) or values differ (max|Δ| {err:.3e})")
    log(f"  csr_aggregate with live: NaN in pad-named F row 0 reaches the same {nan_rows} rows "
        "as the plain version")
    del h_nan, want
    fq, wq = feats.to(torch.bfloat16), wgt.to(torch.bfloat16)
    out_k = csr_aggregate_op(nbr, wq, fq, live=glive)
    torch.cuda.synchronize()
    check_close(np, f"csr_aggregate bf16 layer 1 with live (S={gcfg.d_feat})", out_k,
                csr_aggregate_ref(nbr, wq, fq), BF16_TOL)
    log(f"    kernel bf16 {cuda_ms(torch, lambda: csr_aggregate_op(nbr, wq, fq, live=glive)):.4f} ms")
    del fq, wq, out_k, h16, a_csr
    log(f"  csr_aggregate per GCN forward (both layers, live): kernel {b4['ms']:.4f} ms "
        f"(all slots: {b4['all_ms']:.4f} ms), plain {b4['plain_ms']:.4f} ms, "
        f"torch.sparse.mm(CSR) {b4['lib_ms']:.4f} ms, bound {b4['bound_ms']:.4f} ms ({b4['by']})")

    # the Wide & Deep model (its 5.12 GB table made on the card) and inputs
    torch.cuda.empty_cache()
    wcfg = wide_deep.FULL
    dcfg = CTRDataConfig(wcfg.n_sparse, wcfg.n_dense, wcfg.vocab_per_field, seed=0)
    t0 = time.perf_counter()
    batches = {name: sample_ctr_batch(dcfg, cells.RECSYS_SHAPES[name]["batch"])
               for name in ("serve_p99", "serve_bulk", "retrieval_cand")}
    sizes = ", ".join(f"{k} {len(v['labels'])}" for k, v in batches.items())
    log(f"  CTR batches ({sizes}) sampled in {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    wd = WideDeep(wcfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    with torch.no_grad():  # the reference's zero inits, made random so every term counts
        wgen = torch.Generator(device=dev).manual_seed(1)
        wd.wide_table.normal_(0.0, 0.02, generator=wgen)
        wd.wide_dense.normal_(0.0, 0.1, generator=wgen)
        wd.bias.fill_(-0.7)
        for b in wd.mlp_b:
            b.normal_(0.0, 0.02, generator=wgen)
    torch.cuda.synchronize()
    table_bytes = wd.table.numel() * wd.table.element_size()
    log(f"  wide-deep FULL: {wcfg.param_count()} parameters, table {tuple(wd.table.shape)} "
        f"({table_bytes / 1e9:.2f} GB), made on the card in {time.perf_counter() - t0:.2f} s")
    bulk = batches["serve_bulk"]
    rows = wd.rows(bulk["sparse"])
    bb = int(rows.shape[0])
    deep_idx = rows.reshape(-1, 1)
    deep_w = torch.ones(deep_idx.shape, device=dev)
    wide_tab = wd.wide_table[:, None]
    wide_w = torch.ones(rows.shape, device=dev)
    b5 = {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "lib_ms": 0.0, "bound_ms": 0.0,
          "ops": 0.0, "bytes": 0.0}
    for label, tab, idx, w in (("deep", wd.table, deep_idx, deep_w),
                               ("wide", wide_tab, rows, wide_w)):
        b_, k_ = (int(x) for x in idx.shape)
        d_ = int(tab.shape[1])
        tag = f"embedding_bag f32 {label} serve_bulk (V={tab.shape[0]}, D={d_}, B={b_}, K={k_})"
        out_k = embedding_bag_op(tab, idx, w)
        log(f"    {label}: {launch_plan(tab, idx, w, out_k)}")
        torch.cuda.synchronize()
        out_p = embedding_bag_ref(tab, idx, w)
        b5["err"] = max(b5["err"], check_close(np, tag, out_k, out_p, F32_TOL))
        if label == "deep" and not torch.equal(out_k, tab[idx[:, 0].long()]):
            fail(f"{tag}: one slot of weight 1.0 is not an exact gather")
        if not torch.equal(out_k, embedding_bag_op(tab, idx, w)):
            fail(f"{tag}: two launches gave different bytes")
        lib = lambda: torch.nn.functional.embedding_bag(  # noqa: E731
            idx, tab, mode="sum", per_sample_weights=w)
        check_close(np, tag + " vs F.embedding_bag", out_k, lib(), F32_TOL)
        del out_k, out_p
        ms = cuda_ms(torch, lambda: embedding_bag_op(tab, idx, w))
        plain_ms = cuda_ms(torch, lambda: embedding_bag_ref(tab, idx, w))
        lib_ms = cuda_ms(torch, lib)
        n_rows = int(torch.unique(idx).numel())
        ops, nbytes = 2.0 * b_ * k_ * d_, 8.0 * b_ * k_ + 4.0 * n_rows * d_ + 4.0 * b_ * d_
        bms, by = bound(ops, nbytes)
        log(f"    {n_rows} distinct rows; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"F.embedding_bag {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}); the bound's "
            f"{nbytes / 1e9:.4f} GB at {nbytes / ms / 1e9:.3f} TB/s")
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("lib_ms", lib_ms),
                         ("ops", ops), ("bytes", nbytes)):
            b5[key] += val
    b5["bound_ms"], b5["by"] = bound(b5["ops"], b5["bytes"])
    log(f"  embedding_bag per serve_bulk call (deep + wide): kernel {b5['ms']:.4f} ms, plain "
        f"{b5['plain_ms']:.4f} ms, F.embedding_bag {b5['lib_ms']:.4f} ms, "
        f"bound {b5['bound_ms']:.4f} ms ({b5['by']})")
    # the deep lookup written in place into the padded MLP input, as the
    # model's kernel path does, against the contiguous launch and the
    # concatenation it replaces
    ld = wd.deep_in_stride
    head = wcfg.n_sparse * wcfg.embed_dim
    mlp_in = torch.full((bb, ld), float("nan"), device=dev)
    view = mlp_in[:, :head].view(bb, wcfg.n_sparse, wcfg.embed_dim)
    embedding_bag_op(wd.table, deep_idx, deep_w, out=view)
    log(f"    deep into the MLP input (G={wcfg.n_sparse}, ld={ld}): "
        f"{launch_plan(wd.table, deep_idx, deep_w, view)}")
    if not torch.equal(view.reshape(-1, wcfg.embed_dim),
                       embedding_bag_op(wd.table, deep_idx, deep_w)):
        fail("embedding_bag deep into the MLP input differs from the contiguous launch")
    if not torch.isnan(mlp_in[:, head:]).all():
        fail("embedding_bag deep into the MLP input wrote past its head")
    strided_ms = cuda_ms(torch, lambda: embedding_bag_op(wd.table, deep_idx, deep_w, out=view))
    flat, dense_b = view.reshape(bb, head).contiguous(), torch.rand((bb, wcfg.n_dense), device=dev)
    cat_ms = cuda_ms(torch, lambda: torch.cat([flat, dense_b], dim=-1))
    log(f"    deep into the MLP input {strided_ms:.4f} ms; the torch.cat it replaces "
        f"{cat_ms:.4f} ms")
    del mlp_in, view, flat, dense_b
    # a ragged launch: serve_bulk's deep bags minus 17, K = 3 Zipf ids, random weights
    # (the serve shapes are multiples of every tile the kernel picks)
    rb = bb * wcfg.n_sparse - 17
    ids = rows.reshape(-1)
    ridx = torch.stack([ids[:rb], ids[5 : 5 + rb], ids[17 : 17 + rb]], dim=1)
    rw = torch.rand((rb, 3), generator=gen, device=dev)
    tag = f"embedding_bag f32 ragged (V={wd.table.shape[0]}, D={wcfg.embed_dim}, B={rb}, K=3)"
    out_k = embedding_bag_op(wd.table, ridx, rw)
    log(f"    ragged: {launch_plan(wd.table, ridx, rw, out_k)}")
    b5["err"] = max(b5["err"], check_close(np, tag, out_k, embedding_bag_ref(wd.table, ridx, rw),
                                           F32_TOL))
    check_close(np, tag + " vs F.embedding_bag", out_k, torch.nn.functional.embedding_bag(
        ridx, wd.table, mode="sum", per_sample_weights=rw), F32_TOL)
    if not torch.equal(out_k, embedding_bag_op(wd.table, ridx, rw)):
        fail(f"{tag}: two launches gave different bytes")
    log(f"    ragged kernel {cuda_ms(torch, lambda: embedding_bag_op(wd.table, ridx, rw)):.4f} ms")
    del deep_idx, deep_w, wide_w, rows, ids, ridx, rw, out_k

    # ------------------------------------ 9. GCN full-graph inference
    log("== phase 9: GCN full-graph inference, gcn-cora at ogb_products widths")
    gcn = GCN(gcfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    aggregate_op = gnn_module.csr_aggregate_op
    with_live = []

    def recording_aggregate(*args, **kw):  # notes whether each launch had live lengths
        with_live.append(kw.get("live") is not None)
        return aggregate_op(*args, **kw)

    gnn_module.csr_aggregate_op = recording_aggregate
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        logits = gcn(feats, nbr, wgt, glive)
        torch.cuda.synchronize()
    finally:
        gnn_module.csr_aggregate_op = aggregate_op
    t_first = time.perf_counter() - t0
    gcn_counts = launch_counts()
    log(f"  kernel path: logits {tuple(logits.shape)} in {t_first:.4f} s wall; "
        f"launches {gcn_counts}, with live lengths: {with_live}")
    if gcn_counts["csr_aggregate"] != gcfg.n_layers or sum(gcn_counts.values()) != gcfg.n_layers:
        fail(f"GCN forward launched {gcn_counts}, expected {gcfg.n_layers} csr_aggregate")
    if with_live != [True] * gcfg.n_layers:
        fail(f"GCN forward: csr_aggregate calls with live lengths {with_live}")
    if logits.shape != (gn, gcfg.n_classes) or not torch.isfinite(logits).all():
        fail(f"GCN logits: shape {tuple(logits.shape)} or non-finite values")
    walls = wall_s(torch, lambda: gcn(feats, nbr, wgt, glive), iters=5)
    gcn.use_kernel = False
    plain_logits = gcn(feats, nbr, wgt)
    plain_walls = wall_s(torch, lambda: gcn(feats, nbr, wgt), iters=2)
    gcn.use_kernel = True
    check_close(np, "GCN logits, kernel path vs plain path", logits, plain_logits, F32_TOL)
    log(f"  forward wall: kernel path {', '.join(f'{t * 1e3:.2f}' for t in walls)} ms; "
        f"plain path {', '.join(f'{t * 1e3:.2f}' for t in plain_walls)} ms")
    log(f"  predicted-class agreement with the planted labels: "
        f"{float((logits.argmax(1).cpu().numpy() == data.labels).mean()):.4f} "
        "(random weights: near chance, 1/47)")
    del logits, plain_logits
    trace_solve(torch, "GCN forward", lambda: gcn(feats, nbr, wgt, glive))
    del gcn, nbr, wgt, glive, feats, data
    torch.cuda.empty_cache()

    # --------------------------------------------- 10. Wide & Deep serving
    log("== phase 10: Wide & Deep FULL serving: serve_p99, serve_bulk, retrieval_cand")
    serve = make_serve(wd)
    score = make_retrieval_scorer(wd)
    n_cand = cells.pad512(cells.RECSYS_SHAPES["retrieval_cand"]["n_candidates"])
    cand = torch.rand((n_cand, wcfg.mlp_dims[-1]), generator=gen, device=dev)
    q = batches["retrieval_cand"]
    calls = {
        "serve_p99": lambda: serve(batches["serve_p99"]["sparse"], batches["serve_p99"]["dense"]),
        "serve_bulk": lambda: serve(bulk["sparse"], bulk["dense"]),
        "retrieval_cand": lambda: score(q["sparse"], q["dense"], cand),
    }
    want_launches = {"serve_p99": 2, "serve_bulk": 2, "retrieval_cand": 1}
    reset_launch_counts()
    outs = {}
    for name, fn in calls.items():
        before = launch_counts()["embedding_bag"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[name] = fn()
        torch.cuda.synchronize()
        got = launch_counts()["embedding_bag"] - before
        log(f"  {name}: output {tuple(outs[name].shape)}, first call {time.perf_counter() - t0:.4f} s, "
            f"{got} embedding_bag launches")
        if got != want_launches[name]:
            fail(f"{name}: {got} embedding_bag launches, expected {want_launches[name]}")
    wd_counts = launch_counts()
    if sum(wd_counts.values()) != wd_counts["embedding_bag"]:
        fail(f"Wide & Deep launched other kernels: {wd_counts}")
    rows_b, dense_b = wd.rows(bulk["sparse"]), wd._dense(bulk["dense"])
    deep_in = wd._deep_in(rows_b, dense_b)
    wd.use_kernel = False
    if not torch.equal(deep_in, wd._deep_in(rows_b, dense_b)):
        fail("serve_bulk: the deep input written in place differs from the plain path's torch.cat")
    wd.use_kernel = True
    log(f"  serve_bulk deep input {tuple(deep_in.shape)}, row stride {deep_in.stride(0)}: "
        "written in place, equal to the plain path's torch.cat")
    del rows_b, dense_b, deep_in
    expect = {"serve_p99": (512,), "serve_bulk": (bb,), "retrieval_cand": (n_cand,)}
    for name, fn in calls.items():
        out = outs[name]
        if tuple(out.shape) != expect[name] or not torch.isfinite(out).all():
            fail(f"{name}: shape {tuple(out.shape)} or non-finite values")
        walls = wall_s(torch, fn, iters=20 if name != "serve_bulk" else 5)
        wd.use_kernel = False
        plain = fn()
        plain_walls = wall_s(torch, fn, iters=3)
        wd.use_kernel = True
        check_close(np, f"{name} kernel path vs plain path", out, plain, F32_TOL)
        walls_ms = sorted(t * 1e3 for t in walls)
        log(f"    wall per call: kernel path median {walls_ms[len(walls_ms) // 2]:.3f} ms, "
            f"min {walls_ms[0]:.3f}, max {walls_ms[-1]:.3f} ({len(walls)} calls); plain path "
            f"{', '.join(f'{t * 1e3:.3f}' for t in plain_walls)} ms")
    p = outs["serve_bulk"]
    log(f"  serve_bulk probabilities: mean {float(p.mean()):.4f}, min {float(p.min()):.4f}, "
        f"max {float(p.max()):.4f}")
    if not bool(((p > 0) & (p < 1)).all()):
        fail("serve_bulk: probabilities outside (0, 1)")
    peak = torch.cuda.max_memory_allocated() - mem0
    log(f"  device memory: max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.3f} GB, "
        f"{peak / 1e9:.3f} GB of it since the model was made (table {table_bytes / 1e9:.3f} GB "
        "resident)")
    if peak < table_bytes:
        fail(f"peak device memory {peak} below the table's {table_bytes} bytes")
    _, _, by_name = trace_solve(torch, "Wide & Deep serve_bulk call", calls["serve_bulk"])
    cats = [name for name in by_name if "Cat" in name]
    if cats:
        fail(f"serve_bulk on the kernel path concatenated on the card: {cats}")
    b5_us = sum(t for name, (t, _) in by_name.items() if "bag_" in name)
    log(f"  serve_bulk trace: embedding_bag kernels {b5_us / 1e3:.3f} ms, no concatenation")
    del wd, serve, score, calls, cand, outs, p, wide_tab  # the bound methods hold the table
    torch.cuda.empty_cache()

    # ------------------------ 10a. flash_attention vs its plain version
    log("== phase 10a: flash_attention vs its plain version at the transformer path's shapes")
    b6 = flash_kernel_phase(torch, np, dev)
    b6_head = b6["rows"][0]  # the prefill_32k layer launch

    # ------------------- 10b. transformer agreement at full width, f32
    log("== phase 10b: h2o-danube-1.8b FULL widths in f32, kernel path vs plain path")
    transformer_agreement_phase(torch, np, dev)

    # --------------------- 10c. transformer serving at full size, bf16
    log("== phase 10c: h2o-danube-1.8b FULL serving in bf16 on the kernel path")
    serving = transformer_serving_phase(torch, np, dev)

    # ---------------------------------------------- 11. the entry point
    log("== phase 11: the normal entry point (python -m repro_torch run, Session, serve)")
    entry = entry_point_phase(torch, np, dev, bundle, res_k, b1_ms, b3_ms)

    # --------------------------------------------- 12. the bench harness
    t0 = time.perf_counter()
    bench_phase()
    bench_b4 = lp_on_graph_launches(torch, dev)
    log(f"  phase 12: {time.perf_counter() - t0:.1f} s")

    # -------------------------- 13. the autotune sweep and the sharded engine
    t0 = time.perf_counter()
    log("== phase 13 (a): the autotune sweep at full width, the tuned kernel solves")
    tuned = autotune_phase(torch, np, dev, net, res_k, top_k)
    log("== phase 13 (b): the sharded engine on a world of one NCCL rank")
    sharded_phase(torch, np, dev, net, res_k, dhlp1_main, top_k, b1_ms)
    del res_k, dhlp1_main
    log(f"  phase 13: {time.perf_counter() - t0:.1f} s")

    # ------ 15. dhlp-bio at the paper's scales and the GNN zoo (run before
    # the kernel list of phase 14, which counts their launches)
    t0 = time.perf_counter()
    zoo = zoo_phase(torch, np, dev)
    log(f"  phase 15: {time.perf_counter() - t0:.1f} s")

    # ----------------------------- 17. the MoE and MLA models (run before
    # the kernel list of phase 14, which counts their launches)
    t0 = time.perf_counter()
    moe_mla = moe_mla_phase(torch, np, dev)
    log(f"  phase 17: {time.perf_counter() - t0:.1f} s")

    # ------------------------------- 18. training (run before the kernel
    # list of phase 14, which counts B4's forward and backward launches)
    t0 = time.perf_counter()
    train = training_phase(torch, np, dev)
    log(f"  phase 18: {time.perf_counter() - t0:.1f} s")

    # --------------- 19. the dry run (before the kernel list of phase 14;
    # it launches no kernel: its counts must stay as the phases left them)
    before = launch_counts()
    dryrun_phase()
    if launch_counts() != before:
        fail("phase 19 launched a kernel of the port")

    # ------------------------------------------------ 14. the kernel list
    log("== phase 14: kernels")
    counts["csr_round_residual"] += entry["serve_b1"] + tuned["b1"]
    b1_err = max(b1_err, entry["b1_err"], tuned["b1_err"])
    b3_err = max(b3_err, tuned["b3_err"], zoo["b3_err"])
    b4["err"] = max(b4["err"], zoo["b4_err"])
    if zoo["b3"] <= 0 or zoo["b4"] <= 0:
        fail(f"phase 15 launched csr_round {zoo['b3']} and csr_aggregate {zoo['b4']} times")
    counts["csr_round"] = legacy_counts["csr_round"] + entry["b3"] + tuned["b3"] + zoo["b3"]
    counts["csr_aggregate"] = gcn_counts["csr_aggregate"] + zoo["b4"] + bench_b4[0] + train["b4_fwd"]
    counts["csr_aggregate_backward"] = bench_b4[1] + train["b4_bwd_launches"]
    if bench_b4[1] <= 0 or train["b4_bwd_launches"] <= 0:
        fail(f"csr_aggregate's backward launched {bench_b4[1]} times in phase 12 and "
             f"{train['b4_bwd_launches']} in phase 18")
    b4_bwd = train["b4_bwd"]
    counts["embedding_bag"] = wd_counts["embedding_bag"]
    counts["flash_attention"] = serving["launches"] + moe_mla["launches"]
    for name, cnt in counts.items():
        if cnt <= 0:
            fail(f"kernel {name} was not launched on its path")
    kernels = [
        {
            "name": "csr_round_residual",
            "route": "cuda",
            "source": "src/repro_torch/csrc/csr_round_residual.cu",
            "replaces": "src/repro/kernels/segment_reduce/kernel.py:246",
            "launches": counts["csr_round_residual"],
            "max_abs_err": b1_err,
            "ms": b1_ms,
            "plain_ms": b1_plain_ms,
            "bound_ms": b1_bound,
            "bound_by": b1_by,
            "library_ms": b1_lib_ms,
        },
        {
            "name": "csr_round",
            "route": "cuda",
            "source": "src/repro_torch/csrc/csr_round.cu",
            "replaces": "src/repro/kernels/segment_reduce/kernel.py:192",
            "launches": counts["csr_round"],
            "max_abs_err": b3_err,
            "ms": b3_ms,
            "plain_ms": b3_plain_ms,
            "bound_ms": b3_bound,
            "bound_by": b3_by,
            "library_ms": b3_lib_ms,
        },
        {
            "name": "lp_round",
            "route": "cuda",
            "source": "src/repro_torch/csrc/lp_round.cu",
            "replaces": "src/repro/kernels/lp_blockspmm/kernel.py:48",
            "launches": counts["lp_round"],
            "max_abs_err": b2_err,
            "ms": b2_ms,
            "plain_ms": b2_plain_ms,
            "bound_ms": b2_bound,
            "bound_by": b2_by,
            "library_ms": b2_lib_ms,
        },
        {
            "name": "csr_aggregate",
            "route": "cuda",
            "source": "src/repro_torch/csrc/csr_aggregate.cu",
            "replaces": "src/repro/kernels/segment_reduce/kernel.py:147",
            "launches": counts["csr_aggregate"],
            "max_abs_err": b4["err"],
            "ms": b4["ms"],
            "plain_ms": b4["plain_ms"],
            "bound_ms": b4["bound_ms"],
            "bound_by": b4["by"],
            "library_ms": b4["lib_ms"],
        },
        {
            "name": "csr_aggregate_backward",
            "route": "cuda",
            "source": "src/repro_torch/csrc/csr_aggregate.cu",
            "replaces": "src/repro/kernels/segment_reduce/kernel.py:147",
            "launches": counts["csr_aggregate_backward"],
            "max_abs_err": b4_bwd["err"],
            "ms": b4_bwd["ms"],
            "plain_ms": b4_bwd["plain_ms"],
            "bound_ms": b4_bwd["bound_ms"],
            "bound_by": b4_bwd["by"],
            "library_ms": b4_bwd["lib_ms"],
        },
        {
            "name": "embedding_bag",
            "route": "cuda",
            "source": "src/repro_torch/csrc/embedding_bag.cu",
            "replaces": "src/repro/kernels/embedding_bag/kernel.py:57",
            "launches": counts["embedding_bag"],
            "max_abs_err": b5["err"],
            "ms": b5["ms"],
            "plain_ms": b5["plain_ms"],
            "bound_ms": b5["bound_ms"],
            "bound_by": b5["by"],
            "library_ms": b5["lib_ms"],
        },
        {
            "name": "flash_attention",
            "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:85",
            "launches": counts["flash_attention"],
            "max_abs_err": b6["err"],
            "ms": b6_head["ms"],
            "plain_ms": b6_head["plain_ms"],
            "bound_ms": b6_head["bound_ms"],
            "bound_by": b6_head["by"],
            "library_ms": b6_head["lib_ms"],
        },
    ]
    log(f"  total {time.perf_counter() - t_script:.1f} s")
    print(smi_name_and_limit(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    # ----------------------------------------------------- 16. the result
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
