#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

1. device: card name, ``nvidia-smi`` name and power limit, TF32 off;
2. build: every CUDA kernel of the port, one ``nvcc`` per source, in
   parallel; prints the build time (in all and per source) and the
   ``-Xptxas -v`` report;
3. kernels vs their plain PyTorch versions at their paths' shapes
   (``powerlaw`` scenario, scale 1.0, seed 0: 4,396 nodes, S = 4,396
   seed columns), with CUDA-event timings, bounds and library yardsticks:
   ``csr_round_residual`` on the fused plan's buckets, ``lp_round`` on
   the dense operator, ``csr_round`` on every bucket of the legacy
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
   S = 100 and 16; f32, and bf16 at S = 100), ``embedding_bag`` at the
   deep and wide lookups of Wide & Deep ``FULL`` at ``serve_bulk``;
9. GCN (``gcn-cora`` at ``ogb_products`` widths) full-graph inference:
   graph build on host and device, then the forward on the kernel path
   (two ``csr_aggregate`` launches) and on the plain path, which must
   agree at f32 ``rtol=2e-4, atol=5e-4``;
10. Wide & Deep ``FULL`` serving: ``serve_p99``, ``serve_bulk`` and
    ``retrieval_cand`` on the kernel path (two ``embedding_bag`` launches
    per serve call, one per retrieval call) and on the plain path, at the
    same tolerance; peak device memory with the 5.12 GB table resident;
10a. ``flash_attention`` vs its plain version at the transformer path's
    shapes (``h2o-danube-1.8b`` prefill_32k and decode_32k layer launches
    and an 8k f32 one, a ``stablelm-1.6b`` 4k one), bf16 held at
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
11. the kernel list: launches of each kernel on its path (phases 4-5 for
    ``csr_round_residual`` and ``lp_round``, phase 6 for ``csr_round``,
    phase 9 for ``csr_aggregate``, phase 10 for ``embedding_bag``, phase
    10c for ``flash_attention``; all must be non-zero), with the phase 3,
    8 and 10a measurements;
12. the result line.

Phases 4, 6, 7, 9, 10 and 10c each also trace calls with
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
PEAK_BYTES = 3.35e12  # HBM3
F32_TOL = dict(rtol=2e-4, atol=5e-4)  # tests/test_kernels.py::_tol
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# B6 vs its plain version in bf16: both score, softmax and sum in f32 and
# round only the output, so they differ by at most one unit in the last
# place (2**-7 of the value); atol covers f32 summation order near zero.
FLASH_BF16_TOL = dict(rtol=2e-2, atol=1e-5)
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


def check_close(np, name, got, want, tol) -> float:
    got = got.float().cpu().numpy()
    want = want.float().cpu().numpy()
    if got.shape != want.shape or not np.isfinite(got).all():
        fail(f"{name}: shape {got.shape} vs {want.shape} or non-finite values")
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    if not np.allclose(got, want, **tol):
        fail(f"{name}: kernel disagrees with its plain version, max|Δ|={err}")
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
    busy_us, end = 0.0, None
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in events):
        if end is None or start > end:
            busy_us += stop - start
            end = stop
        elif stop > end:
            busy_us += stop - end
            end = stop
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
)


def live_pairs(np, lq, lk, q_offset, window) -> int:
    """(q, k) pairs a causal, optionally windowed, attention computes."""
    qp = np.arange(lq, dtype=np.int64) + q_offset
    hi = np.minimum(lk - 1, qp)
    lo = np.maximum(0, qp - window + 1) if window else np.zeros_like(qp)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def device_kernel_names(torch, fn) -> list:
    """Names of the device kernels one call of ``fn`` runs, recorded in the
    second of two profiled steps (``trace_solve``'s warm-up: the first
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
        fail("profile of an SDPA call: the profiler recorded no step")
    return sorted({e.name for e in recorded[0] if e.device_type != DeviceType.CPU
                   and not e.name.startswith("ProfilerStep")})


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
    got = got.float().cpu().numpy()
    want = want.float().cpu().numpy()
    both = np.isfinite(got) & np.isfinite(want)
    err = float(np.max(np.abs(got[both] - want[both]))) if both.any() else 0.0
    ok = np.array_equal(np.isnan(got), np.isnan(want)) and np.allclose(
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
    from repro_torch.kernels.common import build_all
    from repro_torch.kernels.lp_blockspmm import lp_round_op, lp_round_ref
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
    from repro_torch.kernels.embedding_bag import embedding_bag_op, embedding_bag_ref
    from repro_torch.kernels.segment_reduce import csr_aggregate_op, csr_aggregate_ref
    from repro_torch.models.gnn import GCN, gcn_adjacency
    from repro_torch.models.recsys import WideDeep, make_retrieval_scorer, make_serve

    t_script = time.perf_counter()
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
    libs = build_all(list(SOURCES))
    log(f"  built {len(libs)} kernel libraries in {time.perf_counter() - t0:.1f} s "
        "(one nvcc per source, in parallel)")
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
    out_k = lp_round_op(A_eff, F, base, c=c)
    torch.cuda.synchronize()
    out_p = lp_round_ref(A_eff, F, base, c)
    torch.cuda.synchronize()
    b2_err = check_close(np, f"lp_round f32 (N={n}, S={s})", out_k, out_p, F32_TOL)
    o2 = lp_round_op(A_eff, F, base, c=c)
    torch.cuda.synchronize()
    if not torch.equal(out_k, o2):
        fail("lp_round: two launches gave different bytes")
    del out_k, out_p, o2
    b2_ms = cuda_ms(torch, lambda: lp_round_op(A_eff, F, base, c=c), iters=5)
    b2_plain_ms = cuda_ms(torch, lambda: lp_round_ref(A_eff, F, base, c), iters=5)
    b2_lib_ms = cuda_ms(torch, lambda: torch.addmm(base, A_eff, F, beta=c), iters=5)
    b2_bound, b2_by = bound(2.0 * n * n * s, 4.0 * (n * n + 3 * n * s))
    log(f"  lp_round: kernel {b2_ms:.4f} ms, plain {b2_plain_ms:.4f} ms, "
        f"torch.addmm {b2_lib_ms:.4f} ms, bound {b2_bound:.4f} ms ({b2_by})")

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
    del res_lk, res_ls, res_k
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
    nbr, wgt = gcn_adjacency(data.edges, device=dev)
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

    def b4_bound(s_):
        return bound(2.0 * g_nnz * s_, 4.0 * gn * s_ * 2 + 8.0 * gn * gd)

    b4 = {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "lib_ms": 0.0, "bound_ms": 0.0}
    keep = wgt != 0
    a_csr = torch.sparse_coo_tensor(
        torch.stack([torch.nonzero(keep)[:, 0], nbr[keep].long()]), wgt[keep], (gn, gn),
        check_invariants=True,
    ).coalesce().to_sparse_csr()
    del keep
    for label, F_ in (("layer 1", feats), ("layer 2", h16)):
        s_ = int(F_.shape[1])
        out_k = csr_aggregate_op(nbr, wgt, F_)
        torch.cuda.synchronize()
        out_p = csr_aggregate_ref(nbr, wgt, F_)
        tag = f"csr_aggregate f32 {label} (M={gn}, D={gd}, S={s_})"
        b4["err"] = max(b4["err"], check_close(np, tag, out_k, out_p, F32_TOL))
        if not torch.equal(out_k, csr_aggregate_op(nbr, wgt, F_)):
            fail(f"{tag}: two launches gave different bytes")
        check_close(np, tag + " vs torch.sparse.mm(CSR)", out_k, torch.sparse.mm(a_csr, F_),
                    F32_TOL)
        del out_k, out_p
        ms = cuda_ms(torch, lambda: csr_aggregate_op(nbr, wgt, F_))
        plain_ms = cuda_ms(torch, lambda: csr_aggregate_ref(nbr, wgt, F_), warmup=1, iters=2)
        lib_ms = cuda_ms(torch, lambda: torch.sparse.mm(a_csr, F_))
        bms, by = b4_bound(s_)
        log(f"    kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.sparse.mm(CSR) "
            f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("lib_ms", lib_ms),
                         ("bound_ms", bms)):
            b4[key] += val
    b4["by"] = by
    fq, wq = feats.to(torch.bfloat16), wgt.to(torch.bfloat16)
    out_k = csr_aggregate_op(nbr, wq, fq)
    torch.cuda.synchronize()
    check_close(np, f"csr_aggregate bf16 layer 1 (S={gcfg.d_feat})", out_k,
                csr_aggregate_ref(nbr, wq, fq), BF16_TOL)
    log(f"    kernel bf16 {cuda_ms(torch, lambda: csr_aggregate_op(nbr, wq, fq)):.4f} ms")
    del fq, wq, out_k, h16, a_csr
    log(f"  csr_aggregate per GCN forward (both layers): kernel {b4['ms']:.4f} ms, plain "
        f"{b4['plain_ms']:.4f} ms, torch.sparse.mm(CSR) {b4['lib_ms']:.4f} ms, "
        f"bound {b4['bound_ms']:.4f} ms ({b4['by']})")

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
            f"F.embedding_bag {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("lib_ms", lib_ms),
                         ("ops", ops), ("bytes", nbytes)):
            b5[key] += val
    b5["bound_ms"], b5["by"] = bound(b5["ops"], b5["bytes"])
    log(f"  embedding_bag per serve_bulk call (deep + wide): kernel {b5['ms']:.4f} ms, plain "
        f"{b5['plain_ms']:.4f} ms, F.embedding_bag {b5['lib_ms']:.4f} ms, "
        f"bound {b5['bound_ms']:.4f} ms ({b5['by']})")
    del deep_idx, deep_w, wide_w, rows

    # ------------------------------------ 9. GCN full-graph inference
    log("== phase 9: GCN full-graph inference, gcn-cora at ogb_products widths")
    gcn = GCN(gcfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = gcn(feats, nbr, wgt)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    gcn_counts = launch_counts()
    log(f"  kernel path: logits {tuple(logits.shape)} in {t_first:.4f} s wall; "
        f"launches {gcn_counts}")
    if gcn_counts["csr_aggregate"] != gcfg.n_layers or sum(gcn_counts.values()) != gcfg.n_layers:
        fail(f"GCN forward launched {gcn_counts}, expected {gcfg.n_layers} csr_aggregate")
    if logits.shape != (gn, gcfg.n_classes) or not torch.isfinite(logits).all():
        fail(f"GCN logits: shape {tuple(logits.shape)} or non-finite values")
    walls = wall_s(torch, lambda: gcn(feats, nbr, wgt), iters=5)
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
    trace_solve(torch, "GCN forward", lambda: gcn(feats, nbr, wgt))
    del gcn, nbr, wgt, feats, data
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
    trace_solve(torch, "Wide & Deep serve_bulk call", calls["serve_bulk"])
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

    # ------------------------------------------------ 11. the kernel list
    log("== phase 11: kernels")
    counts["csr_round"] = legacy_counts["csr_round"]
    counts["csr_aggregate"] = gcn_counts["csr_aggregate"]
    counts["embedding_bag"] = wd_counts["embedding_bag"]
    counts["flash_attention"] = serving["launches"]
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
    # ----------------------------------------------------- 12. the result
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
