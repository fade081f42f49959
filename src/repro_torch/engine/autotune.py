"""Autotune cache for the blocked-CSR layout and B1's block sizing.

``block_rows``/``width_mult`` (the layout) and ``slots_per_block`` (how
many slots a CUDA block of the round kernels walks) are defaults that
suit one card and one operator shape.  The right values depend on the
card and on the operator's *shape class*: node count and mean degree
decide whether wide hub rectangles or many narrow buckets win.  Sweeping
them per solve would dwarf the solve; hard-coding them leaves throughput
on the table on every other card.

So: sweep once per (device fingerprint, shape class), persist the winner
under ``results/autotune/<fingerprint>.json``, and answer every later
query from a process-level memo: ``lookup`` is a dict probe.  A cold miss
returns ``None`` and callers fall back to :data:`DEFAULT_PARAMS`, so
nothing ever blocks on a sweep implicitly; only :func:`ensure_tuned`
(called by the bench suite and by users who opt in) pays the sweep cost.
``LPConfig.autotune=False`` opts a solve out of consulting the cache.

The fingerprint names the card (name, compute capability, torch and CUDA
versions), or on the CPU the machine and its core count, so a cache
written on one card is never read on another.  The layout sweep times
the torch-op gather round of each candidate; the block sweep times B1
(``csr_round_residual``) on the fused plan the ``kernel`` engine builds
from the winning layout.  On the CPU the block sweep is skipped: the
plain version has no blocks.

Shape classes bucket (num_nodes, nnz) by rounded log2 so one sweep covers
the whole neighborhood of sizes the serving tier replays.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import platform
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.device import DeviceLike, resolve_device

DEFAULT_CACHE_DIR = Path("results") / "autotune"

# Candidate grid: layout first (dominates), block sizing on the winner.
LAYOUT_GRID: Tuple[Tuple[int, int], ...] = tuple(
    (br, wm) for br in (32, 64, 128) for wm in (4, 8, 16)
)
#: slots a CUDA block of B1/B3 walks (``kernels.segment_reduce.ops``)
PANEL_GRID: Tuple[int, ...] = (1024, 2048, 4096)


@dataclasses.dataclass(frozen=True)
class TunedParams:
    """One winning parameter set for a (device, shape class) cell."""

    block_rows: int = 64
    width_mult: int = 8
    slots_per_block: int = 2048

    def to_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, int]) -> "TunedParams":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: int(v) for k, v in d.items() if k in fields})


DEFAULT_PARAMS = TunedParams()

# process-level memo: resolved cache file path -> {shape_class: TunedParams}
_MEMO: Dict[str, Dict[str, TunedParams]] = {}


def host_fingerprint(device: DeviceLike = None) -> str:
    """Stable id of the device class the timings were taken on.

    On a card: its name, compute capability, and the torch and CUDA
    versions; on the CPU: machine, core count and the torch version.
    Coarse on purpose, so re-created machines of one class share a file.
    """
    import torch

    dev = resolve_device(device)
    if dev.type == "cuda":
        major, minor = torch.cuda.get_device_capability(dev)
        parts = (
            torch.cuda.get_device_name(dev),
            f"sm{major}{minor}",
            f"torch{torch.__version__}",
            f"cuda{torch.version.cuda}",
        )
    else:
        parts = (
            platform.machine(),
            f"cpu{os.cpu_count() or 1}",
            "cpu",
            f"torch{torch.__version__}",
        )
    return "-".join(parts).replace(" ", "_").replace("/", "_")


def shape_class(num_nodes: int, nnz: int) -> str:
    """Bucket an operator by rounded log2(nodes) and log2(mean degree)."""
    n = max(int(num_nodes), 2)
    d = max(float(nnz) / n, 1.0)
    return f"n{round(math.log2(n))}_d{round(math.log2(d))}"


def network_nnz(norm) -> int:
    """Cheap nnz estimate off the normalized blocks (no COO assembly)."""
    nnz = sum(int(np.count_nonzero(s)) for s in norm.S_homo)
    nnz += 2 * sum(int(np.count_nonzero(s)) for s in norm.S_het.values())
    return nnz


def cache_path(
    cache_dir: Optional[os.PathLike] = None, *, device: DeviceLike = None
) -> Path:
    base = Path(cache_dir) if cache_dir is not None else DEFAULT_CACHE_DIR
    return base / f"{host_fingerprint(device)}.json"


def _load(
    cache_dir: Optional[os.PathLike] = None, *, device: DeviceLike = None
) -> Dict[str, TunedParams]:
    path = cache_path(cache_dir, device=device)
    key = str(path.resolve())
    if key in _MEMO:
        return _MEMO[key]
    entries: Dict[str, TunedParams] = {}
    if path.exists():
        try:
            raw = json.loads(path.read_text())
            for sc, d in raw.get("entries", {}).items():
                entries[sc] = TunedParams.from_dict(d)
        except (json.JSONDecodeError, TypeError, ValueError, AttributeError):
            entries = {}  # corrupt cache == cold cache
    _MEMO[key] = entries
    return entries


def clear_memo() -> None:
    """Drop the process memo (tests re-point cache_dir mid-process)."""
    _MEMO.clear()


def lookup(
    num_nodes: int,
    nnz: int,
    *,
    cache_dir: Optional[os.PathLike] = None,
    device: DeviceLike = None,
) -> Optional[TunedParams]:
    """Cached winner for this device + shape class, or None on a cold miss."""
    return _load(cache_dir, device=device).get(shape_class(num_nodes, nnz))


def save(
    num_nodes: int,
    nnz: int,
    params: TunedParams,
    *,
    cache_dir: Optional[os.PathLike] = None,
    device: DeviceLike = None,
) -> Path:
    """Persist a winner and refresh the memo (atomic file replace)."""
    path = cache_path(cache_dir, device=device)
    path.parent.mkdir(parents=True, exist_ok=True)
    entries = dict(_load(cache_dir, device=device))
    entries[shape_class(num_nodes, nnz)] = params
    doc = {
        "host": host_fingerprint(device),
        "entries": {sc: p.to_dict() for sc, p in sorted(entries.items())},
    }
    # one temporary name per process: concurrent writers never share it
    tmp = path.with_suffix(f".json.{os.getpid()}.tmp")
    tmp.write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")
    os.replace(tmp, path)
    _MEMO[str(path.resolve())] = entries
    return path


# --------------------------------------------------------------- the sweep


def _seconds(fn: Callable[[], object], device, repeats: int) -> float:
    """Best time of ``fn()`` over ``repeats`` calls after one warm-up:
    CUDA events on a card, the host clock around the call on the CPU."""
    if device.type == "cuda":
        from repro_torch.bench.timing import time_cuda_events

        stats = time_cuda_events(fn, device, warmup=1, iters=1, repeats=repeats)
        return float(stats.min_s)
    fn()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _random_state(num_nodes: int, s: int, device):
    import torch

    gen = np.random.default_rng(0)
    return torch.as_tensor(
        gen.random((num_nodes, s), dtype=np.float32), device=device
    )


def _time_layout(
    norm, *, alpha, hetero_scale, block_rows, width_mult, s, repeats, device
):
    """Seconds per torch-op gather round at one (block_rows, width_mult)."""
    import torch

    from repro_torch.core.blocked_csr import blocked_csr_from_network
    from repro_torch.kernels.segment_reduce.ref import _aggregate_f32

    bcsr = blocked_csr_from_network(
        norm,
        alpha=alpha,
        hetero_scale=hetero_scale,
        block_rows=block_rows,
        width_mult=width_mult,
    )
    buckets = [
        (
            torch.as_tensor(b.nbr, dtype=torch.int32, device=device),
            torch.as_tensor(b.wgt, dtype=torch.float32, device=device),
        )
        for b in bcsr.width_buckets()
    ]
    order = np.concatenate([b.rows for b in bcsr.width_buckets()])
    inv = torch.as_tensor(np.argsort(order).astype(np.int64), device=device)
    F = _random_state(norm.num_nodes, s, device)

    def _round():
        return torch.cat([_aggregate_f32(nbr, w, F) for nbr, w in buckets])[inv]

    return _seconds(_round, device, repeats), bcsr


def _time_panels(plan, *, slots_per_block, s, repeats, device):
    """Seconds per fused B1 round over ``plan`` (the ``kernel`` engine's
    permuted-space buckets) at one ``slots_per_block``."""
    from repro_torch.engine.sparse import _plan_round

    buckets, perm, _ = plan
    F = _random_state(perm.shape[0], s, device)

    def _round():
        return _plan_round(
            buckets,
            F,
            F,
            c=0.25,
            use_kernel=True,
            storage="f32",
            slots_per_block=slots_per_block,
        )

    return _seconds(_round, device, repeats)


def ensure_tuned(
    norm,
    *,
    alpha: float = 0.5,
    hetero_scale: float = 1.0,
    s: int = 8,
    repeats: int = 2,
    cache_dir: Optional[os.PathLike] = None,
    force: bool = False,
    sweep_panels: bool = True,
    device: DeviceLike = None,
    on_time: Optional[Callable[[str, object, float], None]] = None,
) -> Tuple[TunedParams, bool]:
    """Return ``(params, cache_hit)`` for this device + operator shape.

    On a hit nothing is timed.  On a miss (or ``force=True``) sweeps the
    layout grid with the torch-op round at ``s`` label columns, then, on a
    card, ``PANEL_GRID`` with B1 on the fused plan of the winning layout,
    and persists the combined winner.  ``on_time(kind, candidate,
    seconds)`` sees every timing (``kind`` is ``"layout"`` or
    ``"slots_per_block"``).
    """
    dev = resolve_device(device)
    nnz = network_nnz(norm)
    n = norm.num_nodes
    if not force:
        hit = lookup(n, nnz, cache_dir=cache_dir, device=dev)
        if hit is not None:
            return hit, True

    best_t, best_layout, best_bcsr = float("inf"), LAYOUT_GRID[0], None
    for block_rows, width_mult in LAYOUT_GRID:
        t, bcsr = _time_layout(
            norm,
            alpha=alpha,
            hetero_scale=hetero_scale,
            block_rows=block_rows,
            width_mult=width_mult,
            s=s,
            repeats=repeats,
            device=dev,
        )
        if on_time is not None:
            on_time("layout", (block_rows, width_mult), t)
        if t < best_t:
            best_t, best_layout, best_bcsr = t, (block_rows, width_mult), bcsr

    slots = DEFAULT_PARAMS.slots_per_block
    if sweep_panels and dev.type == "cuda":
        from repro_torch.engine.sparse import _device_plan

        plan = _device_plan(best_bcsr, storage="f32", device=dev)
        best_pt = float("inf")
        for cand in PANEL_GRID:
            t = _time_panels(
                plan, slots_per_block=cand, s=s, repeats=repeats, device=dev
            )
            if on_time is not None:
                on_time("slots_per_block", cand, t)
            if t < best_pt:
                best_pt, slots = t, cand

    params = TunedParams(
        block_rows=best_layout[0], width_mult=best_layout[1], slots_per_block=slots
    )
    save(n, nnz, params, cache_dir=cache_dir, device=dev)
    return params, False


__all__ = [
    "DEFAULT_CACHE_DIR",
    "DEFAULT_PARAMS",
    "LAYOUT_GRID",
    "PANEL_GRID",
    "TunedParams",
    "cache_path",
    "clear_memo",
    "ensure_tuned",
    "host_fingerprint",
    "lookup",
    "network_nnz",
    "save",
    "shape_class",
]
