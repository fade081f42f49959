"""DHLP-1 / DHLP-2 solvers — dense batched engine.

The paper's Giraph programs are re-expressed as tensor iterations
(DESIGN.md §2):

* one BSP superstep of message passing  ==  one (Sp)MM ``S @ F``
* the per-seed sweep (``y=1`` for one vertex at a time) ==  batched seed
  columns ``Y → F`` (the paper-faithful sequential sweep is kept as
  ``mode="sequential"``)
* ``voteToHalt`` == per-column convergence mask (converged columns freeze)

Each loop is a host loop over device tensors; it pays one
``bool(active.any())`` synchronisation per round to decide whether to go
on (the counterpart of the reference's ``lax.while_loop`` condition).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Literal, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.network import (
    HeteroNetwork,
    NormalizedNetwork,
    seeds_identity,
)
from repro_torch.device import DeviceLike, resolve_device, to_numpy_f64
from repro_torch.kernels.lp_blockspmm import lp_round_op

Algorithm = Literal["dhlp1", "dhlp2"]
SeedMode = Literal["fixed", "drift"]


@dataclasses.dataclass(frozen=True)
class LPConfig:
    """Solver hyper-parameters (paper Table 1 symbols α, σ)."""

    alg: Algorithm = "dhlp2"
    alpha: float = 0.5
    sigma: float = 1e-3
    max_iter: int = 1000  # outer-iteration cap (DHLP-2 rounds)
    max_inner: int = 200  # DHLP-1 inner-loop cap
    seed_mode: Optional[SeedMode] = None  # default: per-pseudocode
    mode: Literal["batched", "sequential"] = "batched"
    seed_chunk: int = 0  # 0 = all seeds in one program
    dtype: torch.dtype = torch.float32
    fused: bool = True  # DHLP-2: pre-combine αβH + αM (beyond-paper)
    # Execution backend, a `repro_torch.engine` registry key ("dense",
    # "sparse", "kernel", "auto").  None lets the caller decide (HeteroLP
    # stays dense).
    backend: Optional[str] = None
    # DEPRECATED — use backend="kernel".  Routes the dense fused round
    # through the lp_round CUDA kernel (its plain version on the CPU).
    # Constructing LPConfig(use_kernel=True) without an explicit backend
    # warns and maps to backend="kernel" (see __post_init__).
    use_kernel: bool = False
    # Heavy-ball acceleration (beyond-paper): F ← β²·base + A·F_t
    # + momentum·(F_t − F_{t−1}).  Same fixed point (fixed-seed mode).
    momentum: float = 0.0
    # ``None`` = auto-scale H by 1/(T−1); pass 1.0 for the strictly-literal
    # paper update (which can diverge for T > 2 types).
    hetero_scale: Optional[float] = None
    # Mixed precision (sparse/kernel backends): "bf16" stores operator
    # weights and the per-round gather panel in bfloat16 while state and
    # accumulation stay f32.  "f32" is exact.
    storage_dtype: Literal["f32", "bf16"] = "f32"
    # Consult the autotune cache for the blocked-CSR layout.  This package
    # has no GPU-keyed cache yet, so both values resolve to the defaults
    # (what the reference does with a cold cache).
    autotune: bool = True

    def __post_init__(self) -> None:
        if self.storage_dtype not in ("f32", "bf16"):
            raise ValueError(
                f"storage_dtype must be 'f32' or 'bf16', got "
                f"{self.storage_dtype!r}"
            )
        if self.use_kernel and self.backend is None:
            warnings.warn(
                "LPConfig(use_kernel=True) is deprecated; use "
                "LPConfig(backend='kernel') — the engine registry routes it "
                "through the fused blocked-CSR kernel round (DESIGN.md §11)",
                DeprecationWarning,
                stacklevel=3,
            )
            object.__setattr__(self, "backend", "kernel")

    def resolved_hetero_scale(self, num_types: int) -> float:
        if self.hetero_scale is not None:
            return float(self.hetero_scale)
        return 1.0 / max(1, num_types - 1)

    def resolved_seed_mode(self) -> SeedMode:
        if self.seed_mode is not None:
            return self.seed_mode
        # Pseudocode defaults: DHLP-1 reads gety() (fixed seed), DHLP-2
        # reads getf() (drifting seed).
        return "fixed" if self.alg == "dhlp1" else "drift"


@dataclasses.dataclass
class SolveResult:
    F: np.ndarray  # (N, S) final labels, float64
    outer_iters: int  # rounds until all columns converged
    inner_iters: int  # DHLP-1 total inner iterations (0 for -2)
    converged: bool
    per_column_iters: Optional[np.ndarray] = None

    @property
    def supersteps(self) -> int:
        """Giraph superstep count equivalent (2 messages rounds per iter)."""
        return 2 * self.outer_iters + self.inner_iters


def _mm(A: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """``A @ F`` with an f32 accumulator, returned in ``F.dtype``."""
    if F.dtype == torch.float32:
        return A @ F
    return (A.float() @ F.float()).to(F.dtype)


def _halt(F, Fn, active, sigma):
    """voteToHalt: freeze converged columns, return ``(Fn, still_active)``."""
    Fn = torch.where(active[None, :], Fn, F)
    delta = (Fn - F).abs().amax(dim=0)
    return Fn, active & ~(delta < sigma)


# --------------------------------------------------------------------------
# DHLP-2  (distributed Heter-LP)
# --------------------------------------------------------------------------
def _dhlp2_step_loop(
    H: torch.Tensor,
    M: torch.Tensor,
    Y: torch.Tensor,
    F0: torch.Tensor,
    *,
    alpha: float,
    sigma: float,
    max_iter: int,
    seed_mode: str,
) -> Tuple[torch.Tensor, int, torch.Tensor]:
    """Un-fused (paper-faithful) DHLP-2: two propagation ops per round.

    ``F0`` is the warm-start state (pass ``Y`` for a cold solve).
    """
    beta = 1.0 - alpha
    s = Y.shape[1]
    F = F0
    active = torch.ones(s, dtype=torch.bool, device=Y.device)
    col_iters = torch.zeros(s, dtype=torch.int32, device=Y.device)
    it = 0
    while it < max_iter and bool(active.any()):
        src = Y if seed_mode == "fixed" else F
        # superstep A: heterogeneous injection  y' = βy + αHF
        Yp = beta * src + alpha * _mm(H, F)
        # superstep B: homogeneous propagation  f = βy' + αMF
        Fn = beta * Yp + alpha * _mm(M, F)
        col_iters += active.int()
        F, active = _halt(F, Fn, active, sigma)
        it += 1
    return F, it, col_iters


def _dhlp2_fused_loop(
    A_eff: torch.Tensor,
    beta2: float,
    Y: torch.Tensor,
    F0: torch.Tensor,
    *,
    sigma: float,
    max_iter: int,
    seed_mode: str,
    momentum: float = 0.0,
    use_kernel: bool = False,
) -> Tuple[torch.Tensor, int, torch.Tensor]:
    """Fused DHLP-2: one (N, N) product per round (DESIGN.md §2).

      drift:  F ← β²F + A_eff @ F
      fixed:  F ← β²Y + A_eff @ F [+ μ(F − F_prev) heavy-ball]

    ``use_kernel`` routes the round through ``lp_round_op`` with ``c=1``
    and ``β²·base`` folded in, as the reference does.
    """
    s = Y.shape[1]
    F = F_prev = F0
    active = torch.ones(s, dtype=torch.bool, device=Y.device)
    col_iters = torch.zeros(s, dtype=torch.int32, device=Y.device)
    it = 0
    while it < max_iter and bool(active.any()):
        base = Y if seed_mode == "fixed" else F
        if use_kernel:
            Fn = lp_round_op(A_eff, F, beta2 * base, c=1.0)
        else:
            Fn = beta2 * base + _mm(A_eff, F)
        if momentum:
            Fn = Fn + momentum * (F - F_prev)
        F_prev = F
        col_iters += active.int()
        F, active = _halt(F, Fn, active, sigma)
        it += 1
    return F, it, col_iters


# --------------------------------------------------------------------------
# DHLP-1  (distributed MINProp)
# --------------------------------------------------------------------------
def _dhlp1_loop(
    H: torch.Tensor,
    M: torch.Tensor,
    Y: torch.Tensor,
    F0: torch.Tensor,
    *,
    alpha: float,
    sigma: float,
    max_iter: int,
    max_inner: int,
    seed_mode: str,
) -> Tuple[torch.Tensor, int, int, torch.Tensor]:
    """DHLP-1: outer hetero injection, inner homogeneous iterative solve.

    Pseudocode mapping: lines 1–10 (phase A, compute y′ and message) are the
    outer body's first op; lines 11–24 (phase B, iterate f_t until
    |current−last| < σ, then check outer |f − f_old| < σ) are the inner
    loop.
    """
    beta = 1.0 - alpha
    s = Y.shape[1]

    def inner(Yp, Fi, iact):
        """Solve F = βY' + αMF to tolerance σ on active columns."""
        it = 0
        while it < max_inner and bool(iact.any()):
            Fn = beta * Yp + alpha * _mm(M, Fi)
            Fi, iact = _halt(Fi, Fn, iact, sigma)
            it += 1
        return Fi, it

    F = F0
    active = torch.ones(s, dtype=torch.bool, device=Y.device)
    col_iters = torch.zeros(s, dtype=torch.int32, device=Y.device)
    it, tot_inner = 0, 0
    while it < max_iter and bool(active.any()):
        src = Y if seed_mode == "fixed" else F
        Yp = beta * src + alpha * _mm(H, F)
        Fn, inner_it = inner(Yp, F, active)
        col_iters += active.int()
        F, active = _halt(F, Fn, active, sigma)
        it += 1
        tot_inner += inner_it
    return F, it, tot_inner, col_iters


def _solve_columns(cfg: LPConfig, arrays, Yd, F0d, *, fused: bool):
    """One batched solve of ``Yd`` from ``F0d``: ``(F, outer, inner, cols)``."""
    if cfg.alg == "dhlp2":
        if fused:
            A_eff, beta2 = arrays["fused"]
            F, it, ci = _dhlp2_fused_loop(
                A_eff,
                beta2,
                Yd,
                F0d,
                sigma=cfg.sigma,
                max_iter=cfg.max_iter,
                seed_mode=cfg.resolved_seed_mode(),
                momentum=cfg.momentum,
                use_kernel=cfg.use_kernel,
            )
        else:
            H, M = arrays["split"]
            F, it, ci = _dhlp2_step_loop(
                H,
                M,
                Yd,
                F0d,
                alpha=cfg.alpha,
                sigma=cfg.sigma,
                max_iter=cfg.max_iter,
                seed_mode=cfg.resolved_seed_mode(),
            )
        return F, it, 0, ci
    H, M = arrays["split"]
    return _dhlp1_loop(
        H,
        M,
        Yd,
        F0d,
        alpha=cfg.alpha,
        sigma=cfg.sigma,
        max_iter=cfg.max_iter,
        max_inner=cfg.max_inner,
        seed_mode=cfg.resolved_seed_mode(),
    )


# --------------------------------------------------------------------------
# Public solver
# --------------------------------------------------------------------------
class HeteroLP:
    """The paper's contribution as a composable module.

    >>> solver = HeteroLP(LPConfig(alg="dhlp2", alpha=0.5, sigma=1e-3))
    >>> result = solver.run(net)          # all-sources propagation, cuda:0
    """

    def __init__(self, config: LPConfig = LPConfig(), *, device: DeviceLike = None):
        self.config = config
        self.device = resolve_device(device)

    # -- main entry ---------------------------------------------------------
    def run(
        self,
        net,
        seeds: Optional[np.ndarray] = None,
        F0: Optional[np.ndarray] = None,
    ) -> SolveResult:
        """Solve LP on ``net`` from ``seeds``.

        ``F0`` (same shape as ``seeds``) warm-starts the iteration from a
        previous solution — the fixed point is unchanged in fixed-seed mode
        and already-converged columns freeze in round 0 (DESIGN.md §9).
        """
        cfg = self.config
        norm = coerce_normalized(net)
        n = norm.num_nodes
        Y = seeds_identity(n) if seeds is None else np.asarray(seeds)
        if Y.ndim == 1:
            Y = Y[:, None]
        if Y.shape[0] != n:
            raise ValueError(f"seeds must have {n} rows, got {Y.shape}")
        if F0 is not None:
            F0 = np.asarray(F0)
            if F0.ndim == 1:
                F0 = F0[:, None]
            if F0.shape != Y.shape:
                raise ValueError(
                    f"F0 shape {F0.shape} must match seeds shape {Y.shape}"
                )

        if cfg.mode == "sequential":
            return self._run_sequential(norm, Y, F0)
        return self._run_batched(norm, Y, F0)

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(
            np.ascontiguousarray(x), dtype=self.config.dtype, device=self.device
        )

    # -- batched ------------------------------------------------------------
    def _run_batched(
        self,
        norm: NormalizedNetwork,
        Y: np.ndarray,
        F0: Optional[np.ndarray] = None,
    ) -> SolveResult:
        cfg = self.config
        chunks = chunk_columns(Y, cfg.seed_chunk)
        f0_chunks = (
            [None] * len(chunks) if F0 is None else chunk_columns(F0, cfg.seed_chunk)
        )
        F_parts, outer, inner, col_iters = [], 0, 0, []
        arrays = self.operator_arrays(norm)
        for Yc, F0c in zip(chunks, f0_chunks):
            Yd = self._tensor(Yc)
            F0d = Yd if F0c is None else self._tensor(F0c)
            F, it, ii, ci = _solve_columns(cfg, arrays, Yd, F0d, fused=cfg.fused)
            F_parts.append(to_numpy_f64(F))
            outer = max(outer, int(it))
            inner += int(ii)
            col_iters.append(ci.cpu().numpy())
        return SolveResult(
            F=F_parts[0] if len(F_parts) == 1 else np.concatenate(F_parts, axis=1),
            outer_iters=outer,
            inner_iters=inner,
            converged=bool(outer < cfg.max_iter),
            per_column_iters=np.concatenate(col_iters),
        )

    # -- sequential (paper-faithful per-seed sweep) --------------------------
    def _run_sequential(
        self,
        norm: NormalizedNetwork,
        Y: np.ndarray,
        F0: Optional[np.ndarray] = None,
    ) -> SolveResult:
        """One seed at a time, exactly like the Giraph sweep (un-fused)."""
        cfg = self.config
        arrays = self.operator_arrays(norm)
        cols, outer, inner, per_col = [], 0, 0, []
        for c in range(Y.shape[1]):
            Yc = self._tensor(Y[:, c : c + 1])
            F0c = Yc if F0 is None else self._tensor(F0[:, c : c + 1])
            F, it, ii, ci = _solve_columns(cfg, arrays, Yc, F0c, fused=False)
            cols.append(to_numpy_f64(F))
            outer = max(outer, int(it))
            inner += int(ii)
            per_col.append(int(ci[0]))
        return SolveResult(
            F=np.concatenate(cols, axis=1),
            outer_iters=outer,
            inner_iters=inner,
            converged=True,
            per_column_iters=np.asarray(per_col, np.int32),
        )

    # -- helpers -------------------------------------------------------------
    def operator_arrays(self, norm: NormalizedNetwork):
        """Device-resident dense operator arrays, cached per network.

        Public so the engine layer (``repro_torch/engine/dense.py``) can
        reuse the prepared ``split``/``fused`` arrays for its ``round``
        contract.  Keyed by the identity of the live object (held in the
        cache entry, so the address cannot be recycled for another network).
        """
        cfg = self.config
        cache = getattr(self, "_cache", None)
        if cache is not None and cache[0] is norm:
            return cache[1]
        H, M = norm.assemble_dense()
        H = H * cfg.resolved_hetero_scale(norm.num_types)
        out = {"split": (self._tensor(H), self._tensor(M))}
        if cfg.alg == "dhlp2" and cfg.fused:
            beta = 1.0 - cfg.alpha
            A_eff = cfg.alpha * beta * H + cfg.alpha * M
            out["fused"] = (self._tensor(A_eff), beta * beta)
        self._cache = (norm, out)
        return out


def chunk_columns(Y: np.ndarray, chunk: int):
    """Split seed/state columns into ``chunk``-wide slices (0 = no split).

    Shared by every engine that honors ``LPConfig.seed_chunk`` — one copy
    of the boundary rule, not one per backend.
    """
    if chunk <= 0 or chunk >= Y.shape[1]:
        return [Y]
    return [Y[:, i : i + chunk] for i in range(0, Y.shape[1], chunk)]


def coerce_normalized(net) -> NormalizedNetwork:
    """Accept a raw or normalized network; the one coercion boundary.

    Shared by :class:`HeteroLP` and the engine registry
    (``repro_torch/engine/base.py``) so the accepted-input rule cannot drift.
    """
    if isinstance(net, HeteroNetwork):
        return net.normalize()
    if isinstance(net, NormalizedNetwork):
        return net
    raise TypeError(f"unsupported network type {type(net)}")
