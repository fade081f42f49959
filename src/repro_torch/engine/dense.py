"""Dense backend: the (N, N) matmul engine behind the registry.

Delegates to :class:`~repro_torch.core.solver.HeteroLP` (the loops stay
the single source of truth for the dense math) and exposes the prepared
``fused``/``split`` device arrays through the engine ``round`` contract.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.network import NormalizedNetwork
from repro_torch.core.solver import HeteroLP, LPConfig, SolveResult, _mm
from repro_torch.device import to_numpy_f64
from repro_torch.engine.base import LPEngine, Operator, register_backend


@register_backend("dense")
class DenseEngine(LPEngine):
    supports_momentum = True

    def _build(self, norm: NormalizedNetwork) -> Operator:
        solver = HeteroLP(self.config, device=self.device)
        solver.operator_arrays(norm)  # assemble + upload now, not per solve
        return Operator(
            backend=self.name,
            norm=norm,
            num_nodes=norm.num_nodes,
            payload=solver,
        )

    def solve(
        self,
        op: Operator,
        Y: np.ndarray,
        F0: Optional[np.ndarray] = None,
    ) -> SolveResult:
        return op.payload.run(op.norm, seeds=Y, F0=F0)

    def _round_arrays(self, op: Operator):
        """(A_eff, β²) for the fused round, derived once per operator."""
        cache = getattr(self, "_round_cache", None)
        if cache is not None and cache[0] is op:
            return cache[1], cache[2]
        cfg: LPConfig = self.config
        arrays = op.payload.operator_arrays(op.norm)
        if "fused" in arrays:
            A_eff, beta2 = arrays["fused"]
        else:
            H, M = arrays["split"]
            beta = 1.0 - cfg.alpha
            A_eff = cfg.alpha * beta * H + cfg.alpha * M
            beta2 = beta * beta
        self._round_cache = (op, A_eff, beta2)
        return A_eff, beta2

    def round(self, op: Operator, F, Y):
        cfg: LPConfig = self.config
        A_eff, beta2 = self._round_arrays(op)
        F = torch.as_tensor(np.asarray(F), dtype=cfg.dtype, device=self.device)
        Y = torch.as_tensor(np.asarray(Y), dtype=cfg.dtype, device=self.device)
        out = beta2 * Y + _mm(A_eff, F)
        return to_numpy_f64(out)
