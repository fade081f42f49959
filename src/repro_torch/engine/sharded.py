"""Sharded backend: the ``torch.distributed`` engine behind the registry.

The operator shards are flat slices of the blocked-CSR slot storage
(``BlockedCSR.to_edges``), the same format the sparse/kernel engines
aggregate, cut along the edge axis (DESIGN.md §6/§11).  The mesh is a
deployment knob: pass ``devices=`` (edge-axis size, seed axis 1) or a
ready ``mesh=``; ``auto`` never selects this backend.  Without either the
mesh spans the world: every rank under ``torchrun``, or a world of one
rank this process starts (:func:`repro_torch.parallel.mesh.make_mesh`).
A mesh larger than the world raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.network import NormalizedNetwork
from repro_torch.core.solver import LPConfig, SolveResult
from repro_torch.engine.base import LPEngine, Operator, register_backend


@register_backend("sharded")
class ShardedEngine(LPEngine):
    def __init__(
        self,
        config: Optional[LPConfig] = None,
        *,
        device=None,
        devices: Optional[int] = None,
        mesh=None,
        edge_axis: str = "model",
        seed_axis: str = "data",
        stale_sync: int = 1,
        compression: str = "none",
    ):
        from repro_torch.parallel.mesh import rank_device

        super().__init__(config if config is not None else LPConfig(), device=device)
        from repro_torch.parallel.lp_sharded import ShardedHeteroLP

        # under a launcher, the rank's own card unless one was named
        self.device = rank_device(device)
        self.devices = devices
        self.edge_axis = edge_axis
        self.seed_axis = seed_axis
        self._mesh = mesh
        self._solver = ShardedHeteroLP(
            self.config, stale_sync=stale_sync, compression=compression, device=self.device
        )
        self._round_cache = None

    def mesh(self):
        if self._mesh is None:
            from repro_torch.parallel.mesh import make_mesh, world_size

            k = self.devices or world_size()
            self._mesh = make_mesh(
                (1, k), (self.seed_axis, self.edge_axis), device=self.device
            )
        return self._mesh

    def _build(self, norm: NormalizedNetwork) -> Operator:
        prep = self._solver.prepare(
            norm, self.mesh(), edge_axis=self.edge_axis, seed_axis=self.seed_axis
        )
        return Operator(
            backend=self.name, norm=norm, num_nodes=norm.num_nodes, payload=prep
        )

    def solve(
        self,
        op: Operator,
        Y: np.ndarray,
        F0: Optional[np.ndarray] = None,
    ) -> SolveResult:
        return self._solver.solve_prepared(op.payload, Y, F0=F0)

    def _round_prep(self, op: Operator):
        """The fused DHLP-2 shards ``round`` runs on, cached per operator:
        a DHLP-2 operator's own, or, for a DHLP-1 operator (split shards),
        fused shards built on first use — ``round`` is the fused DHLP-2
        update on every backend (DESIGN.md §11.1)."""
        if op.payload.alg == "dhlp2":
            return op.payload
        if self._round_cache is None or self._round_cache[0] is not op:
            from repro_torch.parallel.lp_sharded import ShardedHeteroLP

            cfg = dataclasses.replace(self.config, alg="dhlp2")
            fused = ShardedHeteroLP(
                cfg, compression=self._solver.compression, device=self.device
            ).prepare(op.norm, self.mesh(), edge_axis=self.edge_axis,
                      seed_axis=self.seed_axis)
            self._round_cache = (op, fused)
        return self._round_cache[1]

    def round(self, op: Operator, F, Y):
        return self._solver.round(self._round_prep(op), F, Y)
