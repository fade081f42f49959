"""LPEngine protocol + string-keyed backend registry (DESIGN.md §11).

Every execution path of this package (dense matmul or the ``lp_round``
kernel, blocked-CSR torch ops, the ``csr_round_residual`` kernel)
implements the same three-method contract:

* ``prepare(net) -> Operator`` — assemble + upload the propagation operator
  once per network (identity-cached, like the solvers' internal caches);
* ``solve(op, Y, F0=None) -> SolveResult`` — batched σ-convergence solve
  with optional warm start (the F0 threading serving relies on);
* ``round(op, F, Y) -> F`` — ONE fused fixed-seed DHLP-2 round, the unit
  serve's incremental refresh steps stale columns with.

Backends register under a string key; callers go through
:func:`make_engine` so backend choice is one ``LPConfig.backend`` value
(``"auto"`` resolves via :func:`select_backend`).  Every engine takes
``device=`` (default ``cuda:0``, see :func:`repro_torch.device.resolve_device`).
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, ClassVar, Dict, Optional, Tuple, Type

import numpy as np

from repro_torch.core.network import NormalizedNetwork, seed_matrix
from repro_torch.core.solver import LPConfig, SolveResult, coerce_normalized
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs.profiler import hot_span

# `auto` picks dense while the (N, N) fused operator stays comfortably
# in device memory (4096² f32 = 64 MB) AND the network is dense enough
# that gather/reduce bookkeeping would not pay for itself.
AUTO_DENSE_MAX_NODES = 4096


class UnknownBackendError(ValueError):
    """Requested backend key is not in the registry."""


class BackendUnsupported(ValueError):
    """Backend exists but cannot run the requested configuration."""


@dataclasses.dataclass
class Operator:
    """A prepared, device-resident propagation operator.

    ``payload`` is backend-specific (dense arrays, CSR buckets, edge
    shards); callers treat operators as opaque handles returned by
    ``prepare`` and passed to ``solve``/``round``.
    """

    backend: str
    norm: NormalizedNetwork
    num_nodes: int
    payload: Any = None


class LPEngine(abc.ABC):
    """Base class for LP execution backends."""

    name: ClassVar[str] = "?"
    #: algorithms this backend can execute
    supports_algs: ClassVar[Tuple[str, ...]] = ("dhlp1", "dhlp2")
    #: whether the fused loop honors LPConfig.momentum (heavy-ball)
    supports_momentum: ClassVar[bool] = False

    def __init__(self, config: LPConfig = LPConfig(), *, device: DeviceLike = None):
        self.config = config
        self.device = resolve_device(device)
        # (norm, Operator): identity-keyed like the solvers' caches — the
        # entry holds the norm object itself so a recycled id() cannot
        # alias a different network.
        self._op_cache: Optional[Tuple[NormalizedNetwork, Operator]] = None

    # ------------------------------------------------------------- contract
    def prepare(self, net) -> Operator:
        """Assemble the operator for ``net`` (cached per network identity).

        The cache key is the object the caller handed in — a raw
        ``HeteroNetwork`` hits the cache without re-normalizing, and the
        derived ``NormalizedNetwork`` is accepted as an alias so callers
        holding either handle share one prepared operator.
        """
        cache = self._op_cache
        if cache is not None and (cache[0] is net or cache[1].norm is net):
            return cache[1]
        if self.config.alg not in self.supports_algs:
            raise BackendUnsupported(
                f"backend {self.name!r} does not support alg "
                f"{self.config.alg!r} (supports {self.supports_algs})"
            )
        if self.config.momentum and not self.supports_momentum:
            # running unaccelerated would silently drop a configured
            # convergence knob — fail loudly like any other capability gap
            raise BackendUnsupported(
                f"backend {self.name!r} has no momentum loop "
                f"(LPConfig.momentum={self.config.momentum})"
            )
        norm = coerce_normalized(net)
        op = self._build(norm)
        self._op_cache = (net, op)
        return op

    @abc.abstractmethod
    def _build(self, norm: NormalizedNetwork) -> Operator:
        """Backend-specific operator assembly."""

    @abc.abstractmethod
    def solve(
        self,
        op: Operator,
        Y: np.ndarray,
        F0: Optional[np.ndarray] = None,
    ) -> SolveResult:
        """Batched solve from seed columns ``Y``, warm-started at ``F0``."""

    def round(self, op: Operator, F, Y):
        """One fused fixed-seed DHLP-2 round ``β²Y + A_eff @ F``."""
        raise NotImplementedError(f"backend {self.name!r} has no incremental round")

    def round_with_residual(self, op: Operator, F, Y):
        """One round plus its per-column residual ``max_r |Fn − F|``.

        Convergence-driven callers (serve's early-exit loop) consume this
        instead of ``round`` + a host-side reduction so fused backends can
        emit the residual from the same kernel launch.  Default: compose
        from ``round``.
        """
        Fn = self.round(op, F, Y)
        delta = np.max(
            np.abs(np.asarray(Fn) - np.asarray(F, dtype=np.float64)), axis=0
        )
        return Fn, delta

    # ---------------------------------------------------------- convenience
    def run(
        self,
        net,
        seeds: Optional[np.ndarray] = None,
        F0: Optional[np.ndarray] = None,
    ) -> SolveResult:
        """``prepare`` + ``solve`` with the shared seed/F0 validation."""
        op = self.prepare(net)
        with hot_span("lp.seeds"):
            Y, F0 = seed_matrix(op.num_nodes, seeds, F0)
        return self.solve(op, Y, F0=F0)


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------
_REGISTRY: Dict[str, Type[LPEngine]] = {}


def register_backend(name: str):
    """Class decorator: ``@register_backend("sparse")`` on an LPEngine."""

    def deco(cls: Type[LPEngine]) -> Type[LPEngine]:
        existing = _REGISTRY.get(name)
        if existing is not None and existing is not cls:
            raise ValueError(f"backend {name!r} already registered")
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def available_backends(*, include_auto: bool = False) -> Tuple[str, ...]:
    """Registered backend keys (sorted); ``auto`` is a policy, not a class."""
    names = sorted(_REGISTRY)
    return tuple(names + ["auto"]) if include_auto else tuple(names)


def get_backend_class(name: str) -> Type[LPEngine]:
    if name not in _REGISTRY:
        known = ", ".join(available_backends(include_auto=True))
        raise UnknownBackendError(f"unknown LP backend {name!r}; registered: {known}")
    return _REGISTRY[name]


def select_backend(num_nodes: int, config: Optional[LPConfig] = None) -> str:
    """The ``auto`` policy (DESIGN.md §11).

    Dense while the (N, N) operator is small (``AUTO_DENSE_MAX_NODES``),
    blocked-CSR sparse beyond.  ``sharded`` is never auto-selected — it
    needs an explicit device count/mesh, which is a deployment decision.
    """
    if num_nodes <= AUTO_DENSE_MAX_NODES:
        return "dense"
    return "sparse"


def resolve_backend(
    name: Optional[str],
    *,
    num_nodes: Optional[int] = None,
    config: Optional[LPConfig] = None,
) -> str:
    """Validate a backend key, resolving ``auto``/``None`` via the policy."""
    if name is None:
        name = "auto"
    if name == "auto":
        if num_nodes is None:
            raise ValueError(
                "resolving backend 'auto' needs num_nodes (the policy is "
                "size-based)"
            )
        return select_backend(num_nodes, config)
    get_backend_class(name)  # raises UnknownBackendError
    return name


def make_engine(
    backend: Optional[str] = None,
    config: LPConfig = LPConfig(),
    *,
    num_nodes: Optional[int] = None,
    device: DeviceLike = None,
    **kwargs,
) -> LPEngine:
    """Instantiate a backend engine.

    ``backend=None`` falls back to ``config.backend`` then ``auto`` (which
    needs ``num_nodes``).  ``device`` is where the engine runs (``None`` =
    ``cuda:0``).  Extra ``kwargs`` are backend-specific (e.g.
    ``block_rows=`` for ``sparse``).
    """
    name = resolve_backend(
        backend or config.backend, num_nodes=num_nodes, config=config
    )
    return get_backend_class(name)(config, device=device, **kwargs)
