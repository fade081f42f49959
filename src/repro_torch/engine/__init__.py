"""Unified LP execution backends (DESIGN.md §11).

>>> from repro_torch.engine import make_engine
>>> engine = make_engine("kernel", LPConfig(alg="dhlp2"))
>>> result = engine.run(net)            # prepare + solve on cuda:0

Registered backends: ``dense`` (torch matmul; the ``lp_round`` kernel
with ``LPConfig(use_kernel=True)``), ``sparse`` (blocked-CSR gather in
torch ops), ``kernel`` (the ``csr_round_residual`` kernel per width
bucket), and the ``auto`` selection policy (:func:`select_backend`).
"""

from repro_torch.engine.base import (
    AUTO_DENSE_MAX_NODES,
    BackendUnsupported,
    LPEngine,
    Operator,
    UnknownBackendError,
    available_backends,
    get_backend_class,
    make_engine,
    register_backend,
    resolve_backend,
    select_backend,
)

# importing the submodules registers the built-in backends
from repro_torch.engine import dense as _dense  # noqa: E402,F401
from repro_torch.engine import sparse as _sparse  # noqa: E402,F401

__all__ = [
    "AUTO_DENSE_MAX_NODES",
    "BackendUnsupported",
    "LPEngine",
    "Operator",
    "UnknownBackendError",
    "available_backends",
    "get_backend_class",
    "make_engine",
    "register_backend",
    "resolve_backend",
    "select_backend",
]
