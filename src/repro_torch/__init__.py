"""PyTorch/CUDA port of the DHLP label-propagation system.

A second package beside ``repro`` (the JAX reference).  It imports
``torch`` and ``numpy`` only — never ``jax`` and nothing of ``repro`` —
and mirrors ``repro``'s module tree and names so each piece has an
obvious counterpart:

* ``core``      — network container, normalization, blocked-CSR, ranking,
                  numpy oracles, and the dense solver (``HeteroLP``);
* ``kernels``   — hand-written CUDA kernels for the TPU kernels on the
                  system's paths, each beside its plain PyTorch version;
* ``engine``    — the backend registry (``make_engine``) with the
                  ``dense``, ``sparse`` and ``kernel`` engines;
* ``scenarios`` — the seeded network generators and the recovery /
                  k-fold evaluation protocols;
* ``eval``      — AUC, AUPR, BestACC and k-fold cross-validation;
* ``data``      — the synthetic drug–disease–target gold standard.

Entry points run on ``cuda:0`` unless the caller passes ``device="cpu"``
(:func:`repro_torch.device.resolve_device`).
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
