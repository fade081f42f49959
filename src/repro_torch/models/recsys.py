"""Wide & Deep serving (Cheng et al., arXiv:1606.07792).

The port's counterpart of ``repro.models.recsys``: ``forward`` (CTR
logits), ``serve`` (probabilities, ``make_serve``), ``user_tower`` and
``retrieval_score`` (``make_retrieval_scorer``).  Both embedding lookups
go through the ``embedding_bag`` kernel, as ``repro``'s docstring names
it for them:

* deep: ``table[rows]`` is a bag of one slot of weight 1.0 per (example,
  field) — an exact gather, bit for bit the reference's;
* wide: ``wide_table[rows].sum(-1)`` is one bag of ``n_sparse`` slots per
  example over the ``(V, 1)`` wide table.

On the kernel path the deep lookup is written in place into the MLP's
input (:meth:`WideDeep._deep_in`), where the reference concatenates.

The kernel gathers unchecked, so the entry points take the ids as numpy
(as ``sample_ctr_batch`` gives them) and range-check them once on the
host (:meth:`WideDeep.rows`).  The MLP and the retrieval product are
plain ``torch`` matrix products, as the reference leaves them to XLA
(float32; TF32 stays off).

Serving only: the parameters do not require gradients.  The training
step comes with the port of ``optim/``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.common import MAX_INT32, round_up
from repro_torch.kernels.embedding_bag import embedding_bag_op, embedding_bag_ref
from repro_torch.models.common import dense_init, embed_init, mlp


@dataclasses.dataclass(frozen=True)
class WideDeepConfig:
    name: str
    n_sparse: int = 40
    n_dense: int = 13
    embed_dim: int = 32
    vocab_per_field: int = 100_000
    mlp_dims: Tuple[int, ...] = (1024, 512, 256)
    dtype: torch.dtype = torch.float32

    @property
    def total_vocab(self) -> int:
        return self.n_sparse * self.vocab_per_field

    @property
    def deep_in(self) -> int:
        return self.n_sparse * self.embed_dim + self.n_dense

    def param_count(self) -> int:
        total = self.total_vocab * self.embed_dim + self.total_vocab  # tables
        dims = (self.deep_in,) + self.mlp_dims + (1,)
        for a, b in zip(dims[:-1], dims[1:]):
            total += a * b + b
        total += self.n_dense + 1
        return total


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class WideDeep(nn.Module):
    """Wide (linear over one-hot ids and dense features) ⊕ deep (MLP over
    the concatenated field embeddings and dense features).

    Parameters are drawn on ``device`` from ``generator`` with the
    reference's initialisers (the 5.12 GB table of the ``FULL`` config
    never passes through the host).  ``use_kernel=False`` looks up with
    the plain PyTorch version on the card too (the yardstick path).
    """

    def __init__(
        self,
        cfg: WideDeepConfig,
        *,
        generator: torch.Generator = None,
        device: DeviceLike = None,
        use_kernel: bool = True,
    ):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
        if cfg.total_vocab > MAX_INT32:
            raise ValueError(f"{cfg.name}: {cfg.total_vocab} table rows exceed int32 ids")
        dims = (cfg.deep_in,) + tuple(cfg.mlp_dims) + (1,)
        zeros = lambda *shape: torch.zeros(shape, dtype=cfg.dtype, device=dev)  # noqa: E731
        self.cfg = cfg
        self.use_kernel = use_kernel
        # deep embedding table, all fields stacked with row offsets
        self.table = _param(embed_init(gen, cfg.total_vocab, cfg.embed_dim, cfg.dtype))
        # wide: one scalar weight per categorical value (linear over one-hot)
        self.wide_table = _param(zeros(cfg.total_vocab))
        self.wide_dense = _param(zeros(cfg.n_dense))
        self.bias = _param(zeros())
        self.mlp_w = nn.ParameterList(
            _param(dense_init(gen, a, b, cfg.dtype)) for a, b in zip(dims[:-1], dims[1:])
        )
        self.mlp_b = nn.ParameterList(_param(zeros(b)) for b in dims[1:])
        # row offset of each field in the stacked tables (int32: checked above)
        offsets = torch.arange(cfg.n_sparse, dtype=torch.int32, device=dev) * cfg.vocab_per_field
        self.register_buffer("field_offsets", offsets, persistent=False)

    # ------------------------------------------------------------- inputs
    def rows(self, sparse_ids: np.ndarray) -> torch.Tensor:
        """``(B, n_sparse)`` per-field ids → global table rows on the card.

        The one range check of the path: the kernel gathers unchecked.
        The ids travel as int32 and get their field offsets on the card.
        """
        ids = np.asarray(sparse_ids)
        cfg = self.cfg
        if ids.ndim != 2 or ids.shape[1] != cfg.n_sparse:
            raise ValueError(f"sparse ids must be (B, {cfg.n_sparse}), got {ids.shape}")
        if not np.issubdtype(ids.dtype, np.integer):
            raise TypeError(f"sparse ids must be integers, got {ids.dtype}")
        if ids.size and (ids.min() < 0 or ids.max() >= cfg.vocab_per_field):
            raise ValueError(
                f"sparse ids must lie in [0, {cfg.vocab_per_field}), got "
                f"[{ids.min()}, {ids.max()}]"
            )
        ids = torch.from_numpy(np.ascontiguousarray(ids, dtype=np.int32))
        return ids.to(self.table.device) + self.field_offsets

    def _dense(self, dense_feats: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(dense_feats), dtype=self.cfg.dtype).to(
            self.table.device
        )

    # ------------------------------------------------------------ lookups
    def _bag(self, table, idx, out=None):
        w = torch.ones(idx.shape, dtype=table.dtype, device=idx.device)
        if not self.use_kernel:
            return embedding_bag_ref(table, idx, w)
        return embedding_bag_op(table, idx, w, out=out)

    def embed(self, rows: torch.Tensor) -> torch.Tensor:
        """The deep lookup ``table[rows]`` flattened to ``(B, F·D)``: one
        bag of one slot of weight 1.0 per (example, field)."""
        return self._bag(self.table, rows.reshape(-1, 1)).reshape(rows.shape[0], -1)

    @property
    def deep_in_stride(self) -> int:
        """Row stride of the MLP input on the kernel path: ``deep_in``
        padded to 16 bytes (1,296 for ``FULL``'s 1,293 f32 values)."""
        return round_up(self.cfg.deep_in, 16 // self.table.element_size())

    def _deep_in(self, rows: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
        """The MLP's input ``[embed(rows) | dense]``, ``(B, deep_in)``.

        The kernel path writes the deep lookup in place: one buffer whose
        row stride is ``deep_in`` padded to 16 bytes (so each field's row
        lands 16-byte aligned), the lookup into its ``F·D`` head, the dense
        features into its tail, and the MLP reads the unpadded view (its
        matrix product takes the row stride as it is, no copy).  The plain
        path concatenates.
        """
        if not self.use_kernel:
            return torch.cat([self.embed(rows), dense], dim=-1)
        cfg = self.cfg
        b, f = rows.shape
        head = f * cfg.embed_dim
        buf = torch.empty((b, self.deep_in_stride), dtype=self.table.dtype,
                          device=self.table.device)
        self._bag(self.table, rows.reshape(-1, 1), out=buf[:, :head].view(b, f, cfg.embed_dim))
        buf[:, head : cfg.deep_in].copy_(dense)
        return buf[:, : cfg.deep_in]

    # ------------------------------------------------------------ outputs
    def forward(self, rows: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
        """CTR logits ``(B,)`` from table rows (:meth:`rows`) and dense features."""
        deep = mlp(self._deep_in(rows, dense), self.mlp_w, self.mlp_b)
        wide = self._bag(self.wide_table[:, None], rows)[:, 0] + dense @ self.wide_dense
        return deep[..., 0] + wide + self.bias

    def serve(self, sparse_ids: np.ndarray, dense_feats: np.ndarray) -> torch.Tensor:
        """CTR probabilities ``(B,)``: two ``embedding_bag`` launches."""
        return torch.sigmoid(self(self.rows(sparse_ids), self._dense(dense_feats)))

    def user_tower(self, rows: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
        """Query embedding = last deep hidden layer ``(B, mlp_dims[-1])``."""
        h = self._deep_in(rows, dense)
        for w, b in zip(self.mlp_w[:-1], self.mlp_b[:-1]):
            h = torch.relu(h @ w + b)
        return h

    def retrieval_score(
        self, sparse_ids: np.ndarray, dense_feats: np.ndarray, candidates: torch.Tensor
    ) -> torch.Tensor:
        """Score ONE query ``(1, n_sparse)`` against ``(C, mlp_dims[-1])``
        candidate vectors with a single matrix product: ``(C,)``; one
        ``embedding_bag`` launch."""
        q = self.user_tower(self.rows(sparse_ids), self._dense(dense_feats))
        return (q @ candidates.T)[0]


def make_serve(model: WideDeep):
    """Counterpart of ``repro.models.recsys.make_serve``."""
    return model.serve


def make_retrieval_scorer(model: WideDeep):
    """Counterpart of ``repro.models.recsys.make_retrieval_scorer``."""
    return model.retrieval_score


__all__ = ["WideDeep", "WideDeepConfig", "make_retrieval_scorer", "make_serve"]
