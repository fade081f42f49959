"""Collective helpers over ``torch.distributed``: compression and
decompositions of an all-reduce.

* ``compressed_psum`` — all-reduce in a lower precision: bf16, or int8
  with a per-tensor scale (maxed over the group) and stochastic rounding
  from an explicit ``torch.Generator``, summed as int32 on the wire.  On a
  large cluster the LP aggregate / gradient all-reduce is bound by the
  interconnect; halving or quartering its bytes moves that term directly.
* ``psum_scatter_then_gather`` — reduce-scatter + all-gather, the two
  halves a scheduler can overlap with compute on other tensors.
* ``ring_allreduce_ppermute`` — an explicit ring of k − 1 point-to-point
  rounds (``batch_isend_irecv``), each adding the buffer its left
  neighbour held.
* ``grad_allreduce`` — ``compressed_psum`` over every leaf of a tree.

Each takes this rank's tensor and a process group (``None`` is the
world; on a mesh, ``mesh.get_group(axis)``) and returns a new tensor;
every rank of the group must call it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def _stochastic_round_int8(x, scale, generator) -> torch.Tensor:
    """Quantize ``x / scale`` to int8 with stochastic rounding."""
    y = torch.clamp(x / scale, -127.0, 127.0)
    floor = torch.floor(y)
    rnd = torch.rand(y.shape, generator=generator, device=y.device, dtype=y.dtype)
    return (floor + (rnd < (y - floor)).to(y.dtype)).to(torch.int8)


def compressed_psum(
    x: torch.Tensor,
    group=None,
    *,
    compression: str = "none",
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Sum of ``x`` over the group with optional wire compression.

    compression:
      - ``"none"``: plain sum in ``x.dtype``.
      - ``"bf16"``: cast to bf16 before the collective (half the bytes),
        result in ``x.dtype``.
      - ``"int8"``: per-tensor absmax scale (maxed over the group first, a
        one-element collective), stochastic rounding drawn from
        ``generator`` (required), int32 sum on the wire.
    """
    if compression == "none":
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out
    if compression == "bf16":
        out = x.to(torch.bfloat16)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out.to(x.dtype)
    if compression == "int8":
        if generator is None:
            raise ValueError("int8 compression needs a torch.Generator")
        absmax = x.abs().max().reshape(1).float()
        dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
        scale = torch.clamp(absmax / 127.0, min=1e-12).to(x.dtype)
        # int8 summands can overflow int8: accumulate in int32 on the wire
        acc = _stochastic_round_int8(x, scale, generator).to(torch.int32)
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
        return acc.to(x.dtype) * scale
    raise ValueError(f"unknown compression {compression!r}")


def psum_scatter_then_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce as reduce-scatter + all-gather over the leading axis
    (its length must divide by the group size)."""
    k = dist.get_world_size(group)
    if x.shape[0] % k:
        raise ValueError(f"leading dim {x.shape[0]} is not divisible by {k} ranks")
    x = x.contiguous()
    part = torch.empty((x.shape[0] // k,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(part, x, op=dist.ReduceOp.SUM, group=group)
    out = torch.empty_like(x)
    dist.all_gather_into_tensor(out, part, group=group)
    return out


def ring_allreduce_ppermute(x: torch.Tensor, group=None) -> torch.Tensor:
    """Explicit (k − 1)-round ring all-reduce: each round sends the buffer
    to the right neighbour and adds the one received from the left."""
    k = dist.get_world_size(group)
    acc = x.clone()
    if k == 1:
        return acc
    me = dist.get_rank(group)
    right = dist.get_global_rank(group, (me + 1) % k) if group is not None else (me + 1) % k
    left = dist.get_global_rank(group, (me - 1) % k) if group is not None else (me - 1) % k
    buf = x.contiguous().clone()
    for _ in range(k - 1):
        recv = torch.empty_like(buf)
        ops = [
            dist.P2POp(dist.isend, buf, right, group=group),
            dist.P2POp(dist.irecv, recv, left, group=group),
        ]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        acc += recv
        buf = recv
    return acc


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def grad_allreduce(
    grads,
    group=None,
    *,
    compression: str = "none",
    generator: Optional[torch.Generator] = None,
):
    """Tree-wide gradient all-reduce (dicts, lists, tuples of tensors) with
    optional compression; one generator draws every leaf's rounding."""
    return _tree_map(
        lambda g: compressed_psum(g, group, compression=compression, generator=generator),
        grads,
    )


__all__ = [
    "compressed_psum",
    "grad_allreduce",
    "psum_scatter_then_gather",
    "ring_allreduce_ppermute",
]
