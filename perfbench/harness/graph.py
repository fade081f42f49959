"""The edge list and operator of a ``powerlaw_graph`` configuration.

Frozen copies, as at commit ca3ff8b, of
``repro_torch.graph.structures.powerlaw_graph`` (both endpoints of every
edge drawn with probability proportional to rank^(-exponent/2), node 0 the
most likely, then a stable sort by destination) and of
``repro_torch.graph.segment.gcn_norm`` (the weights of D^-1/2 A D^-1/2 for
A[dst, src] = w, D its row sums, a zero degree giving a zero inverse, the
product in float64 rounded once to float32).

The program's copy draws on the host with numpy, 6 s at 20 M edges; this
one draws the same law on the device from a ``torch.Generator`` (inverse-CDF
sampling in float64), so a run's set-up does not pay for the draw.  It
draws from the configuration's ``graph_seed``: every run steps the same
graph, and ``--seed`` picks the seed columns (``cells.BioStepLoop``).
On an H100, fresh graphs per seed moved the step time by about 4 %
between seeds, against 1–2 % between two runs of one seed.
"""

from __future__ import annotations

from typing import Tuple

import torch

#: draws per ``searchsorted`` call: bounds the uniform buffer (8 B each)
_DRAW_CHUNK = 1 << 24


def powerlaw_edges(
    num_nodes: int, num_edges: int, exponent: float, seed: int, device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(src, dst)`` int32 on ``device``, sorted by ``dst`` (stable)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    ranks = torch.arange(1, num_nodes + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(ranks ** (-exponent / 2.0), 0)
    cdf /= cdf[-1].clone()

    def draw() -> torch.Tensor:
        out = torch.empty(num_edges, dtype=torch.int32, device=device)
        for i in range(0, num_edges, _DRAW_CHUNK):
            m = min(_DRAW_CHUNK, num_edges - i)
            u = torch.rand(m, dtype=torch.float64, generator=gen, device=device)
            out[i : i + m] = torch.searchsorted(cdf, u, right=True).clamp_(max=num_nodes - 1)
        return out

    src = draw()
    dst = draw()
    order = torch.sort(dst, stable=True).indices
    return src[order].contiguous(), dst[order].contiguous()


def sym_norm_weights(src: torch.Tensor, dst: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """Weights of D^-1/2 A D^-1/2 for unit edges ``A[dst, src] = 1``, f32."""
    dst_l, src_l = dst.long(), src.long()
    w64 = torch.ones(dst.shape[0], dtype=torch.float64, device=dst.device)
    deg = torch.zeros(num_nodes, dtype=torch.float64, device=dst.device).index_add_(0, dst_l, w64)
    inv = torch.zeros_like(deg)
    nz = deg > 0
    inv[nz] = 1.0 / torch.sqrt(deg[nz])
    return (inv[dst_l] * w64 * inv[src_l]).float()


def make(config: dict, device):
    """``(src, dst, w)`` of the configuration: w = α·D^-1/2 A D^-1/2."""
    g = config["graph"]
    n, e = g["num_nodes"], g["num_edges"]
    src, dst = powerlaw_edges(n, e, g["exponent"], g["graph_seed"], device)
    w = config["solver"]["alpha"] * sym_norm_weights(src, dst, n)
    return src, dst, w
