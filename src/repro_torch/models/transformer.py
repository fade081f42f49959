"""Decoder-only transformer serving: GQA or MLA attention over a KV cache,
dense SwiGLU or mixture-of-experts FFN.

The port's counterpart of ``repro.models.transformer`` for serving all
five LM archs of the registry: ``h2o-danube-1.8b`` (GQA with a sliding
window), ``stablelm-1.6b`` (MHA), ``granite-moe-3b-a800m`` and
``moonshot-v1-16b-a3b`` (GQA, MoE FFN) and ``minicpm3-4b`` (MLA): the
configs with their parameter arithmetic, ``init_params``, ``Transformer``
(whose ``forward`` and ``hidden_states`` are the reference's functions of
those names), ``make_prefill``, ``make_decode_step``, ``init_cache`` and
``cache_spec``.  The training step is not ported (ROADMAP A.9.4).

GQA attention takes one of two routes (``Transformer.use_kernel``):

* ``True``: every attention call goes through the hand-written kernel B6
  (:func:`~repro_torch.kernels.flash_attention.gqa_attention_op`, on the
  model's ``(B, L, H, D)`` activations and ``(B, S, H_kv, D)`` cache
  slices, KV heads read in place) — on the card the CUDA kernel; on the
  CPU its plain version;
* ``False``: B6's plain version
  (:func:`~repro_torch.kernels.flash_attention.gqa_attention_ref`), f32
  scores and softmax over queries in chunks of ``attn_chunk``, each
  against the keys its rows can see, KV heads repeated (the yardstick
  path on the card).  It stands for ``repro``'s plain path
  ``_chunked_softmax_attn``; that path masks to ``-1e30`` and this one to
  ``-inf``, the same function on every row that sees a key (every row of
  this model does).

``repro`` itself never reaches its Pallas kernel on this path; its
``_chunked_softmax_attn`` docstring names the kernel for serving, and the
port runs it there.

**MLA attention always takes the plain route** (:func:`_chunked_softmax_attn`,
the port of the reference's, whatever ``use_kernel`` says): B6 takes
equal query, key and value head dims of ``HEAD_DIMS`` and scales by
1/√D, while MLA's absorbed path attends with every query head over one
shared latent "KV head" with a score dim of ``kv_lora_rank + d_head_rope``
(288 in ``minicpm3-4b``), a value dim of ``kv_lora_rank`` (256) and a
scale of 1/√(d_head_nope + d_head_rope).

**The MoE FFN** (:func:`_moe_ffn`) is the reference's GShard grouped
capacity dispatch with one routing function (:func:`_route`) and the
dispatch and combine by index (:func:`_dispatch_index`); the reference's
one-hot einsums stay beside it as its plain version
(:func:`_dispatch_plain`), which no path of the model runs.  The expert
products are batched ``torch.bmm`` calls (the reference computes them
outside Pallas too).

**Caches are written in place.**  The layout is ``repro``'s fixed
buffer, ``(L, 2, B, S, H_kv, D)`` for GQA and ``(L, B, S, kv_lora_rank +
d_head_rope)`` for MLA (the normed latent and the rotated rope key);
``forward`` with ``caches`` writes each layer's new entries into it (no
functional copy: the ``decode_32k`` cache is 32 GB) and returns the same
tensor.  The write starts at ``cache_pos`` clamped to ``[0, S - L]``,
where ``jax.lax.dynamic_update_slice`` puts it (:func:`_write_start`),
while the queries keep the unclamped positions ``cache_pos + i``: at
``cache_pos >= S`` the write lands in the last slots and the mask is by
buffer index (``repro``'s "ring" cache is not a ring).  ``cache_pos`` is a
host int.

The models call :func:`~repro_torch.parallel.hints.shard_hint` where the
reference does; with no mesh registered (every path of the port so far)
each call returns its input.

Serving only: parameters do not require gradients and the entry points
run without autograd.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_attention import gqa_attention_op, gqa_attention_ref
from repro_torch.models.common import (
    apply_rope, causal_mask, dense_init, embed_init, rms_norm, swiglu)
from repro_torch.parallel.hints import BATCH, TP, shard_hint

@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    n_shared: int = 0
    group_size: int = 1024
    pad_experts_to: Optional[int] = None

    @property
    def padded_experts(self) -> int:
        return max(self.num_experts, self.pad_experts_to or 0)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    d_head_nope: int = 64
    d_head_rope: int = 32
    d_head_v: int = 64


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None  # default d_model // n_heads
    attention: str = "gqa"  # "gqa" | "mla"
    window: Optional[int] = None  # sliding-window size (SWA)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True  # a training switch of the reference; unused when serving
    mla_absorbed: bool = True
    # query-chunked plain attention: caps the live (b, h, chunk, Lk) f32
    # score tensor (repro chunks only when Lq % attn_chunk == 0, the port
    # whenever Lq > attn_chunk; the result is the same)
    attn_chunk: Optional[int] = 1024
    ce_chunk: Optional[int] = None  # a training switch of the reference

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 128; the padded logit columns
        are masked to ``-1e30``."""
        return ((self.vocab + 127) // 128) * 128

    @property
    def sub_quadratic(self) -> bool:
        """True if serve memory is o(L) in context length (a window)."""
        return self.window is not None

    def param_count(self) -> int:
        """Total parameters (for 6·N·D roofline bookkeeping)."""
        d, v = self.d_model, self.vocab
        hd = self.head_dim
        if self.attention == "mla":
            m = self.mla or MLAConfig()
            attn = (
                d * m.q_lora_rank
                + m.q_lora_rank * self.n_heads * (m.d_head_nope + m.d_head_rope)
                + d * (m.kv_lora_rank + m.d_head_rope)
                + m.kv_lora_rank * self.n_heads * (m.d_head_nope + m.d_head_v)
                + self.n_heads * m.d_head_v * d
            )
        else:
            attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        if self.moe is not None:
            ffn = (
                d * self.moe.num_experts
                + (self.moe.num_experts + self.moe.n_shared) * 3 * d * self.moe.d_ff_expert
            )
        else:
            ffn = 3 * d * self.d_ff
        per_layer = attn + ffn + 2 * d
        return v * d + self.n_layers * per_layer + d + d * v

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE: only routed experts)."""
        if self.moe is None:
            return self.param_count()
        unused = (self.moe.num_experts - self.moe.top_k) * 3 * self.d_model * self.moe.d_ff_expert
        return self.param_count() - self.n_layers * unused


def _check_supported(cfg: TransformerConfig) -> None:
    if cfg.attention not in ("gqa", "mla"):
        raise ValueError(f"{cfg.name}: attention={cfg.attention!r}, expected 'gqa' or 'mla'")
    if cfg.attention == "gqa" and cfg.n_heads % cfg.n_kv_heads:
        raise ValueError(f"{cfg.name}: {cfg.n_heads} heads not a multiple of {cfg.n_kv_heads}")


# ---------------------------------------------------------------- params
def _expert_init(gen: torch.Generator, e: int, fan_in: int, fan_out: int, dt) -> torch.Tensor:
    """``e`` stacked ``dense_init(fan_in, fan_out)`` draws: ``(e, fan_in, fan_out)``."""
    w = torch.randn((e, fan_in, fan_out), generator=gen, device=gen.device)
    return w.mul_(1.0 / (fan_in**0.5)).to(dt)


def init_params(cfg: TransformerConfig, generator: torch.Generator) -> Dict:
    """Parameters with the reference's distributions (``dense_init``
    N(0, 1)/√fan_in, ``embed_init`` N(0, 1)·0.02, norms 1), drawn on the
    generator's device: ``{"embed", "final_norm", "lm_head", "layers":
    [per-layer dict]}``.  A layer holds GQA (``wq``, ``wk``, ``wv``,
    ``wo``) or MLA (``q_a``, ``q_a_norm``, ``q_b``, ``kv_a``,
    ``kv_a_norm``, ``kv_b``, ``o``) attention, and a dense (``w_gate``,
    ``w_up``, ``w_down``) or MoE FFN: ``router`` (d, E_pad), ``w_gate`` /
    ``w_up`` (E_pad, d, ff), ``w_down`` (E_pad, ff, d) (drawn as
    (E_pad, d, ff) and transposed, as the reference's swapped
    ``expert_stack``), ``shared_{gate,up,down}`` when ``n_shared > 0``.
    The padded experts' weights are stored, as in the reference."""
    _check_supported(cfg)
    d, hd, dt, gen = cfg.d_model, cfg.head_dim, cfg.dtype, generator
    hq, hkv = cfg.n_heads, cfg.n_kv_heads

    def ones(n):
        return torch.ones((n,), dtype=dt, device=gen.device)

    def dense(fan_in, fan_out):
        return dense_init(gen, fan_in, fan_out, dt)

    def layer():
        p = {"norm_attn": ones(d), "norm_ffn": ones(d)}
        if cfg.attention == "mla":
            m = cfg.mla or MLAConfig()
            p.update(
                q_a=dense(d, m.q_lora_rank),
                q_a_norm=ones(m.q_lora_rank),
                q_b=dense(m.q_lora_rank, hq * (m.d_head_nope + m.d_head_rope)),
                kv_a=dense(d, m.kv_lora_rank + m.d_head_rope),
                kv_a_norm=ones(m.kv_lora_rank),
                kv_b=dense(m.kv_lora_rank, hq * (m.d_head_nope + m.d_head_v)),
                o=dense(hq * m.d_head_v, d),
            )
        else:
            p.update(wq=dense(d, hq * hd), wk=dense(d, hkv * hd), wv=dense(d, hkv * hd),
                     wo=dense(hq * hd, d))
        if cfg.moe is not None:
            e, ff = cfg.moe.padded_experts, cfg.moe.d_ff_expert
            p.update(
                router=dense(d, e),
                w_gate=_expert_init(gen, e, d, ff, dt),
                w_up=_expert_init(gen, e, d, ff, dt),
                w_down=_expert_init(gen, e, d, ff, dt).transpose(1, 2).contiguous(),
            )
            if cfg.moe.n_shared:
                sff = ff * cfg.moe.n_shared
                p.update(shared_gate=dense(d, sff), shared_up=dense(d, sff),
                         shared_down=dense(sff, d))
        else:
            p.update(w_gate=dense(d, cfg.d_ff), w_up=dense(d, cfg.d_ff),
                     w_down=dense(cfg.d_ff, d))
        return p

    params = {
        "embed": embed_init(gen, cfg.padded_vocab, d, dt),
        "final_norm": ones(d),
        "lm_head": dense_init(gen, d, cfg.padded_vocab, dt),
    }
    params["layers"] = [layer() for _ in range(cfg.n_layers)]
    return params


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class TransformerLayer(nn.Module):
    """One layer's parameters, named as ``repro``'s ``params["layers"]`` keys."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        super().__init__()
        for name, t in params.items():
            setattr(self, name, _param(t))


# ------------------------------------------------------------- attention
def _write_start(cache_pos: int, l: int, s: int) -> int:
    """Where ``jax.lax.dynamic_update_slice`` writes ``l`` rows into ``s``
    slots starting at ``cache_pos``: a negative start counts from the end
    (``+ s``), then the start is clamped to ``[0, s - l]``."""
    if l > s:
        raise ValueError(f"{l} new positions do not fit a {s}-slot cache")
    pos = int(cache_pos)
    if pos < 0:
        pos += s
    return min(max(pos, 0), s - l)


def _chunked_softmax_attn(
    q_list: Sequence[torch.Tensor],
    k_list: Sequence[torch.Tensor],
    v_ctx: torch.Tensor,
    q_offset: int,
    scale: float,
    *,
    window: Optional[int] = None,
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """``repro``'s ``_chunked_softmax_attn``: masked softmax attention
    whose scores are the sum over matching (query, key) pairs, in f32.

    Each query is ``(b, l, h, x)``; its key is ``(b, m, h, x)`` (per head)
    or ``(b, m, x)`` (one key shared by every head: MLA's latent and rope
    key).  ``v_ctx`` is ``(b, m, h, x)`` or ``(b, m, x)``.  Query ``i``
    sits at position ``q_offset + i`` and sees key ``j`` where ``j`` is at
    most its position (and within ``window``); a row that sees no key
    takes the uniform average, as the reference's ``-1e30`` mask gives.
    The queries go in chunks of ``chunk`` rows (whenever ``l > chunk``;
    the reference only when ``l % chunk == 0``, the same function), each
    against the keys up to its last row's position (the masked keys past
    it weigh exactly 0).  Returns ``(b, l, h, x)`` f32.
    """
    l, lk = q_list[0].shape[1], k_list[0].shape[1]
    step = chunk if chunk and l > chunk else max(l, 1)
    v32 = v_ctx.float()
    outs = []
    for a in range(0, l, step):
        e = min(l, a + step)
        hi = min(lk, max(q_offset + e, 1))
        sc = None
        for qq, kk in zip(q_list, k_list):
            contract = "bchx,bmhx->bhcm" if kk.dim() == 4 else "bchx,bmx->bhcm"
            term = torch.einsum(contract, qq[:, a:e].float(), kk[:, :hi].float())
            sc = term if sc is None else sc + term
        sc = sc * scale
        mask = causal_mask(e - a, hi, q_offset + a, window, device=sc.device)
        p = torch.softmax(sc.masked_fill(~mask, -1e30), dim=-1)
        del sc
        contract = "bhcm,bmhx->bchx" if v32.dim() == 4 else "bhcm,bmx->bchx"
        outs.append(torch.einsum(contract, p, v32[:, :hi]))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _gqa_attention(
    cfg: TransformerConfig,
    lp: TransformerLayer,
    x: torch.Tensor,  # (B, L, d)
    q_pos: torch.Tensor,  # (L,) absolute positions
    cache: Optional[torch.Tensor],  # (2, B, S, hkv, hd) buffer, written in place
    cache_pos: int,
    use_kernel: bool,
) -> torch.Tensor:
    b, l, _ = x.shape
    hd, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = shard_hint((x @ lp.wq).reshape(b, l, hq, hd), BATCH, None, TP, None)
    k = shard_hint((x @ lp.wk).reshape(b, l, hkv, hd), BATCH, None, TP, None)
    v = shard_hint((x @ lp.wv).reshape(b, l, hkv, hd), BATCH, None, TP, None)
    pos = q_pos[:, None]  # (L, 1): one rotation for every head
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    if cache is not None:
        start = _write_start(cache_pos, l, cache.shape[2])
        cache[0, :, start : start + l] = k
        cache[1, :, start : start + l] = v
        k_full, v_full = cache[0], cache[1]
    else:
        k_full, v_full = k, v
    # the reference's sequence-parallel keys (its repeated K/V heads)
    k_full = shard_hint(k_full, BATCH, TP, None, None)
    v_full = shard_hint(v_full, BATCH, TP, None, None)
    kw = dict(causal=True, window=cfg.window, q_offset=int(cache_pos), layout="blhd")
    if use_kernel:
        o = gqa_attention_op(q, k_full, v_full, **kw)
    else:
        o = gqa_attention_ref(q, k_full, v_full, chunk=cfg.attn_chunk, **kw)
    return o.reshape(b, l, hq * hd) @ lp.wo


def _mla_attention(
    cfg: TransformerConfig,
    lp: TransformerLayer,
    x: torch.Tensor,  # (B, L, d)
    q_pos: torch.Tensor,  # (L,) absolute positions
    cache: Optional[torch.Tensor],  # (B, S, kv_rank + d_rope) buffer, written in place
    cache_pos: int,
) -> torch.Tensor:
    """Multi-head latent attention (the reference's ``_mla_attention``).

    The cache holds the rms-normed latent ``c_kv`` and the rotated rope
    key shared by every head.  With a cache and ``cfg.mla_absorbed`` it
    runs DeepSeek-V2's absorbed path: ``W_uk`` folded into the query,
    ``W_uv`` into the output, attention over the latent.  Otherwise (no
    cache, or ``mla_absorbed=False``) the naive path decompresses per-head
    keys and values from every cached latent.  Both on the plain route.
    """
    m = cfg.mla or MLAConfig()
    b, l, _ = x.shape
    h, r = cfg.n_heads, m.kv_lora_rank
    dn, dr, dv = m.d_head_nope, m.d_head_rope, m.d_head_v
    pos = q_pos[:, None]  # (L, 1)
    qa = rms_norm(x @ lp.q_a, lp.q_a_norm)
    qb = (qa @ lp.q_b).reshape(b, l, h, dn + dr)
    q_nope = qb[..., :dn]
    q_rope = apply_rope(qb[..., dn:], pos, cfg.rope_theta)
    kva = x @ lp.kv_a
    c_kv = rms_norm(kva[..., :r], lp.kv_a_norm)
    k_rope = apply_rope(kva[..., r:][:, :, None], pos, cfg.rope_theta)[:, :, 0]  # (B, L, dr)
    latent = torch.cat([c_kv, k_rope], dim=-1)
    if cache is not None:
        start = _write_start(cache_pos, l, cache.shape[1])
        cache[:, start : start + l] = latent
        latent_full = cache
    else:
        latent_full = latent
    lk = latent_full.shape[1]
    c_full, krope_full = latent_full[..., :r], latent_full[..., r:]
    scale = 1.0 / ((dn + dr) ** 0.5)
    kw = dict(window=cfg.window, chunk=cfg.attn_chunk)

    if cfg.mla_absorbed and cache is not None:
        kvb_w = lp.kv_b.reshape(r, h, dn + dv)
        w_uk, w_uv = kvb_w[..., :dn], kvb_w[..., dn:]
        q_abs = torch.einsum("blhe,rhe->blhr", q_nope, w_uk)  # (b, l, h, r)
        ctx = _chunked_softmax_attn(
            [q_abs, q_rope], [c_full, krope_full], c_full, int(cache_pos), scale, **kw
        ).to(x.dtype)
        o = torch.einsum("blhr,rhe->blhe", ctx, w_uv).reshape(b, l, h * dv)
        return o @ lp.o

    kvb = (c_full @ lp.kv_b).reshape(b, lk, h, dn + dv)
    k_nope, v_lat = kvb[..., :dn], kvb[..., dn:]
    o = _chunked_softmax_attn(
        [q_nope, q_rope], [k_nope, krope_full], v_lat, int(cache_pos), scale, **kw
    ).to(x.dtype)
    return o.reshape(b, l, h * dv) @ lp.o


def _attention(cfg, lp, x, q_pos, cache, cache_pos: int, use_kernel: bool) -> torch.Tensor:
    """The layer's attention on its normed input: MLA on the plain route,
    GQA on B6 (``use_kernel``) or its plain version."""
    if cfg.attention == "mla":
        return _mla_attention(cfg, lp, x, q_pos, cache, cache_pos)
    return _gqa_attention(cfg, lp, x, q_pos, cache, cache_pos, use_kernel)


# ------------------------------------------------------------------ MoE
class Route(NamedTuple):
    """One dispatch's routing (``_route``): per group ``g``, token ``t``
    and choice ``k``."""

    gate_vals: torch.Tensor  # (g, t, k) f32, renormalised over the k choices
    gate_idx: torch.Tensor  # (g, t, k) int64 expert ids, never a padded one
    pos: torch.Tensor  # (g, t, k) int64 place in the expert's queue of this group
    keep: torch.Tensor  # (g, t, k) bool: pos < cap
    cap: int  # slots per expert and group


def _group(cfg: TransformerConfig, x: torch.Tensor) -> torch.Tensor:
    """``(B, L, d)`` tokens as ``(n_g, g_sz, d)`` dispatch groups."""
    b, l, d = x.shape
    t = b * l
    g_sz = min(cfg.moe.group_size, t)
    n_g = t // g_sz
    if n_g * g_sz != t:
        raise ValueError(f"tokens {t} not divisible by group {g_sz}")
    return shard_hint(x.reshape(n_g, g_sz, d), BATCH, None, None)


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest, ties in order of index (a stable
    sort; ``torch.topk`` promises no order among equal values)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(cfg: TransformerConfig, lp: TransformerLayer, xt: torch.Tensor) -> Route:
    """GShard top-k routing with capacity, as the reference's ``_moe_ffn``
    computes it: router logits in ``x.dtype`` then f32, padded experts at
    ``-1e30``, softmax, top-k renormalised (floor 1e-9), the capacity from
    the REAL expert count, each choice's place in its expert's queue by a
    running count over the group's (t·k) choices in order."""
    moe = cfg.moe
    n_g, g_sz, _ = xt.shape
    e, k = moe.padded_experts, moe.top_k
    logits = (xt @ lp.router).float()
    if e != moe.num_experts:  # padded experts are never routed
        dead = torch.arange(e, device=xt.device) >= moe.num_experts
        logits = logits.masked_fill(dead, -1e30)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top_k(probs, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    # capacity is a property of the REAL expert count: padding must not
    # change which tokens are dropped
    cap = max(1, int(moe.capacity_factor * g_sz * moe.top_k / moe.num_experts))
    flat = gate_idx.reshape(n_g, g_sz * k)
    counts = torch.nn.functional.one_hot(flat, e).cumsum(dim=1)  # (g, t*k, e)
    pos = (counts.gather(2, flat[..., None])[..., 0] - 1).reshape(n_g, g_sz, k)
    return Route(gate_vals, gate_idx, pos, pos < cap, cap)


def _expert_swiglu(lp: TransformerLayer, x_e: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU on its ``(E, rows, d)`` slots (batched products)."""
    hg = torch.bmm(x_e, lp.w_gate)
    hu = torch.bmm(x_e, lp.w_up)
    h = torch.nn.functional.silu(hg.float()).to(x_e.dtype) * hu
    return torch.bmm(h, lp.w_down)


def _dispatch_index(cfg: TransformerConfig, lp: TransformerLayer, xt: torch.Tensor,
                    route: Route) -> torch.Tensor:
    """The routed experts by index: each kept choice copies its token into
    its ``(expert, group, pos)`` slot of an ``(E, n_g·cap, d)`` buffer (a
    slot holds at most one token), the experts run as batched products
    over the slots, and each token sums its kept choices' outputs weighted
    by their gates in ``x.dtype`` (f32 accumulation).  The same function
    as :func:`_dispatch_plain`'s one-hot products, with no (g, t, e, c)
    tensor.  Returns ``(n_g, g_sz, d)``."""
    n_g, g_sz, d = xt.shape
    e, k, cap = cfg.moe.padded_experts, cfg.moe.top_k, route.cap
    group = torch.arange(n_g, device=xt.device)[:, None, None]
    slot = (route.gate_idx * n_g + group) * cap + route.pos  # (g, t, k)
    keep = route.keep
    tokens = torch.arange(n_g * g_sz, device=xt.device).reshape(n_g, g_sz, 1).expand(-1, -1, k)
    x_e = xt.new_zeros((e * n_g * cap, d))
    x_e[slot[keep]] = xt.reshape(-1, d)[tokens[keep]]
    y_e = _expert_swiglu(lp, x_e.view(e, n_g * cap, d)).view(e * n_g * cap, d)
    # a dropped choice reads slot 0 with weight 0
    w = (route.gate_vals.to(xt.dtype) * keep).reshape(n_g * g_sz, 1, k)
    ys = y_e[torch.where(keep, slot, 0).reshape(-1)].view(n_g * g_sz, k, d)
    return torch.bmm(w, ys).view(n_g, g_sz, d)


def _dispatch_plain(cfg: TransformerConfig, lp: TransformerLayer, xt: torch.Tensor,
                    route: Route) -> torch.Tensor:
    """The reference's one-hot dispatch and combine, written out: the
    (g, t, e, c) dispatch and combine tensors, the experts as einsums over
    (g, e, c, d) blocks.  The plain version :func:`_dispatch_index` is
    held to (tests, ``chip_smoke.py``); no path of the model runs it."""
    n_g, g_sz, d = xt.shape
    e, k, cap, dt = cfg.moe.padded_experts, cfg.moe.top_k, route.cap, xt.dtype
    dev = xt.device

    def one_hot(idx, n):  # jax.nn.one_hot: an index out of range gives zeros
        return (idx[..., None] == torch.arange(n, device=dev)).to(dt)

    disp = one_hot(route.gate_idx, e) * route.keep[..., None].to(dt)  # (g, t, k, e)
    pos_oh = one_hot(route.pos, cap)  # (g, t, k, c)
    gt = n_g * g_sz

    def k_contract(a, b):  # (gt, k, e) x (gt, k, c) -> (g, t, e, c)
        out = torch.bmm(a.reshape(gt, k, e).transpose(1, 2), b.reshape(gt, k, cap))
        return out.reshape(n_g, g_sz, e, cap)

    dispatch = shard_hint(k_contract(disp, pos_oh), BATCH, None, TP, None)
    combine = shard_hint(k_contract(disp * route.gate_vals.to(dt)[..., None], pos_oh),
                         BATCH, None, TP, None)
    x_e = shard_hint(torch.einsum("gtec,gtd->gecd", dispatch, xt), BATCH, TP, None, None)
    hg = torch.einsum("gecd,edf->gecf", x_e, lp.w_gate)
    hu = torch.einsum("gecd,edf->gecf", x_e, lp.w_up)
    h = torch.nn.functional.silu(hg.float()).to(dt) * hu
    y_e = shard_hint(torch.einsum("gecf,efd->gecd", h, lp.w_down), BATCH, TP, None, None)
    return shard_hint(torch.einsum("gtec,gecd->gtd", combine, y_e), BATCH, None, None)


def _moe_ffn(cfg: TransformerConfig, lp: TransformerLayer, x: torch.Tensor) -> torch.Tensor:
    """GShard grouped capacity dispatch (the reference's ``_moe_ffn``):
    groups, routing (:func:`_route`), the routed experts by index, plus
    the shared experts."""
    b, l, d = x.shape
    xt = _group(cfg, x)
    out = _dispatch_index(cfg, lp, xt, _route(cfg, lp, xt))
    if cfg.moe.n_shared:
        out = out + swiglu(xt, lp.shared_gate, lp.shared_up, lp.shared_down)
    return out.reshape(b, l, d)


def _dense_ffn(lp: TransformerLayer, x: torch.Tensor) -> torch.Tensor:
    return swiglu(x, lp.w_gate, lp.w_up, lp.w_down)


# ---------------------------------------------------------------- forward
def _layer(cfg, lp, x, q_pos, cache, cache_pos, use_kernel):
    x = shard_hint(x, BATCH, None, None)
    h = _attention(cfg, lp, rms_norm(x, lp.norm_attn), q_pos, cache, cache_pos, use_kernel)
    x = shard_hint(x + h, BATCH, None, None)
    ffn_in = rms_norm(x, lp.norm_ffn)
    ffn = _moe_ffn(cfg, lp, ffn_in) if cfg.moe is not None else _dense_ffn(lp, ffn_in)
    return shard_hint(x + ffn, BATCH, None, None)


class Transformer(nn.Module):
    """The decoder stack with its parameters on ``device``.

    Parameters are drawn from ``generator`` with the reference's
    initialisers (the 8 GB of ``granite-moe-3b-a800m`` in bf16 never pass
    through the host).  ``use_kernel`` picks the GQA attention route; MLA
    attention always takes the plain route (module docstring).
    """

    def __init__(
        self,
        cfg: TransformerConfig,
        *,
        generator: torch.Generator = None,
        device: DeviceLike = None,
        use_kernel: bool = True,
    ):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
        params = init_params(cfg, gen)
        self.cfg = cfg
        self.use_kernel = use_kernel
        self.embed = _param(params["embed"])
        self.final_norm = _param(params["final_norm"])
        self.lm_head = _param(params["lm_head"])
        self.layers = nn.ModuleList(TransformerLayer(p) for p in params["layers"])

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _tokens(self, tokens) -> torch.Tensor:
        t = torch.as_tensor(tokens, device=self.device)
        if t.dim() != 2 or t.is_floating_point():
            raise ValueError(f"tokens must be (B, L) integers, got {tuple(t.shape)} {t.dtype}")
        return t.long()

    def _check_caches(self, caches: torch.Tensor, batch: int) -> None:
        cfg = self.cfg
        got = tuple(caches.shape)
        if cfg.attention == "mla":
            m = cfg.mla or MLAConfig()
            want = (cfg.n_layers, batch, m.kv_lora_rank + m.d_head_rope)
            if len(got) != 4 or got[:2] + got[3:] != want:
                raise ValueError(f"caches {got} do not match (L, B, S, kv_rank + d_rope) = "
                                 f"{want} with any S")
        else:
            want = (cfg.n_layers, 2, batch, cfg.n_kv_heads, cfg.head_dim)
            if len(got) != 6 or got[:3] + got[4:] != want:
                raise ValueError(f"caches {got} do not match (L, 2, B, S, hkv, hd) = {want} "
                                 "with any S")
        if caches.dtype != cfg.dtype or caches.device != self.device:
            raise TypeError(f"caches are {caches.dtype} on {caches.device}, expected "
                            f"{cfg.dtype} on {self.device}")

    def trunk(self, tokens, caches=None, cache_pos: int = 0) -> torch.Tensor:
        """Embedding, the layers (writing ``caches`` in place) and the final
        norm: ``(B, L, d)``."""
        tokens = self._tokens(tokens)
        b, l = tokens.shape
        if caches is not None:
            self._check_caches(caches, b)
        x = self.embed[tokens]
        q_pos = torch.arange(l, device=x.device) + int(cache_pos)
        for i, lp in enumerate(self.layers):
            cache = None if caches is None else caches[i]
            x = _layer(self.cfg, lp, x, q_pos, cache, int(cache_pos), self.use_kernel)
        return rms_norm(x, self.final_norm)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        out = x @ self.lm_head
        cfg = self.cfg
        if cfg.padded_vocab != cfg.vocab:
            pad = torch.arange(cfg.padded_vocab, device=out.device) >= cfg.vocab
            out = out.masked_fill(pad, -1e30)
        return out

    @torch.no_grad()
    def forward(
        self, tokens, caches: Optional[torch.Tensor] = None, cache_pos: int = 0
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``(logits (B, L, padded_vocab), caches)``; ``caches`` (or None)
        is written in place and returned."""
        return self.logits(self.trunk(tokens, caches, cache_pos)), caches

    @torch.no_grad()
    def hidden_states(self, tokens) -> torch.Tensor:
        """Forward up to the final norm, no unembedding, no cache."""
        return self.trunk(tokens)

    @torch.no_grad()
    def prefill(self, tokens, caches: torch.Tensor):
        """Full-sequence forward that fills ``caches`` from position 0:
        ``(last-position logits (B, V), caches)``.  Only the last position
        is unembedded (the reference unembeds all and keeps the last)."""
        x = self.trunk(tokens, caches, 0)
        return self.logits(x[:, -1]), caches

    @torch.no_grad()
    def decode_step(self, caches: torch.Tensor, token, cache_len: int):
        """One token per sequence ``(B, 1)`` at position ``cache_len``:
        ``(logits (B, V), caches)``."""
        logits, caches = self(token, caches, cache_len)
        return logits[:, -1], caches


# --------------------------------------------------------------- entry points
def make_prefill(model: Transformer):
    """Counterpart of ``repro.models.transformer.make_prefill``:
    ``prefill(tokens, caches) -> (logits[:, -1], caches)``."""
    return model.prefill


def make_decode_step(model: Transformer):
    """Counterpart of ``repro.models.transformer.make_decode_step``:
    ``decode_step(caches, token, cache_len) -> (logits[:, -1], caches)``,
    one build of the kernel for every position (``cache_len`` is a
    runtime argument)."""
    return model.decode_step


def _cache_shape(cfg: TransformerConfig, batch: int, length: int) -> Tuple[int, ...]:
    if cfg.attention == "mla":
        m = cfg.mla or MLAConfig()
        return (cfg.n_layers, batch, length, m.kv_lora_rank + m.d_head_rope)
    return (cfg.n_layers, 2, batch, length, cfg.n_kv_heads, cfg.head_dim)


def init_cache(
    cfg: TransformerConfig, batch: int, length: int, dtype: torch.dtype = None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Zeroed cache buffer: GQA ``(L, 2, B, S, hkv, hd)``, MLA ``(L, B, S,
    kv_lora_rank + d_head_rope)``."""
    _check_supported(cfg)
    return torch.zeros(_cache_shape(cfg, batch, length), dtype=dtype or cfg.dtype,
                       device=resolve_device(device))


def cache_spec(cfg: TransformerConfig, batch: int, length: int, dtype: torch.dtype = None):
    """The cache's shape and dtype, nothing allocated (the dry run's input
    spec): a :class:`~repro_torch.configs.cells.TensorSpec`."""
    from repro_torch.configs.cells import TensorSpec  # cells imports this module

    return TensorSpec(_cache_shape(cfg, batch, length), dtype or cfg.dtype)


__all__: List[str] = [
    "MLAConfig",
    "MoEConfig",
    "Route",
    "Transformer",
    "TransformerConfig",
    "TransformerLayer",
    "cache_spec",
    "init_cache",
    "init_params",
    "make_decode_step",
    "make_prefill",
]
