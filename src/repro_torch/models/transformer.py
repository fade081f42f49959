"""Decoder-only transformer serving: GQA attention over a KV cache, dense
SwiGLU FFN.

The port's counterpart of ``repro.models.transformer`` for the
configurations with grouped-query attention and a dense FFN
(``h2o-danube-1.8b``, whose ``window`` is sliding-window attention, and
``stablelm-1.6b``): the configs with their parameter arithmetic,
``init_params``, ``Transformer`` (whose ``forward`` and ``hidden_states``
are the reference's functions of those names), ``make_prefill``,
``make_decode_step`` and ``init_cache``.  Mixture-of-experts FFNs, latent
attention (MLA) and the training step are not ported yet: a config that
needs them raises ``NotImplementedError``.

Attention takes one of two routes (``Transformer.use_kernel``):

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

**Caches are written in place.**  The layout is ``repro``'s
``(L, 2, B, S, H_kv, D)`` fixed buffer; ``forward`` with ``caches`` writes
each layer's new keys and values into it (no functional copy: the
``decode_32k`` cache is 32 GB) and returns the same tensor.  The write
starts at ``cache_pos`` clamped to ``[0, S - L]``, where
``jax.lax.dynamic_update_slice`` puts it (:func:`_write_start`), while the
queries keep the unclamped positions ``cache_pos + i``: at
``cache_pos >= S`` the write lands in the last slots and the mask is by
buffer index (``repro``'s "ring" cache is not a ring).  ``cache_pos`` is a host int.

Serving only: parameters do not require gradients and the entry points
run without autograd.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_attention import gqa_attention_op, gqa_attention_ref
from repro_torch.models.common import apply_rope, dense_init, embed_init, rms_norm, swiglu

_NOT_PORTED = "is not ported yet (ROADMAP A.9.3: MoE FFN, MLA attention)"


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
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: a mixture-of-experts FFN {_NOT_PORTED}")
    if cfg.attention != "gqa":
        raise NotImplementedError(f"{cfg.name}: attention={cfg.attention!r} {_NOT_PORTED}")
    if cfg.n_heads % cfg.n_kv_heads:
        raise ValueError(f"{cfg.name}: {cfg.n_heads} heads not a multiple of {cfg.n_kv_heads}")


# ---------------------------------------------------------------- params
def init_params(cfg: TransformerConfig, generator: torch.Generator) -> Dict:
    """GQA + dense-FFN parameters with the reference's distributions
    (``dense_init`` N(0, 1)/√fan_in, ``embed_init`` N(0, 1)·0.02, norms 1),
    drawn on the generator's device: ``{"embed", "final_norm", "lm_head",
    "layers": [per-layer dict]}``."""
    _check_supported(cfg)
    d, hd, dt, gen = cfg.d_model, cfg.head_dim, cfg.dtype, generator
    hq, hkv = cfg.n_heads, cfg.n_kv_heads

    def ones(n):
        return torch.ones((n,), dtype=dt, device=gen.device)

    params = {
        "embed": embed_init(gen, cfg.padded_vocab, d, dt),
        "final_norm": ones(d),
        "lm_head": dense_init(gen, d, cfg.padded_vocab, dt),
    }
    params["layers"] = [
        {
            "norm_attn": ones(d),
            "norm_ffn": ones(d),
            "wq": dense_init(gen, d, hq * hd, dt),
            "wk": dense_init(gen, d, hkv * hd, dt),
            "wv": dense_init(gen, d, hkv * hd, dt),
            "wo": dense_init(gen, hq * hd, d, dt),
            "w_gate": dense_init(gen, d, cfg.d_ff, dt),
            "w_up": dense_init(gen, d, cfg.d_ff, dt),
            "w_down": dense_init(gen, cfg.d_ff, d, dt),
        }
        for _ in range(cfg.n_layers)
    ]
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
    q = (x @ lp.wq).reshape(b, l, hq, hd)
    k = (x @ lp.wk).reshape(b, l, hkv, hd)
    v = (x @ lp.wv).reshape(b, l, hkv, hd)
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
    kw = dict(causal=True, window=cfg.window, q_offset=int(cache_pos), layout="blhd")
    if use_kernel:
        o = gqa_attention_op(q, k_full, v_full, **kw)
    else:
        o = gqa_attention_ref(q, k_full, v_full, chunk=cfg.attn_chunk, **kw)
    return o.reshape(b, l, hq * hd) @ lp.wo


def _dense_ffn(lp: TransformerLayer, x: torch.Tensor) -> torch.Tensor:
    return swiglu(x, lp.w_gate, lp.w_up, lp.w_down)


# ---------------------------------------------------------------- forward
def _layer(cfg, lp, x, q_pos, cache, cache_pos, use_kernel):
    x = x + _gqa_attention(
        cfg, lp, rms_norm(x, lp.norm_attn), q_pos, cache, cache_pos, use_kernel
    )
    return x + _dense_ffn(lp, rms_norm(x, lp.norm_ffn))


class Transformer(nn.Module):
    """The decoder stack with its parameters on ``device``.

    Parameters are drawn from ``generator`` with the reference's
    initialisers (the 3.7 GB of ``h2o-danube-1.8b`` in bf16 never pass
    through the host).  ``use_kernel`` picks the attention route (module
    docstring).
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
        want = (cfg.n_layers, 2, batch, cfg.n_kv_heads, cfg.head_dim)
        got = tuple(caches.shape)
        if len(got) != 6 or got[:3] + got[4:] != want:
            raise ValueError(f"caches {got} do not match (L, 2, B, S, hkv, hd) = {want} with any S")
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


def init_cache(
    cfg: TransformerConfig, batch: int, length: int, dtype: torch.dtype = None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Zeroed ``(L, 2, B, S, hkv, hd)`` KV buffer."""
    _check_supported(cfg)
    return torch.zeros(
        (cfg.n_layers, 2, batch, length, cfg.n_kv_heads, cfg.head_dim),
        dtype=dtype or cfg.dtype,
        device=resolve_device(device),
    )



__all__: List[str] = [
    "MLAConfig",
    "MoEConfig",
    "Transformer",
    "TransformerConfig",
    "TransformerLayer",
    "init_cache",
    "init_params",
    "make_decode_step",
    "make_prefill",
]
