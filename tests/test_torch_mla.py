"""The port's multi-head latent attention (MLA) vs the JAX reference, on
the CPU.

``minicpm3-4b`` at its REDUCED config with ``repro``'s ``init_params(cfg,
PRNGKey(0))`` carried across by ``load_transformer``: prefill and decode
logits and the latent caches at f32 ``rtol=2e-4, atol=5e-4`` (bf16
``2e-2``) on the absorbed serving path, on the naive one
(``mla_absorbed=False``), and without a cache (the naive path's
``hidden_states``); the plain attention, :func:`_chunked_softmax_attn`,
against the reference's on GQA's one (query, key) pair and MLA's two.
MLA never takes B6 (the module docstring says why); on the card the
model runs in ``chip_smoke.py`` phase 17 (c).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import minicpm3_4b as jax_minicpm3
from repro.models import transformer as jt
from repro_torch.configs import cells
from repro_torch.models import transformer as pt
from repro_torch.models.convert import load_transformer

F32_TOL = dict(rtol=2e-4, atol=5e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
B, L, S = 2, 40, 48


def _port_config(cfg):
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["mla"] = pt.MLAConfig(**dataclasses.asdict(cfg.mla))
    fields["dtype"] = torch.bfloat16 if cfg.dtype == jnp.bfloat16 else torch.float32
    return pt.TransformerConfig(**fields)


def _configs(**kw):
    jcfg = dataclasses.replace(jax_minicpm3.REDUCED, **kw)
    return jcfg, _port_config(jcfg)


def _setup(jcfg, pcfg, *, use_kernel=True):
    params = jt.init_params(jcfg, jax.random.PRNGKey(0))
    model = pt.Transformer(pcfg, device="cpu", use_kernel=use_kernel)
    load_transformer(model, jax.tree.map(np.asarray, params))
    return params, model


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _decode_run(jcfg, pcfg, steps, *, use_kernel=True, tol=F32_TOL, jit=True, l=L, s=S):
    params, model = _setup(jcfg, pcfg, use_kernel=use_kernel)
    toks = _tokens(jcfg, (B, l), 8)
    prefill, dec = jt.make_prefill(jcfg), jt.make_decode_step(jcfg)
    if jit:
        prefill, dec = jax.jit(prefill), jax.jit(dec)
    jl, jc = prefill(params, jnp.asarray(toks), jt.init_cache(jcfg, B, s))
    caches = pt.init_cache(pcfg, B, s, device="cpu")
    pl, pc = pt.make_prefill(model)(torch.from_numpy(toks), caches)
    assert pc is caches and pc.shape == jc.shape == (pcfg.n_layers, B, s, 16 + 8)
    _close(pl, jl, tol)
    _close(pc, jc, tol)
    for i, cache_len in enumerate(steps):
        tok = _tokens(jcfg, (B, 1), 100 + i)
        jl, jc = dec(params, jc, jnp.asarray(tok), cache_len)
        pl, _ = pt.make_decode_step(model)(pc, torch.from_numpy(tok), cache_len)
        _close(pl, jl, tol)
        _close(pc, jc, tol)


class TestServing:
    @pytest.mark.parametrize("use_kernel", [True, False])
    @pytest.mark.parametrize("absorbed", [True, False])
    def test_prefill_then_three_steps_match_the_reference(self, absorbed, use_kernel):
        _decode_run(*_configs(mla_absorbed=absorbed), [L, L + 1, L + 2], use_kernel=use_kernel)

    @pytest.mark.parametrize("absorbed", [True, False])
    def test_bf16(self, absorbed):
        """The reference op by op (``TestDecode::test_bf16`` of
        ``test_torch_transformer``), so that it rounds where it says."""
        jcfg, pcfg = _configs(mla_absorbed=absorbed, dtype=jnp.bfloat16)
        with jax.disable_jit():
            _decode_run(jcfg, pcfg, [L, L + 1], tol=BF16_TOL, jit=False)

    def test_chunked_queries(self):
        """32 tokens in query chunks of 16 on both sides."""
        _decode_run(*_configs(attn_chunk=16), [32], l=32, s=40)

    def test_a_step_past_the_buffer_end_clamps_like_the_reference(self):
        _decode_run(*_configs(), [L, S + 3])

    @pytest.mark.parametrize("absorbed", [True, False])
    def test_forward_and_hidden_states_without_cache_take_the_naive_path(self, absorbed):
        jcfg, pcfg = _configs(mla_absorbed=absorbed)
        params, model = _setup(jcfg, pcfg)
        toks = _tokens(jcfg, (B, 24), 3)
        jl, _ = jt.forward(jcfg, params, jnp.asarray(toks))
        pl, caches = model(torch.from_numpy(toks))
        assert caches is None and pl.shape == (B, 24, pcfg.padded_vocab)
        _close(pl, jl)
        _close(model.hidden_states(toks), jt.hidden_states(jcfg, params, jnp.asarray(toks)))

    def test_mla_never_launches_b6(self, monkeypatch):
        calls = []
        monkeypatch.setattr(pt, "gqa_attention_op", lambda *a, **kw: calls.append(kw))
        _, pcfg = _configs()
        model = pt.Transformer(pcfg, device="cpu", use_kernel=True)
        caches = pt.init_cache(pcfg, B, S, device="cpu")
        model.prefill(_tokens(pcfg, (B, L), 5), caches)
        model.decode_step(caches, _tokens(pcfg, (B, 1), 6), L)
        assert calls == []


class TestCache:
    @pytest.mark.parametrize("config", ["mla", "gqa"])
    def test_init_cache_and_cache_spec_are_the_reference_layout(self, config):
        from repro.configs import h2o_danube_1_8b as jax_danube
        from repro_torch.configs import h2o_danube_1_8b

        jcfg, pcfg = (_configs() if config == "mla"
                      else (jax_danube.REDUCED, h2o_danube_1_8b.REDUCED))
        c = pt.init_cache(pcfg, 3, 40, device="cpu")
        assert c.shape == jt.init_cache(jcfg, 3, 40).shape and float(c.abs().max()) == 0.0
        spec = pt.cache_spec(pcfg, 3, 40, torch.bfloat16)
        ref = jt.cache_spec(jcfg, 3, 40, jnp.bfloat16)
        assert spec == cells.TensorSpec(tuple(ref.shape), torch.bfloat16)

    def test_caches_of_the_gqa_layout_raise(self):
        _, pcfg = _configs()
        model = pt.Transformer(pcfg, device="cpu")
        gqa = torch.zeros((pcfg.n_layers, 2, B, 8, pcfg.n_kv_heads, pcfg.head_dim))
        with pytest.raises(ValueError, match="kv_rank"):
            model.prefill(_tokens(pcfg, (B, 4), 9), gqa)
        with pytest.raises(TypeError, match="caches"):
            model.prefill(_tokens(pcfg, (B, 4), 9),
                          pt.init_cache(pcfg, B, 8, dtype=torch.bfloat16, device="cpu"))


class TestWeights:
    def test_mla_keys_load_and_a_missing_kv_b_raises(self):
        jcfg, pcfg = _configs()
        params = jax.tree.map(np.asarray, jt.init_params(jcfg, jax.random.PRNGKey(0)))
        model = load_transformer(pt.Transformer(pcfg, device="cpu"), params)
        for name in ("q_a", "q_a_norm", "q_b", "kv_a", "kv_a_norm", "kv_b", "o"):
            np.testing.assert_array_equal(getattr(model.layers[1], name).numpy(),
                                          params["layers"][name][1])
        layers = dict(params["layers"])
        layers.pop("kv_b")
        with pytest.raises(ValueError, match="keys"):
            load_transformer(model, dict(params, layers=layers))
        bad = dict(params["layers"], kv_b=params["layers"]["kv_b"][:, :8])
        with pytest.raises(ValueError, match=r"layers\.kv_b\[0\]"):
            load_transformer(model, dict(params, layers=bad))

    def test_init_follows_the_reference_layout(self):
        jcfg, pcfg = _configs()
        model = pt.Transformer(pcfg, generator=torch.Generator().manual_seed(5), device="cpu")
        jshapes = jax.eval_shape(lambda: jt.init_params(jcfg, jax.random.PRNGKey(0)))["layers"]
        names = {n for n, _ in model.layers[0].named_parameters()}
        assert names == set(jshapes)
        for name, p in model.layers[0].named_parameters():
            assert (pcfg.n_layers,) + tuple(p.shape) == jshapes[name].shape, name


class TestPlainAttention:
    """:func:`_chunked_softmax_attn` against the reference's on the same
    numpy inputs (the reference reads ``window`` and ``attn_chunk`` from
    its config)."""

    def _compare(self, q_list, k_list, v, q_offset, scale, window, chunk):
        jcfg = dataclasses.replace(jax_minicpm3.REDUCED, window=window, attn_chunk=chunk)
        l = q_list[0].shape[1]
        want = jt._chunked_softmax_attn(
            jcfg, [jnp.asarray(q) for q in q_list], [jnp.asarray(k) for k in k_list],
            jnp.asarray(v), jnp.arange(l) + q_offset, scale)
        got = pt._chunked_softmax_attn(
            [torch.from_numpy(q) for q in q_list], [torch.from_numpy(k) for k in k_list],
            torch.from_numpy(v), q_offset, scale, window=window, chunk=chunk)
        assert got.dtype == torch.float32
        _close(got, want, dict(rtol=1e-5, atol=1e-6))

    @pytest.mark.parametrize("window,chunk,q_offset", [(None, None, 0), (5, 8, 0), (None, 8, 7),
                                                       (6, 8, 30)])
    def test_one_pair_per_head_keys(self, window, chunk, q_offset):
        rng = np.random.default_rng(31)
        q, k, v = (rng.standard_normal(s).astype(np.float32)
                   for s in ((2, 16, 3, 8), (2, 40, 3, 8), (2, 40, 3, 8)))
        self._compare([q], [k], v, q_offset, 8**-0.5, window, chunk)

    @pytest.mark.parametrize("chunk,q_offset", [(None, 0), (8, 0), (4, 20)])
    def test_two_pairs_with_shared_keys(self, chunk, q_offset):
        """MLA's absorbed shape: the latent and the rope key shared by
        every head, the latent also the values."""
        rng = np.random.default_rng(32)
        q1, q2, c, kr = (rng.standard_normal(s).astype(np.float32)
                         for s in ((2, 16, 4, 12), (2, 16, 4, 6), (2, 40, 12), (2, 40, 6)))
        self._compare([q1, q2], [c, kr], c, q_offset, 10**-0.5, None, chunk)

    def test_gqa_pair_is_b6s_plain_version(self):
        """One (query, key) pair with repeated heads is B6's plain version
        up to f32 rounding (``-1e30`` against ``-inf`` masks; every row
        sees a key)."""
        from repro_torch.kernels.flash_attention import gqa_attention_ref

        rng = np.random.default_rng(33)
        q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for s in ((2, 12, 4, 8), (2, 20, 2, 8), (2, 20, 2, 8)))
        got = pt._chunked_softmax_attn([q], [k.repeat_interleave(2, 2)],
                                       v.repeat_interleave(2, 2), 8, 8**-0.5, window=4, chunk=5)
        want = gqa_attention_ref(q, k, v, window=4, q_offset=8, layout="blhd")
        _close(got, want, dict(rtol=1e-5, atol=1e-6))

