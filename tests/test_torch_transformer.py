"""The port's transformer serving slice vs the JAX reference, on the CPU.

``repro``'s ``init_params(cfg, PRNGKey(0))`` is carried across by
``repro_torch.models.convert.load_transformer``; prompts and tokens are
drawn with numpy.  Prefill and decode logits and the KV caches must agree
at f32 ``rtol=2e-4, atol=5e-4`` (bf16 ``2e-2``), the tolerances of
``tests/test_kernels.py::_tol``, on both attention routes of the port:
``use_kernel=True`` (B6's wrapper, which on the CPU runs its plain
version) and ``use_kernel=False`` (its chunked plain version).  The
CUDA kernel itself runs in ``test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import cells as jax_cells
from repro.configs import granite_moe_3b_a800m as jax_granite
from repro.configs import h2o_danube_1_8b as jax_danube
from repro.configs import minicpm3_4b as jax_minicpm3
from repro.configs import moonshot_v1_16b_a3b as jax_moonshot
from repro.configs import stablelm_1_6b as jax_stablelm
from repro.models import common as jax_common
from repro.models import transformer as jt
from repro_torch.configs import cells, h2o_danube_1_8b, stablelm_1_6b
from repro_torch.models import common
from repro_torch.models import transformer as pt
from repro_torch.models.convert import load_transformer

F32_TOL = dict(rtol=2e-4, atol=5e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
CONFIGS = {
    "danube": (jax_danube.REDUCED, h2o_danube_1_8b.REDUCED),  # GQA 4/2, window 16
    "stablelm": (jax_stablelm.REDUCED, stablelm_1_6b.REDUCED),  # MHA, no window
}
B, L, S = 2, 40, 48  # the prompt is longer than danube's window


def _port_config(cfg: jt.TransformerConfig) -> pt.TransformerConfig:
    """``repro``'s config with its sub-configs and dtype in the port's types."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if cfg.moe is not None:
        fields["moe"] = pt.MoEConfig(**dataclasses.asdict(cfg.moe))
    if cfg.mla is not None:
        fields["mla"] = pt.MLAConfig(**dataclasses.asdict(cfg.mla))
    fields["dtype"] = torch.bfloat16 if cfg.dtype == jnp.bfloat16 else torch.float32
    return pt.TransformerConfig(**fields)


def _setup(jcfg, pcfg, *, use_kernel=True):
    params = jt.init_params(jcfg, jax.random.PRNGKey(0))
    model = pt.Transformer(pcfg, device="cpu", use_kernel=use_kernel)
    load_transformer(model, jax.tree.map(np.asarray, params))
    return params, model


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _prefill_both(jcfg, params, model, tokens, s=S, jit=True):
    prefill = jt.make_prefill(jcfg)
    if jit:
        prefill = jax.jit(prefill)
    jl, jc = prefill(params, jnp.asarray(tokens), jt.init_cache(jcfg, len(tokens), s))
    caches = pt.init_cache(model.cfg, len(tokens), s, device="cpu")
    pl, pc = pt.make_prefill(model)(torch.from_numpy(tokens), caches)
    assert pc is caches  # written in place
    return (jl, jc), (pl, pc)


class TestPrefill:
    @pytest.mark.parametrize("use_kernel", [True, False])
    @pytest.mark.parametrize("name", list(CONFIGS))
    def test_logits_and_cache_match_the_reference(self, name, use_kernel):
        jcfg, pcfg = CONFIGS[name]
        params, model = _setup(jcfg, pcfg, use_kernel=use_kernel)
        (jl, jc), (pl, pc) = _prefill_both(jcfg, params, model, _tokens(jcfg, (B, L), 1))
        assert pl.shape == (B, pcfg.padded_vocab) and pc.shape == jc.shape
        _close(pl, jl)
        _close(pc, jc)

    @pytest.mark.parametrize("use_kernel", [True, False])
    @pytest.mark.parametrize("name", list(CONFIGS))
    def test_chunked_attention_loop(self, name, use_kernel):
        """32 tokens in query chunks of 16 on both sides."""
        jcfg, pcfg = (dataclasses.replace(c, attn_chunk=16) for c in CONFIGS[name])
        params, model = _setup(jcfg, pcfg, use_kernel=use_kernel)
        (jl, jc), (pl, pc) = _prefill_both(jcfg, params, model, _tokens(jcfg, (B, 32), 2), s=32)
        _close(pl, jl)
        _close(pc, jc)

    @pytest.mark.parametrize("use_kernel", [True, False])
    def test_forward_and_hidden_states_without_cache(self, use_kernel):
        jcfg, pcfg = CONFIGS["danube"]
        params, model = _setup(jcfg, pcfg, use_kernel=use_kernel)
        toks = _tokens(jcfg, (B, 24), 3)
        jl, _ = jt.forward(jcfg, params, jnp.asarray(toks))
        pl, caches = model(torch.from_numpy(toks))
        assert caches is None and pl.shape == (B, 24, pcfg.padded_vocab)
        _close(pl, jl)
        _close(model.hidden_states(toks), jt.hidden_states(jcfg, params, jnp.asarray(toks)))

    def test_padded_vocab_columns_are_masked(self):
        jcfg, pcfg = (dataclasses.replace(c, vocab=120) for c in CONFIGS["danube"])
        params, model = _setup(jcfg, pcfg)
        (jl, _), (pl, _) = _prefill_both(jcfg, params, model, _tokens(jcfg, (B, 20), 4))
        assert pl.shape == (B, 128)
        assert torch.equal(pl[:, 120:], torch.full((B, 8), -1e30))
        _close(pl, jl)

    def test_kernel_route_takes_b6_once_per_layer(self, monkeypatch):
        calls = []
        real = pt.gqa_attention_op

        def counting(*a, **kw):
            calls.append(kw)
            return real(*a, **kw)

        monkeypatch.setattr(pt, "gqa_attention_op", counting)
        jcfg, pcfg = CONFIGS["danube"]
        _, model = _setup(jcfg, pcfg)
        caches = pt.init_cache(pcfg, B, S, device="cpu")
        model.prefill(_tokens(jcfg, (B, L), 5), caches)
        model.decode_step(caches, _tokens(jcfg, (B, 1), 6), L)
        assert len(calls) == 2 * pcfg.n_layers
        assert calls[0] == dict(causal=True, window=16, q_offset=0, layout="blhd")
        assert calls[-1]["q_offset"] == L
        model.use_kernel = False
        model.decode_step(caches, _tokens(jcfg, (B, 1), 7), L + 1)
        assert len(calls) == 2 * pcfg.n_layers


class TestDecode:
    def _decode_run(self, jcfg, pcfg, steps, *, use_kernel=True, tol=F32_TOL, s=S, jit=True):
        params, model = _setup(jcfg, pcfg, use_kernel=use_kernel)
        (jl, jc), (pl, pc) = _prefill_both(jcfg, params, model, _tokens(jcfg, (B, L), 8), s=s,
                                           jit=jit)
        _close(pl, jl, tol)
        dec = jax.jit(jt.make_decode_step(jcfg)) if jit else jt.make_decode_step(jcfg)
        step_fn = pt.make_decode_step(model)
        for i, cache_len in enumerate(steps):
            tok = _tokens(jcfg, (B, 1), 100 + i)
            jl, jc = dec(params, jc, jnp.asarray(tok), cache_len)
            pl, pc2 = step_fn(pc, torch.from_numpy(tok), cache_len)
            assert pc2 is pc and pl.shape == (B, pcfg.padded_vocab)
            _close(pl, jl, tol)
            _close(pc, jc, tol)

    @pytest.mark.parametrize("use_kernel", [True, False])
    @pytest.mark.parametrize("name", list(CONFIGS))
    def test_three_steps_after_prefill(self, name, use_kernel):
        self._decode_run(*CONFIGS[name], [L, L + 1, L + 2], use_kernel=use_kernel)

    @pytest.mark.parametrize("name", list(CONFIGS))
    def test_a_step_past_the_buffer_end_clamps_like_the_reference(self, name):
        """``dynamic_update_slice`` clamps the write to the last slot while
        the query keeps its position (S + 3 here)."""
        self._decode_run(*CONFIGS[name], [L, S + 3])

    @pytest.mark.parametrize("name", list(CONFIGS))
    def test_bf16(self, name):
        """The reference runs op by op here: compiled, XLA may skip the bf16
        rounding between fused ops (``xla_allow_excess_precision``), which
        moved a few logits by 1-2 bf16 ulps past 2e-2; op by op, stablelm's
        prefill logits are bit-identical to the port's."""
        jcfg, pcfg = (dataclasses.replace(c, dtype=dt) for c, dt in
                      zip(CONFIGS[name], (jnp.bfloat16, torch.bfloat16)))
        with jax.disable_jit():
            self._decode_run(jcfg, pcfg, [L, L + 1], tol=BF16_TOL, jit=False)


class TestCache:
    @pytest.mark.parametrize("pos,l,s", [(5, 2, 6), (0, 3, 8), (7, 1, 8), (9, 1, 8),
                                         (-3, 2, 8), (-10, 2, 8), (30, 4, 16)])
    def test_write_start_is_dynamic_update_slice(self, pos, l, s):
        buf = jnp.zeros((s,), jnp.int32)
        upd = jax.lax.dynamic_update_slice(buf, jnp.arange(1, l + 1, dtype=jnp.int32), (pos,))
        start = pt._write_start(pos, l, s)
        want = np.zeros(s, np.int32)
        want[start : start + l] = np.arange(1, l + 1)
        np.testing.assert_array_equal(np.asarray(upd), want)

    def test_write_longer_than_the_buffer_raises(self):
        with pytest.raises(ValueError, match="do not fit"):
            pt._write_start(0, 9, 8)

    def test_init_cache_is_the_reference_layout(self):
        jcfg, pcfg = CONFIGS["danube"]
        c = pt.init_cache(pcfg, 3, 40, device="cpu")
        assert c.shape == jt.init_cache(jcfg, 3, 40).shape and c.dtype == torch.float32
        assert float(c.abs().max()) == 0.0

    def test_caches_of_another_shape_or_dtype_raise(self):
        _, pcfg = CONFIGS["danube"]
        model = pt.Transformer(pcfg, device="cpu")
        toks = _tokens(pcfg, (B, 4), 9)
        with pytest.raises(ValueError, match="caches"):
            model.prefill(toks, pt.init_cache(pcfg, B + 1, 8, device="cpu"))
        with pytest.raises(TypeError, match="caches"):
            model.prefill(toks, pt.init_cache(pcfg, B, 8, dtype=torch.bfloat16, device="cpu"))


class TestWeights:
    def test_load_checks_shapes_and_keys(self):
        jcfg, pcfg = CONFIGS["danube"]
        params = jax.tree.map(np.asarray, jt.init_params(jcfg, jax.random.PRNGKey(0)))
        model = pt.Transformer(pcfg, device="cpu")
        bad = dict(params, layers=dict(params["layers"], wq=params["layers"]["wq"][:1]))
        with pytest.raises(ValueError, match="layers.wq"):
            load_transformer(model, bad)
        bad = dict(params, layers=dict(params["layers"], wo=params["layers"]["wo"][:, :3]))
        with pytest.raises(ValueError, match=r"layers.wo\[0\]"):
            load_transformer(model, bad)
        layers = dict(params["layers"])
        layers.pop("w_up")
        with pytest.raises(ValueError, match="keys"):
            load_transformer(model, dict(params, layers=layers))
        with pytest.raises(ValueError, match="embed"):
            load_transformer(model, dict(params, embed=params["embed"][:5]))

    def test_bf16_parameters_are_carried_across_exactly(self):
        jcfg = dataclasses.replace(jax_danube.REDUCED, dtype=jnp.bfloat16)
        pcfg = dataclasses.replace(h2o_danube_1_8b.REDUCED, dtype=torch.bfloat16)
        params = jt.init_params(jcfg, jax.random.PRNGKey(1))
        host = jax.tree.map(np.asarray, params)
        assert host["embed"].dtype.name == "bfloat16"  # what torch.from_numpy refuses
        model = load_transformer(pt.Transformer(pcfg, device="cpu"), host)
        assert model.embed.dtype == torch.bfloat16
        want = np.asarray(params["layers"]["wk"][1], np.float32)
        np.testing.assert_array_equal(model.layers[1].wk.float().numpy(), want)
        np.testing.assert_array_equal(model.embed.float().numpy(),
                                      np.asarray(params["embed"], np.float32))

    def test_init_follows_the_reference_distribution(self):
        cfg = dataclasses.replace(h2o_danube_1_8b.REDUCED, d_model=256, d_ff=512, vocab=1024)
        model = pt.Transformer(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
        wq = model.layers[0].wq
        assert wq.shape == (256, 4 * 64) and not wq.requires_grad
        assert abs(float(wq.std()) * 16.0 - 1.0) < 0.05
        assert abs(float(model.embed.std()) / 0.02 - 1.0) < 0.05
        assert float(model.layers[1].norm_ffn.min()) == float(model.final_norm.max()) == 1.0

    def test_needs_an_explicit_cpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pt.Transformer(h2o_danube_1_8b.REDUCED)


class TestConfigs:
    FULL = [jax_danube.FULL, jax_stablelm.FULL, jax_granite.FULL, jax_minicpm3.FULL,
            jax_moonshot.FULL]

    @pytest.mark.parametrize("cfg", FULL, ids=lambda c: c.name)
    def test_parameter_arithmetic_is_the_reference(self, cfg):
        mine = _port_config(cfg)
        assert mine.param_count() == cfg.param_count()
        assert mine.active_param_count() == cfg.active_param_count()
        assert (mine.head_dim, mine.padded_vocab, mine.sub_quadratic) == (
            cfg.head_dim, cfg.padded_vocab, cfg.sub_quadratic)

    @pytest.mark.parametrize("cfg", [jax_granite.REDUCED, jax_minicpm3.REDUCED],
                             ids=lambda c: c.name)
    def test_moe_and_mla_models_build_and_prefill_like_the_reference(self, cfg):
        params, model = _setup(cfg, _port_config(cfg))
        (jl, jc), (pl, pc) = _prefill_both(cfg, params, model, _tokens(cfg, (B, L), 10))
        assert pc.shape == jc.shape == tuple(pt.init_cache(model.cfg, B, S, device="cpu").shape)
        _close(pl, jl)
        _close(pc, jc)

    def test_configs_are_the_reference_configs(self):
        for mine, ref in ((h2o_danube_1_8b.FULL, jax_danube.FULL),
                          (h2o_danube_1_8b.REDUCED, jax_danube.REDUCED),
                          (stablelm_1_6b.FULL, jax_stablelm.FULL),
                          (stablelm_1_6b.REDUCED, jax_stablelm.REDUCED)):
            assert mine == _port_config(ref)
        assert h2o_danube_1_8b.SHAPES == jax_danube.SHAPES
        assert stablelm_1_6b.SHAPES == jax_stablelm.SHAPES
        assert h2o_danube_1_8b.FULL.param_count() == 1_831_201_280

    @pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
    @pytest.mark.parametrize("name", ["danube", "stablelm"])
    def test_lm_shapes_and_cache_lengths_are_the_reference(self, name, shape):
        jcfg, pcfg = {"danube": (jax_danube.FULL, h2o_danube_1_8b.FULL),
                      "stablelm": (jax_stablelm.FULL, stablelm_1_6b.FULL)}[name]
        cell = jax_cells.lm_cell(jcfg.name, jcfg, shape)
        sh = cells.LM_SHAPES[shape]
        if cell.skip_reason:
            with pytest.raises(ValueError, match="full quadratic"):
                cells.lm_cache_len(pcfg, shape)
            return
        cache = cell.input_specs[2] if sh["kind"] == "prefill" else cell.input_specs[1]
        assert cache.shape[2:4] == (sh["batch"], cells.lm_cache_len(pcfg, shape))
        assert cell.meta["tokens"] == sh["batch"] * sh.get("seq", 1)
        if sh["kind"] == "decode":
            assert cell.meta["cache_len"] == cells.lm_cache_len(pcfg, shape)

    def test_train_shape_has_no_cache(self):
        assert cells.LM_SHAPES["train_4k"] == dict(seq=4096, batch=256, kind="train")
        with pytest.raises(ValueError, match="training"):
            cells.lm_cache_len(h2o_danube_1_8b.FULL, "train_4k")


class TestCommon:
    def test_rope_rotates_interleaved_pairs_like_the_reference(self):
        rng = np.random.default_rng(11)
        x = rng.standard_normal((2, 3, 10, 16)).astype(np.float32)
        pos = np.arange(10)[None, None, :] + 37
        want = jax_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500.0)
        got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 500.0)
        _close(got, want, dict(rtol=1e-5, atol=1e-5))
        cos, sin = common.rope_frequencies(16, 12, 500.0)
        jcos, jsin = jax_common.rope_frequencies(16, 12, 500.0)
        _close(cos, jcos, dict(rtol=1e-5, atol=1e-6))
        _close(sin, jsin, dict(rtol=1e-5, atol=1e-6))

    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_rms_norm_and_swiglu(self, dtype):
        jdt, tdt, tol = {"f32": (jnp.float32, torch.float32, F32_TOL),
                         "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}[dtype]
        rng = np.random.default_rng(12)
        x, g = rng.standard_normal((3, 5, 32)), rng.random(32) + 0.5
        wg, wu, wd = (rng.standard_normal(s) / 6 for s in ((32, 48), (32, 48), (48, 32)))
        j = lambda a: jnp.asarray(a, jdt)  # noqa: E731
        t = lambda a: torch.from_numpy(a.astype(np.float32)).to(tdt)  # noqa: E731
        _close(common.rms_norm(t(x), t(g)), jax_common.rms_norm(j(x), j(g)), tol)
        _close(common.swiglu(t(x), t(wg), t(wu), t(wd)), jax_common.swiglu(j(x), j(wg), j(wu), j(wd)),
               tol)

    @pytest.mark.parametrize("window", [None, 3])
    def test_causal_mask(self, window):
        np.testing.assert_array_equal(
            common.causal_mask(5, 9, q_offset=4, window=window).numpy(),
            np.asarray(jax_common.causal_mask(5, 9, q_offset=4, window=window)))
