"""The port's mixture-of-experts FFN vs the JAX reference, on the CPU.

``granite-moe-3b-a800m`` and ``moonshot-v1-16b-a3b`` at their REDUCED
configs (and variants: experts padded, a shared expert, dispatch groups
smaller than the batch), with ``repro``'s ``init_params(cfg,
PRNGKey(0))`` carried across by ``load_transformer`` and prompts drawn
with numpy.  Prefill and decode logits and the KV caches must agree at
f32 ``rtol=2e-4, atol=5e-4`` (bf16 ``2e-2``), the tolerances of
``tests/test_kernels.py::_tol``, on both attention routes.  The routing
(``_route``) must equal the reference's intermediates, which are read
from its ``jax.lax.top_k`` and ``jax.nn.one_hot`` calls, ties included;
the index dispatch must equal the one-hot einsum version.  On the card
the same comparisons run in ``chip_smoke.py`` phase 17.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import granite_moe_3b_a800m as jax_granite
from repro.configs import moonshot_v1_16b_a3b as jax_moonshot
from repro.models import transformer as jt
from repro_torch.models import transformer as pt
from repro_torch.models.convert import load_transformer

F32_TOL = dict(rtol=2e-4, atol=5e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
B, L, S = 2, 40, 48


def _port_config(cfg: jt.TransformerConfig) -> pt.TransformerConfig:
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if cfg.moe is not None:
        fields["moe"] = pt.MoEConfig(**dataclasses.asdict(cfg.moe))
    if cfg.mla is not None:
        fields["mla"] = pt.MLAConfig(**dataclasses.asdict(cfg.mla))
    fields["dtype"] = torch.bfloat16 if cfg.dtype == jnp.bfloat16 else torch.float32
    return pt.TransformerConfig(**fields)


def _moe(cfg, **kw):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **kw))


JAX_CONFIGS = {
    "granite": jax_granite.REDUCED,  # GQA 4/2, 8 experts top-2, one group
    "moonshot": jax_moonshot.REDUCED,  # MHA, head dim 16, 8 experts top-2
    "padded": _moe(jax_granite.REDUCED, num_experts=6, pad_experts_to=8),
    "shared": _moe(jax_moonshot.REDUCED, n_shared=1),
    "grouped": _moe(jax_granite.REDUCED, group_size=16, capacity_factor=1.0),
}


def _configs(name, dtype=None):
    jcfg = JAX_CONFIGS[name]
    if dtype is not None:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
    return jcfg, _port_config(jcfg)


def _setup(jcfg, pcfg, *, use_kernel=True, key=0):
    params = jt.init_params(jcfg, jax.random.PRNGKey(key))
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


def _decode_run(jcfg, pcfg, steps, *, use_kernel=True, tol=F32_TOL, jit=True):
    params, model = _setup(jcfg, pcfg, use_kernel=use_kernel)
    toks = _tokens(jcfg, (B, L), 8)
    prefill = jt.make_prefill(jcfg)
    dec = jt.make_decode_step(jcfg)
    if jit:
        prefill, dec = jax.jit(prefill), jax.jit(dec)
    jl, jc = prefill(params, jnp.asarray(toks), jt.init_cache(jcfg, B, S))
    caches = pt.init_cache(pcfg, B, S, device="cpu")
    pl, pc = pt.make_prefill(model)(torch.from_numpy(toks), caches)
    assert pc is caches and pl.shape == (B, pcfg.padded_vocab) and pc.shape == jc.shape
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
    @pytest.mark.parametrize("name", list(JAX_CONFIGS))
    def test_prefill_then_three_steps_match_the_reference(self, name, use_kernel):
        _decode_run(*_configs(name), [L, L + 1, L + 2], use_kernel=use_kernel)

    @pytest.mark.parametrize("name", ["granite", "moonshot"])
    def test_bf16(self, name):
        """The reference op by op, as ``test_torch_transformer``'s
        ``TestDecode::test_bf16`` runs it (compiled, XLA may skip the bf16
        rounding between fused ops)."""
        with jax.disable_jit():
            _decode_run(*_configs(name, jnp.bfloat16), [L, L + 1], tol=BF16_TOL, jit=False)

    @pytest.mark.parametrize("name", ["granite", "shared"])
    def test_forward_and_hidden_states_without_cache(self, name):
        jcfg, pcfg = _configs(name)
        params, model = _setup(jcfg, pcfg)
        toks = _tokens(jcfg, (B, 24), 3)
        jl, _ = jt.forward(jcfg, params, jnp.asarray(toks))
        pl, caches = model(torch.from_numpy(toks))
        assert caches is None and pl.shape == (B, 24, pcfg.padded_vocab)
        _close(pl, jl)
        _close(model.hidden_states(toks), jt.hidden_states(jcfg, params, jnp.asarray(toks)))

    def test_kernel_route_takes_b6_once_per_layer(self, monkeypatch):
        calls = []
        real = pt.gqa_attention_op
        monkeypatch.setattr(pt, "gqa_attention_op", lambda *a, **kw: calls.append(kw)
                            or real(*a, **kw))
        _, pcfg = _configs("granite")
        model = pt.Transformer(pcfg, device="cpu")
        caches = pt.init_cache(pcfg, B, S, device="cpu")
        model.prefill(_tokens(pcfg, (B, L), 5), caches)
        model.decode_step(caches, _tokens(pcfg, (B, 1), 6), L)
        assert len(calls) == 2 * pcfg.n_layers
        assert calls[-1] == dict(causal=True, window=None, q_offset=L, layout="blhd")


def _layer_input(jcfg, seed, b, l):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, l, jcfg.d_model)).astype(np.float32)


def _reference_routing(monkeypatch, jcfg, params, x):
    """Run the reference's ``_moe_ffn`` on layer 0 op by op and read its
    routing from the calls it makes: ``top_k`` gives the chosen
    probabilities and experts, the ``one_hot`` into ``cap`` classes the
    positions."""
    seen = {"one_hot": []}
    top_k, one_hot = jax.lax.top_k, jax.nn.one_hot

    def rec_top_k(a, k):
        out = top_k(a, k)
        seen["top_k"] = [np.asarray(o) for o in out]
        return out

    def rec_one_hot(a, n, **kw):
        seen["one_hot"].append((np.asarray(a), n))
        return one_hot(a, n, **kw)

    monkeypatch.setattr(jax.lax, "top_k", rec_top_k)
    monkeypatch.setattr(jax.nn, "one_hot", rec_one_hot)
    lp = jax.tree.map(lambda a: a[0], params["layers"])
    with jax.disable_jit():
        out = jt._moe_ffn(jcfg, lp, jnp.asarray(x, jcfg.dtype))
    vals, idx = seen["top_k"]
    pos, cap = seen["one_hot"][-1]
    gates = vals / np.maximum(vals.sum(-1, keepdims=True), 1e-9)
    return dict(gate_vals=gates, gate_idx=idx, pos=pos, keep=pos < cap, cap=cap), out


class TestRouting:
    @pytest.mark.parametrize(
        "b,l,group",
        [
            (2, 40, 1024),  # one group of t = 80 < group_size
            (2, 40, 16),  # five groups
            (4, 20, 80),  # one group of exactly group_size
            (1, 1, 256),  # a decode step of one token
            (4, 1, 2),  # decode, two groups
        ],
    )
    @pytest.mark.parametrize("name", ["granite", "padded"])
    def test_route_is_the_reference(self, monkeypatch, name, b, l, group):
        jcfg, pcfg = (_moe(c, group_size=group) for c in _configs(name))
        params, model = _setup(jcfg, pcfg)
        x = _layer_input(jcfg, 21, b, l)
        want, out = _reference_routing(monkeypatch, jcfg, params, x)
        lp = model.layers[0]
        xt = pt._group(pcfg, torch.from_numpy(x))
        route = pt._route(pcfg, lp, xt)
        assert route.cap == want["cap"] == max(1, int(
            jcfg.moe.capacity_factor * min(group, b * l) * jcfg.moe.top_k
            / jcfg.moe.num_experts))
        for key in ("gate_idx", "pos", "keep"):
            np.testing.assert_array_equal(getattr(route, key).numpy(), want[key])
        _close(route.gate_vals, want["gate_vals"], dict(rtol=1e-5, atol=1e-6))
        assert int(route.gate_idx.max()) < pcfg.moe.num_experts  # no padded expert
        _close(pt._moe_ffn(pcfg, lp, torch.from_numpy(x)), out)

    def test_groups_must_divide_the_tokens(self):
        jcfg, pcfg = (_moe(c, group_size=32) for c in _configs("granite"))
        x = _layer_input(jcfg, 22, B, L)  # 80 tokens
        with pytest.raises(ValueError, match="not divisible by group 32"):
            pt._group(pcfg, torch.from_numpy(x))
        params = jt.init_params(jcfg, jax.random.PRNGKey(0))
        with pytest.raises(AssertionError, match="not divisible by group 32"):
            jt._moe_ffn(jcfg, jax.tree.map(lambda a: a[0], params["layers"]), jnp.asarray(x))

    def test_top_k_breaks_ties_by_index_like_lax_top_k(self):
        probs = np.random.default_rng(23).integers(0, 4, (64, 16)).astype(np.float32)
        for k in (1, 3, 8):
            jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
            tv, ti = pt._top_k(torch.from_numpy(probs), k)
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))

    @pytest.mark.parametrize("top_k", [1, 2])
    def test_tied_router_columns_route_like_the_reference(self, monkeypatch, top_k):
        """Experts 3 and 5 get equal router columns, so every token's two
        probabilities tie; where the tie straddles the top-k boundary the
        lower index is chosen, and the queue positions follow."""
        jcfg, pcfg = (_moe(c, top_k=top_k, group_size=16) for c in _configs("granite"))
        params = jax.tree.map(np.asarray, jt.init_params(jcfg, jax.random.PRNGKey(0)))
        router = params["layers"]["router"].copy()
        router[:, :, 5] = router[:, :, 3] = 3.0 * router[:, :, 3]  # often the largest
        params["layers"]["router"] = router
        model = pt.Transformer(pcfg, device="cpu")
        load_transformer(model, params)
        x = _layer_input(jcfg, 24, B, L)
        want, _ = _reference_routing(monkeypatch, jcfg, jax.tree.map(jnp.asarray, params), x)
        route = pt._route(pcfg, model.layers[0], pt._group(pcfg, torch.from_numpy(x)))
        chosen = route.gate_idx.numpy()
        straddle = (chosen == 3).any(-1) & ~(chosen == 5).any(-1)
        assert straddle.sum() > 0 and not ((chosen == 5) & ~(chosen == 3).any(-1,
                                                                        keepdims=True)).any()
        np.testing.assert_array_equal(chosen, want["gate_idx"])
        np.testing.assert_array_equal(route.pos.numpy(), want["pos"])

    def test_capacity_drops_the_later_choices(self):
        """One group, capacity 1.0: each expert keeps its first ``cap``
        choices in (t, k) order and drops the rest; a (g, e, c) slot holds
        at most one token."""
        jcfg, pcfg = (_moe(c, group_size=80, capacity_factor=1.0) for c in _configs("granite"))
        _, model = _setup(jcfg, pcfg)
        xt = pt._group(pcfg, torch.from_numpy(_layer_input(jcfg, 25, B, L)))
        r = pt._route(pcfg, model.layers[0], xt)
        assert r.cap == 20 and not r.keep.all()
        idx, pos = r.gate_idx.reshape(-1), r.pos.reshape(-1)
        for e in range(pcfg.moe.num_experts):
            np.testing.assert_array_equal(pos[idx == e].numpy(),
                                          np.arange(int((idx == e).sum())))
        kept = idx[r.keep.reshape(-1)] * r.cap + pos[r.keep.reshape(-1)]
        assert kept.unique().numel() == kept.numel()


class TestDispatch:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("name", ["granite", "padded", "shared", "grouped"])
    def test_index_dispatch_is_the_one_hot_einsums(self, name, dtype):
        _, pcfg = _configs(name)
        pcfg = dataclasses.replace(pcfg, dtype=dtype)
        model = pt.Transformer(pcfg, generator=torch.Generator().manual_seed(4), device="cpu")
        lp = model.layers[1]
        x = torch.from_numpy(_layer_input(pcfg, 26, B, L)).to(dtype)
        xt = pt._group(pcfg, x)
        route = pt._route(pcfg, lp, xt)
        got = pt._dispatch_index(pcfg, lp, xt, route)
        want = pt._dispatch_plain(pcfg, lp, xt, route)
        _close(got, want, F32_TOL if dtype == torch.float32 else BF16_TOL)

    def test_plain_dispatch_is_the_reference(self):
        jcfg, pcfg = _configs("grouped")
        params, model = _setup(jcfg, pcfg)
        x = _layer_input(jcfg, 27, B, L)
        want = jt._moe_ffn(jcfg, jax.tree.map(lambda a: a[1], params["layers"]), jnp.asarray(x))
        xt = pt._group(pcfg, torch.from_numpy(x))  # "grouped" has no shared expert
        lp = model.layers[1]
        got = pt._dispatch_plain(pcfg, lp, xt, pt._route(pcfg, lp, xt))
        _close(got.reshape(want.shape), want)


class TestExpertPadding:
    def test_padded_experts_bitwise_identical(self):
        """The port's counterpart of ``test_arch_smoke.py::TestExpertPadding``:
        dead padded experts change neither routing nor outputs."""
        cfg0 = pt.TransformerConfig(
            name="m", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=0, vocab=128,
            dtype=torch.float32,
            moe=pt.MoEConfig(num_experts=5, top_k=2, d_ff_expert=32, group_size=8),
        )
        cfgp = dataclasses.replace(cfg0, moe=dataclasses.replace(cfg0.moe, pad_experts_to=8))
        mp = pt.Transformer(cfgp, generator=torch.Generator().manual_seed(0), device="cpu")
        m0 = pt.Transformer(cfg0, generator=torch.Generator().manual_seed(1), device="cpu")
        with torch.no_grad():
            for name in ("embed", "lm_head", "final_norm"):
                getattr(m0, name).copy_(getattr(mp, name))
            for l0, lpad in zip(m0.layers, mp.layers):
                for name, p in l0.named_parameters():
                    src = getattr(lpad, name)
                    if name == "router":
                        src = src[:, :5]
                    elif name in ("w_gate", "w_up", "w_down"):
                        src = src[:5]
                    p.copy_(src)
        toks = np.random.default_rng(0).integers(0, 128, (2, 16))
        l0, _ = m0(toks)
        lpad, _ = mp(toks)
        assert torch.equal(l0, lpad)
        assert mp.layers[0].w_gate.shape == (8, 64, 32) and mp.layers[0].w_down.shape == (8, 32, 64)


class TestWeights:
    def test_moe_keys_load_and_a_wrong_expert_count_raises(self):
        jcfg, pcfg = _configs("shared")
        params = jax.tree.map(np.asarray, jt.init_params(jcfg, jax.random.PRNGKey(0)))
        model = load_transformer(pt.Transformer(pcfg, device="cpu"), params)
        np.testing.assert_array_equal(model.layers[1].w_down.numpy(), params["layers"]["w_down"][1])
        np.testing.assert_array_equal(model.layers[0].shared_up.numpy(),
                                      params["layers"]["shared_up"][0])
        fewer = dataclasses.replace(pcfg, moe=dataclasses.replace(pcfg.moe, num_experts=6))
        with pytest.raises(ValueError, match=r"layers\.router\[0\]"):
            load_transformer(pt.Transformer(fewer, device="cpu"), params)
        layers = dict(params["layers"])
        layers.pop("shared_down")
        with pytest.raises(ValueError, match="keys"):
            load_transformer(model, dict(params, layers=layers))

    def test_init_follows_the_reference_layout(self):
        _, pcfg = _configs("shared")
        model = pt.Transformer(pcfg, generator=torch.Generator().manual_seed(5), device="cpu")
        jshapes = jax.eval_shape(lambda: jt.init_params(JAX_CONFIGS["shared"],
                                                        jax.random.PRNGKey(0)))["layers"]
        for name, p in model.layers[0].named_parameters():
            assert (pcfg.n_layers,) + tuple(p.shape) == jshapes[name].shape, name
        w = model.layers[0].w_down  # drawn (E, d, ff) at 1/sqrt(d), stored (E, ff, d)
        assert abs(float(w.std()) * 8.0 - 1.0) < 0.05

