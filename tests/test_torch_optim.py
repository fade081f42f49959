"""The port's optimizers and schedules vs ``repro.optim``, on the CPU.

``adamw`` and ``sgd_momentum`` take 3 updates from the same parameters
fed identical gradients (made with numpy from a seed), on f32 and bf16
leaves of a nested tree; after each update the parameters and the f32
moments must agree at f32 ``rtol=1e-4, atol=1e-5`` (bf16 parameters at
``2e-2``, one rounding of the same f32 update), and the step count
exactly.  ``clip_by_global_norm`` and every schedule at steps 0..N are
held to the reference at the f32 tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jax_optim
from repro_torch import optim

F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _tree(rng, dtype):
    return {
        "w": [rng.normal(0, 1, (5, 3)), rng.normal(0, 1, (3,))],
        "emb": rng.normal(0, 1, (7, 4)),
        "scalar": rng.normal(0, 1, ()),
    }


def _jax(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float32), dtype), tree)


def _torch(tree, dtype):
    return optim.tree_map(lambda a: torch.tensor(np.asarray(a, np.float32)).to(dtype), tree)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(mine, ref, tol):
    a, b = optim.tree_leaves(mine), jax.tree.leaves(ref)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(_np(x), _np(y), **tol)


OPTIMIZERS = {
    "adamw": (lambda m: m.adamw(m.linear_warmup_cosine(1e-2, 2, 10), weight_decay=0.1)),
    "adamw_const": (lambda m: m.adamw(3e-3, b1=0.8, b2=0.9, eps=1e-6, weight_decay=0.0)),
    "sgd": (lambda m: m.sgd_momentum(m.cosine_decay(0.1, 5), weight_decay=0.01)),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_three_updates_match_the_reference(name, dtype):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    rng = np.random.default_rng(0)
    base = _tree(rng, dtype)
    jp, tp = _jax(base, jdt), _torch(base, tdt)
    jopt, topt = OPTIMIZERS[name](jax_optim), OPTIMIZERS[name](optim)
    js, ts = jopt.init(jp), topt.init(tp)
    assert ts.step.dtype == torch.int32 and int(ts.step) == 0
    for leaf in optim.tree_leaves(ts.mu):
        assert leaf.dtype == torch.float32
    ptol = F32_TOL if dtype == "f32" else BF16_TOL
    for _ in range(3):
        g = _tree(rng, dtype)
        jp, js = jopt.update(_jax(g, jdt), js, jp)
        tp, ts = topt.update(_torch(g, tdt), ts, tp)
        assert int(ts.step) == int(js.step)
        for leaf in optim.tree_leaves(tp):
            assert leaf.dtype == tdt  # the update is cast back
        _close(tp, jp, ptol)
        _close(ts.mu, js.mu, F32_TOL)
        if js.nu is None:
            assert ts.nu is None
        else:
            _close(ts.nu, js.nu, F32_TOL)


def test_update_is_in_place_on_the_parameter_tree():
    p = {"a": torch.ones(3), "b": [torch.ones(2, dtype=torch.bfloat16)]}
    ids = [t.data_ptr() for t in optim.tree_leaves(p)]
    opt = optim.adamw(0.1)
    s = opt.init(p)
    q, s2 = opt.update({"a": torch.ones(3), "b": [torch.ones(2)]}, s, p)
    assert q is p and [t.data_ptr() for t in optim.tree_leaves(q)] == ids
    assert int(s.step) == 0 and int(s2.step) == 1  # a new step, the old state's untouched
    assert not torch.equal(p["a"], torch.ones(3))


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_the_reference(max_norm):
    g = _tree(np.random.default_rng(3), "f32")
    jg, jn = jax_optim.clip_by_global_norm(_jax(g, jnp.float32), max_norm)
    tg, tn = optim.clip_by_global_norm(_torch(g, torch.float32), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), **F32_TOL)
    _close(tg, jg, F32_TOL)


SCHEDULES = {
    "constant": lambda m: m.constant(0.3),
    "cosine_decay": lambda m: m.cosine_decay(1e-2, 7, floor=1e-4),
    "linear_warmup_cosine": lambda m: m.linear_warmup_cosine(3e-4, 3, 9, floor=1e-5),
    "warmup_zero": lambda m: m.linear_warmup_cosine(1.0, 0, 1),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_the_reference(name):
    jfn, tfn = SCHEDULES[name](jax_optim), SCHEDULES[name](optim)
    for s in range(12):
        got = tfn(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(jfn(jnp.asarray(s, jnp.int32))), **F32_TOL)
