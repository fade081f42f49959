"""The MoE and MLA transformers on the card (marker ``gpu``; skipped
without one).

Run on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_lm_gpu.py

The REDUCED ``granite-moe-3b-a800m`` / ``moonshot-v1-16b-a3b`` (with
padded and shared experts and small dispatch groups) and
``minicpm3-4b`` (absorbed and naive MLA) on the card, GQA attention
through B6, against the same weights on the CPU (B6's plain version) at
f32 ``rtol=2e-4, atol=5e-4``; the MoE dispatch by index against the
one-hot einsums on the card.  The CPU tests hold the CPU route to
``repro`` (``test_torch_moe.py``, ``test_torch_mla.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import granite_moe_3b_a800m, minicpm3_4b, moonshot_v1_16b_a3b
from repro_torch.models import transformer as pt

pytestmark = pytest.mark.gpu

F32_TOL = dict(rtol=2e-4, atol=5e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
B, L, S = 2, 40, 48


def _moe(cfg, **kw):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **kw))


CONFIGS = {
    "granite": granite_moe_3b_a800m.REDUCED,
    "moonshot": moonshot_v1_16b_a3b.REDUCED,
    "padded": _moe(granite_moe_3b_a800m.REDUCED, num_experts=6, pad_experts_to=8),
    "shared": _moe(moonshot_v1_16b_a3b.REDUCED, n_shared=1),
    "grouped": _moe(granite_moe_3b_a800m.REDUCED, group_size=16, capacity_factor=1.0),
    "mla absorbed": minicpm3_4b.REDUCED,
    "mla naive": dataclasses.replace(minicpm3_4b.REDUCED, mla_absorbed=False),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: B6 has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **tol)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_serving_on_the_card_matches_the_cpu(dev, name):
    cfg = CONFIGS[name]
    host = pt.Transformer(cfg, generator=torch.Generator().manual_seed(6), device="cpu")
    card = pt.Transformer(cfg, device=dev)
    card.load_state_dict(host.state_dict())
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (B, L + 2))
    out = {}
    for m in (host, card):
        caches = pt.init_cache(cfg, B, S, device=m.device)
        logits = [m.prefill(toks[:, :L], caches)[0]]
        logits += [m.decode_step(caches, toks[:, p:p + 1], p)[0] for p in (L, L + 1)]
        out[m.device.type] = (torch.stack(logits), caches)
    _close(out["cuda"][0], out["cpu"][0])
    _close(out["cuda"][1], out["cpu"][1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_index_dispatch_is_the_one_hot_einsums_on_the_card(dev, dtype):
    cfg = dataclasses.replace(CONFIGS["grouped"], dtype=dtype)
    model = pt.Transformer(cfg, generator=torch.Generator(device=dev).manual_seed(8), device=dev)
    lp = model.layers[0]
    x = torch.randn((4, 64, cfg.d_model), generator=torch.Generator(device=dev).manual_seed(9),
                    device=dev).to(dtype)
    xt = pt._group(cfg, x)
    route = pt._route(cfg, lp, xt)
    _close(pt._dispatch_index(cfg, lp, xt, route), pt._dispatch_plain(cfg, lp, xt, route),
           F32_TOL if dtype == torch.float32 else BF16_TOL)
