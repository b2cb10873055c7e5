"""At capacity factor = n_experts the port's capacity dispatch drops no
choice at any N, and equals the reference's dropless mixture."""

from __future__ import annotations

import pytest
import torch

from kubetpu_torch.jobs import model as pm
from portbench import build, inputs
from portbench.reference import model as ref

M = dict(vocab=64, d_model=32, n_layers=1, n_heads=2, n_kv_heads=1,
         head_dim=16, d_ff=48, max_seq=64, rope_theta=1e4,
         rms_norm_eps=1e-6, dtype="float32", n_experts=8, moe_top_k=2,
         moe_capacity_factor=8.0, moe_renormalize=False)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 33, 64])
def test_capacity_dispatch_is_dropless(n):
    w = inputs.make_weights(M, 100 + n, "cpu", torch.float32)
    layer = build.transformer(build.model_config(M), w).blocks[0]
    h = torch.randn(1, n, M["d_model"],
                    generator=torch.Generator().manual_seed(n))
    out, _ = pm._moe_mlp_capacity(h, layer, 8.0, 2)
    blk = ref.layer_weights(w, 0)
    want = ref.moe(h[0], blk, 2, False, ref._Mm("f32"))
    torch.testing.assert_close(out[0], want, rtol=1e-5, atol=1e-5)
    # capacity int(8 * n / 8) = n slots an expert: every choice fits
    probs = torch.softmax(h[0] @ layer.moe_router, -1)
    _, topi = pm._top_k(probs[None], 2)
    expert = topi.transpose(1, 2).reshape(1, 2 * n)
    assert int(pm._capacity_slots(expert, 8).max()) < max(1, int(8 * n / 8))


def test_a_lower_factor_drops_and_departs():
    n = 64
    w = inputs.make_weights(M, 7, "cpu", torch.float32)
    layer = build.transformer(build.model_config(M), w).blocks[0]
    h = torch.randn(1, n, M["d_model"], generator=torch.Generator()
                    .manual_seed(1))
    out, _ = pm._moe_mlp_capacity(h, layer, 1.0, 2)
    want = ref.moe(h[0], ref.layer_weights(w, 0), 2, False, ref._Mm("f32"))
    assert (out[0] - want).abs().max() > 1e-3


@pytest.mark.parametrize("precision", ["f32", "fp8"])
def test_reference_forward_matches_the_port_at_f32(precision):
    w = inputs.make_weights(M, 3, "cpu", torch.float32)
    model = build.transformer(build.model_config(M), w)
    toks = torch.tensor(inputs.tokens(3, "t", 40, M["vocab"]))
    lp = pm.forward(model, toks[None], build.model_config(M))[0]
    lr = ref.logits(w, M, toks, torch.arange(40), precision)
    gap = float((lp - lr).abs().max())
    if precision == "f32":
        assert gap < 1e-4
    else:
        assert gap > 1e-3      # the control is a different computation
