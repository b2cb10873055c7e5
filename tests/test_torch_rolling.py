"""The port's ring-cache rolling generate against the JAX package's
(``kubetpu/jobs/decode.py:409-530``, oracle ``tests/test_decode.py:218-263``):
token-exact against ``make_generate`` on the same windowed config across
several wraps of the ring, from prompts shorter and longer than the window;
equal to the reference's ``make_rolling_generate`` on trained weights, bf16
and int8 weights; the window required; the ring's bytes O(window)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubetpu.jobs import decode as jdecode
from kubetpu.jobs import quant as jquant
from kubetpu_torch.jobs import decode as tdecode
from kubetpu_torch.jobs import model as tmodel
from kubetpu_torch.jobs import quant as tquant
from kubetpu_torch.jobs.convert import params_from_numpy

torch.set_num_threads(1)

CFG = tmodel.ModelConfig(vocab=64, d_model=32, n_layers=2, n_heads=4,
                         d_ff=64, window=5)


def _model(cfg=CFG, seed=0):
    return tmodel.init_params(torch.Generator().manual_seed(seed), cfg,
                              device="cpu")


@pytest.mark.parametrize("prompt", [[1, 2, 3], [1, 2, 3, 4, 5, 6, 7, 8]],
                         ids=["shorter_than_window", "longer_than_window"])
@pytest.mark.parametrize("over", [{}, {"n_kv_heads": 2}], ids=["mha", "gqa"])
def test_rolling_generate_token_exact_vs_dense_cache(prompt, over):
    cfg = dataclasses.replace(CFG, **over)
    model = _model(cfg)
    p = torch.tensor([prompt])
    want = tdecode.make_generate(cfg)(model, p, 0, 20)
    got = tdecode.make_rolling_generate(cfg)(model, p, 0, 20)
    assert torch.equal(got, want)


def test_rolling_generate_requires_window():
    with pytest.raises(ValueError, match="window"):
        tdecode.make_rolling_generate(dataclasses.replace(CFG, window=0))


def test_rolling_generate_with_int8_params():
    model = _model()
    qmodel = tquant.quantize_params(model)
    out = tdecode.make_rolling_generate(CFG)(qmodel, torch.tensor([[1, 2, 3]]),
                                             0, 12)
    assert out.shape == (1, 15) and int(out.max()) < CFG.vocab
    # the ring path on int8 weights is the dense path on the same weights
    want = tdecode.make_generate(CFG)(qmodel, torch.tensor([[1, 2, 3]]), 0,
                                      12)
    assert torch.equal(out, want)


def test_rolling_generate_sampled_is_seeded():
    model = _model()
    gen = tdecode.make_rolling_generate(CFG, temperature=0.9, top_k=8,
                                        top_p=0.95)
    p = torch.tensor([[3, 14, 15]])
    a, b, c = gen(model, p, 7, 16), gen(model, p, 7, 16), gen(model, p, 8, 16)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < CFG.vocab


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_rolling_generate_equals_the_reference(trained_small, quantized):
    """On trained weights at window 8 (the ring wraps several times), the
    port's rolling generate gives the reference's tokens, through full or
    int8 weights."""
    jcfg, params, data = trained_small
    wcfg = dataclasses.replace(jcfg, window=8)
    if quantized:
        params = jquant.quantize_params(params)
    cfg = tmodel.ModelConfig(vocab=wcfg.vocab, d_model=wcfg.d_model,
                             n_layers=wcfg.n_layers, n_heads=wcfg.n_heads,
                             d_ff=wcfg.d_ff, max_seq=wcfg.max_seq, window=8)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    prompt = np.asarray(data[0][0][:2, :12]).astype(np.int64)
    want = jdecode.make_rolling_generate(wcfg)(params, jnp.asarray(prompt),
                                               jax.random.PRNGKey(0), 24)
    got = tdecode.make_rolling_generate(cfg)(model, torch.from_numpy(prompt),
                                             0, 24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ring_cache_io_writes_one_slot_and_masks_unwritten():
    """A ring of W slots: a write at pos lands in slot pos % W, and the
    read sees exactly the slots whose position was written."""
    w, first = 4, 2
    k = torch.zeros(1, w, 1, 2)
    v = torch.zeros(1, w, 1, 2)
    io = tdecode._ring_cache_io(w, first)
    q = torch.ones(1, 1, 1, 2)
    new = torch.full((1, 1, 1, 2), 3.0)
    attn, _ = io(q, new, new, (k, v), 5)
    assert torch.equal(k[0, 1], new[0, 0])          # 5 % 4 == 1
    assert float(k[0, [0, 2, 3]].abs().sum()) == 0.0
    # slots 2, 3, 0 hold positions 2, 3, 4 (>= first): visible, all zero
    # here; slot 1 holds 5: the output is the softmax mix of 0s and 3s
    s = torch.tensor([0.0, 6.0, 0.0, 0.0]) * 2 ** -0.5
    want = (torch.softmax(s, 0)[1] * 3.0).item()
    assert abs(attn[0, 0, 0, 0].item() - want) < 1e-6
    jout = jdecode._attend_ring(jnp.ones((1, 1, 1, 2)),
                                jnp.asarray(k.numpy()),
                                jnp.asarray(v.numpy()), 5, w, first)
    np.testing.assert_allclose(attn.numpy(), np.asarray(jout), atol=1e-6)
    # position 1 (< first) would sit in slot 1 of an earlier lap: invisible
    vis = tdecode._attend_ring(q, k, v, 3, w, first)
    jvis = jdecode._attend_ring(jnp.ones((1, 1, 1, 2)),
                                jnp.asarray(k.numpy()),
                                jnp.asarray(v.numpy()), 3, w, first)
    np.testing.assert_allclose(vis.numpy(), np.asarray(jvis), atol=1e-6)


def test_the_ring_holds_window_slots_not_the_sequence():
    cfg = dataclasses.replace(CFG, n_kv_heads=2)

    def nbytes(cache):
        return sum(t.numel() * t.element_size() for t in cache)

    ring = tdecode.init_ring_cache(cfg, 2, device="cpu")
    assert tuple(ring[0].shape) == (2, 2, cfg.window, 2, 8)
    dense = tdecode.init_kv_cache(cfg, 2, 512, device="cpu")
    assert nbytes(ring) * 512 == nbytes(dense) * cfg.window
