"""The port's model, KV quantization and sampling filters against the JAX
package on identical inputs: logits through ``params_from_numpy``,
byte-equal int8 KV entries, identical filter masks."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _cfg
from kubetpu.jobs import model as jmodel
from kubetpu.jobs import quant as jquant
from kubetpu.jobs import sampling as jsampling
from kubetpu_torch.jobs import model as tmodel
from kubetpu_torch.jobs import quant as tquant
from kubetpu_torch.jobs import sampling as tsampling
from kubetpu_torch.jobs.convert import params_from_numpy

torch.set_num_threads(1)


def port_cfg(jcfg, **over):
    """The port's ModelConfig with the JAX config's fields (f32)."""
    fields = {f: getattr(jcfg, f) for f in (
        "vocab", "d_model", "n_layers", "n_heads", "d_ff", "max_seq",
        "rope_theta", "window", "rope_llama3_scaling", "n_kv_heads")}
    fields.update(over)
    return tmodel.ModelConfig(**fields)


@pytest.mark.parametrize("variant", [
    {},
    {"n_kv_heads": 2},
    {"window": 8},
    {"rope_llama3_scaling": (8.0, 1.0, 4.0, 32)},
], ids=["mha", "gqa", "window", "llama3_rope"])
def test_forward_logits_match_jax(variant):
    """f32 logits of the port equal the JAX forward within 1e-4 (the
    frameworks sum in different orders) on the tiny entry config."""
    jcfg = dataclasses.replace(_cfg(), **variant)
    params = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 24))
    ref = np.asarray(jmodel.forward(params, jnp.asarray(tokens), jcfg))
    cfg = port_cfg(jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    out = tmodel.forward(model, torch.from_numpy(tokens), cfg).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_params_from_numpy_rejects_a_mismatched_tree():
    jcfg = _cfg()
    tree = jax.tree.map(np.asarray,
                        jmodel.init_params(jax.random.PRNGKey(0), jcfg))
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(tree, port_cfg(jcfg, d_ff=64), device="cpu")
    with pytest.raises(NotImplementedError):
        port_cfg(jcfg, n_experts=2)


def test_init_params_shapes_and_scales():
    cfg = port_cfg(_cfg(), n_kv_heads=2)
    model = tmodel.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    blk = model.blocks[0]
    assert tuple(blk.wq.shape) == (64, 4, 16)
    assert tuple(blk.wk.shape) == (64, 2, 16)
    assert tuple(blk.wo.shape) == (4, 16, 64)
    assert torch.all(blk.ln1 == 1) and torch.all(model.ln_f == 1)
    # normal draws times d**-0.5 (0.125): the std lands near the scale
    assert abs(float(blk.w_up.std()) - 64 ** -0.5) < 0.02
    assert abs(float(blk.w_down.std()) - 128 ** -0.5) < 0.02
    again = tmodel.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    assert torch.equal(again.embed, model.embed)


def test_quantize_kv_chunk_is_byte_equal_to_jax():
    x = np.random.default_rng(0).standard_normal((3, 5, 2, 16))
    x = x.astype(np.float32)
    x[0, 0, 0] = 0.0                                   # zero vector
    x[1, 1, 1, :5] = [127.0, 0.5, 1.5, 2.5, -0.5]      # exact halves
    x[1, 1, 1, 5:] = 0.0
    j8, js = jquant.quantize_kv_chunk(jnp.asarray(x))
    t8, ts = tquant.quantize_kv_chunk(torch.from_numpy(x))
    assert t8.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(t8.numpy(), np.asarray(j8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert list(t8[1, 1, 1, :5]) == [127, 0, 2, 2, 0]


def test_sampling_filters_give_the_jax_masks():
    logits = np.random.default_rng(2).standard_normal((4, 3, 50))
    logits = logits.astype(np.float32)
    k = np.array([[0, 1, 5], [50, 7, 2], [3, 0, 60], [10, 10, 1]], np.int32)
    p = np.array([[1.0, 0.5, 0.9], [0.1, 1.0, 0.99], [0.3, 0.7, 1.0],
                  [0.05, 0.6, 0.8]], np.float32)
    jk = np.asarray(jsampling.apply_top_k_rows(jnp.asarray(logits),
                                               jnp.asarray(k)))
    tk = tsampling.apply_top_k_rows(torch.from_numpy(logits),
                                    torch.from_numpy(k)).numpy()
    np.testing.assert_array_equal(tk <= -1e29, jk <= -1e29)
    np.testing.assert_array_equal(tk, jk)
    jp = np.asarray(jsampling.apply_top_p_rows(jnp.asarray(logits),
                                               jnp.asarray(p)))
    tp = tsampling.apply_top_p_rows(torch.from_numpy(logits),
                                    torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(tp <= -1e29, jp <= -1e29)
    tok = logits.argmax(-1)
    np.testing.assert_allclose(
        tsampling.chosen_logprob(torch.from_numpy(logits),
                                 torch.from_numpy(tok)).numpy(),
        np.asarray(jsampling.chosen_logprob(jnp.asarray(logits),
                                            jnp.asarray(tok))),
        atol=1e-6)


def test_slot_sampler_greedy_rows_and_seeded_draws():
    """Greedy rows are the argmax; a stochastic row's draw depends only on
    its seed and its settings, never on the other rows."""
    sample = tsampling.make_slot_sampler()
    logits = torch.from_numpy(
        np.random.default_rng(3).standard_normal((3, 40)).astype(np.float32))
    greedy = sample(logits, np.zeros(3), np.zeros(3), np.ones(3), [0, 0, 0])
    assert torch.equal(greedy, logits.argmax(-1))
    temp = np.array([0.0, 1.0, 0.8], np.float32)
    topk = np.array([0, 5, 0])
    topp = np.array([1.0, 1.0, 0.9], np.float32)
    seeds = [tsampling.row_seed(7, r, 11) for r in range(3)]
    a = sample(logits, temp, topk, topp, seeds)
    assert int(a[0]) == int(logits[0].argmax())
    b = sample(logits[1:], temp[1:], topk[1:], topp[1:], seeds[1:])
    assert torch.equal(a[1:], b)
    # row 1 draws inside its top-5
    assert int(a[1]) in set(torch.topk(logits[1], 5).indices.tolist())
