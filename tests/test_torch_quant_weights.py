"""The port's int8 weights against the JAX package's
(``kubetpu/jobs/quant.py``): ``quantize_tensor`` values and scales
byte-equal on 2-D and stacked leaves, ``quantize_params`` and
``param_bytes`` equal leaf for leaf on the port's per-layer blocks, a
quantized JAX tree carried by ``convert``, and greedy tokens through
quantized weights equal to the reference's ``make_generate``,
``DecodeServer`` and ``PagedDecodeServer`` on trained weights; the
counterpart of the reference's int8-KV-with-int8-weights window test pins
what the reference outputs on both cache arms."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubetpu.jobs import decode as jdecode
from kubetpu.jobs import model as jmodel
from kubetpu.jobs import quant as jquant
from kubetpu.jobs.paged import PagedDecodeServer as JaxPagedServer
from kubetpu.jobs.serving import DecodeServer as JaxDecodeServer
from kubetpu_torch.jobs import decode as tdecode
from kubetpu_torch.jobs import model as tmodel
from kubetpu_torch.jobs import quant as tquant
from kubetpu_torch.jobs.convert import params_from_numpy, params_to_numpy
from kubetpu_torch.jobs.lora import LoraConfig, init_lora_params, merge_lora
from kubetpu_torch.jobs.multi_lora import PagedMultiLoraDecodeServer
from kubetpu_torch.jobs.paged import PagedDecodeServer
from kubetpu_torch.jobs.serving import DecodeServer
from kubetpu_torch.jobs.spec_serving import PagedSpeculativeDecodeServer
from kubetpu_torch.jobs.train import (make_eval_step, make_optimizer,
                                      state_from_params)

torch.set_num_threads(1)

CFG = jmodel.ModelConfig(vocab=64, d_model=32, n_layers=2, n_heads=4,
                         d_ff=64)


def port_cfg(jcfg, **over):
    fields = {f: getattr(jcfg, f) for f in (
        "vocab", "d_model", "n_layers", "n_heads", "d_ff", "max_seq",
        "window", "n_kv_heads", "n_experts", "moe_capacity_factor",
        "moe_top_k")}
    fields.update(over)
    return tmodel.ModelConfig(**fields)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _weights(shape, seed=0):
    """Normal draws with an all-zero output channel and exact halves."""
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    w[..., 0] = 0.0
    flat = w.reshape(-1, shape[-1])
    flat[0, 1], flat[1, 1] = 127.0, 0.5      # |max| 127: scale 1, 0.5 -> 0
    return w


@pytest.mark.parametrize("shape", [(64, 32), (2, 16, 24), (2, 16, 4, 8),
                                   (2, 4, 8, 16), (2, 4, 16, 24)],
                         ids=["2d", "L_d_f", "L_d_h_hd", "L_h_hd_d",
                              "L_E_d_f"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_tensor_is_byte_equal_to_the_reference(shape, dtype):
    w = _weights(shape)
    jw = jnp.asarray(w, dtype)
    w = np.array(jw.astype(jnp.float32))     # bf16-representable values
    ref = jquant.quantize_tensor(jw)
    got = tquant.quantize_tensor(
        torch.from_numpy(w).to(getattr(torch, dtype)))
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    assert got.nbytes == ref.nbytes
    # the per-layer rule the port's blocks use gives each layer's slice
    if len(shape) >= 3:
        for i in range(shape[0]):
            one = tquant.quantize_channels(
                torch.from_numpy(w[i]).to(getattr(torch, dtype)))
            np.testing.assert_array_equal(one.q.numpy(),
                                          np.asarray(ref.q)[i])
            np.testing.assert_array_equal(one.scale.numpy(),
                                          np.asarray(ref.scale)[i])
    np.testing.assert_array_equal(
        got.dequantize().float().numpy(),
        np.asarray(ref.dequantize().astype(jnp.float32)))


def test_roundtrip_error_bounded_per_channel():
    w = torch.from_numpy(_weights((64, 32), seed=3))
    qt = tquant.quantize_tensor(w)
    assert torch.all((qt.dequantize() - w).abs() <= qt.scale / 2 + 1e-7)


def test_stacked_weights_get_per_layer_scales():
    w = torch.stack([torch.ones(8, 4) * 0.01, torch.ones(8, 4) * 100.0])
    qt = tquant.quantize_tensor(w)
    assert tuple(qt.scale.shape) == (2, 1, 4)
    back = qt.dequantize()
    np.testing.assert_allclose(back[0].numpy(), 0.01, rtol=1e-2)
    np.testing.assert_allclose(back[1].numpy(), 100.0, rtol=1e-2)


@pytest.mark.parametrize("over", [
    {},
    {"n_kv_heads": 2},
    {"n_experts": 4, "moe_capacity_factor": 1.5, "moe_top_k": 2},
], ids=["dense", "gqa", "moe"])
def test_quantize_params_equals_the_reference_leaf_for_leaf(over):
    jcfg = dataclasses.replace(CFG, dtype=jnp.bfloat16, **over)
    params = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    jq = jquant.quantize_params(params)
    cfg = port_cfg(jcfg, dtype=torch.bfloat16)
    model = params_from_numpy(_np(params), cfg, device="cpu")
    tq = tquant.quantize_params(model)
    assert tquant.param_bytes(tq) == jquant.param_bytes(jq)
    assert tquant.param_bytes(model) == jquant.param_bytes(params)
    assert isinstance(tq.head, tquant.QTensor)
    np.testing.assert_array_equal(tq.head.q.numpy(), np.asarray(jq["head"].q))
    np.testing.assert_array_equal(tq.head.scale.numpy(),
                                  np.asarray(jq["head"].scale))
    for name in ("embed", "ln_f"):       # raw, shared with the model
        assert not isinstance(getattr(tq, name), tquant.QTensor)
        assert getattr(tq, name).data_ptr() == getattr(model, name).data_ptr()
    for name in tmodel.block_leaves(cfg):
        ref = jq["blocks"][name]
        for i, blk in enumerate(tq.blocks):
            leaf = getattr(blk, name)
            if name in ("ln1", "ln2"):
                assert not isinstance(leaf, tquant.QTensor)
                continue
            assert isinstance(ref, jquant.QTensor)
            np.testing.assert_array_equal(leaf.q.numpy(),
                                          np.asarray(ref.q)[i])
            np.testing.assert_array_equal(leaf.scale.numpy(),
                                          np.asarray(ref.scale)[i])
    # the model quantized from is left as it was
    assert not tquant.is_quantized(model)


@pytest.mark.parametrize("over", [{}, {"n_experts": 4}], ids=["dense", "moe"])
def test_convert_carries_a_quantized_jax_tree(over):
    jcfg = dataclasses.replace(CFG, **over)
    params = jmodel.init_params(jax.random.PRNGKey(1), jcfg)
    cfg = port_cfg(jcfg)
    carried = params_from_numpy(_np(jquant.quantize_params(params)), cfg,
                                device="cpu")
    local = tquant.quantize_params(params_from_numpy(_np(params), cfg,
                                                     device="cpu"))
    a, b = carried.state_dict(), local.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k
    assert tquant.param_bytes(carried) == jquant.param_bytes(
        jquant.quantize_params(params))
    # and the whole-model dequantize equals the reference's
    deq = params_to_numpy(tquant.maybe_dequantize(carried))
    jax.tree.map(lambda x, y: np.testing.assert_array_equal(x, np.asarray(y)),
                 deq, jquant.maybe_dequantize(jquant.quantize_params(params)))


def test_maybe_dequantize_is_noop_for_raw_params():
    cfg = port_cfg(CFG)
    model = tmodel.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    assert tquant.maybe_dequantize(model) is model
    assert tquant.maybe_dequantize(model.blocks[0]) is model.blocks[0]
    assert tquant.maybe_dequantize(model.head) is model.head
    layer = tquant.maybe_dequantize(tquant.quantize_params(model).blocks[0])
    assert layer.wq.dtype == cfg.dtype
    assert layer.ln1.data_ptr() == model.blocks[0].ln1.data_ptr()


def test_quantize_params_halves_resident_bytes():
    cfg = port_cfg(CFG, dtype=torch.bfloat16)
    model = tmodel.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    qm = tquant.quantize_params(model)
    assert tquant.param_bytes(qm) < 0.6 * tquant.param_bytes(model)
    assert not isinstance(qm.ln_f, tquant.QTensor)
    assert isinstance(qm.head, tquant.QTensor)


def test_int8_weights_are_refused_where_the_reference_has_no_path():
    cfg = port_cfg(CFG)
    qm = tquant.quantize_params(tmodel.init_params(
        torch.Generator().manual_seed(0), cfg, device="cpu"))
    with pytest.raises(ValueError, match="full-precision"):
        state_from_params(qm, make_optimizer())
    lcfg = LoraConfig(rank=2)
    with pytest.raises(ValueError, match="full-precision"):
        merge_lora(qm, init_lora_params(torch.Generator().manual_seed(1),
                                        cfg, lcfg, device="cpu"), lcfg)
    with pytest.raises(ValueError, match="full-precision"):
        params_to_numpy(qm)
    tokens = np.zeros((1, 8), np.int64)
    with pytest.raises(ValueError, match="full-precision"):
        make_eval_step(cfg, attention="dense", device="cpu")(qm, tokens,
                                                             tokens)


# -- serving through quantized weights, on trained weights ------------------

@pytest.fixture(scope="module")
def quantized(trained_small):
    """(jax cfg, jax quantized params, port cfg, port quantized model
    carried by convert, corpus prompts)."""
    jcfg, params, data = trained_small
    jq = jquant.quantize_params(params)
    cfg = port_cfg(jcfg)
    model = params_from_numpy(_np(jq), cfg, device="cpu")
    rows = np.asarray(data[2][0])
    prompts = [rows[i, :n].tolist() for i, n in enumerate((6, 13, 9, 17))]
    return jcfg, jq, cfg, model, prompts


def _storm(server, prompts):
    rids = [server.enqueue(p) for p in prompts[:2]]
    server.step()
    rids += [server.enqueue(p) for p in prompts[2:]]
    server.drain()
    return [server.result(r) for r in rids]


def test_generate_through_quantized_weights_equals_the_reference(quantized):
    jcfg, jq, cfg, model, prompts = quantized
    prompt = np.asarray([p[:6] for p in prompts], np.int64)
    want = jdecode.make_generate(jcfg)(jq, jnp.asarray(prompt),
                                       jax.random.PRNGKey(0), 16)
    got = tdecode.make_generate(cfg)(model, torch.from_numpy(prompt), 0, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("server", ["dense", "paged", "paged_chunked"])
def test_servers_through_quantized_weights_equal_the_reference(quantized,
                                                               server):
    jcfg, jq, cfg, model, prompts = quantized
    kw = dict(n_slots=2, max_seq=64, max_new_tokens=10)
    if server == "dense":
        ref, port = JaxDecodeServer, DecodeServer
    else:
        ref, port = JaxPagedServer, PagedDecodeServer
        kw.update(page_size=8,
                  prefill_budget=8 if server == "paged_chunked" else 0)
    want = _storm(ref(jcfg, jq, **kw), prompts)
    got = _storm(port(cfg, model, device="cpu", **kw), prompts)
    assert got == want


def test_speculative_and_multi_lora_servers_take_quantized_weights(
        quantized):
    """The reference's speculative and multi-LoRA legs dequantize per layer
    too: greedy speculation over int8 weights (the int8 model as its own
    draft) and the packed server with a zero-delta adapter give the plain
    paged server's tokens."""
    _jcfg, _jq, cfg, model, prompts = quantized
    kw = dict(n_slots=2, max_seq=64, max_new_tokens=10, page_size=8)
    plain = _storm(PagedDecodeServer(cfg, model, device="cpu", **kw),
                   prompts)
    spec = PagedSpeculativeDecodeServer(cfg, cfg, model, model, gamma_max=3,
                                        device="cpu", **kw)
    assert _storm(spec, prompts) == plain
    lcfg = LoraConfig(rank=2)
    adapter = init_lora_params(torch.Generator().manual_seed(2), cfg, lcfg,
                               device="cpu")
    packed = PagedMultiLoraDecodeServer(cfg, model, lcfg, [adapter],
                                        device="cpu", **kw)
    assert _storm(packed, prompts) == plain


def test_kv_int8_with_int8_weights_and_window_pins_the_reference(
        trained_small):
    """The counterpart of the reference's
    ``test_kv_int8_composes_with_int8_weights_and_window``, which fails in
    the JAX package: its int8-cache tokens differ from its bf16-cache
    tokens there. The port is held to what the reference outputs on each
    cache arm (window 8, int8 weights, trained weights)."""
    jcfg, params, data = trained_small
    wcfg = dataclasses.replace(jcfg, window=8)
    jq = jquant.quantize_params(params)
    cfg = port_cfg(wcfg)
    model = params_from_numpy(_np(jq), cfg, device="cpu")
    prompt = np.asarray(data[0][0][:2, :10]).astype(np.int64)
    for kv_int8 in (False, True):
        want = jdecode.make_generate(wcfg, kv_int8=kv_int8)(
            jq, jnp.asarray(prompt), jax.random.PRNGKey(0), 24)
        got = tdecode.make_generate(cfg, kv_int8=kv_int8)(
            model, torch.from_numpy(prompt), 0, 24)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
