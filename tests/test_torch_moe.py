"""The port's mixture-of-experts blocks against the JAX package's
(``kubetpu/jobs/model.py``): ``_moe_mlp`` and ``_moe_mlp_capacity`` (top-1
and top-2, roomy and tight capacity, the per-row dispatch of the vmapped
legs) within 1e-5 in f32, the load-balance term, ``forward(return_aux)``,
``next_token_loss`` and first-step gradients, the capacity prefill against
``forward``, the config's repr and validation, and greedy tokens of the
paged, dense and speculative servers against the JAX servers on a small MoE
model trained briefly."""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubetpu.jobs import ModelConfig as JaxConfig
from kubetpu.jobs import decode as jdecode
from kubetpu.jobs import init_state, make_mesh, make_train_step
from kubetpu.jobs import model as jmodel
from kubetpu.jobs.data import SyntheticCorpus
from kubetpu.jobs.paged import PagedDecodeServer as JaxPagedServer
from kubetpu.jobs.serving import DecodeServer as JaxDecodeServer
from kubetpu.jobs.spec_serving import SpeculativeDecodeServer as JaxSpecServer
from kubetpu_torch.jobs import decode as tdecode
from kubetpu_torch.jobs import model as tmodel
from kubetpu_torch.jobs import train as ttrain
from kubetpu_torch.jobs.convert import params_from_numpy, params_to_numpy
from kubetpu_torch.jobs.paged import PagedDecodeServer
from kubetpu_torch.jobs.serving import DecodeServer
from kubetpu_torch.jobs.spec_serving import SpeculativeDecodeServer

torch.set_num_threads(1)

MOE_TOL = 1e-5
FIELDS = ("vocab", "d_model", "n_layers", "n_heads", "d_ff", "max_seq",
          "n_kv_heads", "window", "n_experts", "moe_capacity_factor",
          "moe_aux_coeff", "moe_top_k")
CFG = JaxConfig(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
                max_seq=64, n_experts=4, moe_capacity_factor=1.5,
                moe_top_k=2, moe_aux_coeff=0.01)


def port_cfg(jcfg, **over):
    fields = {f: getattr(jcfg, f) for f in FIELDS}
    fields.update(over)
    return tmodel.ModelConfig(**fields)


def _layer(seed=0, d=16, e=4, f=24, tie=False):
    rng = np.random.default_rng(seed)
    layer = {"moe_router": rng.standard_normal((d, e)) * 0.5,
             "w_gate": rng.standard_normal((e, d, f)) * 0.3,
             "w_up": rng.standard_normal((e, d, f)) * 0.3,
             "w_down": rng.standard_normal((e, f, d)) * 0.3}
    layer = {k: v.astype(np.float32) for k, v in layer.items()}
    if tie:            # experts 0 and 1 tie on every row, 2 and 3 too
        layer["moe_router"][:, 1] = layer["moe_router"][:, 0]
        layer["moe_router"][:, 3] = layer["moe_router"][:, 2]
    return ({k: jnp.asarray(v) for k, v in layer.items()},
            SimpleNamespace(**{k: torch.from_numpy(v)
                               for k, v in layer.items()}))


def _h(shape=(2, 9, 16), seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("cf,k", [(0.5, 1), (8.0, 1), (0.5, 2), (8.0, 2),
                                  (1.0, 3)],
                         ids=["top1_tight", "top1_roomy", "top2_tight",
                              "top2_roomy", "top3"])
@pytest.mark.parametrize("tie", [False, True], ids=["plain", "tied"])
def test_capacity_dispatch_matches_the_reference(cf, k, tie):
    jl, tl = _layer(tie=tie)
    h = _h()
    jo, jp = jmodel._moe_mlp_capacity(jnp.asarray(h), jl, cf, k)
    to, tp = tmodel._moe_mlp_capacity(torch.from_numpy(h), tl, cf, k)
    assert tuple(tp.shape) == jp.shape
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=MOE_TOL,
                               rtol=MOE_TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=MOE_TOL)
    for top_k in (1, k):
        assert abs(float(tmodel._moe_aux_from_probs(tp, top_k))
                   - float(jmodel._moe_aux_from_probs(jp, top_k))) < MOE_TOL


@pytest.mark.parametrize("tie", [False, True], ids=["plain", "tied"])
def test_dense_dispatch_matches_the_reference(tie):
    jl, tl = _layer(seed=2, tie=tie)
    h = _h(seed=3)
    jo, jp = jmodel._moe_mlp(jnp.asarray(h), jl)
    to, tp = tmodel._moe_mlp(torch.from_numpy(h), tl)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=MOE_TOL,
                               rtol=MOE_TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=MOE_TOL)


@pytest.mark.parametrize("cf,k", [(0.5, 2), (2.0, 1)], ids=["tight", "top1"])
def test_per_row_dispatch_is_the_reference_under_vmap(cf, k):
    """The dense server's step and the speculative draft vmap the chunk
    forward over the batch in the JAX package: each row is its own
    capacity dispatch."""
    jl, tl = _layer(seed=4)
    h = _h((3, 5, 16), seed=5)
    jo = jax.vmap(lambda x: jmodel._moe_mlp_capacity(
        x[None], jl, cf, k)[0][0])(jnp.asarray(h))
    to, _ = tmodel._moe_mlp_capacity(torch.from_numpy(h), tl, cf, k,
                                     per_row=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=MOE_TOL,
                               rtol=MOE_TOL)
    batched, _ = tmodel._moe_mlp_capacity(torch.from_numpy(h), tl, cf, k)
    assert not torch.allclose(batched, to)     # N changes who is dropped


@pytest.mark.parametrize("over", [
    {},
    {"moe_capacity_factor": 0.0, "moe_top_k": 1},
    {"moe_capacity_factor": 0.5, "moe_top_k": 1, "n_kv_heads": 2},
], ids=["capacity_top2", "dense_dispatch", "tight_top1_gqa"])
def test_forward_aux_and_loss_match_the_reference(over):
    jcfg = dataclasses.replace(CFG, **over)
    params = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = port_cfg(jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 12))
    jl, ja = jmodel.forward(params, jnp.asarray(tokens), jcfg,
                            return_aux=True)
    tl, ta = tmodel.forward(model, torch.from_numpy(tokens), cfg,
                            return_aux=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    assert abs(float(ta) - float(ja)) < 1e-5
    targets = np.roll(tokens, -1, axis=1)
    jloss = jmodel.next_token_loss(params, jnp.asarray(tokens),
                                   jnp.asarray(targets), jcfg)
    tloss = tmodel.next_token_loss(model, torch.from_numpy(tokens),
                                   torch.from_numpy(targets), cfg)
    assert abs(float(tloss) - float(jloss)) < 1e-5
    # the aux term is in the loss: without it, the loss drops by coeff * aux
    plain = tmodel.next_token_loss(
        model, torch.from_numpy(tokens), torch.from_numpy(targets),
        dataclasses.replace(cfg, moe_aux_coeff=0.0))
    assert abs(float(tloss - plain) - 0.01 * float(ta)) < 1e-6


def _stack(model, grads):
    named = dict(zip([n for n, _ in model.named_parameters()], grads))
    return {"embed": named["embed"].numpy(), "ln_f": named["ln_f"].numpy(),
            "head": named["head"].numpy(),
            "blocks": {leaf: np.stack([named[f"blocks.{i}.{leaf}"].numpy()
                                       for i in range(len(model.blocks))])
                       for leaf in tmodel.block_leaves(model.cfg)}}


def test_first_train_step_gradients_and_losses_match_the_reference():
    mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1})
    jstate, jopt = init_state(jax.random.PRNGKey(0), CFG, mesh)
    cfg = port_cfg(CFG)
    model = params_from_numpy(jax.tree.map(np.asarray, jstate.params), cfg,
                              device="cpu").requires_grad_(True)
    it = SyntheticCorpus(CFG.vocab, seed=3).batches(4, 16, seed=5)
    batches = [next(it) for _ in range(3)]
    tokens, targets = batches[0]
    jgrads = jax.grad(lambda p: jmodel.next_token_loss(
        p, jnp.asarray(tokens), jnp.asarray(targets), CFG))(jstate.params)
    loss = tmodel.next_token_loss(model, torch.from_numpy(tokens).long(),
                                  torch.from_numpy(targets).long(), cfg)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), atol=1e-5, rtol=1e-4), _stack(model, grads),
        jgrads)
    jstep = make_train_step(CFG, mesh, optimizer=jopt, attention="dense")
    opt = ttrain.make_optimizer()
    tstep = ttrain.make_train_step(cfg, opt, attention="dense", device="cpu")
    state = ttrain.state_from_params(model, opt)
    for tokens, targets in batches:
        jstate, jloss = jstep(jstate, jnp.asarray(tokens),
                              jnp.asarray(targets))
        state, tloss = tstep(state, tokens, targets)
        assert abs(float(tloss) - float(jloss)) <= 1e-4 * abs(float(jloss))


def test_capacity_prefill_matches_the_training_forward():
    """``tests/test_decode.py::test_capacity_moe_prefill_matches_training_
    forward``'s counterpart: the prefill uses the training forward's
    dispatch (same N), in the port and against the reference."""
    jcfg = dataclasses.replace(CFG, moe_top_k=1, moe_aux_coeff=0.0)
    params = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = port_cfg(jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    tokens = np.random.default_rng(1).integers(0, 64, (2, 12))
    logits, _k, _v = tdecode.prefill(cfg, model, torch.from_numpy(tokens),
                                     *tdecode.init_kv_cache(cfg, 2, 12,
                                                            device="cpu"))
    full = tmodel.forward(model, torch.from_numpy(tokens), cfg)
    np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(),
                               rtol=2e-4, atol=2e-5)
    jlogits, _, _ = jdecode.prefill(jcfg, params, jnp.asarray(tokens),
                                    *jdecode.init_kv_cache(jcfg, 2, 12))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)


def test_params_round_trip_and_init_shapes():
    cfg = port_cfg(CFG)
    model = tmodel.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    blk = model.blocks[0]
    assert tuple(blk.moe_router.shape) == (32, 4)
    assert tuple(blk.w_gate.shape) == (4, 32, 64)
    assert tuple(blk.w_down.shape) == (4, 64, 32)
    assert abs(float(blk.w_down.std()) - 64 ** -0.5) < 0.02
    # a dense config's draws do not move when MoE exists
    dense = dataclasses.replace(cfg, n_experts=0, moe_capacity_factor=0.0,
                                moe_top_k=1)
    a = tmodel.init_params(torch.Generator().manual_seed(0), dense,
                           device="cpu")
    assert torch.equal(a.blocks[0].wo, blk.wo)
    tree = params_to_numpy(model)
    jshapes = jax.tree.map(lambda x: x.shape, jmodel.init_params(
        jax.random.PRNGKey(0), CFG))
    assert jax.tree.map(np.shape, tree) == jshapes
    back = params_from_numpy(tree, cfg, device="cpu")
    for (n, p), (_, q) in zip(model.named_parameters(),
                              back.named_parameters()):
        assert torch.equal(p, q), n


@pytest.mark.parametrize("over", [
    {},
    {"moe_capacity_factor": 2.0, "moe_top_k": 2, "n_experts": 8},
    {"moe_aux_coeff": 0.0, "moe_top_k": 1, "moe_capacity_factor": 0.0},
    {"dtype": "bfloat16", "n_kv_heads": 2},
], ids=["top2", "mixtral_routing", "top1_dense", "bf16_gqa"])
def test_reference_config_repr_equals_the_reference(over):
    over = dict(over)
    dtype = over.pop("dtype", "float32")
    jcfg = dataclasses.replace(CFG, dtype=getattr(jnp, dtype), **over)
    cfg = port_cfg(jcfg, dtype=getattr(torch, dtype))
    assert tmodel.reference_config_repr(cfg) == repr(jcfg)


@pytest.mark.parametrize("over", [
    {"n_experts": 2, "moe_top_k": 3, "moe_capacity_factor": 1.0},
    {"n_experts": 2, "moe_top_k": 2},
    {"moe_top_k": 0},
], ids=["top_k_above_experts", "top2_needs_capacity", "top_k_zero"])
def test_moe_validation_matches_the_reference(over):
    with pytest.raises(ValueError) as jerr:
        JaxConfig(**over)
    with pytest.raises(ValueError) as terr:
        tmodel.ModelConfig(**over)
    assert str(terr.value) == str(jerr.value)


# -- serving a briefly trained MoE model -----------------------------------

SERVE_CFG = JaxConfig(vocab=64, d_model=64, n_layers=2, n_heads=4,
                      d_ff=128, max_seq=128, n_experts=4, moe_top_k=2,
                      moe_capacity_factor=2.0, moe_aux_coeff=0.01)


@pytest.fixture(scope="module")
def trained_moe():
    """A small top-2 capacity MoE model trained 100 steps on the skewed
    synthetic corpus (``trained_small``'s recipe): (jax cfg, jax params,
    port cfg, port model, prompts)."""
    mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1})
    it = SyntheticCorpus(SERVE_CFG.vocab, seed=3,
                         skew=[0.85, 0.05, 0.05, 0.05]).batches(8, 32, seed=5)
    data = [next(it) for _ in range(8)]
    state, opt = init_state(jax.random.PRNGKey(0), SERVE_CFG, mesh)
    step = make_train_step(SERVE_CFG, mesh, optimizer=opt, use_ring=False)
    for i in range(100):
        state, _ = step(state, *data[i % 8])
    cfg = port_cfg(SERVE_CFG)
    model = params_from_numpy(jax.tree.map(np.asarray, state.params), cfg,
                              device="cpu")
    rows = np.asarray(data[3][0])
    prompts = [rows[i, :n].tolist() for i, n in enumerate((6, 13, 9, 17, 5,
                                                           11))]
    return SERVE_CFG, state.params, cfg, model, prompts


def _storm(server, prompts):
    """Three prompts, one step, three more joining mid-flight, drained:
    inactive slots and ragged positions in every decode step."""
    rids = [server.enqueue(p) for p in prompts[:3]]
    server.step()
    rids += [server.enqueue(p) for p in prompts[3:]]
    server.drain()
    return [server.result(r) for r in rids]


@pytest.mark.parametrize("budget", [0, 8], ids=["monolithic", "chunked"])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32", "int8"])
def test_paged_server_tokens_equal_the_reference(trained_moe, budget,
                                                 kv_int8):
    jcfg, params, cfg, model, prompts = trained_moe
    kw = dict(n_slots=3, max_seq=64, max_new_tokens=12, page_size=8,
              prefill_budget=budget, kv_int8=kv_int8)
    want = _storm(JaxPagedServer(jcfg, params, **kw), prompts)
    server = PagedDecodeServer(cfg, model, device="cpu", **kw)
    assert _storm(server, prompts) == want
    server.check_invariants()


@pytest.mark.parametrize("server", ["dense", "speculative"])
def test_vmapped_servers_tokens_equal_the_reference(trained_moe, server):
    """The dense server's step and the speculative rounds run each row as
    its own capacity dispatch, as the reference's vmapped legs do."""
    jcfg, params, cfg, model, prompts = trained_moe
    kw = dict(n_slots=3, max_seq=64, max_new_tokens=10)
    if server == "dense":
        want = _storm(JaxDecodeServer(jcfg, params, **kw), prompts)
        got = _storm(DecodeServer(cfg, model, device="cpu", **kw), prompts)
    else:
        want = _storm(JaxSpecServer(jcfg, jcfg, params, params, gamma=3,
                                    **kw), prompts)
        got = _storm(SpeculativeDecodeServer(cfg, cfg, model, model, gamma=3,
                                             device="cpu", **kw), prompts)
    assert got == want
