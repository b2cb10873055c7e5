"""Draft distillation in the port (``kubetpu_torch/jobs/distill.py``)
against the JAX package's ``distill`` on ``trained_small``, from the same
weights and batches (f32 on both sides):

- ``truncated_draft``: the same leaves exactly, sharing the target's
  tensors;
- ``distill_loss``: within 1e-5 relative, for two temperatures and hard
  weights;
- three ``make_distill_step`` steps (the port's flash core, its plain
  version on the CPU; the JAX step's dense core): every loss within 1e-4
  relative and the trained draft within 2e-3 (Adam moves an element near
  zero by up to 2 * lr a step either way);
- ``agreement_rate``: within one position of the (8, 32) batch's 256
  (a float near-tie between the two forwards may flip one argmax);
- the vocabulary refusal, and a warm-started draft that shares no storage
  with the target."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubetpu.jobs import distill as jdistill
from kubetpu.jobs import model as jmodel
from kubetpu_torch.jobs import distill as tdistill
from kubetpu_torch.jobs import model as tmodel
from kubetpu_torch.jobs.convert import params_from_numpy, params_to_numpy

torch.set_num_threads(1)

JDCFG = jmodel.ModelConfig(vocab=64, d_model=32, n_layers=1, n_heads=4,
                           d_ff=64, max_seq=128)


def port_cfg(jcfg):
    return tmodel.ModelConfig(**{f: getattr(jcfg, f) for f in (
        "vocab", "d_model", "n_layers", "n_heads", "d_ff", "max_seq",
        "rope_theta", "n_kv_heads")})


@pytest.fixture(scope="module")
def pair(trained_small):
    """(jcfg, jparams, cfg, port model, data) of the trained target."""
    jcfg, jparams, data = trained_small
    cfg = port_cfg(jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    return jcfg, jparams, cfg, model, data


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_truncated_draft_leaves_equal_jax(pair):
    jcfg, jparams, cfg, model, _data = pair
    for n in (1, 2):
        jdcfg, jd = jdistill.truncated_draft(jcfg, jparams, n)
        dcfg, draft = tdistill.truncated_draft(cfg, model, n)
        assert dcfg.n_layers == jdcfg.n_layers == n
        mine, theirs = params_to_numpy(draft), _np_tree(jd)
        jax.tree.map(np.testing.assert_array_equal, mine, theirs)
        assert draft.embed is model.embed and draft.head is model.head
        assert draft.blocks[0] is model.blocks[0]
    for bad in (0, 3):
        with pytest.raises(ValueError):
            tdistill.truncated_draft(cfg, model, bad)


@pytest.mark.parametrize("temperature,hard", [(1.0, 0.5), (2.0, 0.0)])
def test_distill_loss_equals_jax(pair, temperature, hard):
    jcfg, jparams, cfg, model, data = pair
    tokens, targets = data[0]
    jdraft = jmodel.init_params(jax.random.PRNGKey(1), JDCFG)
    draft = params_from_numpy(_np_tree(jdraft), port_cfg(JDCFG),
                              device="cpu")
    t_logits = jmodel.forward(jparams, jnp.asarray(tokens), jcfg)
    want = float(jdistill.distill_loss(JDCFG, jdraft, t_logits,
                                       jnp.asarray(tokens),
                                       jnp.asarray(targets), temperature,
                                       hard))
    got = float(tdistill.distill_loss(
        port_cfg(JDCFG), draft, torch.from_numpy(np.array(t_logits)),
        torch.from_numpy(tokens).long(), torch.from_numpy(targets).long(),
        temperature, hard))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_three_distill_steps_equal_jax(pair):
    jcfg, jparams, cfg, model, data = pair
    dcfg = port_cfg(JDCFG)
    jstep, jopt = jdistill.make_distill_step(jcfg, JDCFG, temperature=2.0)
    jstate = jdistill.init_draft_state(jax.random.PRNGKey(1), JDCFG, jopt)
    start = params_from_numpy(_np_tree(jstate.params), dcfg, device="cpu")
    step, opt = tdistill.make_distill_step(cfg, dcfg, temperature=2.0,
                                           device="cpu")
    state = tdistill.init_draft_state(None, dcfg, opt, init_params=start)
    jl, tl = [], []
    for tokens, targets in data[:3]:
        jstate, loss = jstep(jstate, jparams, tokens, targets)
        jl.append(float(loss))
        state, loss = step(state, model, tokens, targets)
        tl.append(float(loss))
    assert state.step == 3 and int(jstate.step) == 3
    for a, b in zip(tl, jl):
        assert abs(a - b) <= 1e-4 * abs(b), (tl, jl)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, atol=2e-3),
                 params_to_numpy(state.params), _np_tree(jstate.params))
    # the frozen teacher did not move
    jax.tree.map(np.testing.assert_array_equal, params_to_numpy(model),
                 _np_tree(jparams))


def test_agreement_rate_equals_jax(pair):
    jcfg, jparams, cfg, model, data = pair
    tokens, _ = data[1]
    jdcfg, jd = jdistill.truncated_draft(jcfg, jparams, 1)
    dcfg, draft = tdistill.truncated_draft(cfg, model, 1)
    jrand = jmodel.init_params(jax.random.PRNGKey(9), JDCFG)
    rand = params_from_numpy(_np_tree(jrand), port_cfg(JDCFG), device="cpu")
    rates = {}
    for name, (jc, jp, c, p) in {
            "self": (jcfg, jparams, cfg, model),
            "truncated": (jdcfg, jd, dcfg, draft),
            "random": (JDCFG, jrand, port_cfg(JDCFG), rand)}.items():
        want = jdistill.agreement_rate(jcfg, jc, jparams, jp, tokens)
        got = tdistill.agreement_rate(cfg, c, model, p, tokens)
        assert abs(got - want) <= 1 / tokens.size, (name, got, want)
        rates[name] = want
    assert rates["self"] == 1.0
    assert rates["truncated"] > rates["random"]


def test_warm_start_shares_no_storage_with_the_target(pair):
    _jcfg, _jparams, cfg, model, data = pair
    dcfg, draft = tdistill.truncated_draft(cfg, model, 1)
    target_ptrs = {p.data_ptr() for p in model.parameters()}
    before = [p.detach().clone() for p in model.parameters()]
    step, opt = tdistill.make_distill_step(cfg, dcfg, device="cpu")
    state = tdistill.init_draft_state(None, dcfg, opt, init_params=draft)
    assert not target_ptrs & {p.data_ptr() for p in state.params.parameters()}
    for tokens, targets in data[:2]:
        state, loss = step(state, model, tokens, targets)
        assert np.isfinite(float(loss))
    for a, b in zip(before, model.parameters()):
        assert torch.equal(a, b)
    fresh = tdistill.init_draft_state(torch.Generator().manual_seed(0), dcfg,
                                      opt, device="cpu")
    assert all(p.requires_grad for p in fresh.params.parameters())


def test_vocab_mismatch_refused_like_jax(pair):
    jcfg, _jparams, cfg, _model, _data = pair
    with pytest.raises(ValueError, match="vocabulary"):
        jdistill.make_distill_step(jcfg, dataclasses.replace(JDCFG, vocab=32))
    with pytest.raises(ValueError, match="vocabulary"):
        tdistill.make_distill_step(
            cfg, dataclasses.replace(port_cfg(JDCFG), vocab=32),
            device="cpu")
