"""The port's encoder-decoder against ``kubetpu.jobs.seq2seq`` on the same
seeded weights and batches, f32: the parameter tree's leaves and shapes,
``encode``, ``decoder_forward``, the loss with the aux term of both
stacks, the chunked loss tail, whole train steps against the JAX step on a
one-device mesh, and, on weights trained here on a copy task, the cached
and recompute greedy generates' tokens equal to the JAX generate's (window
0 and 3), with EOS pinning."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubetpu.jobs import model as jmodel
from kubetpu.jobs import seq2seq as js2s
from kubetpu.jobs.meshjob import make_mesh
from kubetpu_torch.jobs import model as tmodel
from kubetpu_torch.jobs import seq2seq
from kubetpu_torch.jobs import train as ttrain
from kubetpu_torch.jobs.convert import (seq2seq_params_from_numpy,
                                        seq2seq_params_to_numpy)
from test_torch_encoder import STEP_LR, assert_updates_match
from torch_mesh_worlds import MeshStub

torch.set_num_threads(1)

JCFG = jmodel.ModelConfig(vocab=32, d_model=32, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=64)
LOGIT_TOL = 1e-5        # f32 dense on both sides
TRAIN_STEPS = 150       # the copy task's loss falls below a quarter


def port_cfg(jcfg, **over):
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(tmodel.ModelConfig)
              if f.name != "dtype"}
    fields.update(over)
    return tmodel.ModelConfig(**fields)


def _both(jcfg=JCFG, seed=0):
    jparams = js2s.init_seq2seq_params(jax.random.PRNGKey(seed), jcfg)
    model = seq2seq_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      port_cfg(jcfg), device="cpu")
    return jparams, model


def _copy_batch(b=8, s=8, seed=0):
    """The copy task: target = source, decoder input = BOS + shifted."""
    src = np.random.RandomState(seed).randint(2, 32, size=(b, s))
    tgt_in = np.concatenate([np.ones((b, 1), np.int64), src[:, :-1]], 1)
    return src.astype(np.int32), tgt_in.astype(np.int32)


def test_parameter_tree_matches_the_reference():
    """``init_seq2seq_params``' leaves have the JAX tree's names and
    shapes (no encoder head, the cross leaves in the decoder's blocks); the
    tree crosses both ways exactly; a missing cross leaf is named."""
    jtree = jax.tree.map(np.asarray, js2s.init_seq2seq_params(
        jax.random.PRNGKey(0), JCFG))
    model = seq2seq.init_seq2seq_params(torch.Generator().manual_seed(0),
                                        port_cfg(JCFG), device="cpu")
    mine = seq2seq_params_to_numpy(model)
    assert jax.tree.structure(mine) == jax.tree.structure(jtree)
    jax.tree.map(lambda a, b: np.testing.assert_equal(a.shape, b.shape),
                 mine, jtree)
    assert "head" not in mine["encoder"]
    back = seq2seq_params_to_numpy(seq2seq_params_from_numpy(
        jtree, port_cfg(JCFG), device="cpu"))
    jax.tree.map(np.testing.assert_array_equal, back, jtree)
    bad = jax.tree.map(lambda x: x, jtree)
    del bad["decoder"]["blocks"]["wk_x"]
    with pytest.raises(KeyError, match="wk_x"):
        seq2seq_params_from_numpy(bad, port_cfg(JCFG), device="cpu")


def test_encode_and_decoder_forward_match_the_reference():
    jparams, model = _both()
    src, tgt_in = _copy_batch(b=2)
    cfg = port_cfg(JCFG)
    jmem = js2s.encode(jparams, jnp.asarray(src), JCFG)
    with torch.no_grad():
        mem = seq2seq.encode(model, torch.from_numpy(src).long(), cfg)
        logits = seq2seq.decoder_forward(model, torch.from_numpy(
            tgt_in).long(), mem, cfg)
    np.testing.assert_allclose(mem.numpy(), np.asarray(jmem),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    ref = js2s.decoder_forward(jparams, jnp.asarray(tgt_in), jmem, JCFG)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    # the target side is causal, the source side is read
    with torch.no_grad():
        late = torch.from_numpy(tgt_in).long()
        late[:, -1] = (late[:, -1] + 1) % 32
        moved = seq2seq.decoder_forward(model, late, mem, cfg)
        torch.testing.assert_close(moved[:, :-1], logits[:, :-1])
        src2 = torch.from_numpy(src).long()
        src2[:, 0] = (src2[:, 0] + 1) % 32
        other = seq2seq.decoder_forward(
            model, torch.from_numpy(tgt_in).long(),
            seq2seq.encode(model, src2, cfg), cfg)
    assert float((other - logits).abs().max()) > 1e-4


@pytest.mark.parametrize("aux", [0.0, 0.5])
def test_loss_and_moe_aux_match_the_reference(aux):
    jcfg = dataclasses.replace(JCFG, n_experts=2, moe_aux_coeff=aux)
    jparams, model = _both(jcfg)
    src, tgt_in = _copy_batch(b=2)
    ref = float(js2s.seq2seq_loss(jparams, jnp.asarray(src),
                                  jnp.asarray(tgt_in), jnp.asarray(src),
                                  jcfg))
    got = float(seq2seq.seq2seq_loss(
        model, *(torch.from_numpy(x).long() for x in (src, tgt_in, src)),
        port_cfg(jcfg)).detach())
    assert got == pytest.approx(ref, rel=1e-5)


def test_chunked_loss_and_remat_keep_value_and_gradients():
    """``loss_chunk`` and ``remat`` (the block and its cross branch
    recomputed) change neither the loss (1e-6) nor a gradient (1e-5); the
    chunked value equals the JAX chunked loss within 1e-5."""
    jparams, model = _both()
    src, tgt_in = _copy_batch(b=2)
    ref = float(js2s.seq2seq_loss(
        jparams, jnp.asarray(src), jnp.asarray(tgt_in), jnp.asarray(src),
        dataclasses.replace(JCFG, loss_chunk=4)))
    model.requires_grad_(True)
    out = {}
    for name, over in (("plain", {}), ("chunked", {"loss_chunk": 4}),
                       ("remat", {"remat": True})):
        loss = seq2seq.seq2seq_loss(
            model, *(torch.from_numpy(x).long() for x in (src, tgt_in, src)),
            port_cfg(JCFG, **over))
        out[name] = (float(loss.detach()), torch.autograd.grad(
            loss, list(model.parameters())))
    assert out["chunked"][0] == pytest.approx(ref, rel=1e-5)
    for name in ("chunked", "remat"):
        assert out[name][0] == pytest.approx(out["plain"][0], rel=1e-6)
        for a, b in zip(out[name][1], out["plain"][1]):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_step_matches_the_reference(accum_steps):
    """Two steps of each package's train step from the same weights on
    the copy task, at lr STEP_LR: losses within 1e-5 relative and every
    weight's change within UPDATE_TOL of the JAX step's; the mesh is
    refused."""
    from kubetpu.jobs.train import make_optimizer

    mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1})
    jopt = make_optimizer(lr=STEP_LR)
    jstate, _ = js2s.init_seq2seq_state(jax.random.PRNGKey(0), JCFG, mesh,
                                        optimizer=jopt)
    jstep = js2s.make_seq2seq_train_step(JCFG, mesh, optimizer=jopt,
                                         accum_steps=accum_steps)
    cfg = port_cfg(JCFG)
    opt = ttrain.make_optimizer(lr=STEP_LR)
    jbefore = jax.tree.map(np.array, jstate.params)
    state = ttrain.state_from_params(seq2seq_params_from_numpy(
        jbefore, cfg, device="cpu"), opt)
    before = jax.tree.map(np.array, seq2seq_params_to_numpy(state.params))
    step = seq2seq.make_seq2seq_train_step(cfg, opt, accum_steps=accum_steps,
                                           device="cpu")
    jgrads = []
    for seed in range(2):
        src, tgt_in = _copy_batch(b=4, seed=seed)
        jgrads.append(jax.tree.map(np.asarray, jax.grad(js2s.seq2seq_loss)(
            jstate.params, jnp.asarray(src), jnp.asarray(tgt_in),
            jnp.asarray(src), JCFG)))
        jstate, jloss = jstep(jstate, jnp.asarray(src), jnp.asarray(tgt_in),
                              jnp.asarray(src))
        state, loss = step(state, src, tgt_in, src)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert_updates_match(before, seq2seq_params_to_numpy(state.params),
                         jbefore, jstate.params, jgrads)
    # a mesh is taken; one whose tp does not divide the heads is refused
    with pytest.raises(ValueError, match="does not divide n_heads"):
        seq2seq.make_seq2seq_train_step(cfg, mesh=MeshStub(tp=3),
                                        device="cpu")
    with pytest.raises(ValueError, match="does not divide n_heads"):
        seq2seq.init_seq2seq_state(torch.Generator(), cfg,
                                   mesh=MeshStub(tp=3), device="cpu")


@pytest.fixture(scope="module", params=[0, 3], ids=["dense", "window3"])
def trained(request):
    """(jax cfg, jax params, port cfg, port model, held-out sources): the
    JAX model trained TRAIN_STEPS steps on the copy task at window 0 or 3,
    then carried across."""
    from kubetpu.jobs.train import make_optimizer

    jcfg = dataclasses.replace(JCFG, window=request.param)
    mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1})
    opt = make_optimizer(lr=3e-3)
    state, _ = js2s.init_seq2seq_state(jax.random.PRNGKey(0), jcfg, mesh,
                                       optimizer=opt)
    step = js2s.make_seq2seq_train_step(jcfg, mesh, optimizer=opt)
    losses = []
    for i in range(TRAIN_STEPS):
        src, tgt_in = _copy_batch(seed=i % 8)
        state, loss = step(state, jnp.asarray(src), jnp.asarray(tgt_in),
                           jnp.asarray(src))
        losses.append(float(loss))
    assert losses[-1] < 0.25 * losses[0], losses
    cfg = port_cfg(jcfg)
    model = seq2seq_params_from_numpy(jax.tree.map(np.asarray, state.params),
                                      cfg, device="cpu")
    src, _ = _copy_batch(b=3, s=12, seed=99)
    return jcfg, state.params, cfg, model, src


@pytest.mark.parametrize("eos_id", [None, 0, "emitted"])
def test_generate_matches_the_reference(trained, eos_id):
    """The port's cached and recompute generates emit the JAX cached
    generate's tokens (which the JAX tests hold equal to its recompute
    path); with an EOS every row stays EOS after its first one."""
    jcfg, jparams, cfg, model, src = trained
    if eos_id == "emitted":       # a token the trained model does emit
        plain = seq2seq.make_seq2seq_generate(cfg, device="cpu")(model, src,
                                                                 9)
        eos_id = int(plain[0, 2])
    want = np.asarray(js2s.make_seq2seq_generate(jcfg, bos_id=1,
                                                 eos_id=eos_id)(
        jparams, jnp.asarray(src), 9))
    for cached in (True, False):
        got = seq2seq.make_seq2seq_generate(cfg, bos_id=1, eos_id=eos_id,
                                            cached=cached, device="cpu")(
            model, src, 9)
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"cached={cached}")
    if eos_id is not None:
        for row in want:
            hits = np.where(row == eos_id)[0]
            if hits.size:
                assert (row[hits[0]:] == eos_id).all(), row


def test_trained_model_copies_its_source(trained):
    """What the copy task taught shows in the port's tokens: on sources it
    trained on, most emitted tokens equal the source's."""
    _jcfg, _jparams, cfg, model, _src = trained
    src, _ = _copy_batch(seed=0)
    out = seq2seq.make_seq2seq_generate(cfg, device="cpu")(model, src, 8)
    assert (out.numpy() == src).mean() >= 0.5
