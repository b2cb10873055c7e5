"""The port's masked-LM encoder against ``kubetpu.jobs.encoder`` on the same
seeded weights and batches, f32: logits (dense core, and the port's plain
flash against the Pallas kernel in interpret mode), the masked-LM loss, the
MoE aux term, the chunked loss tail, the refused attention, and one whole
train step against the JAX step on a one-device mesh."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubetpu.jobs import data as jdata
from kubetpu.jobs import encoder as jenc
from kubetpu.jobs import model as jmodel
from kubetpu.jobs import train as jtrain
from kubetpu.jobs.meshjob import make_mesh
from kubetpu.ops import flash_attention as jflash_attention
from kubetpu_torch.jobs import encoder
from kubetpu_torch.jobs import model as tmodel
from kubetpu_torch.jobs import train as ttrain
from kubetpu_torch.jobs.convert import params_from_numpy, params_to_numpy
from kubetpu_torch.ops.flash_attention import flash_attention
from torch_mesh_worlds import MeshStub

torch.set_num_threads(1)

JCFG = jmodel.ModelConfig(vocab=64, d_model=32, n_layers=2, n_heads=4,
                          d_ff=64)
MASK_ID = 63
B, S = 2, 32            # two 16-row tiles of the interpreted Pallas kernel
LOGIT_TOL = 1e-5        # f32 dense on both sides
FLASH_TOL = 2e-4        # the Pallas interpreter's tiled sums against ours
STEP_LR = 1e-2          # the train-step tests' rate: Adam's first steps
                        # move each weight by about this much
UPDATE_TOL = 1e-5       # a weight's change over two steps against JAX's:
                        # a thousandth of one step
GRAD_ZERO = 1e-6        # a reference gradient at most this share of its
                        # leaf's largest is zero to rounding


def port_cfg(jcfg, **over):
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(tmodel.ModelConfig)
              if f.name != "dtype"}
    fields.update(over)
    return tmodel.ModelConfig(**fields)


def _both(jcfg=JCFG, seed=0):
    jparams = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, jparams),
                              port_cfg(jcfg), device="cpu")
    return jparams, model


def _batch(seed=1, rate=0.3):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, MASK_ID, (B, S)).astype(np.int32)
    mask = rng.random((B, S)) < rate
    return tokens, mask


def _jflash():
    return functools.partial(jflash_attention, block_q=16, block_k=16,
                             interpret=True, causal=False)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_encoder_forward_matches_the_reference(attention):
    jparams, model = _both()
    tokens, _ = _batch()
    jattn = _jflash() if attention == "flash" else None
    ref = np.asarray(jenc.encoder_forward(jparams, jnp.asarray(tokens), JCFG,
                                          attn_fn=jattn))
    attn = functools.partial(flash_attention, causal=False) \
        if attention == "flash" else None
    got = encoder.encoder_forward(model, torch.from_numpy(tokens).long(),
                                  port_cfg(JCFG), attn_fn=attn).numpy()
    tol = FLASH_TOL if attention == "flash" else LOGIT_TOL
    np.testing.assert_allclose(got, ref, atol=tol, rtol=tol)


def test_encoder_sees_the_future():
    """A change to the last token moves the first position's logits (the
    causal ``model.forward`` keeps them)."""
    _jparams, model = _both()
    tokens, _ = _batch()
    t1 = torch.from_numpy(tokens).long()
    t2 = t1.clone()
    t2[0, -1] = (t2[0, -1] + 1) % 60
    cfg = port_cfg(JCFG)
    e1 = encoder.encoder_forward(model, t1, cfg)
    e2 = encoder.encoder_forward(model, t2, cfg)
    assert not torch.allclose(e1[0, 0], e2[0, 0])
    d1, d2 = tmodel.forward(model, t1, cfg), tmodel.forward(model, t2, cfg)
    torch.testing.assert_close(d1[0, :-1], d2[0, :-1])


@pytest.mark.parametrize("rate", [0.0, 0.3], ids=["no_mask", "masked"])
def test_masked_lm_loss_matches_the_reference(rate):
    jparams, model = _both()
    tokens, mask = _batch(rate=rate)
    ref = float(jenc.masked_lm_loss(jparams, jnp.asarray(tokens),
                                    jnp.asarray(mask), MASK_ID, JCFG))
    got = float(encoder.masked_lm_loss(
        model, torch.from_numpy(tokens).long(), torch.from_numpy(mask),
        MASK_ID, port_cfg(JCFG)))
    assert got == pytest.approx(ref, rel=1e-5, abs=1e-6)
    if rate == 0.0:
        assert got == 0.0


def test_mlm_moe_aux_term_matches_the_reference():
    base = dataclasses.replace(JCFG, n_experts=4)
    with_aux = dataclasses.replace(base, moe_aux_coeff=0.5)
    jparams, model = _both(with_aux)
    tokens, mask = _batch()
    losses = {}
    for jcfg in (base, with_aux):
        ref = float(jenc.masked_lm_loss(jparams, jnp.asarray(tokens),
                                        jnp.asarray(mask), MASK_ID, jcfg))
        got = float(encoder.masked_lm_loss(
            model, torch.from_numpy(tokens).long(), torch.from_numpy(mask),
            MASK_ID, port_cfg(jcfg)))
        assert got == pytest.approx(ref, rel=1e-5)
        losses[jcfg.moe_aux_coeff] = got
    assert losses[0.5] > losses[0.0]       # the aux term (>= 1) was added


def test_mlm_chunked_loss_matches_unchunked_and_the_reference():
    """``loss_chunk`` streams the weighted (masked-position) tail: value
    within 1e-6 and gradients within 1e-5 of the materialized tail, value
    within 1e-5 of the JAX chunked loss."""
    jparams, model = _both()
    tokens, mask = _batch()
    cfgc = dataclasses.replace(JCFG, loss_chunk=8)
    ref = float(jenc.masked_lm_loss(jparams, jnp.asarray(tokens),
                                    jnp.asarray(mask), MASK_ID, cfgc))
    model.requires_grad_(True)
    grads = {}
    for chunk in (0, 8):
        loss = encoder.masked_lm_loss(
            model, torch.from_numpy(tokens).long(), torch.from_numpy(mask),
            MASK_ID, port_cfg(JCFG, loss_chunk=chunk))
        grads[chunk] = (float(loss.detach()), torch.autograd.grad(
            loss, list(model.parameters())))
    assert grads[8][0] == pytest.approx(grads[0][0], rel=1e-6)
    assert grads[8][0] == pytest.approx(ref, rel=1e-5)
    for a, b in zip(grads[8][1], grads[0][1]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_mlm_refuses_an_unknown_attention_and_a_mesh():
    with pytest.raises(ValueError, match="unknown encoder attention"):
        encoder.make_mlm_train_step(port_cfg(JCFG), MASK_ID,
                                    attention="falsh", device="cpu")
    # a mesh is taken; one whose tp does not divide the heads is refused
    with pytest.raises(ValueError, match="does not divide n_heads"):
        encoder.make_mlm_train_step(port_cfg(JCFG), MASK_ID,
                                    mesh=MeshStub(tp=3), device="cpu")


def assert_updates_match(before, after, jbefore, jafter, jgrads,
                         tol=UPDATE_TOL):
    """Each leaf's change over the steps (after - before) equals the JAX
    step's within *tol*, element by element. Left out are only the
    elements whose reference gradient is nonzero but zero to rounding at
    every step (``|g| <= GRAD_ZERO * max|g|`` over the leaf): there Adam's
    ``g / (|g| + eps)`` turns rounding into a move of up to lr either way.
    Every leaf moved by more than half a step in the reference, so a step
    that skips a leaf, or the whole update, fails."""
    def check(path, b, a, jb, ja, *grads):
        g = np.abs(np.stack([np.asarray(x) for x in grads]))
        noise = (g > 0) & (g <= GRAD_ZERO * g.max())
        keep = ~noise.all(axis=0)
        moved, ref = (a - b)[keep], (np.asarray(ja) - np.asarray(jb))[keep]
        name = jax.tree_util.keystr(path)
        assert np.abs(ref).max() > 0.5 * STEP_LR, name
        np.testing.assert_allclose(moved, ref, atol=tol, rtol=0,
                                   err_msg=name)
    jax.tree_util.tree_map_with_path(check, before, after, jbefore, jafter,
                                     *jgrads)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_mlm_train_step_matches_the_reference(attention):
    """Two steps of each package's masked-LM step from the same weights on
    ``mlm_batches`` (byte-equal in both packages), at lr STEP_LR: losses
    within 1e-5 relative and every weight's change within UPDATE_TOL of the
    JAX step's (the JAX flash in interpret mode, the port's flash its plain
    version)."""
    from kubetpu_torch.jobs import data as tdata

    mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1})
    jopt = jtrain.make_optimizer(lr=STEP_LR)
    jstate, _ = jtrain.init_state(jax.random.PRNGKey(0), JCFG, mesh,
                                  optimizer=jopt)
    jstep = jenc.make_mlm_train_step(JCFG, mesh, MASK_ID, optimizer=jopt,
                                     attention=attention, interpret=True)
    jattn = _jflash() if attention == "flash" else None
    cfg = port_cfg(JCFG)
    opt = ttrain.make_optimizer(lr=STEP_LR)
    jbefore = jax.tree.map(np.array, jstate.params)
    state = ttrain.state_from_params(
        params_from_numpy(jbefore, cfg, device="cpu"), opt)
    before = jax.tree.map(np.array, params_to_numpy(state.params))
    step = encoder.make_mlm_train_step(cfg, MASK_ID, optimizer=opt,
                                       attention=attention, device="cpu")
    jit = jdata.mlm_batches(jdata.SyntheticCorpus(60, seed=2), B, S, seed=3)
    tit = tdata.mlm_batches(tdata.SyntheticCorpus(60, seed=2), B, S, seed=3)
    jgrads = []
    for _ in range(2):
        (jt, jm), (tt, tm) = next(jit), next(tit)
        assert jt.tobytes() == tt.tobytes() and jm.tobytes() == tm.tobytes()
        jgrads.append(jax.tree.map(np.asarray, jax.grad(
            jenc.masked_lm_loss)(jstate.params, jnp.asarray(jt),
                                 jnp.asarray(jm), MASK_ID, JCFG,
                                 attn_fn=jattn)))
        jstate, jloss = jstep(jstate, jnp.asarray(jt), jnp.asarray(jm))
        state, loss = step(state, tt, tm)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert state.step == 2
    assert_updates_match(before, params_to_numpy(state.params), jbefore,
                         jstate.params, jgrads)
