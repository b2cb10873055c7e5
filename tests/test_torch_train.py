"""The port's training slice against the JAX package on identical inputs:
data batches, the loss tail, the optimizer, and whole train steps with the
flash core (the port's plain versions on the CPU; the Pallas kernels in
interpret mode on the JAX side)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubetpu.jobs import data as jdata
from kubetpu.jobs import model as jmodel
from kubetpu.jobs import train as jtrain
from kubetpu.jobs.meshjob import make_mesh
from kubetpu_torch.jobs import data as tdata
from kubetpu_torch.jobs import model as tmodel
from kubetpu_torch.jobs import train as ttrain
from kubetpu_torch.jobs.convert import params_from_numpy, params_to_numpy

torch.set_num_threads(1)

# a small f32 GQA decoder; S = 32 is one Pallas tile, so the JAX flash
# kernels run in interpret mode in a few seconds
JCFG = jmodel.ModelConfig(vocab=64, d_model=32, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=64, max_seq=64)
BATCH, SEQ = 4, 32


def port_cfg(jcfg, **over):
    fields = {f: getattr(jcfg, f) for f in (
        "vocab", "d_model", "n_layers", "n_heads", "d_ff", "max_seq",
        "rope_theta", "window", "n_kv_heads", "remat", "remat_policy",
        "loss_chunk", "label_smoothing", "z_loss")}
    fields.update(over)
    return tmodel.ModelConfig(**fields)


def _jax_params(jcfg=JCFG, seed=0):
    return jmodel.init_params(jax.random.PRNGKey(seed), jcfg)


def _port_model(jparams, cfg):
    """The port's model with *jparams*' weights, gradients on."""
    return params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu").requires_grad_(True)


def _batches(n, seed=5):
    it = tdata.SyntheticCorpus(JCFG.vocab, seed=3).batches(BATCH, SEQ,
                                                           seed=seed)
    return [next(it) for _ in range(n)]


# -- data -------------------------------------------------------------------

@pytest.mark.parametrize("skew", [None, [0.85, 0.05, 0.05, 0.05]],
                         ids=["uniform", "skewed"])
def test_synthetic_corpus_is_byte_equal(skew):
    j = jdata.SyntheticCorpus(100, seed=7, skew=skew).batches(3, 17, seed=2)
    t = tdata.SyntheticCorpus(100, seed=7, skew=skew).batches(3, 17, seed=2)
    for _ in range(3):
        for a, b in zip(next(j), next(t)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("mode,isolate", [("stream", False),
                                          ("greedy", False),
                                          ("greedy", True)])
def test_pack_documents_is_byte_equal(mode, isolate):
    rng = np.random.default_rng(0)
    docs = [rng.integers(1, 50, rng.integers(1, 40)).tolist()
            for _ in range(60)]
    kw = dict(batch=3, seq=16, eos_id=0, mode=mode, pad_id=0,
              isolate_documents=isolate)
    j = list(jdata.pack_documents(iter(docs), **kw))
    t = list(tdata.pack_documents(iter(docs), **kw))
    assert len(j) == len(t) > 1
    for jb, tb in zip(j, t):
        for a, b in zip(jb, tb):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_pack_documents_refuses_isolation_in_stream_mode():
    with pytest.raises(ValueError, match="greedy"):
        next(tdata.pack_documents(iter([[1, 2]]), 1, 4, 0, mode="stream",
                                  isolate_documents=True))
    with pytest.raises(ValueError, match="mode"):
        next(tdata.pack_documents(iter([[1, 2]]), 1, 4, 0, mode="x"))


# -- the loss tail ----------------------------------------------------------

@pytest.mark.parametrize("over", [
    {},
    {"label_smoothing": 0.1, "z_loss": 1e-3},
    {"loss_chunk": 8},
    {"loss_chunk": 8, "label_smoothing": 0.1, "z_loss": 1e-3},
], ids=["plain", "smooth_z", "chunked", "chunked_smooth_z"])
@pytest.mark.parametrize("weighted", [False, True])
def test_next_token_loss_matches_jax(over, weighted):
    """Materialized and chunked tails, label smoothing, z-loss and
    per-position weights: the loss within 1e-5 (f32)."""
    jcfg = dataclasses.replace(JCFG, **over)
    jparams = _jax_params(jcfg)
    tokens, targets = _batches(1)[0]
    weights = None
    if weighted:
        weights = (np.random.default_rng(1).random((BATCH, SEQ)) > 0.3
                   ).astype(np.float32)
    ref = float(jmodel.next_token_loss(
        jparams, jnp.asarray(tokens), jnp.asarray(targets), jcfg,
        weights=None if weights is None else jnp.asarray(weights)))
    cfg = port_cfg(jcfg)
    model = _port_model(jparams, cfg)
    got = tmodel.next_token_loss(
        model, torch.from_numpy(tokens).long(),
        torch.from_numpy(targets).long(), cfg,
        weights=None if weights is None else torch.from_numpy(weights))
    assert abs(float(got.detach()) - ref) <= 1e-5 * max(1.0, abs(ref))


@pytest.mark.parametrize("over", [{"loss_chunk": -1},
                                  {"label_smoothing": 1.0},
                                  {"z_loss": -0.1},
                                  {"remat_policy": "some"}])
def test_config_refuses_what_the_jax_config_refuses(over):
    with pytest.raises(ValueError):
        dataclasses.replace(JCFG, **over)
    with pytest.raises(ValueError):
        port_cfg(JCFG, **over)


# -- the optimizer ----------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {},
    {"warmup_steps": 3},
    {"warmup_steps": 2, "decay_steps": 6, "clip_norm": 0.5},
    {"decay_steps": 4, "clip_norm": 100.0, "weight_decay": 0.1},
], ids=["constant", "warmup", "warmup_cosine_clip", "cosine_noclip"])
def test_optimizer_matches_optax(kw):
    """Seven updates from a fixed gradient sequence: every parameter within
    1e-6 of optax's, step by step."""
    kw = dict(lr=1e-2, **kw)
    rng = np.random.default_rng(0)
    shapes = [(3, 5), (7,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(7)]
    tx = jtrain.make_optimizer(**kw)
    jp = [jnp.asarray(p) for p in params]
    jstate = tx.init(jp)
    opt = ttrain.make_optimizer(**kw)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = opt.init(tp)
    for g in grads:
        updates, jstate = tx.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        opt.update([torch.from_numpy(x) for x in g], tstate, tp)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=1e-6)
    assert int(tstate.count) == len(grads)


# -- whole train steps ------------------------------------------------------

def _port_grads(model, cfg, tokens, targets, attention="flash"):
    attn = ttrain._resolve_attention(attention, cfg.window)
    loss = tmodel.next_token_loss(model, torch.from_numpy(tokens).long(),
                                  torch.from_numpy(targets).long(), cfg,
                                  attn)
    leaves = list(model.parameters())
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _stack_grads(model, grads):
    """Port gradients as the JAX tree layout (blocks stacked on axis 0)."""
    named = dict(zip([n for n, _ in model.named_parameters()], grads))
    blocks = {}
    for leaf in ("ln1", "ln2", "wq", "wk", "wv", "wo", "w_gate", "w_up",
                 "w_down"):
        blocks[leaf] = np.stack([named[f"blocks.{i}.{leaf}"].numpy()
                                 for i in range(len(model.blocks))])
    return {"embed": named["embed"].numpy(), "blocks": blocks,
            "ln_f": named["ln_f"].numpy(), "head": named["head"].numpy()}


def test_train_steps_match_jax_flash_interpret():
    """Three steps of the port's flash train step on the CPU against the
    JAX step with the Pallas kernels in interpret mode, from the same
    weights and batches: per-step losses within 1e-4 relative, first-step
    gradients within 1e-4, and the trained weights within 2e-3 (Adam
    normalizes each gradient element, so an element near 0 may move by up
    to 2 * lr = 6e-4 a step on either side)."""
    mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1})
    jstate, jopt = jtrain.init_state(jax.random.PRNGKey(0), JCFG, mesh)
    cfg = port_cfg(JCFG)
    model = _port_model(jstate.params, cfg)
    batches = _batches(3)

    tokens, targets = batches[0]
    jgrads = jax.grad(lambda p: jmodel.next_token_loss(
        p, jnp.asarray(tokens), jnp.asarray(targets), JCFG,
        jtrain._resolve_attention(mesh, "flash_interpret")))(jstate.params)
    state = ttrain.state_from_params(model, ttrain.make_optimizer())
    _loss, tgrads = _port_grads(model, cfg, tokens, targets)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), atol=1e-4, rtol=1e-4),
        _stack_grads(model, tgrads), jgrads)

    jstep = jtrain.make_train_step(JCFG, mesh, optimizer=jopt,
                                   attention="flash_interpret")
    tstep = ttrain.make_train_step(cfg, state_opt := ttrain.make_optimizer(),
                                   attention="flash", device="cpu")
    state = ttrain.state_from_params(model, state_opt)
    for tokens, targets in batches:
        jstate, jloss = jstep(jstate, jnp.asarray(tokens),
                              jnp.asarray(targets))
        state, tloss = tstep(state, tokens, targets)
        assert abs(float(tloss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    assert state.step == 3
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), atol=2e-3), params_to_numpy(state.params),
        jstate.params)


@pytest.mark.parametrize("attention", ["flash", "dense"])
def test_accum_steps_give_the_full_batch_gradient(attention):
    """accum_steps=2 hands the optimizer the mean of two half-batch
    gradients: the full batch's gradient within 1e-6, and the mean loss."""
    cfg = port_cfg(JCFG)
    model = _port_model(_jax_params(), cfg)
    tokens, targets = _batches(1)[0]
    full_loss, full = _port_grads(model, cfg, tokens, targets, attention)

    class Recorder:
        def update(self, grads, state, params, ok=None):
            self.grads = grads

    rec = Recorder()
    attn = ttrain._resolve_attention(attention, 0)
    step = ttrain.make_update_step(
        lambda p, t, y: tmodel.next_token_loss(p, t, y, cfg, attn), rec,
        accum_steps=2)
    state = ttrain.TrainState(model, None)
    state, loss = step(state, torch.from_numpy(tokens).long(),
                       torch.from_numpy(targets).long())
    assert abs(float(loss) - float(full_loss)) <= 1e-6
    for a, b in zip(rec.grads, full):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError, match="divisible"):
        step(state, torch.zeros((3, SEQ), dtype=torch.long),
             torch.zeros((3, SEQ), dtype=torch.long))


def test_skip_nonfinite_leaves_weights_and_optimizer_untouched():
    cfg = port_cfg(JCFG)
    state, opt = ttrain.init_state(torch.Generator().manual_seed(0), cfg,
                                   device="cpu")
    step = ttrain.make_train_step(cfg, opt, skip_nonfinite=True,
                                  device="cpu")
    tokens, targets = _batches(1)[0]
    with torch.no_grad():
        state.params.head[0, 0] = float("inf")
    before = [p.detach().clone() for p in state.params.parameters()]
    state, loss = step(state, tokens, targets)
    assert not torch.isfinite(loss)
    assert state.step == 1 and int(state.opt_state.count) == 0
    for a, b in zip(state.params.parameters(), before):
        assert torch.equal(a.detach(), b)
    assert all(not m.any() for m in state.opt_state.mu)
    with torch.no_grad():
        state.params.head[0, 0] = 0.0
    state, loss = step(state, tokens, targets)
    assert torch.isfinite(loss) and int(state.opt_state.count) == 1
    assert not torch.equal(state.params.blocks[0].wq.detach(),
                           before[3])          # embed, ln1, ln2, wq, ...


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gives_the_same_gradients(policy):
    """Recomputing each block in the backward (both policies) changes no
    gradient beyond rounding (1e-6)."""
    cfg = port_cfg(JCFG)
    model = _port_model(_jax_params(), cfg)
    tokens, targets = _batches(1)[0]
    _, plain = _port_grads(model, cfg, tokens, targets)
    remat = dataclasses.replace(cfg, remat=True, remat_policy=policy)
    _, again = _port_grads(model, remat, tokens, targets)
    for a, b in zip(again, plain):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_evaluate_matches_jax():
    """make_eval_step + evaluate: the mean loss over two batches against the
    JAX eval step (dense core) within 1e-5; the serving forward stays
    gradient-free on a trained model."""
    jparams = _jax_params()
    mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1})
    batches = _batches(2)
    ref = jdata.evaluate(jtrain.make_eval_step(JCFG, mesh, use_ring=False),
                         jparams, iter(batches), 2)
    cfg = port_cfg(JCFG)
    state = ttrain.state_from_params(_port_model(jparams, cfg),
                                     ttrain.make_optimizer())
    got = tdata.evaluate(ttrain.make_eval_step(cfg, device="cpu"),
                         state.params, iter(batches), 2)
    assert got["n_batches"] == 2 and got["n_tokens"] == ref["n_tokens"]
    assert abs(got["loss"] - ref["loss"]) <= 1e-5 * ref["loss"]
    logits = tmodel.forward(state.params, torch.from_numpy(batches[0][0]),
                            cfg)
    assert not logits.requires_grad


def test_ring_cores_wait_for_the_multi_device_slice():
    """The ring cores are ported (the sharded step over a mesh is
    tests/test_torch_sharded_train.py): without a mesh each is a ring of
    one, the same step as the flash core's; an unknown core raises."""
    cfg = port_cfg(JCFG)
    tokens, targets = _batches(1)[0]
    losses = []
    for name in ("flash", "ring", "ring_flash"):
        opt = ttrain.make_optimizer()
        state = ttrain.state_from_params(
            _port_model(_jax_params(), cfg), opt)
        step = ttrain.make_train_step(cfg, opt, attention=name, device="cpu")
        losses.append(float(step(state, tokens, targets)[1]))
    assert abs(losses[1] - losses[0]) <= 1e-6 * losses[0]
    assert abs(losses[2] - losses[0]) <= 1e-6 * losses[0]
    with pytest.raises(ValueError, match="unknown attention"):
        ttrain.make_train_step(cfg, attention="sparse", device="cpu")
