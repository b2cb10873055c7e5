"""The other families' sharded steps in the port, in one 8-rank gloo world
on the CPU, against the JAX package's steps from the same weights and
batches (f32 on both sides; the JAX steps on conftest's virtual devices
with their dense cores, the port's flash cores their plain versions):

- the masked-LM encoder on {dp 2, sp 2, tp 2} (the batch on dp only, the
  sequence replicated over sp, the flash core at the rank's heads);
- the ViT on {dp 4, tp 2} (the ViT's own leaves replicated);
- the encoder-decoder on {dp 2, sp 2, tp 2} with ``accum_steps`` 2 (the
  source and target on sp: the encoder and the cross branch through the
  non-causal ring, the decoder through the causal one);
- distillation of a one-layer draft on {dp 2, sp 2, tp 2} (the flash
  ring; the draft's vocab shards gathered for the soft cross-entropy),
  against the JAX package's one-device step;
- beam search on ``trained_small`` on {dp 2, tp 4}, from the whole model
  and from its shard, against JAX's ``make_beam_search(mesh=)`` on
  {dp 2, tp 2}.

Each step's two losses are held within LOSS_RTOL, each weight's change
over the two steps within MESH_UPDATE_TOL of JAX's
(``test_torch_encoder.assert_updates_match``), and the gradient the step
hands its optimizer and ``GradSync.sq_norm`` within GRAD_TOL of
``jax.grad`` and ``optax.global_norm``; the encoder's gradient summed
over sp as well (the planted fault) reads sp times the norm. Every
sharded init (``init_state``, the pipeline's, the ViT's, the seq2seq's,
``params_from_hf``) equals cutting the whole model of its seed bit for
bit, and servers built from ``init_shard``'s shard emit the tokens of
servers built from the whole model."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubetpu.jobs import beam as jbeam
from kubetpu.jobs import distill as jdistill
from kubetpu.jobs import encoder as jenc
from kubetpu.jobs import model as jmodel
from kubetpu.jobs import seq2seq as js2s
from kubetpu.jobs import train as jtrain
from kubetpu.jobs import vision as jvit
from kubetpu.jobs.meshjob import make_mesh

from test_torch_encoder import STEP_LR, assert_updates_match
from test_torch_sharded_train import (GRAD_TOL, LOSS_RTOL,
                                      MESH_UPDATE_TOL)
from torch_mesh_worlds import spawn

torch.set_num_threads(1)

KW = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
          d_ff=64, max_seq=64)
MESH3 = {"dp": 2, "sp": 2, "tp": 2}
VIT_MESH = {"dp": 4, "tp": 2}
BEAM_MESH = {"dp": 2, "tp": 4}
MASK_ID = 63
VIT = dict(image_size=16, patch_size=4, channels=3, n_classes=10,
           model=dict(d_model=32, n_layers=2, n_heads=4, d_ff=64))
S2S = dict(KW, vocab=32)
DRAFT = dict(KW, n_layers=1)
DISTILL = dict(temperature=2.0, hard_weight=0.5)
BEAM = [dict(k=3, kw={}), dict(k=2, kw={"length_penalty": 0.6,
                                        "eos_id": 5})]
BEAM_STEPS = 6
SEED = 3
FAMILIES = ["mlm", "vit", "seq2seq", "distill"]


def _rng(seed):
    return np.random.default_rng(seed)


def _tree(x):
    return jax.tree.map(np.asarray, x)


def _mlm_batches():
    rng = _rng(11)
    return [(rng.integers(0, MASK_ID, (4, 16)),
             rng.random((4, 16)) < 0.3) for _ in range(2)]


def _vit_batches():
    rng = _rng(12)
    return [(rng.standard_normal((8, 16, 16, 3)).astype(np.float32),
             rng.integers(0, 10, (8,))) for _ in range(2)]


def _s2s_batches():
    rng = _rng(13)
    out = []
    for _ in range(2):
        src = rng.integers(2, S2S["vocab"], (8, 16))
        tgt = rng.integers(2, S2S["vocab"], (8, 16))
        out.append((src, np.concatenate([np.ones((8, 1), np.int64),
                                         tgt[:, :-1]], axis=1), tgt))
    return out


def _lm_batches():
    rng = _rng(14)
    out = []
    for _ in range(2):
        tok = rng.integers(0, KW["vocab"], (4, 16))
        out.append((tok, np.roll(tok, -1, axis=1)))
    return out


def _jcfg(kw):
    return jmodel.ModelConfig(**kw)


def _jvit_cfg():
    kw = dict(VIT)
    return jvit.VitConfig(model=jmodel.ModelConfig(**kw.pop("model")), **kw)


def _hf_state_dict(cfg_kw):
    """A random llama-layout state dict of *cfg_kw*'s shapes."""
    rng = _rng(15)
    d, h, kv, f, v = (cfg_kw["d_model"], cfg_kw["n_heads"],
                      cfg_kw["n_kv_heads"], cfg_kw["d_ff"], cfg_kw["vocab"])
    hd = d // h

    def w(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    sd = {"model.embed_tokens.weight": w(v, d), "model.norm.weight": w(d),
          "lm_head.weight": w(v, d)}
    for i in range(cfg_kw["n_layers"]):
        p = f"model.layers.{i}."
        sd.update({p + "input_layernorm.weight": w(d),
                   p + "post_attention_layernorm.weight": w(d),
                   p + "self_attn.q_proj.weight": w(h * hd, d),
                   p + "self_attn.k_proj.weight": w(kv * hd, d),
                   p + "self_attn.v_proj.weight": w(kv * hd, d),
                   p + "self_attn.o_proj.weight": w(d, h * hd),
                   p + "mlp.gate_proj.weight": w(f, d),
                   p + "mlp.up_proj.weight": w(f, d),
                   p + "mlp.down_proj.weight": w(d, f)})
    return sd


@pytest.fixture(scope="module")
def weights(trained_small):
    jcfg, jparams, data = trained_small
    return {
        "mlm": _tree(jmodel.init_params(jax.random.PRNGKey(SEED),
                                        _jcfg(KW))),
        "vit": _tree(jvit.init_vit_params(jax.random.PRNGKey(SEED),
                                          _jvit_cfg())),
        "seq2seq": _tree(js2s.init_seq2seq_params(jax.random.PRNGKey(SEED),
                                                  _jcfg(S2S))),
        "target": _tree(jmodel.init_params(jax.random.PRNGKey(SEED),
                                           _jcfg(KW))),
        "draft": _tree(jmodel.init_params(jax.random.PRNGKey(SEED + 1),
                                          _jcfg(DRAFT))),
        "beam": (jcfg, jparams,
                 np.asarray(data[1][0][:4, :8]).astype(np.int64)),
    }


def _beam_kw(jcfg):
    return dict(vocab=jcfg.vocab, d_model=jcfg.d_model,
                n_layers=jcfg.n_layers, n_heads=jcfg.n_heads, d_ff=jcfg.d_ff,
                max_seq=jcfg.max_seq)


@pytest.fixture(scope="module")
def world(weights, tmp_path_factory):
    opt = {"lr": STEP_LR}
    cases = [
        dict(kind="mlm", cfg=KW, mesh=MESH3, params=weights["mlm"],
             opt=opt, attention="flash", mask_id=MASK_ID,
             batches=_mlm_batches()),
        dict(kind="vit", cfg=VIT, mesh=VIT_MESH, params=weights["vit"],
             opt=opt, attention="flash", batches=_vit_batches()),
        dict(kind="seq2seq", cfg=S2S, mesh=MESH3,
             params=weights["seq2seq"], opt=opt, accum_steps=2,
             batches=_s2s_batches()),
        dict(kind="distill", tcfg=KW, dcfg=DRAFT, mesh=MESH3,
             target=weights["target"], draft=weights["draft"], opt=opt,
             batches=_lm_batches(), **DISTILL)]
    jcfg, jparams, prompt = weights["beam"]
    for b in BEAM:
        cases.append(dict(kind="beam", cfg=_beam_kw(jcfg), mesh=BEAM_MESH,
                          params=_tree(jparams), prompt=prompt,
                          steps=BEAM_STEPS, **b))
    cases.append(dict(
        kind="init", seed=SEED,
        models=[("dense", KW, MESH3, False),
                ("dense_bf16", dict(KW, dtype=torch.bfloat16), MESH3, False),
                ("moe_ep", dict(KW, n_experts=4, moe_top_k=2,
                                moe_capacity_factor=2.0),
                 {"dp": 2, "ep": 2, "tp": 2}, False),
                ("pp", KW, {"dp": 2, "pp": 2, "tp": 2}, True)],
        vit=VIT, vit_mesh=VIT_MESH, seq2seq=S2S, seq2seq_mesh=MESH3,
        hf_cfg=KW, hf_mesh=VIT_MESH, hf_sd=_hf_state_dict(KW)))
    cases.append(dict(kind="server", cfg=KW, mesh={"dp": 4, "tp": 2},
                      seed=SEED, kw=dict(n_slots=2, max_seq=64,
                                         max_new_tokens=6),
                      prompts=[[1, 2, 3, 4, 5], [7, 8, 9], [1, 2, 3, 4, 6]]))
    res = spawn("families", 8, tmp_path_factory.mktemp("families"),
                {"cases": cases}, timeout=300)
    assert all(r["foreign"] == [] for r in res)
    return [r["cases"] for r in res]


# -- the JAX references -------------------------------------------------------


def _jax_mlm(params):
    jcfg = _jcfg(KW)
    mesh = make_mesh(MESH3)
    state, tx = jtrain.init_state(jax.random.PRNGKey(0), jcfg, mesh,
                                  optimizer=jtrain.make_optimizer(
                                      lr=STEP_LR))
    state = state._replace(params=jax.tree.map(jnp.asarray, params))
    step = jenc.make_mlm_train_step(jcfg, mesh, MASK_ID, optimizer=tx)

    def loss(p, tokens, mask):
        return jenc.masked_lm_loss(p, tokens, mask, MASK_ID, jcfg)

    return state, step, jax.jit(jax.grad(loss)), _mlm_batches()


def _jax_vit(params):
    jcfg = _jvit_cfg()
    mesh = make_mesh(VIT_MESH)
    state, tx = jvit.init_vit_state(jax.random.PRNGKey(0), jcfg, mesh,
                                    optimizer=jtrain.make_optimizer(
                                        lr=STEP_LR))
    state = state._replace(params=jax.tree.map(jnp.asarray, params))
    step = jvit.make_vit_train_step(jcfg, mesh, optimizer=tx)

    def loss(p, images, labels):
        return jvit.vit_loss(p, images, labels, jcfg)

    return state, step, jax.jit(jax.grad(loss)), _vit_batches()


def _jax_seq2seq(params):
    jcfg = _jcfg(S2S)
    mesh = make_mesh(MESH3)
    state, tx = js2s.init_seq2seq_state(jax.random.PRNGKey(0), jcfg, mesh,
                                        optimizer=jtrain.make_optimizer(
                                            lr=STEP_LR))
    state = state._replace(params=jax.tree.map(jnp.asarray, params))
    step = js2s.make_seq2seq_train_step(jcfg, mesh, optimizer=tx,
                                        accum_steps=2)

    def loss(p, src, tgt_in, tgt_out):
        return js2s.seq2seq_loss(p, src, tgt_in, tgt_out, jcfg)

    return state, step, jax.jit(jax.grad(loss)), _s2s_batches()


def _jax_distill(weights):
    tcfg, dcfg = _jcfg(KW), _jcfg(DRAFT)
    target = jax.tree.map(jnp.asarray, weights["target"])
    tx = jtrain.make_optimizer(lr=STEP_LR)
    state = jdistill.init_draft_state(
        jax.random.PRNGKey(0), dcfg, tx,
        init_params=jax.tree.map(jnp.asarray, weights["draft"]))
    jstep, _ = jdistill.make_distill_step(tcfg, dcfg, tx, **DISTILL)

    def loss(p, tokens, targets):
        t_logits = jmodel.forward(target, tokens, tcfg)
        return jdistill.distill_loss(dcfg, p, t_logits, tokens, targets,
                                     **DISTILL)

    def step(state, tokens, targets):
        return jstep(state, target, tokens, targets)

    return state, step, jax.jit(jax.grad(loss)), _lm_batches()


@pytest.fixture(scope="module")
def jax_runs(weights):
    """family -> (the JAX step's two losses, its weights after them, the
    gradient at each step's weights), each run once."""
    cache = {}

    def get(name):
        if name not in cache:
            if name == "distill":
                state, step, grad, batches = _jax_distill(weights)
            else:
                state, step, grad, batches = globals()[f"_jax_{name}"](
                    weights[name])
            losses, grads = [], []
            for batch in batches:
                batch = [jnp.asarray(x) for x in batch]
                grads.append(_tree(grad(state.params, *batch)))
                state, loss = step(state, *batch)
                losses.append(float(loss))
            cache[name] = (losses, _tree(state.params), grads)
        return cache[name]

    return get


def _initial(weights, name):
    return weights["draft" if name == "distill" else name]


@pytest.mark.parametrize("name", FAMILIES)
def test_sharded_family_step_matches_jax(world, weights, jax_runs, name):
    """Both steps' losses, on every rank the global one, and each weight's
    change over the two steps against the JAX step's."""
    i = FAMILIES.index(name)
    want_losses, want_params, jgrads = jax_runs(name)
    got = world[0][i]
    for r in world:
        assert r[i]["losses"] == got["losses"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
    init = _initial(weights, name)
    assert_updates_match(init, got["params"], init, want_params, jgrads,
                         MESH_UPDATE_TOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_sharded_family_gradient_and_norm_match_jax(world, jax_runs, name):
    """The gradient the sharded step hands its optimizer (the ranks' parts
    summed over the family's data axes) against ``jax.grad`` of the JAX
    loss on the whole first batch, and ``GradSync.sq_norm``'s norm against
    ``optax.global_norm``, on every rank."""
    i = FAMILIES.index(name)
    want = jax_runs(name)[2][0]
    want_norm = float(optax.global_norm(want))

    def check(path, g, w):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))

    jax.tree_util.tree_map_with_path(check, world[0][i]["probe"]["grads"],
                                     want)
    for r in world:
        assert r[i]["probe"]["norm"] == pytest.approx(want_norm,
                                                      rel=GRAD_TOL)


def test_encoder_gradient_summed_over_sp_reads_sp_times(world, jax_runs):
    """The planted fault of the encoder's gate: a ``GradSync`` over dp x
    sp (the decoder's) counts each token sp times, so its norm is sp times
    the sound one."""
    want_norm = float(optax.global_norm(jax_runs("mlm")[2][0]))
    for r in world:
        assert r[0]["fault_norm"] == pytest.approx(
            MESH3["sp"] * want_norm, rel=GRAD_TOL)


@pytest.mark.parametrize("b", range(len(BEAM)))
def test_meshed_beam_matches_jax(world, weights, b):
    """The meshed search's sequences equal JAX's meshed search's and its
    scores within test_torch_beam's tolerance, from the whole model and
    from its shard alike, on every rank."""
    from test_torch_beam import SCORE_TOL

    jcfg, jparams, prompt = weights["beam"]
    case = BEAM[b]
    search = jbeam.make_beam_search(jcfg, case["k"],
                                    mesh=make_mesh({"dp": 2, "tp": 2}),
                                    **case["kw"])
    jseq, jscores = search(_tree(jparams), jnp.asarray(prompt), BEAM_STEPS)
    for r in world:
        for got in r[len(FAMILIES) + b].values():
            np.testing.assert_array_equal(got["seq"], np.asarray(jseq))
            np.testing.assert_allclose(got["scores"], np.asarray(jscores),
                                       rtol=SCORE_TOL, atol=SCORE_TOL)


def test_sharded_inits_equal_cutting_the_whole_model(world):
    """Every rank's shard drawn leaf by leaf equals, bit for bit, its cut
    of the whole model of the same seed (dense f32 and bf16, MoE over ep,
    a pipeline stage, the ViT, the seq2seq, an imported llama state dict),
    and ``shard_model`` of a shard returns it as it is."""
    i = len(FAMILIES) + len(BEAM)
    for r in world:
        got = r[i]
        for name, res in got.items():
            assert res["differ"] == [], (name, res["differ"])
            assert res.get("differ_cut", []) == [], name
            assert res.get("kept", True), name


def test_servers_built_from_a_shard_emit_the_whole_models_tokens(world):
    """The paged and the dense server built from ``init_shard``'s shard
    emit the tokens of the same servers built from the whole model of the
    seed (which they cut), on every rank."""
    i = len(FAMILIES) + len(BEAM) + 1
    for r in world:
        got = r[i]
        for kind in ("paged", "dense"):
            assert got[f"{kind}_shard"] == got[f"{kind}_whole"], kind
            assert all(len(t) > 0 for t in got[f"{kind}_shard"])
