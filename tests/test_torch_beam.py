"""The port's beam search against ``kubetpu.jobs.beam.make_beam_search`` on
the session's trained small model, f32: tokens equal and scores within
1e-4 for beam sizes 1-4, with and without EOS pinning and with the GNMT
length penalty; ``beam_size=1`` equal to greedy ``make_generate``; the
order among equal scores (the reference's ``lax.top_k`` lower-index-first
and stable final sort) on a model whose every logit ties."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubetpu.jobs import beam as jbeam
from kubetpu_torch.jobs import beam, decode
from kubetpu_torch.jobs import model as tmodel
from kubetpu_torch.jobs.convert import params_from_numpy
from torch_mesh_worlds import MeshStub

torch.set_num_threads(1)

SCORE_TOL = 1e-4        # f32 on both sides: summation order only
STEPS = 6


def port_cfg(jcfg):
    return tmodel.ModelConfig(
        vocab=jcfg.vocab, d_model=jcfg.d_model, n_layers=jcfg.n_layers,
        n_heads=jcfg.n_heads, d_ff=jcfg.d_ff, max_seq=jcfg.max_seq)


@pytest.fixture(scope="module")
def both(trained_small):
    """(jax cfg, jax params, port cfg, port model, prompt (3, 8) int64)."""
    jcfg, params, data = trained_small
    cfg = port_cfg(jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    prompt = np.asarray(data[1][0][:3, :8]).astype(np.int64)
    return jcfg, params, cfg, model, prompt


def _eos(prompt_tokens_model):
    """An EOS id the trained model actually emits within STEPS greedy steps
    of the first prompt, so that pinning happens."""
    cfg, model, prompt = prompt_tokens_model
    out = decode.make_generate(cfg)(model, torch.from_numpy(prompt), 0, STEPS)
    return int(out[0, prompt.shape[1] + 1])


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("variant", ["plain", "eos", "penalty"])
def test_beam_search_matches_the_reference(both, k, variant):
    jcfg, params, cfg, model, prompt = both
    kw = {}
    if variant == "eos":
        kw["eos_id"] = _eos((cfg, model, prompt))
    elif variant == "penalty":
        kw["length_penalty"] = 0.6
        kw["eos_id"] = _eos((cfg, model, prompt))
    jseq, jscores = jbeam.make_beam_search(jcfg, k, **kw)(
        params, jnp.asarray(prompt, jnp.int32), STEPS)
    seq, scores = beam.make_beam_search(cfg, k, device="cpu", **kw)(
        model, prompt, STEPS)
    assert seq.shape == (prompt.shape[0], k, prompt.shape[1] + STEPS)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               atol=SCORE_TOL, rtol=SCORE_TOL)
    s = scores.numpy()
    assert (np.diff(s, axis=1) <= 1e-6).all()           # best-first
    if "eos_id" in kw:
        gen = seq.numpy()[:, :, prompt.shape[1]:]
        for row in gen.reshape(-1, STEPS):
            hits = np.where(row == kw["eos_id"])[0]
            if hits.size:                       # pinned after the first EOS
                assert (row[hits[0]:] == kw["eos_id"]).all(), row


def test_beam_one_is_greedy(both):
    _jcfg, _params, cfg, model, prompt = both
    want = decode.make_generate(cfg)(model, torch.from_numpy(prompt), 0,
                                     STEPS)
    got, scores = beam.make_beam_search(cfg, 1, device="cpu")(
        model, torch.from_numpy(prompt), STEPS)
    assert torch.equal(got[:, 0], want)
    # the score is the teacher-forced sum of the chosen tokens' log-probs
    logits = tmodel.forward(model, got[:, 0, :-1], cfg)
    logp = torch.log_softmax(logits.float(), dim=-1)
    n = prompt.shape[1]
    picked = torch.gather(logp[:, n - 1:], 2, got[:, 0, n:, None])[..., 0]
    np.testing.assert_allclose(scores[:, 0].numpy(),
                               picked.sum(dim=1).numpy(), atol=SCORE_TOL,
                               rtol=SCORE_TOL)


@pytest.mark.parametrize("eos_id", [None, 2], ids=["no_eos", "eos"])
def test_equal_scores_break_ties_as_the_reference(both, eos_id):
    """Every logit of a model with a zero head ties, so every candidate of
    a step scores the same: the beams must pick the lower flat index first
    (beam 0's tokens 0..K-1) and keep that order in the final sort, as
    ``lax.top_k`` and the stable ``argsort`` do; with EOS among them the
    pinned beams' -1e30 continuations tie too."""
    jcfg, params, cfg, model, prompt = both
    jtree = jax.tree.map(np.asarray, params)
    jtree["head"] = np.zeros_like(jtree["head"])
    flat = params_from_numpy(jtree, cfg, device="cpu")
    k = 4
    jseq, jscores = jbeam.make_beam_search(jcfg, k, eos_id=eos_id)(
        jax.tree.map(jnp.asarray, jtree), jnp.asarray(prompt, jnp.int32), 5)
    seq, scores = beam.make_beam_search(cfg, k, eos_id=eos_id,
                                        device="cpu")(flat, prompt, 5)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               atol=SCORE_TOL, rtol=SCORE_TOL)
    if eos_id is None:
        # every step extends beam 0 with tokens 0..K-1: all four share its
        # lineage of token 0 and end in 0, 1, 2, 3
        n = prompt.shape[1]
        assert (seq[:, :, n:-1] == 0).all()
        assert seq[:, :, -1].tolist() == [[0, 1, 2, 3]] * prompt.shape[0]


def test_top_k_orders_ties_like_lax_top_k():
    rng = np.random.default_rng(0)
    flat = np.full((3, 40), -1e30, np.float32)
    flat[:, :8] = rng.integers(0, 3, (3, 8)).astype(np.float32) - 2.0
    flat = flat + np.float32(-1.5)           # -1e30 + x rounds to -1e30
    jv, ji = jax.lax.top_k(jnp.asarray(flat), 12)
    tv, ti = tmodel._top_k(torch.from_numpy(flat), 12)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_beam_refuses_what_it_cannot_run(both):
    _jcfg, _params, cfg, _model, _prompt = both
    with pytest.raises(ValueError, match="beam_size"):
        beam.make_beam_search(cfg, 0, device="cpu")
    # a mesh is taken; one whose tp does not divide the heads is refused
    with pytest.raises(ValueError, match="does not divide n_heads"):
        beam.make_beam_search(cfg, 2, mesh=MeshStub(tp=3), device="cpu")
