"""The port's batch speculative decoding (``make_speculative_generate``):
its output equals target-only greedy decoding for a random draft, a perfect
draft, a GQA target and gamma 1, and equals the JAX package's
``make_speculative_generate`` on trained weights."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubetpu.jobs import init_params as jax_init_params
from kubetpu.jobs.speculative import (
    make_speculative_generate as jax_speculative_generate)
from kubetpu_torch.jobs import model as tmodel
from kubetpu_torch.jobs.convert import params_from_numpy
from kubetpu_torch.jobs.decode import make_generate
from kubetpu_torch.jobs.speculative import (_scatter_rows,
                                            make_speculative_generate)

torch.set_num_threads(1)

TARGET = tmodel.ModelConfig(vocab=64, d_model=32, n_layers=3, n_heads=4,
                            d_ff=64)
DRAFT = tmodel.ModelConfig(vocab=64, d_model=16, n_layers=1, n_heads=2,
                           d_ff=32)


def _models(target_cfg, draft_cfg):
    t = tmodel.init_params(torch.Generator().manual_seed(0), target_cfg,
                           device="cpu")
    d = tmodel.init_params(torch.Generator().manual_seed(7), draft_cfg,
                           device="cpu")
    return t, d


def _prompt(cfg, b=2, s=5):
    rng = np.random.default_rng(1)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))


def _assert_matches_plain_greedy(target_cfg, draft_cfg, gamma, steps=9):
    t, d = _models(target_cfg, draft_cfg)
    prompt = _prompt(target_cfg)
    plain = make_generate(target_cfg)(t, prompt, 0, steps)
    spec, mean = make_speculative_generate(target_cfg, draft_cfg, gamma)(
        t, d, prompt, steps)
    assert spec.tolist() == plain.tolist()
    return mean


@pytest.mark.parametrize("case", ["random_draft", "gqa_target", "gamma1"])
def test_speculative_equals_greedy(case):
    """A draft that almost never agrees, a GQA target and gamma 1 all give
    the exact greedy output; every round emits at least one token."""
    if case == "random_draft":
        mean = _assert_matches_plain_greedy(TARGET, DRAFT, gamma=4)
    elif case == "gqa_target":
        mean = _assert_matches_plain_greedy(
            dataclasses.replace(TARGET, n_kv_heads=2), DRAFT, gamma=3)
    else:
        mean = _assert_matches_plain_greedy(TARGET, DRAFT, gamma=1)
    assert mean >= 1.0


def test_speculative_equals_greedy_perfect_draft():
    """Draft == target: the output is still the greedy sequence, and
    rounds emit several tokens (not exactly gamma+1: the draft decodes in
    one-token steps and verification is one chunk, so a random model's
    near-ties can flip under the other summation order)."""
    t, _ = _models(TARGET, DRAFT)
    prompt = _prompt(TARGET)
    plain = make_generate(TARGET)(t, prompt, 0, 8)
    spec, mean = make_speculative_generate(TARGET, TARGET, 4)(t, t, prompt, 8)
    assert spec.tolist() == plain.tolist()
    assert mean > 1.8


def test_scatter_rows_writes_only_valid_entries():
    out = torch.zeros((2, 5), dtype=torch.long)
    write_pos = torch.tensor([[0, 1, 4], [2, 4, 4]])
    values = torch.tensor([[7, 8, 9], [5, 6, 3]])
    valid = torch.tensor([[True, True, False], [True, False, False]])
    _scatter_rows(out, write_pos, values, valid)
    assert out.tolist() == [[7, 8, 0, 0, 0], [0, 0, 5, 0, 0]]


def test_speculative_equals_the_reference_on_trained_weights(trained_small):
    """The trained target with a seed-7 random draft: the port's tokens
    equal the JAX package's."""
    jcfg, params, data = trained_small
    jdraft = dataclasses.replace(jcfg, d_model=32, n_layers=1, n_heads=2,
                                 d_ff=64)
    dparams = jax_init_params(jax.random.PRNGKey(7), jdraft)
    prompt = np.asarray(data[0][0][:2, :10]).astype(np.int64)
    want, _ = jax_speculative_generate(jcfg, jdraft, 4)(
        params, dparams, jnp.asarray(prompt), 12)

    def port(cfg, tree):
        pcfg = tmodel.ModelConfig(vocab=cfg.vocab, d_model=cfg.d_model,
                                  n_layers=cfg.n_layers, n_heads=cfg.n_heads,
                                  d_ff=cfg.d_ff, max_seq=cfg.max_seq)
        return pcfg, params_from_numpy(jax.tree.map(np.asarray, tree), pcfg,
                                       device="cpu")

    (tcfg, t), (dcfg, d) = port(jcfg, params), port(jdraft, dparams)
    got, mean = make_speculative_generate(tcfg, dcfg, 4)(
        t, d, torch.from_numpy(prompt), 12)
    assert got.tolist() == np.asarray(want).tolist()
    assert mean >= 1.0


def test_vocab_mismatch_is_refused():
    with pytest.raises(ValueError, match="vocabulary"):
        make_speculative_generate(TARGET,
                                  dataclasses.replace(DRAFT, vocab=32))
