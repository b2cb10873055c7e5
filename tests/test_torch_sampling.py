"""The port's static samplers against the JAX package's
(``kubetpu/jobs/sampling.py:31-83``, oracle ``tests/test_sampling.py``):
``apply_top_k`` / ``apply_top_p`` masks equal the reference's, greedy is the
exact argmax (first index on ties), and sampled draws from an explicit
``torch.Generator`` are reproducible and stay inside the filtered support
(the port is not held to ``jax.random``'s stream)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubetpu.jobs import sampling as jsampling
from kubetpu_torch.jobs import sampling as tsampling

torch.set_num_threads(1)


def _logits(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("k", [1, 2, 5, 50, 80])
def test_top_k_masks_equal_the_reference(k):
    x = _logits((4, 3, 50))
    x[0, 0, :4] = x[0, 0, 0]                       # a tie at the threshold
    want = np.asarray(jsampling.apply_top_k(jnp.asarray(x), k))
    got = tsampling.apply_top_k(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [0.01, 0.3, 0.8, 0.95, 1.0])
def test_top_p_masks_equal_the_reference(p):
    x = _logits((4, 3, 50), seed=1) * 3.0
    want = np.asarray(jsampling.apply_top_p(jnp.asarray(x), p))
    got = tsampling.apply_top_p(torch.from_numpy(x), p).numpy()
    np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
    np.testing.assert_array_equal(got, want)


def test_top_k_masks_below_threshold():
    masked = tsampling.apply_top_k(torch.tensor([5.0, 4.0, 3.0, 2.0, 1.0]), 2)
    assert masked[0] == 5.0 and masked[1] == 4.0
    assert all(m <= -1e29 for m in masked[2:])


def test_top_p_keeps_nucleus_and_boundary_token():
    logits = torch.log(torch.tensor([0.60, 0.30, 0.06, 0.03, 0.01]))
    masked = tsampling.apply_top_p(logits, 0.8)
    assert masked[0] > -1e29 and masked[1] > -1e29
    assert all(m <= -1e29 for m in masked[2:])
    assert torch.equal(tsampling.apply_top_p(logits, 1.0), logits)


def test_greedy_is_the_exact_argmax_first_index_on_ties():
    x = _logits((6, 40), seed=2)
    x[1, [3, 9]] = x[1].max() + 1.0                # tie: index 3 wins
    x[2, :] = 0.0                                  # all tied: index 0
    want = np.asarray(jsampling.make_sampler(0.0)(jnp.asarray(x),
                                                  jax.random.PRNGKey(0)))
    got = tsampling.make_sampler(0.0)(torch.from_numpy(x), None)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[1]) == 3 and int(got[2]) == 0
    # the filters are irrelevant to greedy
    got = tsampling.make_sampler(0.0, top_k=2, top_p=0.5)(
        torch.from_numpy(x), _gen(0))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_draws_are_seeded_and_stay_in_support():
    logits = torch.tensor([2.0, 1.9, 1.8, -1.0, -2.0, -3.0])
    sample = tsampling.make_sampler(1.0, top_k=3)
    draws = {int(sample(logits, _gen(i))) for i in range(200)}
    assert draws <= {0, 1, 2} and len(draws) > 1
    spiked = tsampling.make_sampler(1.0, top_p=0.01)
    assert {int(spiked(torch.tensor([10.0, 0.0, -5.0]), _gen(i)))
            for i in range(50)} == {0}
    x = torch.from_numpy(_logits((4, 7, 32), seed=3))
    both = tsampling.make_sampler(0.7, top_k=5, top_p=0.9)
    a, b = both(x, _gen(4)), both(x, _gen(4))
    assert a.shape == (4, 7) and torch.equal(a, b)
    # every draw is inside the reference's filtered support
    keep = np.asarray(jsampling.apply_top_p(jsampling.apply_top_k(
        jnp.asarray(x.numpy()) / 0.7, 5), 0.9)) > -1e29
    assert np.take_along_axis(keep, a.numpy()[..., None], -1).all()


def test_per_row_filters_match_static_filters():
    x = torch.from_numpy(_logits((4, 16), seed=5))
    np.testing.assert_array_equal(
        tsampling.apply_top_k_rows(x, torch.full((4,), 3)).numpy(),
        tsampling.apply_top_k(x, 3).numpy())
    np.testing.assert_allclose(
        tsampling.apply_top_p_rows(x, torch.full((4,), 0.7)).numpy(),
        tsampling.apply_top_p(x, 0.7).numpy(), rtol=1e-6)


def test_invalid_params_rejected():
    with pytest.raises(ValueError):
        tsampling.make_sampler(-1.0)
    with pytest.raises(ValueError):
        tsampling.apply_top_k(torch.zeros(3), 0)
    with pytest.raises(ValueError):
        tsampling.apply_top_p(torch.zeros(3), 0.0)
