"""The port's dense KV-cache path against the JAX package's: prefill logits
and caches (f32 and int8) within 1e-4, the chunk forward at per-row
positions against sequential one-token steps, and ``make_generate``'s
greedy tokens equal to ``kubetpu.jobs.decode.make_generate``'s on trained
weights, f32 and int8 caches, at window 0 and window 8."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubetpu.jobs import decode as jdecode
from kubetpu_torch.jobs import decode
from kubetpu_torch.jobs import model as tmodel
from kubetpu_torch.jobs.convert import params_from_numpy

torch.set_num_threads(1)


def port_cfg(jcfg, **over):
    return tmodel.ModelConfig(
        vocab=jcfg.vocab, d_model=jcfg.d_model, n_layers=jcfg.n_layers,
        n_heads=jcfg.n_heads, d_ff=jcfg.d_ff, max_seq=jcfg.max_seq, **over)


@pytest.fixture(scope="module")
def both(trained_small):
    """(jax cfg, jax params, port cfg, port model, prompt (2, 10) int)."""
    jcfg, params, data = trained_small
    cfg = port_cfg(jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    prompt = np.asarray(data[0][0][:2, :10]).astype(np.int64)
    return jcfg, params, cfg, model, prompt


def _flat(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in _flat(t)]
    return [tree]


@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32", "int8"])
def test_prefill_logits_and_cache_match_the_reference(both, kv_int8):
    jcfg, params, cfg, model, prompt = both
    s_max = 16
    if kv_int8:
        jcache = jdecode.init_kv_cache_int8(jcfg, 2, s_max)
        jlogits, jcache = jdecode.prefill_int8(jcfg, params,
                                               jnp.asarray(prompt), jcache)
        cache = decode.init_kv_cache_int8(cfg, 2, s_max, device="cpu")
        logits, cache = decode.prefill_int8(cfg, model,
                                            torch.from_numpy(prompt), cache)
    else:
        jlogits, *jcache = jdecode.prefill(
            jcfg, params, jnp.asarray(prompt),
            *jdecode.init_kv_cache(jcfg, 2, s_max))
        logits, *cache = decode.prefill(
            cfg, model, torch.from_numpy(prompt),
            *decode.init_kv_cache(cfg, 2, s_max, device="cpu"))
        jcache, cache = tuple(jcache), tuple(cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)
    for got, want in zip(_flat(cache), _flat(jcache)):
        want = np.asarray(want)
        assert got.shape == want.shape
        if got.dtype == torch.int8:
            # the two frameworks' K/V agree to ~1e-6, so a value at a
            # rounding tie may quantize one step apart
            assert np.abs(got.numpy().astype(int) - want).max() <= 1
        else:
            np.testing.assert_allclose(got.numpy(), want, atol=1e-4,
                                       rtol=1e-4)


def test_forward_chunk_at_matches_sequential_decode():
    """A T-token chunk at per-row positions equals T one-token steps (the
    port of ``tests/test_speculative.py``'s chunk test), and rows at
    different positions equal each row's own forward at its offset."""
    cfg = tmodel.ModelConfig(vocab=64, d_model=32, n_layers=3, n_heads=4,
                             n_kv_heads=2, d_ff=64)
    model = tmodel.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 6)))
    extra = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 3)))

    k1, v1 = decode.init_kv_cache(cfg, 2, 16, device="cpu")
    decode.prefill(cfg, model, prompt, k1, v1)
    chunk_logits, k1, v1 = decode.forward_chunk(cfg, model, extra, k1, v1, 6)

    k2, v2 = decode.init_kv_cache(cfg, 2, 16, device="cpu")
    decode.prefill(cfg, model, prompt, k2, v2)
    pos = torch.full((2,), 6, dtype=torch.int32)
    seq = []
    for t in range(3):
        lg, k2, v2 = decode.forward_chunk_at(cfg, model, extra[:, t:t + 1],
                                             k2, v2, pos + t)
        seq.append(lg[:, 0])
    torch.testing.assert_close(chunk_logits, torch.stack(seq, 1), atol=2e-5,
                               rtol=2e-4)
    torch.testing.assert_close(k1, k2, atol=1e-6, rtol=1e-5)

    # per-row offsets: row b at position 6 + b
    k3, v3 = decode.init_kv_cache(cfg, 2, 16, device="cpu")
    decode.prefill(cfg, model, prompt, k3, v3)
    lg, k3, v3 = decode.forward_chunk_at(cfg, model, extra[:, :1], k3, v3,
                                         torch.tensor([6, 5]))
    for b, p in ((0, 6), (1, 5)):
        kb, vb = decode.init_kv_cache(cfg, 1, 16, device="cpu")
        decode.prefill(cfg, model, prompt[b:b + 1], kb, vb)
        want, kb, _ = decode.forward_chunk(cfg, model, extra[b:b + 1, :1],
                                           kb, vb, p)
        torch.testing.assert_close(lg[b], want[0], atol=2e-5, rtol=2e-4)
        torch.testing.assert_close(k3[:, b, :p + 1], kb[:, 0, :p + 1])


def test_chunk_write_past_the_cache_end_clamps_like_the_reference():
    """A chunk that would run past S_max lands at S_max - T, as
    ``lax.dynamic_update_slice`` clamps it, for an int and a per-row
    position."""
    cache = torch.zeros((2, 8, 1, 1))
    new = torch.ones((2, 3, 1, 1))
    decode._write_at(cache, new, 7)
    assert cache[:, 5:].eq(1).all() and cache[:, :5].eq(0).all()
    cache.zero_()
    decode._write_at(cache, new, torch.tensor([7, 1]))
    assert cache[0, 5:].eq(1).all() and cache[0, :5].eq(0).all()
    assert cache[1, 1:4].eq(1).all() and cache[1, 4:].eq(0).all()


@pytest.mark.parametrize("window", [0, 8], ids=["w0", "w8"])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32", "int8"])
def test_make_generate_greedy_equals_the_reference(both, kv_int8, window):
    jcfg, params, _cfg, model, prompt = both
    jcfg = dataclasses.replace(jcfg, window=window)
    cfg = port_cfg(jcfg, window=window)
    want = jdecode.make_generate(jcfg, kv_int8=kv_int8)(
        params, jnp.asarray(prompt), jax.random.PRNGKey(0), 12)
    got = decode.make_generate(cfg, kv_int8=kv_int8)(
        model, torch.from_numpy(prompt), 0, 12)
    assert got.tolist() == np.asarray(want).tolist()


def test_make_generate_seeded_is_request_deterministic(both):
    """Seeded sampling: the same seed draws the same tokens, another seed
    other tokens, and row b's draws do not depend on the batch."""
    _jcfg, _params, cfg, model, prompt = both
    gen = decode.make_generate(cfg, temperature=3.0, top_k=40, top_p=0.99)
    p = torch.from_numpy(prompt)
    a, b = gen(model, p, 3, 10), gen(model, p, 3, 10)
    assert a.tolist() == b.tolist()
    assert gen(model, p, 4, 10).tolist() != a.tolist()
    assert gen(model, p[:1], 3, 10).tolist() == a[:1].tolist()
    greedy = decode.make_generate(cfg)(model, p, 3, 10)
    assert greedy.tolist() != a.tolist()
