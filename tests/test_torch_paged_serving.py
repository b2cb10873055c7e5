"""The port's paged server against the JAX package's: greedy tokens equal
on trained weights over {f32 pool, kv_int8} x {monolithic, chunked
prefill}, with the pool oracle checked after every drain; within the port,
chunked output equals monolithic output under seeded sampling, and pool
exhaustion parks a request without corrupting it."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from kubetpu.jobs.paged import PagedDecodeServer as JaxPagedServer
from kubetpu_torch.jobs import model as tmodel
from kubetpu_torch.jobs.convert import params_from_numpy
from kubetpu_torch.jobs.decode import forward_chunk_io
from kubetpu_torch.jobs.paged import PagedDecodeServer, _paged_prefill_io
from kubetpu_torch.jobs.paged import init_page_pool
from kubetpu_torch.ops.paged_attention import paged_attention_chunk

torch.set_num_threads(1)

# staggered lengths: one page, several pages, a page boundary mid-decode
PROMPTS = [[3, 14, 15, 9, 2, 6], [26, 5, 1, 7] * 5,
           [35, 8, 9, 7, 9, 3, 2, 1, 4, 11, 12, 13, 14, 15, 16, 17, 18]]


def port_cfg(jcfg):
    return tmodel.ModelConfig(
        vocab=jcfg.vocab, d_model=jcfg.d_model, n_layers=jcfg.n_layers,
        n_heads=jcfg.n_heads, d_ff=jcfg.d_ff, max_seq=jcfg.max_seq)


@pytest.fixture(scope="module")
def both(trained_small):
    """(jax cfg, jax params, port cfg, port model) on the same weights."""
    jcfg, params, _data = trained_small
    cfg = port_cfg(jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    return jcfg, params, cfg, model


def staggered(server, chunked):
    """The lifecycle of test_paged's parity test: a starts, one step, b
    joins, drain, c alone, drain; the pool oracle after every drain."""
    admit = server.enqueue if chunked else server.submit
    ra = admit(PROMPTS[0])
    server.step()
    rb = admit(PROMPTS[1])
    server.drain()
    server.check_invariants()
    rc = admit(PROMPTS[2])
    server.drain()
    server.check_invariants()
    assert server.pages_in_use() == 0
    return [server.result(r) for r in (ra, rb, rc)]


@pytest.mark.parametrize("budget", [0, 8], ids=["monolithic", "chunked"])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32", "int8"])
def test_greedy_tokens_equal_the_jax_server(both, kv_int8, budget):
    jcfg, params, cfg, model = both
    kw = dict(n_slots=2, max_seq=64, max_new_tokens=12, page_size=8,
              kv_int8=kv_int8, prefill_budget=budget)
    ref = staggered(JaxPagedServer(jcfg, params, **kw), budget > 0)
    out = staggered(PagedDecodeServer(cfg, model, device="cpu", **kw),
                    budget > 0)
    assert out == ref


def test_chunked_equals_monolithic_under_seeded_sampling(both):
    _, _, cfg, model = both
    sampling = {"temperature": 0.9, "top_k": 20, "top_p": 0.95}
    outs = []
    for budget in (0, 8):
        server = PagedDecodeServer(cfg, model, n_slots=2, max_seq=64,
                                   max_new_tokens=10, page_size=8,
                                   prefill_budget=budget, seed=5,
                                   device="cpu")
        rids = [server.enqueue(p, sampling=sampling) for p in PROMPTS]
        server.drain()
        server.check_invariants()
        outs.append([server.pop_result(r) for r in rids])
    assert outs[0] == outs[1]
    greedy = PagedDecodeServer(cfg, model, n_slots=2, max_seq=64,
                               max_new_tokens=10, page_size=8, device="cpu")
    rids = [greedy.enqueue(p) for p in PROMPTS]
    greedy.drain()
    assert [greedy.result(r) for r in rids] != outs[0]


def test_pool_exhaustion_parks_without_corruption(both):
    """A pool with room for one worst case: b waits (submit None, then
    queued) until a retires, then decodes to a quiet run's tokens."""
    _, _, cfg, model = both
    server = PagedDecodeServer(cfg, model, n_slots=2, max_seq=64,
                               max_new_tokens=8, page_size=8, n_pages=3,
                               device="cpu")
    pa, pb = [7, 8, 9, 1], [11, 12, 13]
    ra = server.submit(pa)
    assert ra is not None
    assert server.submit(pb) is None
    rb = server.enqueue(pb)
    assert rb not in server.step()
    assert server.load_info()["queue_depth"] == 1
    server.drain()
    server.check_invariants()
    assert server.finished(ra) and server.finished(rb)
    for rid, p in ((ra, pa), (rb, pb)):
        quiet = PagedDecodeServer(cfg, model, n_slots=1, max_seq=64,
                                  max_new_tokens=8, page_size=8,
                                  device="cpu")
        q = quiet.submit(p)
        quiet.drain()
        assert server.result(rid) == quiet.result(q)
    with pytest.raises(ValueError, match="pool"):
        server.enqueue([1] * 20)


def test_lifecycle_surface(both):
    """cancel, pop_result, logprobs, load_info and the window refusal."""
    _, _, cfg, model = both
    server = PagedDecodeServer(cfg, model, n_slots=1, max_seq=64,
                               max_new_tokens=6, page_size=8, device="cpu")
    ra = server.enqueue(PROMPTS[0])
    rb = server.enqueue(PROMPTS[1])
    assert server.cancel(rb)
    server.drain()
    assert server.finished(rb) and server.result(rb) == PROMPTS[1]
    lps = server.result_logprobs(ra)
    assert len(lps) == 6 and all(lp <= 0.0 for lp in lps)
    info = server.load_info()
    assert info["pages_in_use"] == 0 and info["pages_free"] == \
        info["pool_pages"]
    assert server.pop_result(ra)[:6] == PROMPTS[0]
    with pytest.raises(KeyError):
        server.pop_result(ra)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PagedDecodeServer(dataclasses.replace(cfg, window=8), model,
                          device="cpu")


@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32", "int8"])
def test_prefill_io_kernel_and_gather_branches_agree(both, kv_int8):
    """Both branches of the paged prefill strategy: the same chunk logits
    and the same pool bytes, over a chunk that resumes after an earlier
    one and a pad-only page that must be dropped."""
    _, _, cfg, model = both
    ps = 8
    tokens = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab, (1, 24)))
    row = torch.tensor([5, 2, 7, 0, -1, -1, -1, -1], dtype=torch.int32)
    results = []
    for attend_chunk in (None, paged_attention_chunk):
        pools = init_page_pool(cfg, 9, ps, kv_int8=kv_int8, device="cpu")
        first = _paged_prefill_io(torch.tensor([5, 2]), row[:2], ps, 0,
                                  attend_chunk)
        forward_chunk_io(cfg, model, tokens[:, :16], pools, 0, first)
        # 8 real tokens + a pad-only page (sentinel 9 = the pool size)
        chunk = torch.cat(
            [tokens[:, 16:], torch.zeros(1, 8, dtype=torch.long)], dim=1)
        io = _paged_prefill_io(torch.tensor([7, 9]), row[:4], ps, 0,
                               attend_chunk)
        logits, _ = forward_chunk_io(cfg, model, chunk, pools, 16, io)
        results.append((logits[0, :8], pools))
    (la, pa), (lb, pb) = results
    torch.testing.assert_close(la, lb, atol=1e-4, rtol=1e-4)

    def flat(pools):
        return [t for x in pools
                for t in (x if isinstance(x, tuple) else (x,))]

    for a, b in zip(flat(pa), flat(pb)):
        if a.dtype == torch.int8:
            assert (a.int() - b.int()).abs().max() <= 1
        else:
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    # page 0 was never a write target: still zero
    assert all(float(t[:, 0].abs().sum()) == 0.0 for t in flat(pa))
