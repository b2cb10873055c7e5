"""Windowed serving on the ring page table in the port against the JAX
package: greedy tokens equal the JAX server's at window 8 over {f32,
kv_int8} x {monolithic, chunked}, across prompts and decodes long enough
to wrap the ring; a slot's pages are bounded by its ring, not by its
sequence; and the pool oracle knows a ring from a double mapping."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from kubetpu.jobs.paged import PagedDecodeServer as JaxPagedServer
from kubetpu_torch.jobs import model as tmodel
from kubetpu_torch.jobs.convert import params_from_numpy
from kubetpu_torch.jobs.paged import PagedDecodeServer

torch.set_num_threads(1)

WINDOW = 8
PS = 4                       # ring = 8 / 4 + 1 = 3 pages


@pytest.fixture(scope="module")
def both(trained_small):
    jcfg, params, data = trained_small
    jcfg = dataclasses.replace(jcfg, window=WINDOW)
    cfg = tmodel.ModelConfig(
        vocab=jcfg.vocab, d_model=jcfg.d_model, n_layers=jcfg.n_layers,
        n_heads=jcfg.n_heads, d_ff=jcfg.d_ff, max_seq=jcfg.max_seq,
        window=WINDOW)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    rows = [[int(t) for t in data[i][0][0]] for i in range(4)]
    return jcfg, params, cfg, model, rows


def staggered(server, rows):
    """Prompts of 6, 2, 9 and 40 tokens (9 makes the bucket pad exceed the
    ring; 40 keeps only the last ring of prompt pages live), admitted
    staggered; the pool oracle after every drain."""
    prompts = [rows[0][:6], rows[1][:2], rows[2][:9], rows[3][:40]]
    ra = server.enqueue(prompts[0])
    server.step()
    rb = server.enqueue(prompts[1])
    server.step()
    server.check_invariants()
    server.drain()
    server.check_invariants()
    rc, rd = server.enqueue(prompts[2]), server.enqueue(prompts[3])
    server.drain()
    server.check_invariants()
    assert server.pages_in_use() == 0
    return [server.result(r) for r in (ra, rb, rc, rd)]


@pytest.mark.parametrize("budget", [0, 8], ids=["monolithic", "chunked"])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32", "int8"])
def test_windowed_greedy_tokens_equal_the_jax_server(both, kv_int8, budget):
    jcfg, params, cfg, model, rows = both
    kw = dict(n_slots=2, max_seq=96, max_new_tokens=24, page_size=PS,
              kv_int8=kv_int8, prefill_budget=budget)
    ref = staggered(JaxPagedServer(jcfg, params, **kw), rows)
    out = staggered(PagedDecodeServer(cfg, model, device="cpu", **kw), rows)
    assert out == ref


def test_windowed_tokens_equal_the_jax_kernel_server(both):
    """The JAX server's banded Pallas kernel (interpret mode) on the ring
    gives the same tokens as the port."""
    jcfg, params, cfg, model, rows = both
    kw = dict(n_slots=2, max_seq=96, max_new_tokens=12, page_size=PS)
    ref = JaxPagedServer(jcfg, params, use_kernel=True, interpret=True, **kw)
    port = PagedDecodeServer(cfg, model, device="cpu", **kw)
    outs = []
    for server in (ref, port):
        rids = [server.enqueue(p) for p in (rows[0][:6], rows[3][:40])]
        server.drain()
        server.check_invariants()
        outs.append([server.pop_result(r) for r in rids])
    assert outs[1] == outs[0]


def test_pages_are_bounded_by_the_ring_not_the_sequence(both):
    """A windowed slot maps ceil(window / ps) + 1 physical pages however
    long it runs, and returns them at retirement; an unwindowed server of
    the same shapes cannot even admit the request."""
    _, _, cfg, model, rows = both
    server = PagedDecodeServer(cfg, model, n_slots=2, max_seq=128,
                               max_new_tokens=60, page_size=PS, n_pages=8,
                               device="cpu")
    ring = WINDOW // PS + 1
    assert server._ring_pages == ring
    rid = server.submit(rows[0][:11])
    assert server.pages_in_use() == ring
    row = server._table[server._slot_rid.index(rid)]
    assert len(set(row[row >= 0].tolist())) == ring
    assert int((row >= 0).sum()) == -(-(11 + 60 + 1) // PS)
    peak = 0
    while not server._idle():
        server.step()
        peak = max(peak, server.pages_in_use())
    assert peak == ring and server.pages_in_use() == 0
    assert len(server.pop_result(rid)) == 11 + 60
    plain = PagedDecodeServer(dataclasses.replace(cfg, window=0), model,
                              n_slots=2, max_seq=128, max_new_tokens=60,
                              page_size=PS, n_pages=8, device="cpu")
    with pytest.raises(ValueError, match="pool"):
        plain.submit(rows[0][:11])


def test_a_chunk_longer_than_the_ring_writes_each_ring_page_once(both,
                                                                 monkeypatch):
    """A 40-token monolithic prefill covers 10 logical pages of a 3-page
    ring: the write row keeps only the last logical occurrence of each
    physical page, so no scatter carries a page twice."""
    from kubetpu_torch.jobs import paged

    _, _, cfg, model, rows = both
    seen = []
    real = paged._paged_prefill_io

    def spy(write_phys, gather_row, ps, window, attend_chunk=None):
        seen.append((write_phys.clone(), attend_chunk))
        return real(write_phys, gather_row, ps, window, attend_chunk)

    monkeypatch.setattr(paged, "_paged_prefill_io", spy)
    server = PagedDecodeServer(cfg, model, n_slots=1, max_seq=96,
                               max_new_tokens=4, page_size=PS, device="cpu")
    server.submit(rows[3][:40])
    (write_phys, attend_chunk), = seen
    kept = write_phys[write_phys < server.pool_pages].tolist()
    assert len(kept) == len(set(kept)) == server._ring_pages
    # the kept entries are the last ring-many real pages of the prompt
    assert (write_phys[7:10] < server.pool_pages).all()
    assert attend_chunk is None        # the gather path, never the kernel
    server.drain()
    server.check_invariants()


def test_check_invariants_knows_a_ring_from_a_double_mapping(both):
    _, _, cfg, model, rows = both
    server = PagedDecodeServer(cfg, model, n_slots=2, max_seq=64,
                               max_new_tokens=20, page_size=PS,
                               device="cpu")
    ra = server.submit(rows[0][:10])
    rb = server.submit(rows[1][:10])
    server.step()
    server.check_invariants()          # each ring maps its pages ~6 times
    sa, sb = server._slot_rid.index(ra), server._slot_rid.index(rb)
    saved = server._table[sb, 0]
    server._table[sb, 0] = server._table[sa, 1]
    with pytest.raises(AssertionError, match="two slots"):
        server.check_invariants()
    server._table[sb, 0] = saved
    server._free.append(int(server._table[sa, 0]))
    with pytest.raises(AssertionError, match="mapped and free"):
        server.check_invariants()
    server._free.pop()
    server.drain()
    server.check_invariants()
