"""Shared-prefix reuse in the port against the JAX package: the radix tree
driven by one seeded operation sequence gives the reference tree's returns
and passes its ``check()``; the port's paged server with a prefix cache
gives the JAX server's greedy tokens and ``prefix_cache_stats()`` on
trained weights, over {f32, kv_int8} x {monolithic, chunked}, with the pool
oracle after every drain — through the copy-on-write boundary, reclaim
under pool pressure, slots sharing pages, and the warmup flush."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from kubetpu.jobs.paged import PagedDecodeServer as JaxPagedServer
from kubetpu.jobs.prefix_cache import RadixPrefixCache as JaxTree
from kubetpu_torch.jobs import model as tmodel
from kubetpu_torch.jobs.convert import params_from_numpy
from kubetpu_torch.jobs.paged import PagedDecodeServer
from kubetpu_torch.jobs.prefix_cache import RadixPrefixCache

torch.set_num_threads(1)

PS = 8
VARIANTS = [(False, 0), (False, PS), (True, 0), (True, PS)]
VARIANT_IDS = ["f32-monolithic", "f32-chunked", "int8-monolithic",
               "int8-chunked"]


def port_cfg(jcfg):
    return tmodel.ModelConfig(
        vocab=jcfg.vocab, d_model=jcfg.d_model, n_layers=jcfg.n_layers,
        n_heads=jcfg.n_heads, d_ff=jcfg.d_ff, max_seq=jcfg.max_seq)


@pytest.fixture(scope="module")
def both(trained_small):
    """(jax cfg, jax params, port cfg, port model, token rows of the
    training data) on the same weights."""
    jcfg, params, data = trained_small
    cfg = port_cfg(jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    rows = [[int(t) for t in data[i][0][j]] for i in range(4)
            for j in range(2)]
    return jcfg, params, cfg, model, rows


def servers(both, **kw):
    """(JAX server, port server) with the same settings."""
    jcfg, params, cfg, model, _ = both
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_seq", 64)
    kw.setdefault("max_new_tokens", 8)
    kw.setdefault("page_size", PS)
    kw.setdefault("n_pages", 24)
    return (JaxPagedServer(jcfg, params, **kw),
            PagedDecodeServer(cfg, model, device="cpu", **kw))


def run_both(pair, waves):
    """Each wave enqueued together and drained, on both servers; the pool
    oracle after every drain. Returns both servers' results."""
    outs = []
    for server in pair:
        got = []
        for wave in waves:
            rids = [server.enqueue(p) for p in wave]
            server.drain()
            server.check_invariants()
            got += [server.pop_result(r) for r in rids]
        outs.append(got)
    return outs


def assert_same(pair, outs):
    assert outs[1] == outs[0]
    assert pair[1].prefix_cache_stats() == pair[0].prefix_cache_stats()
    assert pair[1].tier_stats() == pair[0].tier_stats()


# -- the radix tree -----------------------------------------------------------


def _tree_ops(seed, n_ops=300):
    """A seeded sequence of tree operations over a small token alphabet, so
    prefixes collide, nodes split and the budget binds."""
    rng = np.random.default_rng(seed)
    heads = [rng.integers(1, 5, 4 * rng.integers(1, 4)).tolist()
             for _ in range(4)]
    ops = []
    for _ in range(n_ops):
        kind = rng.choice(["insert", "insert", "match", "match_tiered",
                           "missing", "pin", "release", "evict",
                           "evict_spill", "promote", "clear"],
                          p=[.2, .1, .15, .1, .05, .1, .08, .08, .08, .05,
                             .01])
        toks = heads[rng.integers(len(heads))] + rng.integers(
            1, 5, 4 * rng.integers(0, 3)).tolist()
        ops.append((str(kind), toks, int(rng.integers(1, 4))))
    return ops


def _drive(tree, ops, host_array):
    """Apply *ops* to *tree*; the list of what each returned, in a form
    both trees share, and ``check()`` after every op."""
    free = list(range(1000, 0, -1))
    pins = []
    out = []
    for kind, toks, n in ops:
        if kind == "insert":
            full = len(toks) // 4 * 4
            pages = [free.pop() for _ in range(full // 4)]
            got = tree.insert(toks[:full], pages)
            free.extend(p for p in pages if p not in got)
            out.append(sorted(got))
        elif kind == "match":
            m, pages, node = tree.match(toks)
            out.append((m, pages, node.tokens if node else None))
            if node is not None and n == 1:
                tree.pin(node)
                pins.append(node)
        elif kind == "match_tiered":
            m, segs = tree.match_tiered(toks)
            out.append((m, [(nd.tokens, jp, nd.host is not None)
                            for nd, jp in segs]))
        elif kind == "missing":
            out.append(tree.missing_pages(toks))
        elif kind == "pin":
            _, _, node = tree.match(toks)
            if node is not None:
                tree.pin(node)
                pins.append(node)
            out.append(node is not None)
        elif kind == "release":
            if pins:
                tree.release(pins.pop(n % len(pins)))
            out.append(len(pins))
        elif kind in ("evict", "evict_spill"):
            gather = None
            if kind == "evict_spill":
                def gather(pages):
                    return {"k": host_array(len(pages))}
            got = tree.evict(n, gather=gather)
            free.extend(got)
            out.append(got)
        elif kind == "promote":
            _, segs = tree.match_tiered(toks)
            done = []
            for node, _jp in segs:
                if node.host is None:
                    continue
                k = len(node.tokens) // 4
                if tree.total_pages + k > tree.max_pages or k > len(free):
                    break
                tree.promote(node, [free.pop() for _ in range(k)])
                done.append(node.tokens)
            out.append(done)
        else:
            if not pins:
                free.extend(tree.clear())
            out.append(tree.total_pages)
        tree.check()
        out.append((tree.total_pages, tree.n_nodes(), tree.host_bytes,
                    tree.spilled_pages, sorted(tree.owned_pages())))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_radix_tree_matches_the_reference_tree(seed):
    ops = _tree_ops(seed)
    kw = dict(page_size=4, max_pages=10, host_budget_bytes=3 * 2 * 4 * 4)
    ref = _drive(JaxTree(**kw), ops,
                 lambda n: np.zeros((2, n, 4), np.float32))
    got = _drive(RadixPrefixCache(**kw), ops,
                 lambda n: torch.zeros((2, n, 4)))
    assert got == ref


def test_host_split_copies_cpu_tensors_along_the_page_axis():
    """A divergence inside a host-tier span splits its CPU buffers at the
    page boundary; the walk then adopts the donated page for the shared
    head, and the suffix keeps its own contiguous copy."""
    tree = RadixPrefixCache(page_size=2, max_pages=4, host_budget_bytes=1024)
    tree.insert([1, 2, 3, 4, 5, 6], [7, 8, 9])
    buf = torch.arange(2 * 3 * 2, dtype=torch.float32).reshape(2, 3, 2)
    assert tree.evict(3, gather=lambda pages: {"k": buf.clone()}) == [7, 8, 9]
    assert tree.insert([1, 2, 30, 40], [5, 6]) == {5, 6}
    tree.check()
    (node,) = tree.host_nodes()
    assert node.tokens == (3, 4, 5, 6)
    torch.testing.assert_close(node.host["k"], buf[:, 1:])
    assert node.host["k"].is_contiguous()
    assert tree.host_bytes == buf[:, 1:].nbytes
    assert tree.match([1, 2, 30, 40])[:2] == (4, [5, 6])


# -- the server against the JAX server ----------------------------------------


@pytest.mark.parametrize("kv_int8,budget", VARIANTS, ids=VARIANT_IDS)
def test_prefix_reuse_tokens_and_stats_equal_the_jax_server(both, kv_int8,
                                                            budget):
    """A cold seed, then hits on one shared 3-page head with distinct
    tails, then a second family, two at a time."""
    rows = both[4]
    head = rows[0][:3 * PS]
    waves = [[head + rows[1][:3]],
             [head + rows[2][:5], head + rows[3][:1]],
             [head + rows[4][:9], rows[5][:2 * PS + 3]],
             [rows[5][:2 * PS] + rows[6][:4], head + rows[7][:2]]]
    pair = servers(both, kv_int8=kv_int8, prefill_budget=budget,
                   prefix_cache_pages=16)
    outs = run_both(pair, waves)
    assert_same(pair, outs)
    stats = pair[1].prefix_cache_stats()
    assert stats["requests_hit"] >= 5 and stats["prefill_tokens_saved"] > 0


def test_prefix_reuse_equals_the_jax_kernel_server(both):
    """The JAX server on its Pallas kernel (interpret mode) gives the same
    tokens as its gather core, and so as the port."""
    rows = both[4]
    head = rows[0][:2 * PS]
    waves = [[head + rows[1][:3]], [head + rows[2][:6], head + [5]]]
    jcfg, params, cfg, model, _ = both
    kw = dict(n_slots=2, max_seq=64, max_new_tokens=8, page_size=PS,
              prefill_budget=PS, prefix_cache_pages=8)
    pair = (JaxPagedServer(jcfg, params, use_kernel=True, interpret=True,
                           **kw),
            PagedDecodeServer(cfg, model, device="cpu", **kw))
    outs = run_both(pair, waves)
    assert_same(pair, outs)


@pytest.mark.parametrize("kv_int8,budget", VARIANTS, ids=VARIANT_IDS)
def test_cow_boundary_keeps_shared_pages_untouched(both, kv_int8, budget):
    """A prompt fully covered by the tree maps all but its last page and
    recomputes that page privately; the tree's page bytes do not change
    through the second request."""
    prompt = both[4][1][:3 * PS]           # exactly 3 full pages
    pair = servers(both, kv_int8=kv_int8, prefill_budget=budget,
                   prefix_cache_pages=16)
    port = pair[1]
    outs = run_both(pair, [[prompt]])
    tree_pages = sorted(port._prefix_cache.owned_pages())
    assert len(tree_pages) == 3
    pools = [t for pool in (port.k_pages, port.v_pages)
             for t in (pool if isinstance(pool, tuple) else (pool,))]
    before = [t[:, tree_pages].clone() for t in pools]
    rid = port.enqueue(prompt)
    port.step()
    assert max(port._slot_shared) == 2     # capped one page short
    port.check_invariants()
    port.drain()
    port.check_invariants()
    assert port.pop_result(rid) == outs[1][0]
    for a, t in zip(before, pools):
        assert torch.equal(a, t[:, tree_pages])
    stats = port.prefix_cache_stats()
    assert stats["hit_tokens"] == 3 * PS
    assert stats["prefill_tokens_saved"] == 2 * PS
    assert outs[1] == outs[0]


@pytest.mark.parametrize("kv_int8,budget", VARIANTS, ids=VARIANT_IDS)
def test_reclaim_under_pool_pressure_matches_the_jax_server(both, kv_int8,
                                                            budget):
    """A pool too small for a fresh worst case while the tree holds its
    budget: admissions reclaim tree pages instead of parking forever."""
    rows = both[4]
    waves = [[rows[s][:2 * PS + 1]] for s in range(4)]
    waves.append([rows[0][:2 * PS] + [3], rows[4][:2 * PS + 1]])
    pair = servers(both, kv_int8=kv_int8, prefill_budget=budget,
                   n_pages=8, prefix_cache_pages=6)
    outs = run_both(pair, waves)
    assert_same(pair, outs)
    assert pair[1].prefix_cache_stats()["evicted_pages"] > 0


@pytest.mark.parametrize("kv_int8,budget", VARIANTS, ids=VARIANT_IDS)
def test_concurrent_slots_share_pages(both, kv_int8, budget):
    """Two live slots map the same shared pages at once: refcounts track
    both pins mid-flight, tokens equal the JAX server's."""
    rows = both[4]
    head = rows[2][:2 * PS]
    pair = servers(both, kv_int8=kv_int8, prefill_budget=budget,
                   prefix_cache_pages=16)
    outs = run_both(pair, [[head + [2]]])
    shared = [head + rows[3][:3], head + rows[4][:2]]
    for server, out in zip(pair, outs):
        rids = [server.enqueue(p) for p in shared]
        while server._prefills or server.queued():
            server.step()
        if server is pair[1]:
            pinned = [n for n in server._prefix_cache.nodes()
                      if n.refcount]
            assert sum(n.refcount for n in pinned) == 2
            assert sorted(server._slot_shared) == [2, 2]
            server.check_invariants()    # the oracle holds mid-flight
        server.drain()
        server.check_invariants()
        out += [server.pop_result(r) for r in rids]
    assert_same(pair, outs)
    assert all(n.refcount == 0 for n in pair[1]._prefix_cache.nodes())


@pytest.mark.parametrize("kv_int8,budget", VARIANTS, ids=VARIANT_IDS)
def test_warmup_flushes_the_tree_and_serving_continues(both, kv_int8,
                                                       budget):
    rows = both[4]
    prompt = rows[6][:PS] + [2, 3]
    pair = servers(both, kv_int8=kv_int8, prefill_budget=budget,
                   prefix_cache_pages=8, max_seq=32, max_new_tokens=3)
    outs = run_both(pair, [[prompt]])
    port = pair[1]
    assert port._prefix_cache.total_pages > 0
    port.warmup()
    assert port._prefix_cache.total_pages == 0
    assert port.pages_in_use() == 0
    port.check_invariants()
    again = run_both((port,), [[prompt], [prompt]])[0]
    assert again == outs[1] * 2 == outs[0] * 2
    assert port.prefix_cache_stats()["requests_hit"] == 1


def test_windowed_configs_and_bad_settings_are_refused(both):
    _, _, cfg, model, _ = both
    wcfg = dataclasses.replace(cfg, window=8)
    with pytest.raises(ValueError, match="window"):
        PagedDecodeServer(wcfg, model, prefix_cache_pages=8, device="cpu")
    with pytest.raises(ValueError, match="prefix_cache_pages"):
        PagedDecodeServer(cfg, model, prefix_cache_pages=-1, device="cpu")
    with pytest.raises(ValueError, match="host_tier_bytes"):
        PagedDecodeServer(cfg, model, host_tier_bytes=1 << 20, device="cpu")
    with pytest.raises(ValueError, match="pool_frac"):
        PagedDecodeServer(cfg, model, pool_frac=0.0, device="cpu")


def test_pool_frac_sizes_the_pool_and_keeps_the_tokens(both):
    """A quarter share quarters the pool (and ``load_info`` says so) and
    serves the JAX server's tokens."""
    rows = both[4]
    waves = [[rows[0][:12], rows[1][:20]]]
    pair = servers(both, n_pages=32, pool_frac=0.25)
    assert pair[1].pool_pages == pair[0].pool_pages == 8
    assert pair[1].k_pages.shape[1] == 8
    outs = run_both(pair, waves)
    assert outs[1] == outs[0]
    assert pair[1].load_info()["pool_frac"] == 0.25
    assert pair[1].load_info().keys() == pair[0].load_info().keys()
