"""The host DRAM tier and the peer span in the port against the JAX
package: a storm that spills LRU families to host buffers and fills them
back gives the JAX server's greedy tokens and ``tier_stats()`` (f32 and
int8 pools), a host budget too small for any span degrades to dropping, and
a span exported by one package's server injects into the other's with the
same tokens; an inject past the local coverage (a hole) is refused."""

import jax
import numpy as np
import pytest
import torch

from kubetpu.jobs.paged import PagedDecodeServer as JaxPagedServer
from kubetpu_torch.jobs import model as tmodel
from kubetpu_torch.jobs.convert import params_from_numpy
from kubetpu_torch.jobs.paged import PagedDecodeServer

torch.set_num_threads(1)

PS = 8
BUDGET = 4          # HBM tree pages: two 2-page families fill it exactly


@pytest.fixture(scope="module")
def both(trained_small):
    jcfg, params, data = trained_small
    cfg = tmodel.ModelConfig(
        vocab=jcfg.vocab, d_model=jcfg.d_model, n_layers=jcfg.n_layers,
        n_heads=jcfg.n_heads, d_ff=jcfg.d_ff, max_seq=jcfg.max_seq)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    rows = [[int(t) for t in data[i][0][0]] for i in range(8)]
    return jcfg, params, cfg, model, rows


def make(both, port, host=1 << 22, budget=BUDGET, **kw):
    jcfg, params, cfg, model, _ = both
    kw.update(n_slots=2, max_seq=64, max_new_tokens=6, page_size=PS,
              prefix_cache_pages=budget, host_tier_bytes=host)
    if port:
        return PagedDecodeServer(cfg, model, device="cpu", **kw)
    return JaxPagedServer(jcfg, params, **kw)


def fam(both, i):
    """One 2-page shared-prefix family head."""
    return both[4][i][:2 * PS]


def run(server, prompts):
    rids = [server.enqueue(p) for p in prompts]
    server.drain()
    server.check_invariants()
    return [server.pop_result(r) for r in rids]


def spill_storm(both, server):
    """Family 0 warms, families 1 and 2 evict it to the host tier (the HBM
    budget holds two), then family 0 returns and fills back; one wave at a
    time, so the LRU order is deterministic."""
    waves = [[fam(both, 0) + [1], fam(both, 0) + [2]],
             [fam(both, 1) + [1], fam(both, 2) + [1]],
             [fam(both, 0) + [3], fam(both, 0) + [4]]]
    return [out for wave in waves for out in run(server, wave)]


@pytest.mark.parametrize("kv_int8,budget",
                         [(False, 0), (False, PS), (True, PS)],
                         ids=["f32-monolithic", "f32-chunked",
                              "int8-chunked"])
def test_spill_fill_tokens_and_tier_stats_equal_the_jax_server(
        both, kv_int8, budget):
    ref_server = make(both, False, kv_int8=kv_int8, prefill_budget=budget)
    server = make(both, True, kv_int8=kv_int8, prefill_budget=budget)
    ref = spill_storm(both, ref_server)
    got = spill_storm(both, server)
    assert got == ref
    ts = server.tier_stats()
    assert ts == ref_server.tier_stats()
    assert server.prefix_cache_stats() == ref_server.prefix_cache_stats()
    assert ts["spills"]["host"] > 0 and ts["fills"]["host"] > 0
    assert ts["tokens_saved"]["host"] > 0


def test_host_buffers_hold_the_stored_layout(both):
    """Spilled int8 spans stay quantized (int8 values, f32 scales) in CPU
    tensors with the page axis at 1, byte-equal to the pool pages they
    left."""
    server = make(both, True, kv_int8=True, prefill_budget=PS)
    run(server, [fam(both, 0) + [1]])
    before = server._gather_phys_pages(
        server._prefix_cache.match(fam(both, 0))[1])
    run(server, [fam(both, 1) + [1], fam(both, 2) + [1]])
    (node,) = server._prefix_cache.host_nodes()
    assert set(node.host) == {"k_q", "k_s", "v_q", "v_s"}
    for name, buf in node.host.items():
        assert buf.device.type == "cpu" and buf.shape[1] == 2
        assert torch.equal(buf, before[name])
    assert node.host["k_q"].dtype == torch.int8
    assert node.host["k_s"].dtype == torch.float32


def test_tiny_host_budget_degrades_to_drop(both):
    ref = spill_storm(both, make(both, False, host=0, budget=0))
    server = make(both, True, host=16)
    assert spill_storm(both, server) == ref
    assert server.tier_stats()["spills"]["host"] == 0
    assert server._prefix_cache.host_bytes == 0


def test_fill_under_pool_pressure_and_warmup_drop_the_host_tier(both):
    """A fill that must reclaim pool pages for its own upload completes;
    ``warmup()`` then flushes both tiers and the next visit re-warms from
    cold with the same tokens."""
    need = -(-(2 * PS + 1 + 6 + 1) // PS)     # pages per slot
    kw = dict(n_pages=2 * need + BUDGET, prefill_budget=PS)
    ref = spill_storm(both, make(both, False, **kw))
    server = make(both, True, **kw)
    assert spill_storm(both, server) == ref
    assert server._prefix_cache.host_bytes > 0
    server.warmup()
    assert server._prefix_cache.host_bytes == 0
    assert server._prefix_cache.host_nodes() == []
    assert server._prefix_cache.total_pages == 0
    assert run(server, [fam(both, 0) + [1]]) == ref[:1]


@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32", "int8"])
def test_spans_move_between_the_jax_server_and_the_port(both, kv_int8):
    """A span exported by the JAX server injects into the port (and back),
    after which the prompt decodes to the exporter's tokens; a replay
    adopts nothing, and a span that starts past the local coverage is
    refused."""
    prompt = fam(both, 3) + [5]
    jax_server = make(both, False, kv_int8=kv_int8)
    port = make(both, True, kv_int8=kv_int8)
    ref = run(jax_server, [prompt])
    span = jax_server.export_prefix_span(prompt)
    assert span is not None and span["n_pages"] == 2
    tail = jax_server.export_prefix_span(prompt, from_page=1)
    tokens = prompt[:span["matched_tokens"]]
    assert port.inject_prefix(tokens, tail["pages"], from_page=1) == 0
    assert port.inject_prefix(tokens, span["pages"]) == 2
    assert port.inject_prefix(tokens, span["pages"]) == 0
    assert port.tier_stats()["fills"]["peer"] == 2
    assert run(port, [prompt]) == ref
    assert port.prefix_cache_stats()["requests_hit"] == 1

    back = port.export_prefix_span(prompt)
    for name, arr in span["pages"].items():
        assert isinstance(back["pages"][name], np.ndarray)
        assert back["pages"][name].dtype == arr.dtype
        np.testing.assert_array_equal(back["pages"][name], arr)
    other = make(both, False, kv_int8=kv_int8)
    assert other.inject_prefix(tokens, back["pages"]) == 2
    assert run(other, [prompt]) == ref


def test_bf16_spans_wait_for_the_wire():
    """bf16 spans, which waited for the wire's encoding, now travel: a
    bf16 pool exports its span as bf16 tensors, the wire codec's span
    payload carries their 16-bit patterns, and the span injects into
    another bf16 server, which then serves the prompt with the tokens of
    the server that computed it."""
    from kubetpu_torch.router.migration import (decode_span_payload,
                                                encode_span_payload)

    bcfg = tmodel.ModelConfig(vocab=32, d_model=16, n_layers=1, n_heads=2,
                              d_ff=32, dtype=torch.bfloat16)
    model = tmodel.init_params(torch.Generator().manual_seed(0), bcfg,
                               device="cpu")

    def server():
        return PagedDecodeServer(bcfg, model, n_slots=1, max_seq=32,
                                 max_new_tokens=2, page_size=4,
                                 prefix_cache_pages=4, device="cpu")

    src = server()
    ref = run(src, [[1, 2, 3, 4, 5, 6]])
    span = src.export_prefix_span([1, 2, 3, 4, 5])
    assert span["n_pages"] == 1
    assert span["pages"]["k"].dtype == torch.bfloat16
    payload = encode_span_payload(span["pages"], span["from_page"])
    assert {a["dtype"] for a in payload["arrays"]} == {"bfloat16"}
    pages = decode_span_payload(payload)
    for name, t in span["pages"].items():
        assert torch.equal(pages[name], t)
    dst = server()
    assert dst.inject_prefix([1, 2, 3, 4], pages) == 1
    assert dst.prefix_local_pages([1, 2, 3, 4, 9]) == 1
    assert run(dst, [[1, 2, 3, 4, 5, 6]]) == ref
    assert dst.prefix_cache_stats()["requests_hit"] == 1
