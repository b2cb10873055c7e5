"""The port's multi-LoRA serving (``kubetpu_torch.jobs.multi_lora``, the port
of ``tests/test_multi_lora.py``): stack validation; per-example chunk
logits against merged decoding (1e-4, f32) and against the JAX package's
chunk forward on the same stack; prefix-hit parity and cross-tenant
isolation; 64 resident adapters; hot load / evict and the directory; an
in-place load under ``overlap``; a recycled index never serving a stale
prefix; the HBM budget; the adapter map never leaking (the
``_drop_request_state`` hook); migration refused; the tenant counters.
Greedy tokens against the JAX servers on ``trained_small`` are in
``test_torch_multi_lora_servers.py``."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubetpu.jobs import ModelConfig as JaxConfig
from kubetpu.jobs import lora as jlora
from kubetpu.jobs import multi_lora as jml
from kubetpu.jobs.decode import forward_chunk as jax_forward_chunk
from kubetpu.jobs.decode import init_kv_cache as jax_init_kv_cache
from kubetpu_torch.jobs import model as tmodel
from kubetpu_torch.jobs.convert import lora_to_numpy, params_to_numpy
from kubetpu_torch.jobs.decode import forward_chunk, init_kv_cache
from kubetpu_torch.jobs.lora import LoraConfig, init_lora_params, merge_lora
from kubetpu_torch.jobs.multi_lora import (_TENANT_OVERFLOW, _TENANT_TOPK,
                                           PagedMultiLoraDecodeServer,
                                           adapter_fingerprint,
                                           stack_adapters)
from kubetpu_torch.jobs.paged import PagedDecodeServer

torch.set_num_threads(1)

JCFG = JaxConfig(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
                 max_seq=128)
JLCFG = jlora.LoraConfig(rank=4, alpha=8.0)
LCFG = LoraConfig(rank=4, alpha=8.0)
PS = 8


def port_cfg(jcfg):
    return tmodel.ModelConfig(
        vocab=jcfg.vocab, d_model=jcfg.d_model, n_layers=jcfg.n_layers,
        n_heads=jcfg.n_heads, d_ff=jcfg.d_ff, max_seq=jcfg.max_seq)


CFG = port_cfg(JCFG)


def port_adapter(seed):
    """A port adapter with a real effect: B drawn N(0, 0.05)."""
    lora = init_lora_params(torch.Generator().manual_seed(seed), CFG, LCFG,
                            device="cpu")
    gen = torch.Generator().manual_seed(seed + 100)
    for t in LCFG.targets:
        b = lora["blocks"][f"{t}_b"]
        lora["blocks"][f"{t}_b"] = torch.randn(b.shape, generator=gen) * 0.05
    return lora


@pytest.fixture(scope="module")
def small():
    """The reference tests' CFG: a random base and four adapters, made by
    the port (the JAX package gets them through ``params_to_numpy`` /
    ``lora_to_numpy``)."""
    base = tmodel.init_params(torch.Generator().manual_seed(0), CFG,
                              device="cpu")
    return {"base": base, "ads": [port_adapter(s) for s in (1, 2, 3, 4)]}


def paged_multi(base, ads, cfg=CFG, **kw):
    kw.setdefault("n_slots", 3)
    kw.setdefault("max_seq", 64)
    kw.setdefault("max_new_tokens", 6)
    kw.setdefault("page_size", PS)
    return PagedMultiLoraDecodeServer(cfg, base, LCFG, ads, device="cpu",
                                      **kw)


def merged_ref(base, adapter, prompt, cfg=CFG, **kw):
    kw.setdefault("n_slots", 1)
    kw.setdefault("max_seq", 64)
    kw.setdefault("max_new_tokens", 6)
    kw.setdefault("page_size", PS)
    srv = PagedDecodeServer(cfg, merge_lora(base, adapter, LCFG),
                            device="cpu", **kw)
    rid = srv.enqueue(prompt)
    srv.drain()
    return srv.pop_result(rid)


def test_stack_validation(small):
    ads = small["ads"]
    with pytest.raises(ValueError):
        stack_adapters(LCFG, [])
    # validation reads the adapters' actual keys: an adapter trained with
    # an MLP target is refused even under an attention-only config
    mixed = init_lora_params(torch.Generator().manual_seed(0), CFG,
                             LoraConfig(rank=2, targets=("wq", "w_gate")),
                             device="cpu")
    with pytest.raises(ValueError, match="attention targets only"):
        stack_adapters(LCFG, [mixed])
    odd = {"blocks": {k: v for k, v in ads[1]["blocks"].items()
                      if not k.startswith("wq_")}}
    with pytest.raises(ValueError, match="disagree"):
        stack_adapters(LCFG, [ads[0], odd])
    stack = stack_adapters(LCFG, ads[:2])
    assert stack["blocks"]["wq_a"].shape == (2,) + tuple(
        ads[0]["blocks"]["wq_a"].shape)
    with pytest.raises(ValueError, match="attention targets only"):
        PagedMultiLoraDecodeServer(CFG, small["base"], LCFG, [mixed],
                                   device="cpu")


def test_chunk_forward_matches_merged_per_example_and_jax(small):
    """A mixed batch where row i uses adapter a_i: logits and cache equal
    each row through its merged model (1e-4), and the JAX package's chunk
    forward over the same stack."""
    base, ads = small["base"], small["ads"][:2]
    stack = stack_adapters(LCFG, ads)
    tokens = np.random.default_rng(3).integers(0, CFG.vocab, (4, 6))
    aids = np.array([0, 1, 1, 0])
    kc, vc = init_kv_cache(CFG, 4, 16, device="cpu")
    logits, kc, vc = forward_chunk(
        CFG, base, torch.from_numpy(tokens), kc, vc, 0, lora=stack,
        adapter_ids=torch.from_numpy(aids), lora_scale=LCFG.scale)
    for i in range(4):
        merged = merge_lora(base, ads[aids[i]], LCFG)
        kc1, vc1 = init_kv_cache(CFG, 1, 16, device="cpu")
        want, kc1, vc1 = forward_chunk(CFG, merged,
                                       torch.from_numpy(tokens[i:i + 1]),
                                       kc1, vc1, 0)
        torch.testing.assert_close(logits[i], want[0], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(kc[:, i], kc1[:, 0], rtol=1e-4,
                                   atol=1e-4)
    jparams = jax.tree.map(jnp.asarray, params_to_numpy(base))
    jads = [jax.tree.map(jnp.asarray, lora_to_numpy(a)) for a in ads]
    jk, jv = jax_init_kv_cache(JCFG, 4, 16)
    jlogits, _, _ = jax_forward_chunk(
        JCFG, jparams, jnp.asarray(tokens, jnp.int32), jk, jv, 0,
        lora=jml.stack_adapters(JLCFG, jads),
        adapter_ids=jnp.asarray(aids, jnp.int32), lora_scale=JLCFG.scale)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)


def test_prefix_hit_parity_and_cross_tenant_isolation(small):
    """Salted prefix keys: a same-tenant replay hits the warm tree and
    still matches merged decoding; the same prompt under another adapter
    misses."""
    base, ads = small["base"], small["ads"][:2]
    srv = paged_multi(base, ads, prefix_cache_pages=16)
    prompt = list(range(1, 2 * PS + 2))     # two full pages and a tail
    r0 = srv.submit(prompt, adapter=0)
    srv.drain()
    assert srv.prefix_cache_stats()["requests_hit"] == 0
    r1 = srv.submit(prompt, adapter=0)
    srv.drain()
    assert srv.prefix_cache_stats()["requests_hit"] == 1
    r2 = srv.submit(prompt, adapter=1)
    srv.drain()
    assert srv.prefix_cache_stats()["requests_hit"] == 1
    srv.check_invariants()
    # the tree's keys are 64-bit salted ints: (aid + 1) << 32 | token
    keys = {t for node in srv._prefix_cache.nodes() for t in node.tokens}
    assert keys and min(keys) >= 1 << 32
    saved = srv.obs.counter("kubetpu_tenant_prefill_tokens_saved_total",
                            adapter=srv._adapter_label(0))
    assert int(saved.value) == 2 * PS
    want = {a: merged_ref(base, ads[a], prompt, prefix_cache_pages=16)
            for a in (0, 1)}
    assert srv.pop_result(r0) == want[0]
    assert srv.pop_result(r1) == want[0]
    assert srv.pop_result(r2) == want[1]


def test_64_adapters_one_packed_server(small):
    base = small["base"]
    ads = [port_adapter(s) for s in range(1, 65)]
    srv = paged_multi(base, ads, n_slots=2, max_new_tokens=4)
    assert srv.n_adapters == 64 and len(srv.resident_adapters()) == 64
    assert srv.load_info()["adapter_capacity"] == 64
    prompt = [5, 6, 7, 9]
    for t in (0, 40, 63):
        rid = srv.submit(prompt, adapter=t)
        srv.drain()
        assert srv.pop_result(rid) == merged_ref(base, ads[t], prompt,
                                                 max_new_tokens=4)
    srv.check_invariants()


def test_hot_load_evict_directory(small):
    """Content-idempotent load, shape validation, LRU eviction on a full
    stack, the in-use refusal, stale names refused at enqueue."""
    base = small["base"]
    a0, a1, a2, a3 = small["ads"]
    srv = paged_multi(base, [a0, a1], max_adapters=3, n_slots=1)
    stack_ptr = srv.lora_stack["blocks"]["wq_a"].data_ptr()
    n0 = adapter_fingerprint(a0)
    assert srv.load_adapter(a0) == n0
    assert len(srv.resident_adapters()) == 2
    assert srv.load_adapter(a0, name="alias") == "alias"
    assert len(srv.resident_adapters()) == 3
    assert srv.evict_adapter("alias") is True
    bad = {"blocks": {k: v for k, v in a2["blocks"].items()
                      if not k.endswith("wq_b")}}
    with pytest.raises(ValueError):
        srv.load_adapter(bad)
    wrong = {"blocks": {k: v[:, :1] for k, v in a2["blocks"].items()}}
    with pytest.raises(ValueError, match="shape"):
        srv.load_adapter(wrong)
    assert srv.load_adapter(a2, name="t2") == "t2"
    assert srv.load_adapter(a3, name="t3") == "t3"    # full: LRU evicts
    res = srv.resident_adapters()
    assert len(res) == 3 and "t3" in res
    evicted = ({n0, adapter_fingerprint(a1), "t2"} - set(res)).pop()
    srv.check_invariants()
    with pytest.raises(ValueError):
        srv.enqueue([1, 2, 3], adapter=evicted)
    rid = srv.enqueue([5, 6, 7], adapter="t3")
    srv.step()
    with pytest.raises(RuntimeError):
        srv.evict_adapter("t3")
    srv.drain()
    with pytest.raises(RuntimeError):     # finished but not popped: pinned
        srv.evict_adapter("t3")
    srv.pop_result(rid)
    assert srv.evict_adapter("t3") is True
    assert srv.evict_adapter("t3") is False       # replayed evict: no-op
    srv.check_invariants()
    rid = srv.enqueue([5, 6, 7], adapter="t2")
    srv.drain()
    assert srv.pop_result(rid) == merged_ref(base, a2, [5, 6, 7])
    # capacity is fixed at construction: loads write in place
    assert srv.lora_stack["blocks"]["wq_a"].data_ptr() == stack_ptr
    assert srv.lora_stack["blocks"]["wq_a"].shape[0] == 3
    loads = srv.obs.counter("kubetpu_adapter_loads_total")
    evicts = srv.obs.counter("kubetpu_adapter_evicts_total")
    assert (int(loads.value), int(evicts.value)) == (3, 3)


def test_load_is_in_place_and_ordered_under_overlap(small):
    """With ``overlap`` a step is in flight when the load runs: the load
    writes the stack in place, never the index a live slot decodes under
    (even when that index is the least recently used), and every stream
    still equals its merged decode."""
    base = small["base"]
    a0, a1, a2, a3 = small["ads"]
    srv = paged_multi(base, [a0, a1], n_slots=2, max_new_tokens=8,
                      overlap=True)
    r0 = srv.enqueue([5, 6, 7, 9], adapter=0)    # index 0: oldest bind
    srv.step()
    r1 = srv.enqueue([9, 10, 11], adapter=1)
    srv.step()
    assert srv._inflight is not None
    with pytest.raises(RuntimeError):
        srv.load_adapter(a2, name="t2")          # both indices live
    srv.drain()
    srv.pop_result(r1)                           # index 1 now idle
    r0_out = srv.pop_result(r0)
    assert r0_out == merged_ref(base, a0, [5, 6, 7, 9], max_new_tokens=8)
    r0 = srv.enqueue([5, 6, 7, 9], adapter=0)
    srv.step()
    srv._adapter_lru[0] = -1                     # the live index is LRU
    assert srv.load_adapter(a3, name="t3")
    assert srv._resident["t3"] == 1              # not the live index 0
    r3 = srv.enqueue([9, 10, 11], adapter="t3")
    srv.drain()
    srv.check_invariants()
    assert srv.pop_result(r0) == r0_out
    assert srv.pop_result(r3) == merged_ref(base, a3, [9, 10, 11],
                                            max_new_tokens=8)


def test_recycled_index_never_serves_stale_prefix(small):
    """Eviction bumps the index's salt generation: a tenant loaded into a
    recycled index never warm-starts from the previous occupant's
    pages."""
    base = small["base"]
    a0, a1, a2, _ = small["ads"]
    srv = paged_multi(base, [a0, a1], max_adapters=2, n_slots=1,
                      prefix_cache_pages=16)
    prompt = list(range(5, 14))
    rid = srv.enqueue(prompt, adapter=0)
    srv.drain()
    srv.pop_result(rid)
    hits0 = srv.prefix_cache_stats()["requests_hit"]
    srv.load_adapter(a2, name="t2")
    rid = srv.enqueue(prompt, adapter="t2")
    srv.drain()
    out = srv.pop_result(rid)
    assert srv.prefix_cache_stats()["requests_hit"] == hits0
    assert out == merged_ref(base, a2, prompt)
    srv.check_invariants()


def test_adapter_hbm_budget_caps_capacity(small):
    base = small["base"]
    a0, a1, a2, _ = small["ads"]
    per = paged_multi(base, [a0], n_slots=1)._adapter_bytes_each
    assert per == sum(v.numel() * 4 for v in a0["blocks"].values())
    srv = paged_multi(base, [a0], max_adapters=8, n_slots=1,
                      adapter_hbm_bytes=2 * per)
    assert srv.n_adapters == 2
    srv.load_adapter(a1, name="t1")
    srv.load_adapter(a2, name="t2")           # full: LRU evicts
    assert len(srv.resident_adapters()) == 2
    srv.check_invariants()
    with pytest.raises(ValueError, match="capacity"):
        paged_multi(base, [a0, a1], n_slots=1, adapter_hbm_bytes=per)


def test_rid_adapter_map_never_leaks(small):
    """Every exit reclaims the rid -> adapter entry through
    ``_drop_request_state``: pop_result, cancel (queued and admitted),
    queue-TTL expiry, and a submit the pool refused (whose rid the next
    submit reuses under its own adapter)."""
    base, ads = small["base"], small["ads"][:2]
    srv = paged_multi(base, ads, n_slots=1, max_new_tokens=3)
    rid = srv.submit([5, 6, 7], adapter=1)
    srv.drain()
    srv.pop_result(rid)
    assert srv._rid_adapter == {}
    r0 = srv.enqueue([5, 6, 7], adapter=0)      # admitted, then canceled
    r1 = srv.enqueue([9, 10], adapter=1)        # canceled while queued
    srv.step()
    assert srv.cancel(r0) and srv.cancel(r1)
    srv.drain()
    assert srv._rid_adapter == {}
    r2 = srv.enqueue([5, 6], adapter=1, ttl=0.0)
    r3 = srv.enqueue([7, 8], adapter=0)
    time.sleep(0.01)
    srv.drain()
    assert srv.expire_reason(r2) == "queue_ttl"
    srv.pop_result(r3)
    assert srv._rid_adapter == {}, srv._rid_adapter
    for r in (r0, r1, r2):
        srv.pop_result(r)
    assert srv._rid_adapter == {} and not srv._rid_sampling
    # a submit the pool cannot cover leaves nothing behind
    tiny = paged_multi(base, ads, n_slots=2, max_new_tokens=3, n_pages=2)
    held = tiny.submit(list(range(1, 10)), adapter=0)   # 2 pages worst case
    assert tiny.submit([5, 6, 7], adapter=0) is None
    assert tiny._rid_adapter == {held: 0}
    tiny.drain()
    tiny.pop_result(held)
    rid = tiny.submit([5, 6, 7], adapter=1)
    assert tiny._rid_adapter == {rid: 1}
    tiny.drain()
    assert tiny.pop_result(rid) == merged_ref(base, ads[1], [5, 6, 7],
                                              max_new_tokens=3)
    srv.check_invariants()


def test_multilora_slots_refuse_migration(small):
    srv = paged_multi(small["base"], small["ads"][:1], n_slots=1)
    rid = srv.submit([5, 6, 7], adapter=0)
    srv.step()
    with pytest.raises(NotImplementedError):
        srv.snapshot_slot(rid)
    with pytest.raises(NotImplementedError):
        srv.restore_slot({"rid": rid})
    srv.drain()
    srv.pop_result(rid)


def test_tenant_counters_track_requests_and_tokens(small):
    srv = paged_multi(small["base"], small["ads"][:2], n_slots=1,
                      max_new_tokens=3)
    rid = srv.submit([5, 6, 7], adapter=0)
    srv.drain()
    out = srv.pop_result(rid)
    label = srv._adapter_label(0)
    assert label == adapter_fingerprint(small["ads"][0])
    req = srv.obs.counter("kubetpu_tenant_requests_total", adapter=label)
    tok = srv.obs.counter("kubetpu_tenant_decode_tokens_total",
                          adapter=label)
    assert int(req.value) == 1
    # decode steps only: the first emitted token is the prefill's
    assert int(tok.value) == len(out) - 3 - 1
    text = srv.metrics_text()
    assert "kubetpu_adapters_resident 2" in text
    assert "kubetpu_adapter_capacity 2" in text
    with pytest.raises(ValueError):
        srv.submit([1, 2], adapter=2)
    with pytest.raises(ValueError):
        srv.enqueue([1, 2], adapter="no-such")
    assert srv.queued() == 0 and srv._rid_adapter == {}
    # the cardinality bound: 200 distinct labels fold into the top K and
    # one overflow series
    srv._adapter_label = lambda aid: f"tenant-{aid}"
    for aid in range(200):
        srv._tenant_counter("req", aid)
    labels = srv._tenant_counters["req"]
    assert len(labels) == _TENANT_TOPK + 1 and _TENANT_OVERFLOW in labels
