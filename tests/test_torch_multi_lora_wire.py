"""The multi-LoRA control plane across the two packages (the port of
``tests/test_multi_lora_wire.py``): the adapter codec writes the JAX
package's bytes and the fingerprints agree, f32 and bf16; the registry's
content identity; ``POST /adapters`` on a port replica (load, replay under
one key, a fresh key's content-idempotent load, evict, 409 while in use,
404 on a replica without LoRA); a multi-LoRA stream skips migration and
finishes in place; and the JAX ``RouterServer`` fronting port replicas:
its ``/adapters`` distribution and a routed generate naming an adapter,
token-exact against the port's in-process server."""

import json
import time
import urllib.error

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubetpu.jobs import ModelConfig as JaxConfig
from kubetpu.jobs import init_params as jax_init_params
from kubetpu.jobs import lora as jlora
from kubetpu.jobs import multi_lora as jml
from kubetpu.router import RouterServer
from kubetpu.router import adapters as jadapters
from kubetpu_torch.jobs import model as tmodel
from kubetpu_torch.jobs.convert import lora_from_numpy, params_from_numpy
from kubetpu_torch.jobs.lora import LoraConfig, merge_lora
from kubetpu_torch.jobs.multi_lora import (PagedMultiLoraDecodeServer,
                                           adapter_fingerprint)
from kubetpu_torch.jobs.paged import PagedDecodeServer
from kubetpu_torch.router import ReplicaServer
from kubetpu_torch.router.adapters import (AdapterRegistry, decode_adapter,
                                           encode_adapter)
from kubetpu_torch.wire.httpcommon import request_json

torch.set_num_threads(1)

JCFG = JaxConfig(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64)
CFG = tmodel.ModelConfig(vocab=64, d_model=32, n_layers=2, n_heads=4,
                         d_ff=64)
JLCFG = jlora.LoraConfig(rank=4, alpha=8.0)
LCFG = LoraConfig(rank=4, alpha=8.0)
PS = 8
MAX_NEW = 4
WAIT = 60.0


def jax_adapter(seed):
    a = jlora.init_lora_params(jax.random.PRNGKey(seed), JCFG, JLCFG)
    keys = jax.random.split(jax.random.PRNGKey(seed + 100), len(a["blocks"]))
    for i, (k, v) in enumerate(sorted(a["blocks"].items())):
        if k.endswith("_b"):
            a["blocks"][k] = jax.random.normal(keys[i], v.shape,
                                               v.dtype) * 0.05
    return a


def to_numpy(jad):
    """The JAX adapter as numpy arrays, leaves in its own key order (the
    order the codec writes them in; ``jax.tree.map`` would sort them)."""
    return {"blocks": {k: np.asarray(v) for k, v in jad["blocks"].items()}}


def to_port(jad, dtype=torch.float32):
    return lora_from_numpy(to_numpy(jad), device="cpu", dtype=dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codec_and_fingerprint_match_the_jax_package(dtype):
    """The same adapter, JAX and port: identical wire JSON, identical
    fingerprints, and each package decodes the other's payload to the same
    fingerprint (a bf16 leaf arrives as a ``torch.bfloat16`` tensor)."""
    jad = jax_adapter(5)
    if dtype == "bfloat16":
        jad = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jad)
    port = to_port(jad, getattr(torch, dtype))
    j_enc, p_enc = jadapters.encode_adapter(jad), encode_adapter(port)
    assert json.dumps(p_enc) == json.dumps(j_enc)
    assert {v["dtype"] for v in p_enc["blocks"].values()} == {dtype}
    fp = jml.adapter_fingerprint(jad)
    assert adapter_fingerprint(port) == fp
    back = decode_adapter(j_enc)
    assert adapter_fingerprint(back) == fp
    if dtype == "bfloat16":
        assert all(v.dtype == torch.bfloat16 for v in back["blocks"].values())
    assert jml.adapter_fingerprint(jadapters.decode_adapter(p_enc)) == fp
    # the fingerprint sorts the keys: the leaves' order does not matter
    assert adapter_fingerprint(lora_from_numpy(
        jax.tree.map(np.asarray, jad), device="cpu",
        dtype=getattr(torch, dtype))) == fp


def test_adapter_codec_round_trip_and_refusals():
    a = to_port(jax_adapter(5))
    back = decode_adapter(encode_adapter(a))
    assert adapter_fingerprint(back) == adapter_fingerprint(a)
    with pytest.raises(ValueError):
        decode_adapter({"blocks": {}})
    wire = encode_adapter(a)
    wire["blocks"]["wq_a"] = {"dtype": "float32", "shape": [3], "data": "!!"}
    with pytest.raises(ValueError):
        decode_adapter(wire)
    wire["blocks"]["wq_a"] = {"dtype": "bfloat16", "shape": [3],
                              "data": "AAAA"}
    with pytest.raises(ValueError):
        decode_adapter(wire)


def test_registry_content_identity():
    reg = AdapterRegistry()
    a, b = to_port(jax_adapter(1)), to_port(jax_adapter(2))
    n = reg.register(a)
    assert n == adapter_fingerprint(a)
    assert n == jadapters.AdapterRegistry().register(jax_adapter(1))
    assert reg.register(a) == n                  # same bytes: no-op
    reg.register(b, name="tenant-b")
    with pytest.raises(ValueError):
        reg.register(a, name="tenant-b")         # an alias never retargets
    assert reg.names() == sorted([n, "tenant-b"]) and len(reg) == 2
    assert reg.encoded("tenant-b") is reg.encoded("tenant-b")   # cached
    with pytest.raises(KeyError):
        reg.get("no-such")


def port_packed(base, ads, **kw):
    return PagedMultiLoraDecodeServer(
        CFG, base, LCFG, ads, max_adapters=3, n_slots=2, max_seq=64,
        max_new_tokens=MAX_NEW, page_size=PS, prefill_budget=PS,
        prefix_cache_pages=16, device="cpu", **kw)


def merged_tokens(base, adapter, prompt):
    srv = PagedDecodeServer(CFG, merge_lora(base, adapter, LCFG), n_slots=1,
                            max_seq=64, max_new_tokens=MAX_NEW, page_size=PS,
                            prefill_budget=PS, device="cpu")
    rid = srv.enqueue(prompt)
    srv.drain()
    return srv.pop_result(rid)


@pytest.fixture(scope="module")
def fleet():
    """The JAX router (a JAX registry attached) in front of one packed
    multi-LoRA port replica and one plain port replica; every adapter made
    by the JAX package and carried across."""
    jparams = jax_init_params(jax.random.PRNGKey(0), JCFG)
    base = params_from_numpy(jax.tree.map(np.asarray, jparams), CFG,
                             device="cpu")
    jads = [jax_adapter(1), jax_adapter(2)]
    extra = jax_adapter(3)
    packed = port_packed(base, [to_port(a) for a in jads])
    plain = PagedDecodeServer(CFG, base, n_slots=2, max_seq=64,
                              max_new_tokens=MAX_NEW, page_size=PS,
                              prefill_budget=PS, device="cpu")
    reps = [ReplicaServer(packed, "packed0", idle_wait=0.002),
            ReplicaServer(plain, "plain0", idle_wait=0.002)]
    for rep in reps:
        rep.start()
    jreg = jadapters.AdapterRegistry()
    for a in jads:
        jreg.register(a)
    jreg.register(extra, name="tenant-extra")
    preg = AdapterRegistry()
    preg.register(to_port(extra), name="tenant-extra")
    router = RouterServer(load_refresh_s=0.05, adapters=jreg)
    router.start()
    for rep in reps:
        router.register_replica(rep.address)
    yield {"router": router, "reps": reps, "preg": preg, "base": base,
           "extra": to_port(extra)}
    router.shutdown()
    for rep in reps:
        rep.shutdown(graceful=False)


def test_adapters_leg_load_replay_evict_and_409(fleet):
    """Load under one key twice: the replay answers without loading again;
    a fresh key re-executes but the load is content-idempotent. An adapter
    a live (here: finished but unpopped) request references refuses its
    evict with 409; after the pop it evicts, and a replayed evict is a
    no-op."""
    packed_rep, _ = fleet["reps"]
    srv, preg = packed_rep.server, fleet["preg"]
    loads = srv.obs.counter("kubetpu_adapter_loads_total")
    loads0 = int(loads.value)
    payload = {"action": "load", "name": "tenant-extra",
               "adapter": preg.encoded("tenant-extra")}
    url = packed_rep.address + "/adapters"
    out1 = request_json(url, payload, idempotency_key="ad-load-1",
                        timeout=WAIT)
    out2 = request_json(url, payload, idempotency_key="ad-load-1",
                        timeout=WAIT)
    assert out1 == out2 and "tenant-extra" in out1["resident"]
    assert int(loads.value) == loads0 + 1
    out3 = preg.push_adapter(packed_rep.address, "tenant-extra",
                             timeout=WAIT)
    assert "tenant-extra" in out3["resident"]
    assert int(loads.value) == loads0 + 1
    with packed_rep._cv:
        rid = srv.enqueue([5, 6, 7], adapter="tenant-extra")
    with pytest.raises(urllib.error.HTTPError) as e:
        preg.evict_adapter(packed_rep.address, "tenant-extra", timeout=WAIT)
    assert e.value.code == 409
    deadline = time.monotonic() + WAIT
    while True:
        with packed_rep._cv:
            if srv.finished(rid):
                out = srv.pop_result(rid)
                break
        assert time.monotonic() < deadline
        time.sleep(0.01)
    assert out == merged_tokens(fleet["base"], fleet["extra"], [5, 6, 7])
    assert preg.evict_adapter(packed_rep.address, "tenant-extra",
                              timeout=WAIT)["evicted"] is True
    assert preg.evict_adapter(packed_rep.address, "tenant-extra",
                              timeout=WAIT)["evicted"] is False
    with pytest.raises(urllib.error.HTTPError) as e:
        request_json(packed_rep.address + "/generate",
                     {"prompt": [1, 2], "adapter": "tenant-extra",
                      "timeout": 10.0},
                     idempotency_key="ad-stale-1", timeout=10.0)
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        request_json(url, {"action": "load", "adapter": {"blocks": {}}},
                     idempotency_key="ad-bad-1", timeout=10.0)
    assert e.value.code == 400
    with packed_rep._cv:
        srv.check_invariants()


def test_replica_without_lora_refuses_the_adapter_legs(fleet):
    _, plain_rep = fleet["reps"]
    with pytest.raises(urllib.error.HTTPError) as e:
        fleet["preg"].push_adapter(plain_rep.address, "tenant-extra",
                                   timeout=10.0)
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        request_json(plain_rep.address + "/generate",
                     {"prompt": [1, 2], "adapter": 0, "timeout": 10.0},
                     idempotency_key="ad-plain-1", timeout=10.0)
    assert e.value.code == 400


def test_jax_router_distributes_and_routes_to_port_replicas(fleet):
    """The JAX router's ``/adapters`` fans the adapter out to the packed
    port replica (the plain one is skipped, not failed); a routed generate
    naming it lands there and returns the in-process server's tokens."""
    router, (packed_rep, _) = fleet["router"], fleet["reps"]
    out = request_json(router.address + "/adapters",
                       {"action": "load", "name": "tenant-extra"},
                       idempotency_key="ad-dist-1", timeout=WAIT)
    assert out["results"]["packed0"]["ok"] is True
    assert "tenant-extra" in packed_rep.server.resident_adapters()
    summ = request_json(router.address + "/adapters", None, timeout=10.0)
    assert "tenant-extra" in summ["registered"]
    time.sleep(0.2)          # the router's /load poll sees the residency
    body = request_json(router.address + "/generate",
                        {"prompt": [5, 6, 7], "adapter": "tenant-extra",
                         "timeout": WAIT},
                        idempotency_key="ad-gen-1", timeout=WAIT)
    assert body["replica"] == "packed0"
    assert body["tokens"] == merged_tokens(fleet["base"], fleet["extra"],
                                           [5, 6, 7])
    with packed_rep._cv:
        packed_rep.server.check_invariants()


def test_port_router_distribute_and_summary(fleet):
    """The port's router with the port's registry in front of the same
    replicas: ``POST /adapters`` fans the registered adapter out to the
    packed replica (the plain one is skipped, not failed), ``GET``
    summarizes registry and residency, an unregistered name is 404, a
    routed generate naming the tenant lands the packed replica through the
    tenant-affine pick with the in-process server's tokens, and an evict
    fans out too."""
    from kubetpu_torch.router import RouterServer as PortRouterServer

    packed_rep, plain_rep = fleet["reps"]
    router = PortRouterServer(load_refresh_s=0.05, adapters=fleet["preg"])
    router.start()
    try:
        for rep in fleet["reps"]:
            router.register_replica(rep.address)
        out = request_json(router.address + "/adapters",
                           {"action": "load", "name": "tenant-extra"},
                           idempotency_key="pr-dist-1", timeout=WAIT)
        assert out["results"]["packed0"]["ok"] is True
        assert "plain0" not in out["results"]
        assert "tenant-extra" in packed_rep.server.resident_adapters()
        summ = request_json(router.address + "/adapters", None,
                            timeout=10.0)
        assert summ["registered"] == ["tenant-extra"]
        with pytest.raises(urllib.error.HTTPError) as e:
            request_json(router.address + "/adapters",
                         {"action": "load", "name": "no-such"},
                         idempotency_key="pr-dist-2", timeout=10.0)
        assert e.value.code == 404
        router.pool.refresh(0.0)     # the /load snapshot sees residency
        affine = router._c_tenant_affine.value
        body = request_json(router.address + "/generate",
                            {"prompt": [5, 6, 7], "adapter": "tenant-extra",
                             "timeout": WAIT},
                            idempotency_key="pr-gen-1", timeout=WAIT)
        assert body["replica"] == "packed0"
        assert router._c_tenant_affine.value == affine + 1
        assert body["tokens"] == merged_tokens(fleet["base"],
                                               fleet["extra"], [5, 6, 7])
        out = request_json(router.address + "/adapters",
                           {"action": "evict", "name": "tenant-extra"},
                           idempotency_key="pr-evict-1", timeout=WAIT)
        assert out["results"]["packed0"]["ok"] is True
        assert "tenant-extra" not in packed_rep.server.resident_adapters()
        with packed_rep._cv:
            packed_rep.server.check_invariants()
    finally:
        router.shutdown()


def test_multilora_stream_skips_migration_and_finishes_in_place(fleet):
    packed_rep, plain_rep = fleet["reps"]
    srv = packed_rep.server
    with packed_rep._cv:
        rid = srv.enqueue([9, 10, 11], adapter=1)
        while not srv.migratable_rids():
            srv.step()
        assert packed_rep.migrate_rid(rid, plain_rep.address) is False
        assert srv.events.events(kind="migrate_skip") or \
            packed_rep.events.events(kind="migrate_skip")
        srv.drain()
        out = srv.pop_result(rid)
        assert len(out) == 3 + MAX_NEW
        srv.check_invariants()
