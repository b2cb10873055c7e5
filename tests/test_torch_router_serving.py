"""The port's data plane over port serving replicas (CPU): routing is
semantics-free — greedy tokens through ``kubetpu_torch.router.
RouterServer``, with prefix-affinity placement and cache hits, equal a
direct serial run on one replica — and affinity warms the trees (each
prompt family pinned to one replica, later members hitting it). These are
the JAX package's ``tests/test_router_serving.py`` cases on the port.

The storm case runs the same seeded storm (``scripts/router_check.py``'s
shape: three shared-prefix families and a sub-page loner) through the
port's router in front of port replicas and through the JAX router in
front of JAX replicas, then a mid-decode migration that makes the router
re-pin and a drain cordon that makes it fall back: both stacks place every
request on the same replica, count the same fallbacks and re-pins and
return the same greedy tokens.

Weights: ``trained_small`` (greedy parity across frameworks needs trained
weights). Wire waits are on state, with deadlines of at least 60 s."""

import threading
import urllib.error

import jax
import numpy as np
import pytest
import torch

from kubetpu.jobs.paged import PagedDecodeServer as JaxPagedServer
from kubetpu.router import ReplicaServer as JaxReplicaServer
from kubetpu.router import RouterServer as JaxRouterServer
from kubetpu_torch.jobs import model as tmodel
from kubetpu_torch.jobs.convert import params_from_numpy
from kubetpu_torch.jobs.paged import PagedDecodeServer
from kubetpu_torch.obs import span
from kubetpu_torch.router import (ReplicaAutoscaler, ReplicaServer,
                                  RouterServer, ScalePolicy, prefix_head_key)
from kubetpu_torch.wire.httpcommon import request_json
from test_torch_migration import StepGate

torch.set_num_threads(1)

PS = 8
MAX_NEW = 4
WAIT = 60.0


@pytest.fixture(scope="module")
def both(trained_small):
    jcfg, params, _ = trained_small
    cfg = tmodel.ModelConfig(
        vocab=jcfg.vocab, d_model=jcfg.d_model, n_layers=jcfg.n_layers,
        n_heads=jcfg.n_heads, d_ff=jcfg.d_ff, max_seq=jcfg.max_seq)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    return jcfg, params, cfg, model


def _server(both, max_new_tokens=MAX_NEW, n_slots=2):
    return PagedDecodeServer(
        both[2], both[3], n_slots=n_slots, max_seq=64,
        max_new_tokens=max_new_tokens, page_size=PS, prefill_budget=PS,
        prefix_cache_pages=16, device="cpu")


def _jax_server(both, max_new_tokens=MAX_NEW):
    return JaxPagedServer(
        both[0], both[1], n_slots=2, max_seq=64,
        max_new_tokens=max_new_tokens, page_size=PS, prefill_budget=PS,
        prefix_cache_pages=16)


def _family_prompts():
    """Three shared-prefix families (two full pages each) x two tails —
    the fleet workload affinity routing exists for."""
    prompts = []
    for f, seed in enumerate((5, 7, 11)):
        fam = [(i * seed) % 60 + 1 for i in range(2 * PS)]
        for tail in range(2):
            prompts.append(fam + [f * 10 + tail + 1])
    return prompts


@pytest.fixture(scope="module")
def routed_fleet(both):
    """The port's router + 2 port paged replicas + the routed storm's
    results, torn down after the module."""
    replicas = []
    for i in range(2):
        rep = ReplicaServer(_server(both), f"paged{i}", idle_wait=0.002)
        rep.start()
        replicas.append(rep)
    router = RouterServer(load_refresh_s=0.05)
    router.start()
    for rep in replicas:
        router.register_replica(rep.address)
    results = []
    with span("router-serving-test") as root:
        for i, prompt in enumerate(_family_prompts()):
            body = request_json(router.address + "/generate",
                                {"prompt": prompt, "timeout": WAIT},
                                idempotency_key=f"t-serve-{i}", timeout=WAIT)
            results.append((prompt, body))
        tid = root.trace_id
    yield router, replicas, results, tid
    router.shutdown()
    for rep in replicas:
        rep.shutdown(graceful=False)


def test_router_tokens_match_direct_serving(routed_fleet, both):
    """Semantics-free routing: greedy tokens through the router == a quiet
    direct serial run (same weights), prefix-cache hits and replica
    placement notwithstanding; the trace stitches the router hop above a
    replica leg."""
    router, _replicas, results, tid = routed_fleet
    direct = _server(both)
    for prompt, body in results:
        rid = direct.enqueue(prompt)
        direct.drain()
        assert body["tokens"] == direct.pop_result(rid), (
            f"router tokens diverged for prompt {prompt[:4]}...")
    comps = {s.get("component", "") for s in router.trace(tid)["spans"]}
    assert "router" in comps
    assert any(c.startswith("replica:") for c in comps), comps


def test_affinity_pins_families_and_warms_trees(routed_fleet):
    """Each shared-prefix family lands on ONE replica, and the second
    member of every family hits that replica's warm radix tree."""
    _router, replicas, results, _tid = routed_fleet
    prompts = _family_prompts()
    by_family = {}
    for prompt, body in results:
        by_family.setdefault(tuple(prompt[:2 * PS]), set()).add(
            body["replica"])
    assert len(by_family) == 3
    for members in by_family.values():
        assert len(members) == 1
    hits = sum(rep.server.prefix_cache_stats()["requests_hit"]
               for rep in replicas)
    # one cold miss per family; every later family member hits
    assert hits >= len(prompts) - len(by_family)
    for rep in replicas:
        with rep._cv:
            rep.server.check_invariants()


def test_load_info_reports_pool_pressure(routed_fleet):
    _router, replicas, _results, _tid = routed_fleet
    info = replicas[0].server.load_info()
    assert info["pool_pages"] > 0
    assert 0 <= info["pages_free"] <= info["pool_pages"]
    assert "prefix_hit_rate" in info
    assert info["queue_depth"] == 0


# -- the seeded storm through both stacks -------------------------------------


def _storm_prompts():
    """``scripts/router_check.py``'s storm: three shared-prefix families x
    three tails, and a sub-page loner."""
    prompts = []
    for f, seed in enumerate((5, 7, 11)):
        fam = [(i * seed) % 60 + 1 for i in range(2 * PS)]
        for tail in range(3):
            prompts.append(fam + [f * 10 + tail + 1])
    prompts.append([63] * 3)
    return prompts


def _run_storm(stack, both):
    """The storm on one stack -> [(replica, affinity, tokens)] per request
    and the router's fallback / re-pin / routed counters."""
    if stack == "port":
        make, rep_cls, router_cls = _server, ReplicaServer, RouterServer
    else:
        make, rep_cls, router_cls = (_jax_server, JaxReplicaServer,
                                     JaxRouterServer)
    reps = {}
    for i in range(2):
        rep = rep_cls(make(both, max_new_tokens=12), f"st{i}",
                      idle_wait=0.002)
        rep.start()
        reps[rep.name] = rep
    router = router_cls(load_refresh_s=0.05, seed=0)
    router.start()
    out = []

    def route(prompt, key):
        body = request_json(router.address + "/generate",
                            {"prompt": prompt, "timeout": WAIT},
                            idempotency_key=key, timeout=WAIT)
        out.append((body["replica"], body["affinity"], body["tokens"]))
        return body

    try:
        for rep in reps.values():
            router.register_replica(rep.address)
        prompts = _storm_prompts()
        for i, p in enumerate(prompts):
            route(p, f"storm-{i}")
        # re-pin: a routed stream of family 1 parked mid-decode on its
        # owner, migrated to the other replica; the router chases the 409
        owner = out[3][0]
        other = next(n for n in reps if n != owner)
        gate = StepGate(reps[owner])
        done = {}
        t = threading.Thread(target=lambda: done.update(
            body=route(prompts[3][:-1] + [50], "storm-repin")), daemon=True)
        t.start()
        gate.wait_midstream()
        res = request_json(reps[owner].address + "/migrate_out",
                           {"target": reps[other].address,
                            "reason": "storm"},
                           idempotency_key=f"{stack}-storm-mo", timeout=WAIT)
        assert res == {"migrated": 1, "failed": 0}
        gate.release()
        t.join(WAIT)
        assert not t.is_alive() and done["body"]["replica"] == other
        # fallback: family 0's owner cordoned by a drain; its next member
        # lands on the other replica, counted
        router.pool.drain(out[0][0])
        route(prompts[0][:-1] + [51], "storm-fallback")
        for rep in reps.values():
            with rep._cv:
                rep.server.check_invariants()
        counters = {"fallback": router._c_fallback.value,
                    "repin": router._c_repin.value,
                    "routed": router._c_routed.value}
    finally:
        router.shutdown()
        for rep in reps.values():
            rep.shutdown(graceful=False)
    return out, counters


def test_seeded_storm_equals_the_jax_stack(both):
    """Request for request, the port's stack and the JAX stack pick the
    same replica (affinity flag included), fall back and re-pin alike, and
    return the same greedy tokens, which equal a quiet direct run."""
    port, port_counts = _run_storm("port", both)
    ref, ref_counts = _run_storm("jax", both)
    assert [(r, a) for r, a, _ in port] == [(r, a) for r, a, _ in ref]
    assert [t for _, _, t in port] == [t for _, _, t in ref]
    assert port_counts == ref_counts
    assert port_counts["repin"] == 1 and port_counts["fallback"] >= 1
    assert port[-1][1] is False                 # the fallback request
    families = {}
    for prompt, (name, _, _) in zip(_storm_prompts()[:9], port[:9]):
        families.setdefault(tuple(prompt[:2 * PS]), set()).add(name)
    assert all(len(v) == 1 for v in families.values())
    direct = _server(both, max_new_tokens=12)
    for prompt, (_, _, tokens) in zip(_storm_prompts(), port):
        rid = direct.enqueue(prompt)
        direct.drain()
        assert tokens == direct.pop_result(rid)


def test_router_events_query_is_validated(routed_fleet):
    """``/events?limit=abc`` is 400 at the port's router, as at the JAX
    package's; ``?kind=route`` keeps the storm's six route events."""
    from kubetpu_torch.obs.events import validate_events_jsonl
    from kubetpu_torch.wire.httpcommon import request_text

    router, _replicas, _results, _tid = routed_fleet
    with pytest.raises(urllib.error.HTTPError) as err:
        request_text(router.address + "/events?limit=abc")
    assert err.value.code == 400
    routes = request_text(router.address + "/events?kind=route")
    assert validate_events_jsonl(routes) == []
    assert len(routes.splitlines()) == len(_family_prompts())


def _prompts_owned_by(router, names, per_replica):
    """*per_replica* single-page prompts of distinct families for each of
    *names*, picked by the router's own ring lookup."""
    out = {n: [] for n in names}
    seed = 1
    while any(len(v) < per_replica for v in out.values()):
        seed += 1
        p = [(i * seed + seed) % 60 + 1 for i in range(PS + 3)]
        owner = router.ring.lookup(prefix_head_key(
            p, router.head_tokens, router.head_quantum))
        if owner in out and len(out[owner]) < per_replica:
            out[owner].append(p)
    return out


def test_autoscaler_scale_down_migrates_streams_token_exact(both):
    """A hot policy (real TTFT over a 1 us ceiling) scales the fleet up
    through a launcher that builds a port replica; a relaxed policy then
    scales it down, migrate-then-remove, from a replica holding two
    mid-decode routed streams: they finish on the survivor (the router
    re-pins each) with the quiet run's tokens, and the router's events
    read scale_up < scale_down_migrate < drain < scale_down."""
    reps, stopped = {}, []

    def make(name):
        rep = ReplicaServer(_server(both, max_new_tokens=24, n_slots=4),
                            name, idle_wait=0.002)
        rep.start()
        reps[name] = rep
        return rep

    router = RouterServer(load_refresh_s=0.05, head_quantum=PS)
    router.start()
    threads = []
    try:
        router.register_replica(make("scale-b").address)
        scaler = ReplicaAutoscaler(
            router, lambda: make("scale-a").address,
            policy=ScalePolicy(min_replicas=1, max_replicas=2, up_after=1,
                               down_after=1, cooldown_s=0.0,
                               ttft_p50_ms=0.001),
            terminator=lambda name, url: stopped.append(name))
        request_json(router.address + "/generate",
                     {"prompt": [1, 2, 3], "timeout": WAIT},
                     idempotency_key="scale-warm", timeout=WAIT)
        assert scaler.poll_once()["action"] == "scale_up:scale-a"
        owned = _prompts_owned_by(router, sorted(reps), 2)
        gates = {n: StepGate(reps[n], count=2) for n in reps}
        bodies = {}
        for name, prompts in owned.items():
            for j, p in enumerate(prompts):
                key = f"scale-{name}-{j}"
                t = threading.Thread(target=lambda p=p, key=key: bodies.update(
                    {key: request_json(router.address + "/generate",
                                       {"prompt": p, "timeout": WAIT},
                                       idempotency_key=key, timeout=WAIT)}),
                    daemon=True)
                t.start()
                threads.append(t)
        for gate in gates.values():
            gate.wait_midstream()
        scaler.policy = ScalePolicy(min_replicas=1, max_replicas=2,
                                    up_after=99, down_after=1,
                                    cooldown_s=0.0, cold_active_frac=1.01)
        # equal load on both: the victim is the first name
        assert scaler.poll_once()["action"] == "drain:scale-a"
        gates["scale-b"].release()
        for _ in range(int(WAIT / 0.05)):
            action = scaler.poll_once()["action"]
            if action is not None:
                break
            threading.Event().wait(0.05)
        assert action == "scale_down:scale-a"
        assert stopped == ["scale-a"]
        assert router.pool.names() == ["scale-b"]
        for t in threads:
            t.join(WAIT)
            assert not t.is_alive()
        direct = _server(both, max_new_tokens=24, n_slots=4)
        for name, prompts in owned.items():
            for j, p in enumerate(prompts):
                body = bodies[f"scale-{name}-{j}"]
                rid = direct.enqueue(p)
                direct.drain()
                assert body["tokens"] == direct.pop_result(rid)
                assert body["replica"] == "scale-b"
        assert router._c_repin.value == 2
        seqs = {}
        for e in router.events.events():
            seqs.setdefault(e["kind"], e["seq"])
        assert (seqs["scale_up"] < seqs["scale_down_migrate"]
                < seqs["drain"] < seqs["scale_down"])
        with reps["scale-b"]._cv:
            reps["scale-b"].server.check_invariants()
    finally:
        router.shutdown()
        for rep in reps.values():
            rep.shutdown(graceful=False)
