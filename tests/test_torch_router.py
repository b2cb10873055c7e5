"""The port's data plane (``kubetpu_torch.router`` and ``obs``), held to
the JAX package's router tests case for case: hash-ring stability, the
replica wire surface, affinity routing and load fallback, SLO-class
admission, breaker health, graceful drain, the autoscaler's event order,
the disaggregated roles and the router's surfaces, read by the JAX
package's ``cli.obs``.

Everything here runs against ``FakeSlotServer`` — a host-only stand-in
for the ``SlotServerBase`` duck surface — behind the port's
``ReplicaServer``, so the wire, admission and scaling logic run without
model work (the model-backed token parity lives in
``tests/test_torch_router_serving.py``). The seeded ring check holds the
port's ``HashRing`` and ``prefix_head_key`` to the reference's."""

import threading
import time
import urllib.error

import pytest

from kubetpu_torch.obs.events import EventLog
from kubetpu_torch.obs.registry import Registry, validate_prometheus_text
from kubetpu_torch.obs.slo import Objective
from kubetpu_torch.router import (
    HashRing,
    ReplicaAutoscaler,
    ReplicaServer,
    RouterServer,
    ScalePolicy,
    prefix_head_key,
)
from kubetpu_torch.wire.faults import FaultInjector, RoutePolicy
from kubetpu_torch.wire.httpcommon import NO_RETRY, request_json, request_text


class FakeSlotServer:
    """Host-only ``SlotServerBase`` duck: admits into ``n_slots``,
    emits one deterministic token per step (prompt reversed, cycled),
    finishes after ``max_new`` tokens. ``load_override`` lets tests
    feed the autoscaler synthetic pressure signals."""

    def __init__(self, n_slots=2, max_new=3, step_sleep=0.0):
        self.obs = Registry()
        self.events = EventLog(component="serving")
        self.slo = None
        self.n_slots = n_slots
        self.max_new = max_new
        self.step_sleep = step_sleep
        self.load_override = {}
        self._next = 0
        self._queue = []
        self._prompts = {}
        self._emitted = {}
        self._active = set()
        self._done = {}
        self._expired = {}
        self.obs.gauge_fn("kubetpu_serving_queue_depth",
                          lambda: len(self._queue))
        self.obs.gauge_fn("kubetpu_serving_active_slots",
                          lambda: len(self._active))

    def enqueue(self, prompt, sampling=None, ttl=None):
        if not prompt:
            raise ValueError("empty prompt")
        if sampling and float(sampling.get("temperature", 0) or 0) < 0:
            raise ValueError("temperature must be >= 0")
        rid = self._next
        self._next += 1
        self._prompts[rid] = list(prompt)
        self._emitted[rid] = []
        self._done[rid] = False
        self._queue.append(rid)
        return rid

    def step(self):
        if self.step_sleep:
            time.sleep(self.step_sleep)
        while self._queue and len(self._active) < self.n_slots:
            rid = self._queue.pop(0)
            self._active.add(rid)
            self.events.emit("admit", rid=rid)
        out = {}
        for rid in sorted(self._active):
            toks = self._emitted[rid]
            prompt = self._prompts[rid]
            toks.append(prompt[::-1][len(toks) % len(prompt)])
            out[rid] = [toks[-1]]
            if len(toks) >= self.max_new:
                self._done[rid] = True
                self._active.discard(rid)
                self.events.emit("retire", rid=rid)
        return out

    def _idle(self):
        return not self._queue and not self._active

    def finished(self, rid):
        return self._done.get(rid, False)

    def cancel(self, rid):
        if self._done.get(rid, True):
            return False
        self._queue = [r for r in self._queue if r != rid]
        self._active.discard(rid)
        self._done[rid] = True
        return True

    def expire_reason(self, rid):
        return self._expired.get(rid)

    def pop_result(self, rid):
        out = self._prompts.pop(rid) + self._emitted.pop(rid)
        del self._done[rid]
        return out

    # -- the migration duck surface (host-only: nothing to
    # snapshot, so drains with a migrate target complete via idleness)

    def migratable_rids(self):
        return []

    def migrated_to(self, rid):
        return None

    def unfinished_rids(self):
        return sorted(set(self._queue) | self._active)

    def cancel_expired(self, rid, reason):
        if self._done.get(rid, False):
            return False
        self._expired[rid] = str(reason)
        return self.cancel(rid)

    def metrics_text(self):
        return self.obs.render()

    def load_info(self):
        info = {
            "n_slots": self.n_slots,
            "active_slots": len(self._active),
            "queue_depth": len(self._queue),
            "inflight_prefills": 0,
            "queue_wait_p99_ms": 0.0,
            "ttft_p50_ms": 0.0,
        }
        info.update(self.load_override)
        return info


@pytest.fixture()
def fleet(request):
    """(router, [(replica_server, fake)]) with 2 registered replicas;
    everything shut down at teardown."""
    made = []

    def build(n=2, router_kw=None, fake_kw=None):
        router = RouterServer(load_refresh_s=0.0, **(router_kw or {}))
        router.start()
        replicas = []
        for i in range(n):
            fake = FakeSlotServer(**(fake_kw or {}))
            rep = ReplicaServer(fake, f"rep{i}", idle_wait=0.002)
            rep.start()
            router.register_replica(rep.address)
            replicas.append((rep, fake))
        made.append((router, replicas))
        return router, replicas

    yield build
    for router, replicas in made:
        router.shutdown()
        for rep, _fake in replicas:
            rep.shutdown(graceful=False)


# -- hashing -----------------------------------------------------------------


def test_prefix_head_key_depends_only_on_head():
    a = prefix_head_key([5] * 40 + [1], head_tokens=32)
    b = prefix_head_key([5] * 40 + [2, 3, 4], head_tokens=32)
    c = prefix_head_key([6] + [5] * 39, head_tokens=32)
    assert a == b          # tails past the head don't matter
    assert a != c          # any head token does
    # stable across processes/runs: pinned literal
    assert prefix_head_key([1, 2, 3]) == (
        prefix_head_key((1, 2, 3)))


def test_ring_add_remaps_about_one_over_n():
    """Adding a 5th replica must remap ~1/5 of keys — every moved key
    moving TO the newcomer — and removing it must restore the exact
    prior mapping (the scale-event cache-survival contract)."""
    keys = [prefix_head_key([i, i * 3, i * 7]) for i in range(1000)]
    ring = HashRing(vnodes=64)
    for n in ("r0", "r1", "r2", "r3"):
        ring.add(n)
    before = {k: ring.lookup(k) for k in keys}
    ring.add("r4")
    after = {k: ring.lookup(k) for k in keys}
    moved = [k for k in keys if before[k] != after[k]]
    # expected 0.20 at 64 vnodes; generous bounds for the fixed hash
    assert 0.08 < len(moved) / len(keys) < 0.40
    assert all(after[k] == "r4" for k in moved)
    ring.remove("r4")
    assert {k: ring.lookup(k) for k in keys} == before


def test_ring_remove_only_moves_the_removed_owner():
    keys = [prefix_head_key([i, i + 1]) for i in range(1000)]
    ring = HashRing(vnodes=64)
    for n in ("r0", "r1", "r2", "r3"):
        ring.add(n)
    before = {k: ring.lookup(k) for k in keys}
    ring.remove("r1")
    after = {k: ring.lookup(k) for k in keys}
    moved = [k for k in keys if before[k] != after[k]]
    assert moved and all(before[k] == "r1" for k in moved)
    assert all(after[k] != "r1" for k in keys)


def test_ring_preference_is_deterministic_and_full():
    ring = HashRing(vnodes=16)
    for n in ("a", "b", "c"):
        ring.add(n)
    key = prefix_head_key([9, 9, 9])
    pref = ring.preference(key)
    assert sorted(pref) == ["a", "b", "c"]
    assert pref == ring.preference(key)
    assert ring.preference(key, n=1) == [pref[0]]
    assert HashRing().preference(key) == []


# -- replica wire surface ----------------------------------------------------


def test_ring_and_head_key_equal_the_reference():
    """Seeded names and keys: the port's ``prefix_head_key`` digests and
    ``HashRing`` lookups and full preference lists equal the JAX
    package's (two routers, one of each, place every key alike)."""
    import random

    from kubetpu.router import hashring as ref

    rng = random.Random(1234)
    names = [f"rep-{rng.randrange(10**6)}" for _ in range(7)]
    ours, theirs = HashRing(vnodes=48), ref.HashRing(vnodes=48)
    for n in names:
        ours.add(n)
        theirs.add(n)
    for _ in range(300):
        toks = [rng.randrange(32000) for _ in range(rng.randrange(1, 80))]
        head, quantum = rng.choice([(32, 16), (64, 8), (512, 16)])
        key = prefix_head_key(toks, head_tokens=head, quantum=quantum)
        assert key == ref.prefix_head_key(toks, head_tokens=head,
                                          quantum=quantum)
        assert ours.lookup(key) == theirs.lookup(key)
        assert ours.preference(key) == theirs.preference(key)
    ours.remove(names[2])
    theirs.remove(names[2])
    assert ours.members() == theirs.members()
    for i in range(100):
        key = prefix_head_key([i, 7 * i, 3])
        assert ours.preference(key) == theirs.preference(key)


def test_replica_generate_roundtrip(fleet):
    _router, replicas = fleet(n=1)
    rep, _fake = replicas[0]
    body = request_json(rep.address + "/generate",
                        {"prompt": [1, 2, 3]},
                        idempotency_key="t-rt-1")
    assert body["tokens"][:3] == [1, 2, 3]
    assert len(body["emitted"]) == 3          # max_new
    assert body["replica"] == "rep0"
    load = request_json(rep.address + "/load")
    assert load["queue_depth"] == 0 and load["draining"] is False
    text = request_text(rep.address + "/metrics")
    assert validate_prometheus_text(text) == []
    assert "kubetpu_replica_generate_requests_total 1" in text


def test_replica_idempotent_replay_no_double_admission(fleet):
    _router, replicas = fleet(n=1)
    rep, fake = replicas[0]
    first = request_json(rep.address + "/generate", {"prompt": [7, 8]},
                         idempotency_key="t-replay")
    again = request_json(rep.address + "/generate", {"prompt": [7, 8]},
                         idempotency_key="t-replay")
    assert again == first                     # committed result replayed
    assert len(fake.events.events(kind="admit")) == 1
    text = request_text(rep.address + "/metrics")
    assert "kubetpu_replica_generate_requests_total 1" in text
    assert "kubetpu_replica_generate_replays_total 1" in text


def test_replica_truncated_response_retry_is_replayed():
    """The partial fault: the first POST EXECUTES but its response is
    truncated mid-write; the client's keyed retry must get the
    committed tokens replayed — never a second admission (the
    double-allocation window idempotency keys exist for)."""
    fake = FakeSlotServer()
    faults = FaultInjector(seed=3, routes={
        "/generate": RoutePolicy(partial=1.0, times=1)})
    rep = ReplicaServer(fake, "rp", faults=faults, idle_wait=0.002)
    rep.start()
    try:
        body = request_json(rep.address + "/generate",
                            {"prompt": [4, 5, 6]},
                            idempotency_key="t-partial")
        assert body["tokens"][:3] == [4, 5, 6]
        assert faults.counts.get("partial") == 1
        assert len(fake.events.events(kind="admit")) == 1
        text = request_text(rep.address + "/metrics")
        assert "kubetpu_replica_generate_replays_total 1" in text
    finally:
        rep.shutdown(graceful=False)


def test_draining_replica_completes_inflight_requests(fleet):
    """The scale-down prerequisite: a request in flight when drain
    lands COMPLETES (tokens delivered), while new work is refused."""
    _router, replicas = fleet(n=1, fake_kw={"step_sleep": 0.03,
                                            "max_new": 5})
    rep, _fake = replicas[0]
    out = {}

    def go():
        out["body"] = request_json(rep.address + "/generate",
                                   {"prompt": [1, 2]},
                                   idempotency_key="t-drain",
                                   timeout=30.0)

    t = threading.Thread(target=go)
    t.start()
    time.sleep(0.06)              # mid-generation
    request_json(rep.address + "/drain", {},
                 idempotency_key="t-drain-post")
    t.join(timeout=10.0)
    assert not t.is_alive()
    assert len(out["body"]["emitted"]) == 5   # completed, not dropped
    with pytest.raises(urllib.error.HTTPError) as ei:
        request_json(rep.address + "/generate", {"prompt": [9]},
                     retry=NO_RETRY)
    assert ei.value.code == 503


# -- routing -----------------------------------------------------------------


def test_affinity_same_head_same_replica(fleet):
    router, _replicas = fleet(n=3)
    heads = {}
    for fam in range(3):
        picks = set()
        for tail in range(4):
            body = request_json(
                router.address + "/generate",
                {"prompt": [fam + 1] * 40 + [tail + 1]},
                idempotency_key=f"t-aff-{fam}-{tail}")
            picks.add(body["replica"])
            assert body["affinity"] is True
        assert len(picks) == 1                # family sticks together
        heads[fam] = picks.pop()
    counts = router.events.counts()
    assert counts.get("route") == 12


def test_load_fallback_skips_overloaded_target(fleet):
    router, replicas = fleet(n=2)
    prompt = [3] * 40
    target = request_json(router.address + "/generate",
                          {"prompt": prompt},
                          idempotency_key="t-fb-0")["replica"]
    # overload the affinity target: deep queue in its /load snapshot
    fake = dict(replicas)[  # name -> fake via the replica servers
        {rep.name: rep for rep, _f in replicas}[target]]
    fake.load_override = {"queue_depth": 99}
    router.pool.refresh(0.0)
    body = request_json(router.address + "/generate",
                        {"prompt": prompt},
                        idempotency_key="t-fb-1")
    assert body["replica"] != target
    assert body["affinity"] is False
    assert router._c_fallback.value >= 1
    # pressure clears -> affinity returns home
    fake.load_override = {}
    router.pool.refresh(0.0)
    body = request_json(router.address + "/generate",
                        {"prompt": prompt},
                        idempotency_key="t-fb-2")
    assert body["replica"] == target and body["affinity"] is True


def test_cordoned_affinity_target_is_an_honest_fallback(fleet):
    """When the TRUE ring target is draining, landing elsewhere must
    report affinity=False and count as a fallback — the health-skip
    case the fallback metric exists to measure."""
    router, replicas = fleet(n=2)
    prompt = [6] * 40
    target = request_json(router.address + "/generate",
                          {"prompt": prompt},
                          idempotency_key="t-cord-0")["replica"]
    router.pool.drain(target)
    before = router._c_fallback.value
    body = request_json(router.address + "/generate", {"prompt": prompt},
                        idempotency_key="t-cord-1")
    assert body["replica"] != target
    assert body["affinity"] is False
    assert router._c_fallback.value == before + 1


def test_pool_drain_cordon_is_sticky_across_refresh(fleet):
    """pool.drain() promises the cordon holds even when the /drain POST
    was lost: a later refresh reading draining=False from the replica
    must NOT un-cordon the handle."""
    router, replicas = fleet(n=2)
    rep, _fake = replicas[0]
    with router.pool._lock:
        router.pool._replicas[rep.name].draining = True   # as if POST lost
    router.pool.refresh(0.0)      # replica itself reports draining=False
    assert rep.name not in router.pool.routable()


def test_replica_client_error_passes_through_without_failover(fleet):
    """A deterministic replica 4xx (bad sampling) surfaces as-is — not
    retried on a second replica, not mis-filed as upstream_error."""
    router, _replicas = fleet(n=2)
    with pytest.raises(urllib.error.HTTPError) as ei:
        request_json(router.address + "/generate",
                     {"prompt": [1, 2],
                      "sampling": {"temperature": -1.0}},
                     retry=NO_RETRY)
    assert ei.value.code == 400
    assert router._c_uperr.value == 0


def test_autoscaler_launcher_receives_vchip_share(fleet):
    """A ``launcher(role, frac)`` is handed the pool's
    ``vchip_frac`` so a scale-up boots a PACKED fractional replica; a
    zero-arg launcher keeps today's whole-chip behavior; and a
    fractional policy with a share-blind launcher fails loudly instead
    of silently booting whole-chip replicas."""
    router, replicas = fleet(n=1)
    launched = []

    def launcher(role, frac):
        launched.append((role, frac))
        fake = FakeSlotServer()
        rep = ReplicaServer(fake, f"vc{len(launched)}", idle_wait=0.002)
        rep.start()
        launched_reps.append(rep)
        return rep.address

    launched_reps = []
    scaler = ReplicaAutoscaler(
        router, launcher,
        policy=ScalePolicy(min_replicas=1, max_replicas=3, up_after=1,
                           cooldown_s=0.0, vchip_frac=0.25))
    replicas[0][1].load_override = {"queue_wait_p99_ms": 9999.0}
    res = scaler.poll_once()
    assert res["action"] and res["action"].startswith("scale_up:")
    assert launched == [("both", 0.25)]
    for rep in launched_reps:
        rep.shutdown(graceful=False)


def test_autoscaler_zero_arg_launcher_keeps_whole_chip_default(fleet):
    router, replicas = fleet(n=1)
    launched = []

    def launcher():
        fake = FakeSlotServer()
        rep = ReplicaServer(fake, f"z{len(launched)}", idle_wait=0.002)
        rep.start()
        launched.append(rep)
        return rep.address

    scaler = ReplicaAutoscaler(
        router, launcher,
        policy=ScalePolicy(min_replicas=1, max_replicas=3, up_after=1,
                           cooldown_s=0.0))          # vchip_frac=1.0
    replicas[0][1].load_override = {"queue_wait_p99_ms": 9999.0}
    res = scaler.poll_once()
    assert res["action"] and res["action"].startswith("scale_up:")
    assert len(launched) == 1
    for rep in launched:
        rep.shutdown(graceful=False)


def test_autoscaler_legacy_two_param_launcher_not_fed_the_share(fleet):
    """An older ``launcher(role, port_base=9000)`` (defaulted
    second extra) was called with ONE arg — raw arity must not start
    feeding 1.0 into its unrelated parameter. Only a REQUIRED second
    positional (or one named for the share) receives vchip_frac."""
    router, replicas = fleet(n=1)
    launched = []
    launched_reps = []

    def launcher(role, port_base=9000):
        launched.append((role, port_base))
        fake = FakeSlotServer()
        rep = ReplicaServer(fake, f"lg{len(launched)}", idle_wait=0.002)
        rep.start()
        launched_reps.append(rep)
        return rep.address

    scaler = ReplicaAutoscaler(
        router, launcher,
        policy=ScalePolicy(min_replicas=1, max_replicas=3, up_after=1,
                           cooldown_s=0.0))          # vchip_frac=1.0
    replicas[0][1].load_override = {"queue_wait_p99_ms": 9999.0}
    res = scaler.poll_once()
    assert res["action"] and res["action"].startswith("scale_up:")
    assert launched == [("both", 9000)]   # default intact, no 1.0 fed in
    for rep in launched_reps:
        rep.shutdown(graceful=False)
    # and under a FRACTIONAL policy the same launcher is share-blind:
    # loud scale_error, never 0.5 silently bound to port_base
    launched.clear()
    scaler2 = ReplicaAutoscaler(
        router, launcher,
        policy=ScalePolicy(min_replicas=1, max_replicas=3, up_after=1,
                           cooldown_s=0.0, vchip_frac=0.5))
    replicas[0][1].load_override = {"queue_wait_p99_ms": 9999.0}
    scaler2.poll_once()
    assert launched == []                 # never called with the share
    errs = [e for e in router.events.events() if e["kind"] == "scale_error"]
    assert errs and "launcher(role, frac)" in errs[-1]["error"]


def test_autoscaler_fractional_policy_refuses_share_blind_launcher(fleet):
    """vchip_frac < 1 with a launcher that cannot receive the share
    would strand (1 - frac) of every chip while the config claims
    packing — the pass must scale_error, not launch."""
    router, replicas = fleet(n=1)
    launched = []

    def launcher(role):                  # role-aware but share-blind
        launched.append(role)
        return "http://127.0.0.1:1"

    scaler = ReplicaAutoscaler(
        router, launcher,
        policy=ScalePolicy(min_replicas=1, max_replicas=3, up_after=1,
                           cooldown_s=0.0, vchip_frac=0.5))
    replicas[0][1].load_override = {"queue_wait_p99_ms": 9999.0}
    res = scaler.poll_once()
    assert res["action"] is None
    assert launched == []
    errs = [e for e in router.events.events() if e["kind"] == "scale_error"]
    assert errs and "launcher(role, frac)" in errs[-1]["error"]


def test_scale_policy_rejects_bad_vchip_frac():
    with pytest.raises(ValueError):
        ScalePolicy(vchip_frac=0.0)
    with pytest.raises(ValueError):
        ScalePolicy(vchip_frac=1.5)


def test_autoscaler_reaps_dead_and_scale_up_gate_uses_alive(fleet):
    """A breaker-DEAD replica is reaped from the pool/ring, and the
    max_replicas gate counts ALIVE capacity — a dead handle must not
    hold the fleet one replica short while it burns."""
    router, replicas = fleet(n=2)
    launched = []

    def launcher():
        fake = FakeSlotServer()
        rep = ReplicaServer(fake, f"heal{len(launched)}", idle_wait=0.002)
        rep.start()
        launched.append(rep)
        return rep.address

    scaler = ReplicaAutoscaler(
        router, launcher,
        policy=ScalePolicy(min_replicas=1, max_replicas=2, up_after=1,
                           cooldown_s=0.0))
    dead_rep, _fake = replicas[0]
    dead_rep.shutdown(graceful=False)
    for _ in range(5):
        router.pool.refresh(0.0)
    assert router.pool.state(dead_rep.name) == "dead"
    # pressure on the survivor: at max_replicas=2 the dead handle would
    # have blocked healing; reap + alive-gate let the fleet recover
    replicas[1][1].load_override = {"queue_wait_p99_ms": 9999.0}
    res = scaler.poll_once()
    assert dead_rep.name not in router.pool.names()       # reaped
    assert res["action"] and res["action"].startswith("scale_up:")
    assert len(router.pool.alive()) == 2
    kinds = [e["kind"] for e in router.events.events()]
    assert "reap" in kinds
    for rep in launched:
        rep.shutdown(graceful=False)


def test_autoscaler_heals_below_min_replicas_without_heat(fleet):
    """min_replicas is a FLOOR, not just a scale-down gate: a fleet
    reaped below it produces no hot signals (no traffic, absent SLIs),
    so healing must not wait for hysteresis heat."""
    router, replicas = fleet(n=1)
    launched = []

    def launcher():
        fake = FakeSlotServer()
        rep = ReplicaServer(fake, f"floor{len(launched)}", idle_wait=0.002)
        rep.start()
        launched.append(rep)
        return rep.address

    scaler = ReplicaAutoscaler(
        router, launcher,
        policy=ScalePolicy(min_replicas=1, max_replicas=2, up_after=99,
                           cooldown_s=0.0))
    rep, _fake = replicas[0]
    rep.shutdown(graceful=False)
    for _ in range(5):
        router.pool.refresh(0.0)
    res = scaler.poll_once()        # reaps the dead one, heals the floor
    assert res["action"] and res["action"].startswith("scale_up:")
    assert len(router.pool.alive()) == 1
    for r in launched:
        r.shutdown(graceful=False)


def test_register_name_conflict_is_409_not_silent_swap(fleet):
    router, replicas = fleet(n=1)
    rep, _fake = replicas[0]
    other = ReplicaServer(FakeSlotServer(), "elsewhere", idle_wait=0.002)
    other.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            request_json(router.address + "/replicas",
                         {"url": other.address, "name": rep.name},
                         idempotency_key="t-conflict")
        assert ei.value.code == 409
        assert router.pool.url(rep.name) == rep.address   # untouched
    finally:
        other.shutdown(graceful=False)


def test_random_policy_spreads(fleet):
    router, _replicas = fleet(n=2, router_kw={"policy": "random",
                                              "seed": 0})
    picks = set()
    for i in range(12):
        picks.add(request_json(router.address + "/generate",
                               {"prompt": [5] * 40 + [i]},
                               idempotency_key=f"t-rand-{i}")["replica"])
    assert len(picks) == 2       # same head, both replicas hit


def test_router_rejects_bad_prompt(fleet):
    router, _replicas = fleet(n=1)
    with pytest.raises(urllib.error.HTTPError) as ei:
        request_json(router.address + "/generate", {"prompt": []},
                     retry=NO_RETRY)
    assert ei.value.code == 400


def test_router_no_replicas_is_503():
    router = RouterServer()
    router.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            request_json(router.address + "/generate", {"prompt": [1]},
                         retry=NO_RETRY)
        assert ei.value.code == 503
    finally:
        router.shutdown()


# -- SLO-class admission -----------------------------------------------------

# an objective that can never be good: queue depth <= -1 (the gauge
# renders >= 0), so one evaluation makes the fast window burn at 100
_ALWAYS_BURNING = [Objective(
    "always_bad", metric="kubetpu_serving_queue_depth",
    threshold=-1.0, op="<=", reduce="max")]


def test_burning_sheds_batch_and_routes_interactive(fleet):
    router, _replicas = fleet(
        n=1, router_kw={"slos": _ALWAYS_BURNING, "slo_interval_s": 0.0,
                        "queue_timeout_s": 0.15})
    router.evaluate_slos(0.0)
    assert router._burning()
    with pytest.raises(urllib.error.HTTPError) as ei:
        request_json(router.address + "/generate",
                     {"prompt": [1, 2], "slo_class": "batch"},
                     retry=NO_RETRY)
    assert ei.value.code == 503
    body = request_json(router.address + "/generate",
                        {"prompt": [1, 2], "slo_class": "interactive"},
                        idempotency_key="t-slo-int")
    assert body["replica"] == "rep0"
    assert router._c_shed.value == 1
    counts = router.events.counts()
    assert counts.get("shed") == 1 and counts.get("route") == 1


def test_burning_queues_standard_until_timeout(fleet):
    router, _replicas = fleet(
        n=1, router_kw={"slos": _ALWAYS_BURNING, "slo_interval_s": 0.0,
                        "queue_timeout_s": 0.15})
    router.evaluate_slos(0.0)
    t0 = time.perf_counter()
    with pytest.raises(urllib.error.HTTPError) as ei:
        request_json(router.address + "/generate",
                     {"prompt": [1], "slo_class": "standard"},
                     retry=NO_RETRY, timeout=10.0)
    assert ei.value.code == 503
    assert time.perf_counter() - t0 >= 0.15   # actually parked
    assert router._c_queued.value == 1
    assert router._c_qtimeout.value == 1


# -- breaker health ----------------------------------------------------------


def test_pool_breaker_suspect_then_dead(fleet):
    router, replicas = fleet(n=2)
    rep, _fake = replicas[0]
    name = rep.name
    rep.shutdown(graceful=False)              # abrupt death
    for _ in range(2):
        router.pool.refresh(0.0)
    assert name not in router.pool.routable()
    kinds = [e["kind"] for e in router.events.events()
             if e.get("replica") == name]
    assert "replica_suspect" in kinds
    for _ in range(3):
        router.pool.refresh(0.0)
    assert "replica_dead" in [
        e["kind"] for e in router.events.events()
        if e.get("replica") == name]
    # ring membership unchanged (no remap): routing just skips it
    assert name in router.ring.members()
    body = request_json(router.address + "/generate", {"prompt": [2] * 40},
                        idempotency_key="t-bk-1")
    assert body["replica"] != name


def test_pool_breaker_recovers_through_probation(fleet):
    router, replicas = fleet(n=1)
    rep, _fake = replicas[0]
    # whitebox: pause the background signals loop so its concurrent
    # refreshes can't interleave with the hand-driven breaker script
    router._stop.set()
    time.sleep(0.3)
    # cordon via misses against a paused scrape: simulate by recording
    # misses directly (the wire path is covered by the dead test above)
    router.pool._record_miss(rep.name)
    router.pool._record_miss(rep.name)
    assert router.pool.routable() == []
    router.pool.refresh(0.0)                  # success -> probation
    assert rep.name in router.pool.routable()
    router.pool.refresh(0.0)                  # second pass -> healthy
    assert "replica_recovered" in [
        e["kind"] for e in router.events.events()]


# -- autoscaler --------------------------------------------------------------


def test_autoscaler_event_sequence_up_drain_down(fleet):
    """The acceptance pin: a sustained hot signal scales UP; a
    sustained cold fleet drains the victim and only a COMPLETED drain
    emits scale_down — scale_up -> ... -> drain -> scale_down in the
    event log, in seq order."""
    router, replicas = fleet(n=2)
    fakes = [f for _r, f in replicas]
    extra = []

    def launcher():
        fake = FakeSlotServer()
        rep = ReplicaServer(fake, f"scaled{len(extra)}", idle_wait=0.002)
        rep.start()
        extra.append((rep, fake))
        return rep.address

    stopped = []
    scaler = ReplicaAutoscaler(
        router, launcher,
        policy=ScalePolicy(min_replicas=1, max_replicas=3, up_after=2,
                           down_after=2, cooldown_s=0.0),
        terminator=lambda name, url: stopped.append(name))
    # sustained pressure: both replicas report queue-wait way past the
    # policy ceiling
    for f in fakes:
        f.load_override = {"queue_wait_p99_ms": 9999.0}
    assert scaler.poll_once()["action"] is None        # hysteresis holds
    action = scaler.poll_once()["action"]
    assert action and action.startswith("scale_up:")
    assert len(router.pool.names()) == 3
    # pressure clears entirely -> cold passes -> drain, then completion
    for f in fakes:
        f.load_override = {}
    assert scaler.poll_once()["action"] is None
    action = scaler.poll_once()["action"]
    assert action and action.startswith("drain:")
    victim = action.split(":", 1)[1]
    # the victim is idle, so the NEXT pass observes it drained
    action = scaler.poll_once()["action"]
    assert action == f"scale_down:{victim}"
    assert stopped == [victim]
    assert len(router.pool.names()) == 2
    seqs = {}
    for e in router.events.events():
        if e["kind"] in ("scale_up", "drain", "scale_down"):
            seqs.setdefault(e["kind"], e["seq"])
    assert seqs["scale_up"] < seqs["drain"] < seqs["scale_down"]
    for rep, _f in extra:
        rep.shutdown(graceful=False)


def test_autoscaler_scale_down_is_migrate_then_drain(fleet):
    """Scale-down names a survivor target and emits
    ``scale_down_migrate -> drain -> scale_down`` in seq order — the
    migrate-then-remove contract."""
    router, replicas = fleet(n=2)
    scaler = ReplicaAutoscaler(
        router, lambda: (_ for _ in ()).throw(RuntimeError("no launch")),
        policy=ScalePolicy(min_replicas=1, max_replicas=3, up_after=99,
                           down_after=1, cooldown_s=0.0))
    action = scaler.poll_once()["action"]
    assert action and action.startswith("drain:")
    victim = action.split(":", 1)[1]
    action = scaler.poll_once()["action"]
    assert action == f"scale_down:{victim}"
    seqs = {}
    targets = {}
    for e in router.events.events():
        if e["kind"] in ("scale_down_migrate", "drain", "scale_down"):
            seqs.setdefault(e["kind"], e["seq"])
            targets[e["kind"]] = e
    assert (seqs["scale_down_migrate"] < seqs["drain"]
            < seqs["scale_down"])
    # the handoff target is the surviving replica, never the victim
    assert targets["scale_down_migrate"]["target"] != victim
    assert targets["scale_down_migrate"]["replica"] == victim


def test_suspect_triggers_migrate_away_once(fleet):
    """Breaker policy: a replica newly SUSPECT gets ONE
    migrate-away sweep toward a routable survivor ('migrate away'
    instead of 'pray'); repeated ticks don't re-spam it, and recovery
    to healthy re-arms the trigger."""
    router, replicas = fleet(n=2)
    pool = router.pool
    victim = pool.names()[0]
    for _ in range(pool.suspect_after):
        pool._record_miss(victim)
    assert pool.state(victim) == "suspect"
    router._check_suspects()
    router._check_suspects()          # second tick: no duplicate sweep
    aways = [e for e in router.events.events()
             if e["kind"] == "migrate_away"]
    assert len(aways) == 1
    assert aways[0]["replica"] == victim
    assert aways[0]["target"] != victim
    assert int(router._c_migrate_away.value) == 1
    # recovery through probation -> healthy re-arms the trigger
    pool._record_ok(victim, {"draining": False})
    for _ in range(pool.probation_passes):
        pool._record_ok(victim, {"draining": False})
    assert pool.state(victim) == "healthy"
    router._check_suspects()
    for _ in range(pool.suspect_after):
        pool._record_miss(victim)
    router._check_suspects()
    aways = [e for e in router.events.events()
             if e["kind"] == "migrate_away"]
    assert len(aways) == 2


def test_autoscaler_respects_min_and_drain_gate(fleet):
    """Scale-down never drops below min_replicas, and a victim with
    in-flight work is NOT removed until its drain completes."""
    router, replicas = fleet(n=2, fake_kw={"step_sleep": 0.03,
                                           "max_new": 6})
    scaler = ReplicaAutoscaler(
        router, lambda: (_ for _ in ()).throw(RuntimeError("no launch")),
        policy=ScalePolicy(min_replicas=1, max_replicas=3, up_after=99,
                           down_after=1, cooldown_s=0.0))
    # keep one replica busy, then go cold enough to pick a victim: the
    # idle one drains first (least loaded)
    busy_rep, _busy_fake = replicas[0]
    out = {}

    def go():
        out["body"] = request_json(busy_rep.address + "/generate",
                                   {"prompt": [1, 2, 3]},
                                   idempotency_key="t-gate", timeout=30.0)

    t = threading.Thread(target=go)
    t.start()
    time.sleep(0.04)
    res = scaler.poll_once()
    # with one replica mid-request the fleet may read hot-ish via queue
    # depth 0 + active < 0.25? active_frac = 1/4 -> not cold... force:
    while res["action"] is None:
        res = scaler.poll_once()
        if res["action"] is not None or not t.is_alive():
            break
        time.sleep(0.02)
    t.join(timeout=10.0)
    assert len(out["body"]["emitted"]) == 6
    # drive to completion: drain finishes, never below min
    for _ in range(10):
        scaler.poll_once()
        if len(router.pool.names()) == 1:
            break
        time.sleep(0.02)
    assert len(router.pool.names()) == 1


# -- disaggregated roles -------------------------------------------


@pytest.fixture()
def role_fleet(request):
    """(router, {name: (replica_server, fake)}) with one replica per
    requested role; everything shut down at teardown."""
    made = []

    def build(roles, router_kw=None, fake_kw=None):
        router = RouterServer(load_refresh_s=0.0, **(router_kw or {}))
        router.start()
        replicas = {}
        for i, role in enumerate(roles):
            fake = FakeSlotServer(**(fake_kw or {}))
            rep = ReplicaServer(fake, f"{role}{i}", role=role,
                                idle_wait=0.002)
            rep.start()
            router.register_replica(rep.address)
            replicas[rep.name] = (rep, fake)
        made.append((router, replicas))
        return router, replicas

    yield build
    for router, replicas in made:
        router.shutdown()
        for rep, _fake in replicas.values():
            rep.shutdown(graceful=False)


def test_decode_role_gets_no_ring_arcs_or_fresh_prompts(role_fleet):
    """A decode-only replica receives streams over the handoff wire,
    never fresh prompts: no ring arcs at registration, and the prompt
    path routes to the prefill-capable replica."""
    router, replicas = role_fleet(["prefill", "decode"])
    assert router.ring.members() == ["prefill0"]
    assert router.pool.role("prefill0") == "prefill"
    assert router.pool.role("decode1") == "decode"
    for i in range(4):
        body = request_json(router.address + "/generate",
                            {"prompt": [i + 1] * 40},
                            idempotency_key=f"t-role-{i}")
        # the FakeSlotServer has no page machinery, so the handoff
        # degrades to local completion — the routing decision is what
        # this test pins
        assert body["replica"] == "prefill0"


def test_migrate_away_respects_role(role_fleet):
    """A suspect PREFILL replica's
    in-flight streams hand off to another prefill replica or a "both"
    node — never to a decode-only target (its pool is sized and
    SLO-judged for pure decode traffic)."""
    router, replicas = role_fleet(["prefill", "decode", "both"])
    pool = router.pool
    for _ in range(pool.suspect_after):
        pool._record_miss("prefill0")
    assert pool.state("prefill0") == "suspect"
    router._check_suspects()
    aways = [e for e in router.events.events()
             if e["kind"] == "migrate_away"]
    assert len(aways) == 1
    assert aways[0]["replica"] == "prefill0"
    assert aways[0]["target"] == "both2"       # never decode1


def test_migrate_away_skips_when_only_decode_survives(role_fleet):
    """With no role-compatible survivor the sweep is SKIPPED — honest
    residue beats shipping prefill streams into the decode pool."""
    router, replicas = role_fleet(["prefill", "decode", "decode"])
    pool = router.pool
    for _ in range(pool.suspect_after):
        pool._record_miss("prefill0")
    router._check_suspects()
    kinds = [e["kind"] for e in router.events.events()]
    assert "migrate_away_skip" in kinds
    assert "migrate_away" not in kinds


def test_autoscaler_scales_pools_independently(role_fleet):
    """the prefill pool scales on queue-wait/TTFT pressure,
    the decode pool on ITL p99 — each with its own hysteresis, and a
    signal from the wrong pool never buys the other pool hardware."""
    router, replicas = role_fleet(["prefill", "decode"])
    launched = []

    def launcher(role):
        fake = FakeSlotServer()
        rep = ReplicaServer(fake, f"auto-{role}-{len(launched)}",
                            role=role, idle_wait=0.002)
        rep.start()
        launched.append((role, rep))
        return rep.address

    scaler = ReplicaAutoscaler(
        router, launcher,
        policy=ScalePolicy(min_replicas=1, max_replicas=2, up_after=1,
                           cooldown_s=0.0))
    pre_fake = replicas["prefill0"][1]
    dec_fake = replicas["decode1"][1]
    # decode-pool signals (queue wait) on the DECODE replica must not
    # scale the decode pool — its criteria are ITL + free pages
    dec_fake.load_override = {"queue_wait_p99_ms": 9999.0}
    res = scaler.poll_once()
    assert res["actions"] == []
    dec_fake.load_override = {}
    # prefill pressure scales the PREFILL pool only
    pre_fake.load_override = {"queue_wait_p99_ms": 9999.0}
    res = scaler.poll_once()
    assert [r for r, _ in launched] == ["prefill"]
    assert any(a.startswith("scale_up:") for a in res["actions"])
    pre_fake.load_override = {}
    # decode ITL pressure scales the DECODE pool only
    dec_fake.load_override = {"itl_p99_ms": 9999.0}
    res = scaler.poll_once()
    assert [r for r, _ in launched] == ["prefill", "decode"]
    ups = [e for e in router.events.events() if e["kind"] == "scale_up"]
    assert [e.get("role") for e in ups] == ["prefill", "decode"]
    for _role, rep in launched:
        rep.shutdown(graceful=False)


def test_autoscaler_heals_a_fully_dead_role_pool(role_fleet):
    """A dedicated pool whose LAST replica died and was reaped must
    keep reconciling: the decode pool's min_replicas floor-heal fires
    even though no alive replica carries the role anymore — otherwise
    a disagg fleet that lost its whole decode pool would silently
    degrade to colocated forever."""
    router, replicas = role_fleet(["prefill", "decode"])
    launched = []

    def launcher(role):
        fake = FakeSlotServer()
        rep = ReplicaServer(fake, f"heal-{role}-{len(launched)}",
                            role=role, idle_wait=0.002)
        rep.start()
        launched.append((role, rep))
        return rep.address

    scaler = ReplicaAutoscaler(
        router, launcher,
        policy=ScalePolicy(min_replicas=1, max_replicas=2, up_after=99,
                           cooldown_s=0.0))
    scaler.poll_once()                 # observe both pools alive
    dead_rep, _fake = replicas["decode1"]
    dead_rep.shutdown(graceful=False)
    for _ in range(5):
        router.pool.refresh(0.0)
    assert router.pool.state("decode1") == "dead"
    res = scaler.poll_once()           # reap + floor-heal the pool
    assert [r for r, _ in launched] == ["decode"]
    assert any(a.startswith("scale_up:") for a in res["actions"])
    for _role, rep in launched:
        rep.shutdown(graceful=False)


def test_dedicated_pool_never_floor_heals_with_roleless_launcher(
        role_fleet):
    """A zero-arg launcher cannot boot a dedicated-role replica: the
    floor-heal must FAIL LOUDLY (scale_error, no launch) instead of
    booting a "both" node that leaves the pool empty and buying
    hardware every pass forever."""
    router, replicas = role_fleet(["prefill", "decode"])
    launched = []

    def launcher():                     # roleless: colocated-era shape
        launched.append(1)
        return "http://127.0.0.1:1"

    scaler = ReplicaAutoscaler(
        router, launcher,
        policy=ScalePolicy(min_replicas=1, max_replicas=2, up_after=99,
                           cooldown_s=0.0))
    scaler.poll_once()
    dead_rep, _fake = replicas["decode1"]
    dead_rep.shutdown(graceful=False)
    for _ in range(5):
        router.pool.refresh(0.0)
    res = scaler.poll_once()            # reap + attempt to heal decode
    assert launched == []               # never launched the wrong kind
    assert res["actions"] == []
    errs = [e for e in router.events.events()
            if e["kind"] == "scale_error"]
    assert any("takes no role" in str(e.get("error")) for e in errs)


def test_router_metrics_and_slo_and_trace_surfaces(fleet):
    router, _replicas = fleet(
        n=2, router_kw={"slos": _ALWAYS_BURNING, "slo_interval_s": 0.0})
    request_json(router.address + "/generate",
                 {"prompt": [8] * 40},
                 idempotency_key="t-surf")
    # evaluation rides the background signals loop; force one so the
    # scrape below deterministically carries the kubetpu_slo_* gauges
    router.evaluate_slos(0.0)
    text = request_text(router.address + "/metrics")
    assert validate_prometheus_text(text) == []
    assert 'kubetpu_router_requests_total{outcome="routed"} 1' in text
    assert 'replica="rep0"' in text and 'replica="rep1"' in text
    assert 'kubetpu_slo_burn_rate{slo="always_bad",window="fast"}' in text
    slo = request_json(router.address + "/slo")
    assert slo["burning"] is True
    listing = request_json(router.address + "/replicas")
    assert {r["name"] for r in listing["replicas"]} == {"rep0", "rep1"}
    events = request_text(router.address + "/events")
    assert '"kind": "route"' in events


def test_cli_summary_router_section_and_trace_hop(fleet):
    """The JAX package's ``cli.obs`` renders the port router's section (routed/shed
    counts, replica breaker states, per-replica load) and ``--trace``
    renders the router hop above the replica leg."""
    from kubetpu.cli.obs import render_summary, render_trace
    from kubetpu_torch.obs import span

    router, _replicas = fleet(n=2)
    with span("cli-router-test") as root:
        request_json(router.address + "/generate", {"prompt": [4] * 40},
                     idempotency_key="t-cli-1")
        tid = root.trace_id
    text = request_text(router.address + "/metrics")
    out = render_summary(text, "router")
    assert "router    routed=1" in out
    assert "replicas healthy=2" in out
    assert "replica   rep0:" in out and "replica   rep1:" in out
    rendered = render_trace(router.trace(tid))
    assert "[router]" in rendered
    assert "[replica:rep0]" in rendered or "[replica:rep1]" in rendered
    # the router span indents ABOVE its replica leg
    lines = rendered.splitlines()
    r_i = next(i for i, ln in enumerate(lines) if "[router]" in ln)
    rep_i = next(i for i, ln in enumerate(lines) if "[replica:" in ln)
    assert r_i < rep_i
