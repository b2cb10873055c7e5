"""The router cases of the JAX package's ``tests/test_disagg.py`` on the
port: the port's ``RouterServer`` in front of port replicas with serving
roles. Decode-only replicas get no ring arcs and no fresh prompts; a
prompt admits on the prefill replica, which streams its KV spans to the
decode replica ``_pick_decode`` names (spread over the decode pool), and
the decode replica emits the stream, token-exact against a quiet
colocated run; the federated ``/metrics`` carries the handoff series that
``disagg_slos`` and the JAX package's ``cli.obs`` read. With no decode
replica left, a routed generate degrades to the prefill replica serving
it; a dense prefill replica aborts the handoff and serves locally; an
all-``both`` fleet never hands off.

Weights: ``trained_small`` (as the other cross-package serving tests)."""

import jax
import numpy as np
import pytest
import torch

from kubetpu_torch.jobs import model as tmodel
from kubetpu_torch.jobs.convert import params_from_numpy
from kubetpu_torch.jobs.paged import PagedDecodeServer
from kubetpu_torch.jobs.serving import DecodeServer
from kubetpu_torch.obs import disagg_slos
from kubetpu_torch.obs.slo import SloEngine
from kubetpu_torch.router import ReplicaServer, RouterServer, role_compatible
from kubetpu_torch.wire.httpcommon import request_json

torch.set_num_threads(1)

PS = 8
MAX_NEW = 10
WAIT = 60.0


@pytest.fixture(scope="module")
def both(trained_small):
    jcfg, params, _ = trained_small
    cfg = tmodel.ModelConfig(
        vocab=jcfg.vocab, d_model=jcfg.d_model, n_layers=jcfg.n_layers,
        n_heads=jcfg.n_heads, d_ff=jcfg.d_ff, max_seq=jcfg.max_seq)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    return cfg, model


def make_server(both, cache_pages=16):
    return PagedDecodeServer(
        both[0], both[1], n_slots=4, max_seq=128, max_new_tokens=MAX_NEW,
        page_size=PS, prefill_budget=16, prefix_cache_pages=cache_pages,
        device="cpu")


def family_prompts(n, fam_tokens=40):
    fam = [(i * 5) % 60 + 1 for i in range(fam_tokens)]
    return [fam + [i + 1] for i in range(n)]


def quiet_run(server, prompts):
    out = []
    for p in prompts:
        rid = server.enqueue(p)
        server.drain()
        out.append(server.pop_result(rid))
    return out


@pytest.fixture()
def role_fleet(both):
    """build(roles) -> (router, [replicas]): port replicas of the given
    roles behind the port's router; everything shut down at teardown."""
    made = []

    def build(roles):
        reps = []
        for i, role in enumerate(roles):
            rep = ReplicaServer(make_server(both), f"d{role}{i}", role=role,
                                idle_wait=0.002)
            rep.start()
            reps.append(rep)
        router = RouterServer(load_refresh_s=0.1)
        router.start()
        for rep in reps:
            router.register_replica(rep.address)
        made.append((router, reps))
        return router, reps

    yield build
    for router, reps in made:
        router.shutdown()
        for rep in reps:
            rep.shutdown(graceful=False)


def _drive(router, prompts, tag):
    return [request_json(router.address + "/generate",
                         {"prompt": p, "timeout": WAIT},
                         idempotency_key=f"disagg-{tag}-{i}", timeout=WAIT)
            for i, p in enumerate(prompts)]


def test_roles_ring_pick_decode_and_pipelined_handoff(both, role_fleet):
    """Ring membership excludes decode-only replicas and ``/replicas``
    lists each role; ``_pick_decode`` never names the prefill replica and
    spreads restores over both decode replicas; every routed stream is
    emitted by a decode replica with the quiet run's tokens, admitted once
    and restored once, with KV bytes shipped before the prefill finished;
    the federated scrape renders the disagg section and reads healthy
    under ``disagg_slos``."""
    from kubetpu.cli.obs import render_summary

    prompts = family_prompts(4)
    expected = quiet_run(make_server(both), prompts)
    router, (pre, d1, d2) = role_fleet(("prefill", "decode", "decode"))
    assert router.ring.members() == [pre.name]
    listing = request_json(router.address + "/replicas", method="GET")
    assert {r["name"]: r["role"] for r in listing["replicas"]} == {
        pre.name: "prefill", d1.name: "decode", d2.name: "decode"}
    picks = {router._pick_decode(exclude=(pre.name,)) for _ in range(4)}
    assert picks == {d1.name, d2.name}
    assert not role_compatible("prefill", "decode")
    bodies = _drive(router, prompts, "parity")
    for body, want in zip(bodies, expected):
        assert body["tokens"] == want
        assert body["replica"] in (d1.name, d2.name)
    assert int(pre.server.obs.counter(
        "kubetpu_handoffs_total", result="committed").value) == len(prompts)
    assert len(pre.server.events.events(kind="admit")) == len(prompts)
    restores = [len(d.server.events.events(kind="migrate_in"))
                for d in (d1, d2)]
    assert sum(restores) == len(prompts) and min(restores) > 0
    assert pre._handoff_early_bytes > 0
    for rep in (pre, d1, d2):
        with rep._cv:
            rep.server.check_invariants()
    text = router.metrics_text()
    assert 'kubetpu_serving_role{role="prefill"' in text
    assert 'kubetpu_handoffs_total{result="committed"' in text
    out = render_summary(text, "router")
    assert "disagg    roles prefill=1  decode=2  both=0" in out
    assert "committed=4" in out
    engine = SloEngine(disagg_slos(itl_p99_s=60.0, handoff_success=0.9))
    assert engine.evaluate(text)["disagg_handoff_success"]["ok"] is True


def test_dead_decode_pool_degrades_to_the_prefill_replica(both, role_fleet):
    """Both decode replicas gone: ``_pick_decode`` names nobody and a
    routed generate is served, token-exact, by the prefill replica."""
    prompt = family_prompts(1)[0]
    want = quiet_run(make_server(both), [prompt])[0]
    router, (pre, d1, d2) = role_fleet(("prefill", "decode", "decode"))
    for rep in (d1, d2):
        rep.shutdown(graceful=False)
    for _ in range(router.pool.dead_after + 1):
        router.pool.refresh(0.0)
    assert router._pick_decode(exclude=(pre.name,)) is None
    body = request_json(router.address + "/generate",
                        {"prompt": prompt, "timeout": WAIT},
                        idempotency_key="disagg-degrade", timeout=WAIT)
    assert body["tokens"] == want
    assert body["replica"] == pre.name
    with pre._cv:
        pre.server.check_invariants()


def test_dense_prefill_replica_degrades_not_crashes(both):
    """A dense (non-paged) server behind a prefill role has no shippable
    page view: the handoff aborts for the stream, the request completes
    locally, token-exact, and the handoff loop survives."""
    cfg, model = both

    def make_dense():
        return DecodeServer(cfg, model, n_slots=2, max_seq=128,
                            max_new_tokens=6, prefill_budget=16,
                            device="cpu")

    prompt = [(i * 3) % 60 + 1 for i in range(24)]
    want = quiet_run(make_dense(), [prompt])[0]
    pre = ReplicaServer(make_dense(), "dense-pre", role="prefill",
                        idle_wait=0.002)
    dec = ReplicaServer(make_server(both), "dense-dec", role="decode",
                        idle_wait=0.002)
    router = RouterServer(load_refresh_s=0.1)
    pre.start()
    dec.start()
    router.start()
    try:
        router.register_replica(pre.address)
        router.register_replica(dec.address)
        body = request_json(router.address + "/generate",
                            {"prompt": prompt, "timeout": WAIT},
                            idempotency_key="dense-degrade", timeout=WAIT)
        assert body["tokens"] == want
        assert body["replica"] == "dense-pre"
        assert int(pre.server.obs.counter(
            "kubetpu_handoffs_total", result="aborted").value) == 1
        assert pre._handoff_thread.is_alive()
    finally:
        router.shutdown()
        pre.shutdown(graceful=False)
        dec.shutdown(graceful=False)


def test_all_both_fleet_degrades_to_colocated(both, role_fleet):
    """With no dedicated roles the router names no decode target and no
    handoff happens."""
    prompts = family_prompts(2)
    expected = quiet_run(make_server(both), prompts)
    router, (r0, r1) = role_fleet(("both", "both"))
    for body, want in zip(_drive(router, prompts, "coloc"), expected):
        assert body["tokens"] == want
    for rep in (r0, r1):
        assert rep.events.events(kind="handoff_intent") == []
        assert int(rep.server.obs.counter(
            "kubetpu_handoffs_total", result="committed").value) == 0
