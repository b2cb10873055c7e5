"""The port's exposition parser, federation, event-stream validator and
``MetricsServer`` (``kubetpu_torch.obs``), held to the JAX package's: the
parser round-trips escaped label values, ``federate`` of port-rendered
text is byte-equal to the reference's federate of the same series, and
``validate_events_jsonl`` gives the same verdicts on good and bad JSONL."""

import json
import urllib.error
import urllib.request

import pytest

from kubetpu.obs import events as ref_events
from kubetpu.obs import registry as ref_registry
from kubetpu_torch.obs import registry as port_registry
from kubetpu_torch.obs import trace as obs_trace
from kubetpu_torch.obs.events import (EventLog, event_log,
                                      validate_events_jsonl)
from kubetpu_torch.obs.exporter import MetricsServer
from kubetpu_torch.obs.registry import (Registry, federate,
                                        install_process_gauges,
                                        parse_prometheus_text,
                                        validate_prometheus_text)

NASTY = ['C:\\tmp\\x', 'line1\nline2', 'say "hi"', 'mix\\"q\\\\n', 'trail\\']


def _series(reg_mod, seed: int):
    """One set of series on a registry of *reg_mod* (the port's or the
    reference's), seeded: counters with escaped labels, gauges, a
    histogram with and one without observations."""
    import random

    rng = random.Random(seed)
    reg = reg_mod.Registry()
    for i, v in enumerate(NASTY):
        reg.counter("kubetpu_esc_total", path=v, i=str(i)).inc(i + 1)
    reg.gauge("kubetpu_serving_pages_free").set(rng.randrange(100))
    reg.gauge("kubetpu_serving_queue_depth").set(rng.randrange(5))
    h = reg.histogram("kubetpu_serving_latency_seconds", op="ttft")
    for _ in range(50):
        h.observe(rng.random())
    reg.histogram("kubetpu_serving_latency_seconds", op="itl")
    reg.counter("kubetpu_router_requests_total", outcome="routed").inc(
        rng.randrange(1, 9))
    return reg


def test_parse_round_trip_and_escapes():
    """render -> validate -> parse keeps every value and every escaped
    label byte-exactly, and equals the reference parser's reading of the
    same text; garbage raises."""
    reg = _series(port_registry, 3)
    text = reg.render()
    assert validate_prometheus_text(text) == []
    got = parse_prometheus_text(text)
    assert got == ref_registry.parse_prometheus_text(text)
    paths = {lab["path"]: v for n, lab, v in got if n == "kubetpu_esc_total"}
    assert paths == {v: float(i + 1) for i, v in enumerate(NASTY)}
    with pytest.raises(ValueError):
        parse_prometheus_text("kubetpu_x not_a_number")
    with pytest.raises(ValueError):
        parse_prometheus_text("}{ garbage")


@pytest.mark.parametrize("label", ["replica", "node", "component"])
def test_federate_is_byte_equal_to_the_reference(label):
    """The same series rendered by each package's registry, federated by
    each package's ``federate`` (own text plus two peers and one
    unparseable peer that is skipped), give the same bytes."""
    own_p, own_r = _series(port_registry, 0), _series(ref_registry, 0)
    peers_p = {"a": _series(port_registry, 1).render(),
               "b": _series(port_registry, 2).render(), "bad": "}{ garbage"}
    peers_r = {"a": _series(ref_registry, 1).render(),
               "b": _series(ref_registry, 2).render(), "bad": "}{ garbage"}
    assert own_p.render() == own_r.render()
    ours = federate(own_p.render(), peers_p, label=label)
    theirs = ref_registry.federate(own_r.render(), peers_r, label=label)
    assert ours == theirs
    assert validate_prometheus_text(ours) == []
    assert f'{label}="a"' in ours and f'{label}="bad"' not in ours
    assert ours.count("# TYPE kubetpu_esc_total counter") == 1
    assert federate("", {}) == ref_registry.federate("", {}) == ""


def test_federate_keeps_a_peer_label_and_process_gauges():
    """A peer series that already carries the federation label keeps its
    own; the identification trio federates per component."""
    reg = Registry()
    install_process_gauges(reg, "router")
    peer = Registry()
    peer.gauge("kubetpu_x", replica="own").set(1)
    install_process_gauges(peer, "replica:r0")
    fed = federate(reg.render(), {"r0": peer.render()}, label="replica")
    assert validate_prometheus_text(fed) == []
    assert 'kubetpu_x{replica="own"} 1' in fed
    assert 'component="replica:r0"' in fed and 'component="router"' in fed


@pytest.mark.parametrize("text", [
    "",
    '{"ts": 1.5, "seq": 0, "kind": "admit"}\n'
    '{"ts": 2, "seq": 1, "kind": "retire", "rid": 3}\n',
    'not json\n{"ts": "late", "seq": 1.5, "kind": 3}\n[1, 2]\n',
    '{"seq": 0}\n\n{"ts": 1, "kind": "x"}\n',
])
def test_validate_events_jsonl_equals_the_reference(text):
    """The same problems (or none) from both validators, good and bad
    streams alike."""
    assert validate_events_jsonl(text) == ref_events.validate_events_jsonl(
        text)


def test_event_log_jsonl_validates_and_default_log_exists():
    log = EventLog(component="c")
    log.emit("a", x=1)
    log.emit("b", y="two")
    assert validate_events_jsonl(log.to_jsonl()) == []
    assert event_log() is event_log()
    before = len(event_log())
    event_log().emit("unit_test_marker")
    assert len(event_log()) == before + 1


def test_metrics_server_serves_registries_traces_and_events():
    """``MetricsServer``: one registry served as is, two federated under
    ``component``; ``/trace/<id>`` from the port's tracer; ``/events``
    merged, filtered and limited; ``/healthz``; 404 elsewhere."""
    reg = Registry()
    reg.histogram("kubetpu_serving_latency_seconds", op="ttft").observe(0.05)
    reg.gauge("kubetpu_serving_active_slots").set(3)
    other = Registry()
    other.gauge("kubetpu_serving_active_slots").set(1)
    log = EventLog(component="serving")
    log.emit("admit", rid="r0")
    log.emit("retire", rid="r0")
    log.emit("admit", rid="r1")
    one = MetricsServer({"replica0": reg}, events=log)
    two = MetricsServer({"r0": reg, "r1": other})
    one.start()
    two.start()

    def get(server, path):
        with urllib.request.urlopen(server.address + path, timeout=5) as r:
            return r.read().decode()

    try:
        text = get(one, "/metrics")
        assert text == reg.render()
        assert validate_prometheus_text(text) == []
        assert ('kubetpu_serving_latency_seconds{op="ttft",quantile="0.5"} '
                '0.05') in text
        fed = get(two, "/metrics")
        assert validate_prometheus_text(fed) == []
        assert 'kubetpu_serving_active_slots{component="r1"} 1' in fed
        assert 'kubetpu_serving_active_slots{component="r0"} 3' in fed
        assert json.loads(get(one, "/healthz")) == {"ok": True}
        with obs_trace.span("exported") as sp:
            tid = sp.trace_id
        body = json.loads(get(one, f"/trace/{tid}"))
        assert [s["op"] for s in body["spans"]] == ["exported"]
        events = get(one, "/events")
        assert validate_events_jsonl(events) == []
        assert len(events.splitlines()) == 3
        admits = get(one, "/events?kind=admit")
        assert len(admits.splitlines()) == 2 and '"retire"' not in admits
        assert json.loads(get(one, "/events?kind=admit&limit=1"))["rid"] \
            == "r1"
        with pytest.raises(urllib.error.HTTPError) as err:
            get(one, "/nowhere")
        assert err.value.code == 404
    finally:
        one.shutdown()
        two.shutdown()
