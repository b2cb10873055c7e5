"""The serving obs registry of the port against the JAX package's: the
port's ``metrics_text()`` passes the JAX validator and carries the same
series as the JAX server's after the same run; the latency summaries, the
event log and ``load_info`` have the reference's shape; ``queue_ttl``
expires a waiting request with the reference's reason."""

import re
import time

import jax
import numpy as np
import pytest
import torch

from kubetpu.jobs.paged import PagedDecodeServer as JaxPagedServer
from kubetpu.obs.registry import Registry as JaxRegistry
from kubetpu.obs.registry import validate_prometheus_text
from kubetpu_torch.jobs import model as tmodel
from kubetpu_torch.jobs.convert import params_from_numpy
from kubetpu_torch.jobs.paged import PagedDecodeServer
from kubetpu_torch.obs import registry as port_registry
from kubetpu_torch.obs.events import EventLog

torch.set_num_threads(1)

PS = 8


@pytest.fixture(scope="module")
def both(trained_small):
    jcfg, params, data = trained_small
    cfg = tmodel.ModelConfig(
        vocab=jcfg.vocab, d_model=jcfg.d_model, n_layers=jcfg.n_layers,
        n_heads=jcfg.n_heads, d_ff=jcfg.d_ff, max_seq=jcfg.max_seq)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    rows = [[int(t) for t in data[i][0][0]] for i in range(4)]
    return jcfg, params, cfg, model, rows


def series(text):
    """{series name with its labels} of an exposition, the build version's
    value left out (the two packages stamp their own)."""
    out = set()
    for line in text.splitlines():
        if line and not line.startswith("#"):
            out.add(re.sub(r'version="[^"]*"', 'version="*"',
                           line.rsplit(" ", 1)[0]))
    return out


def storm(server, rows):
    """Hits, a miss, a cancel and a chunked admission, then a drain."""
    head = rows[0][:2 * PS]
    rids = [server.enqueue(head + [1]), server.enqueue(rows[1][:11])]
    server.drain()
    rids += [server.enqueue(head + [2, 3]), server.enqueue(rows[2][:5])]
    server.cancel(rids[-1])
    server.drain()
    server.check_invariants()
    return [server.result(r) for r in rids]


@pytest.mark.parametrize("host", [0, 1 << 20], ids=["hbm", "host_tier"])
def test_metrics_text_series_equal_the_jax_server(both, host):
    jcfg, params, cfg, model, rows = both
    kw = dict(n_slots=2, max_seq=64, max_new_tokens=6, page_size=PS,
              prefill_budget=PS, prefix_cache_pages=8, host_tier_bytes=host)
    ref = JaxPagedServer(jcfg, params, **kw)
    port = PagedDecodeServer(cfg, model, device="cpu", **kw)
    assert storm(port, rows) == storm(ref, rows)
    text = port.metrics_text()
    assert validate_prometheus_text(text) == []
    assert port_registry.validate_prometheus_text(text) == []
    assert series(text) == series(ref.metrics_text())
    types = [ln for ln in text.splitlines() if ln.startswith("# TYPE")]
    assert types == [ln for ln in ref.metrics_text().splitlines()
                     if ln.startswith("# TYPE")]
    for needle in ('kubetpu_serving_latency_seconds{op="ttft",'
                   'quantile="0.5"}',
                   'kubetpu_prefix_requests_total{result="hit"} 1',
                   f"kubetpu_serving_pages_in_use {port.pages_in_use()}"):
        assert needle in text
    summary = port.metrics_summary()
    assert summary.keys() == ref.metrics_summary().keys()
    assert summary["ttft"]["count"] == 3
    assert port.events.counts() == ref.events.counts()
    assert port.load_info().keys() == ref.load_info().keys()


def test_queue_ttl_expires_waiting_requests(both):
    """A request that waits past its TTL finishes empty with the reason
    "queue_ttl", as the JAX server's does; an admitted one never expires,
    and a per-request ttl overrides the server's."""
    jcfg, params, cfg, model, rows = both
    kw = dict(n_slots=1, max_seq=64, max_new_tokens=4, page_size=PS,
              queue_ttl=0.05)
    reasons = []
    for server in (JaxPagedServer(jcfg, params, **kw),
                   PagedDecodeServer(cfg, model, device="cpu", **kw)):
        ra = server.enqueue(rows[0][:5])
        rb = server.enqueue(rows[1][:5])
        rc = server.enqueue(rows[2][:5], ttl=60.0)
        server.step()                  # ra takes the only slot
        assert server.queued() == 2
        time.sleep(0.1)
        server.drain()
        assert server.finished(rb) and server.result(rb) == rows[1][:5]
        assert server.result_logprobs(rb) == []
        assert len(server.result(rc)) == 5 + 4
        reasons.append([server.expire_reason(r) for r in (ra, rb, rc)])
        assert server.metrics_summary()["queue_expired"]["count"] == 1
        assert [e["rid"] for e in server.events.events(
            kind="queue_expired")] == [rb]
        server.pop_result(rb)
        assert server.expire_reason(rb) is None
    assert reasons[0] == reasons[1] == [None, "queue_ttl", None]
    with pytest.raises(ValueError, match="queue_ttl"):
        PagedDecodeServer(cfg, model, queue_ttl=-1.0, device="cpu")


def test_registry_renders_the_jax_registry_text():
    """The same instruments written the same way render byte-equal text."""
    texts = []
    for reg in (JaxRegistry(), port_registry.Registry()):
        reg.counter("kubetpu_x_total", "x help", kind='a"b').inc(3)
        reg.gauge("kubetpu_g").set(2.5)
        reg.gauge_fn("kubetpu_fn", lambda: 7)
        hist = reg.histogram("kubetpu_lat_seconds", op="step")
        for v in (0.1, 0.2, 0.3, 0.4):
            hist.observe(v)
        texts.append(reg.render())
    assert texts[0] == texts[1]
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("kubetpu_x_total", kind='a"b')


def test_event_log_ring_and_sink(tmp_path):
    log = EventLog(capacity=2, component="serving")
    log.set_sink(str(tmp_path / "events.jsonl"))
    for rid in range(3):
        log.emit("admit", rid=rid, prompt=np.int64(4))
    log.set_sink(None)
    assert [e["rid"] for e in log.events()] == [1, 2]
    assert log.dropped == 1 and log.counts() == {"admit": 2}
    assert all(e["component"] == "serving" and e["prompt"] == "4"
               for e in log.events())
    lines = (tmp_path / "events.jsonl").read_text().splitlines()
    assert [ln.count('"seq"') for ln in lines] == [1, 1, 1]
    assert log.to_jsonl(limit=1).count("\n") == 1
