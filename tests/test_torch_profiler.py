"""The signal layer on the port's servers: the sampled profiler
(``enable_profiler``) and the SLO engine (``declare_slos``), held to the
JAX package's ``tests/test_serving_obs.py`` profiler cases.

- With the profiler disabled, or on a step it does not sample, a
  dispatched step makes no host sync and a routed step exactly one, and
  the profiler adds no upload; a sampled step's device phase waits on the
  host copy its own dispatch queued (``_wait_staged`` of that handle).
- Sampled at every step under chunked admission, the phases cover at
  least 90% of the sampled wall, on the dense, paged and both speculative
  servers, and render on the server's registry.
- An adaptive-gamma walk onto a gamma not run before reads as a first
  call on that gamma's round leg (``round[gamma=1]``).
- ``declare_slos`` renders the ``kubetpu_slo_*`` gauges and the port
  replica's ``/slo`` returns the verdicts.

Weights: ``trained_small``'s target; the draft of the speculative
servers is random, so gamma walks down."""

import jax
import numpy as np
import pytest
import torch

from kubetpu.obs.registry import validate_prometheus_text
from kubetpu_torch.jobs import model as tmodel
from kubetpu_torch.jobs import serving as serving_mod
from kubetpu_torch.jobs.convert import params_from_numpy
from kubetpu_torch.jobs.paged import PagedDecodeServer
from kubetpu_torch.jobs.serving import DecodeServer
from kubetpu_torch.jobs.spec_serving import (PagedSpeculativeDecodeServer,
                                             SpeculativeDecodeServer)
from kubetpu_torch.obs.slo import serving_slos
from kubetpu_torch.router import ReplicaServer
from kubetpu_torch.wire.httpcommon import request_json

torch.set_num_threads(1)

PROMPTS = [[3, 14, 15, 9, 2, 6, 5], [(i * 7) % 60 + 1 for i in range(19)]]
_SYNCS = ("item", "cpu", "tolist", "nonzero", "__bool__", "__int__",
          "__float__")


@pytest.fixture(scope="module")
def both(trained_small):
    jcfg, params, _ = trained_small
    cfg = tmodel.ModelConfig(
        vocab=jcfg.vocab, d_model=jcfg.d_model, n_layers=jcfg.n_layers,
        n_heads=jcfg.n_heads, d_ff=jcfg.d_ff, max_seq=jcfg.max_seq)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    dcfg = tmodel.ModelConfig(vocab=jcfg.vocab, d_model=32, n_layers=1,
                              n_heads=2, d_ff=32, max_seq=jcfg.max_seq)
    draft = tmodel.init_params(torch.Generator().manual_seed(7), dcfg,
                               device="cpu")
    return cfg, model, dcfg, draft


def _server(kind, both, **kw):
    cfg, model, dcfg, draft = both
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_seq", 64)
    kw.setdefault("max_new_tokens", 6)
    if kind == "dense":
        return DecodeServer(cfg, model, device="cpu", **kw)
    if kind == "paged":
        return PagedDecodeServer(cfg, model, page_size=4, device="cpu", **kw)
    kw.pop("prefill_budget", None)
    kw.pop("overlap", None)
    if kind == "spec":
        return SpeculativeDecodeServer(cfg, dcfg, model, draft, gamma=2,
                                       device="cpu", **kw)
    return PagedSpeculativeDecodeServer(cfg, dcfg, model, draft,
                                        page_size=4, gamma_max=2,
                                        device="cpu", **kw)


def run_mixed(server):
    rids = [server.enqueue(p) for p in PROMPTS]
    for _ in range(2):
        server.step()
    server.drain()
    return rids


@pytest.mark.parametrize("overlap", [False, True], ids=["plain", "overlap"])
@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_step_profiler_adds_no_syncs_or_uploads(both, kind, overlap,
                                                monkeypatch):
    """Disabled, and on un-sampled steps when enabled at rate 2, every
    dispatched step makes no host sync and every routed step one; the
    uploads of a step are the same with the profiler as without; each
    sampled step waits once, on the staged copy of the step it
    dispatched."""
    counts = {"dispatch": [], "route": [], "upload": 0}
    window = {"name": None}

    def counting(fn):
        def wrapper(*args, **kwargs):
            if window["name"] is not None:
                counts[window["name"]][-1] += 1
            return fn(*args, **kwargs)
        return wrapper

    for name in _SYNCS:
        monkeypatch.setattr(torch.Tensor, name,
                            counting(getattr(torch.Tensor, name)))
    monkeypatch.setattr(torch, "nonzero", counting(torch.nonzero))

    def run(profiled):
        server = _server(kind, both, max_new_tokens=10, overlap=overlap)
        if profiled:
            server.enable_profiler(sample_every=2)
        dispatched, waited = [], []
        for leg in ("dispatch", "route"):
            fn = getattr(server, f"_{leg}_step")

            def windowed(*args, leg=leg, fn=fn):
                counts[leg].append(0)
                window["name"] = leg
                try:
                    out = fn(*args)
                finally:
                    window["name"] = None
                if leg == "dispatch":
                    dispatched.append(out[0])
                return out
            setattr(server, f"_{leg}_step", windowed)
        real_upload = server._upload

        def upload(a):
            counts["upload"] += 1
            return real_upload(a)
        server._upload = upload
        real_wait = serving_mod._wait_staged
        monkeypatch.setattr(serving_mod, "_wait_staged",
                            lambda staged: (waited.append(staged),
                                            real_wait(staged)))
        counts.update(dispatch=[], route=[], upload=0)
        rids = [server.enqueue(p) for p in PROMPTS]
        server.drain()
        assert all(server.finished(r) for r in rids)
        return server, dict(counts), dispatched, waited

    plain, base, _, waited = run(False)
    assert waited == []
    prof, got, dispatched, waited = run(True)
    for c in (base, got):
        assert len(c["dispatch"]) >= 9
        assert c["dispatch"] == [0] * len(c["dispatch"])
        assert c["route"] == [1] * len(c["dispatch"])
    assert got["upload"] == base["upload"]
    assert [plain.result(r) for r in range(2)] == [prof.result(r)
                                                   for r in range(2)]
    s = prof.profile_summary()
    assert s["sampled_steps"] == (s["steps"] + 1) // 2
    # one wait per sampled step that dispatched, each on that step's copy
    assert 0 < len(waited) <= s["sampled_steps"]
    assert all(any(w is d for d in dispatched) for w in waited)
    assert len({id(w) for w in waited}) == len(waited)


@pytest.mark.parametrize("kind", ["dense", "paged", "spec", "paged_spec"])
def test_profiler_breakdown_covers_step_wall(both, kind):
    """Sampled at every step under a mixed chunked load, the named phases
    sum to at least 90% of the sampled wall, and the series render on the
    server's own registry; ``profile_summary()`` is {} while disabled."""
    srv = _server(kind, both, prefill_budget=4)
    prof = srv.enable_profiler(sample_every=1)
    run_mixed(srv)
    s = prof.summary()
    assert s["sampled_steps"] == s["steps"] > 0
    assert {"schedule", "dispatch", "device", "materialize"} <= set(
        s["phases"])
    assert s["coverage"] >= 0.9, s
    assert s["coverage"] <= 1.0 + 1e-6
    text = srv.metrics_text()
    assert validate_prometheus_text(text) == []
    assert "kubetpu_profile_sampled_steps_total" in text
    assert 'kubetpu_profile_phase_seconds_total{phase="device"}' in text
    assert srv.profile_summary() == s
    assert _server(kind, both).profile_summary() == {}


def test_profiler_watches_legs_and_attributes_warmup(both):
    """Enabled before ``warmup()``, the paged server's watched legs count
    one first call per prompt bucket (prefill) and one for the step, with
    their seconds; the same shapes served afterwards add none."""
    srv = _server("paged", both, max_seq=32)
    prof = srv.enable_profiler(sample_every=4)
    srv.warmup()
    legs = prof.summary()["recompiles"]
    assert legs["step"]["recompiles"] == 1
    buckets = legs["prefill"]["recompiles"]
    assert buckets >= 3                    # 4, 8, 16, 32-token buckets
    rid = srv.enqueue([5, 6, 7])
    srv.drain()
    assert srv.finished(rid)
    legs = prof.summary()["recompiles"]
    assert legs["step"]["recompiles"] == 1
    assert legs["prefill"]["recompiles"] == buckets
    text = srv.metrics_text()
    assert 'kubetpu_jit_recompiles_total{leg="prefill"}' in text
    assert 'kubetpu_jit_compile_seconds_total{leg="step"}' in text


def test_gamma_walk_shows_recompile_counters(both):
    """An adaptive-gamma walk onto a gamma not run before reads as a
    nonzero ``kubetpu_jit_recompiles_total{leg="round[gamma=1]"}`` with
    seconds attached: the random draft walks gamma down from gamma_max,
    so the gamma-1 round runs for the first time only after the change."""
    srv = _server("paged_spec", both, n_slots=1, max_new_tokens=24)
    prof = srv.enable_profiler(sample_every=1)
    rid = srv.submit([5, 9, 3, 1, 7, 2])
    while not srv.finished(rid):
        srv.step()
    gammas = srv.events.events(kind="gamma")
    assert gammas and gammas[0]["old"] == 2 and gammas[0]["new"] == 1
    s = prof.summary()
    assert s["recompiles"]["round[gamma=1]"]["recompiles"] == 1
    assert s["recompiles"]["round[gamma=2]"]["recompiles"] == 1
    text = srv.metrics_text()
    assert 'kubetpu_jit_recompiles_total{leg="round[gamma=1]"}' in text
    assert 'kubetpu_jit_compile_seconds_total{leg="round[gamma=1]"}' in text
    assert s["coverage"] >= 0.9, s
    srv.check_invariants()


def test_declared_slos_render_and_the_replica_serves_them(both):
    """``declare_slos`` over the server's registry: the ``kubetpu_slo_*``
    gauges render on ``metrics_text()`` after a served request, an
    impossible objective reads violating, and the port replica's ``GET
    /slo`` returns the same verdicts."""
    srv = _server("paged", both)
    srv.declare_slos(serving_slos(ttft_p95_s=60.0, min_free_pages=10**6),
                     eval_interval=0.0)
    rep = ReplicaServer(srv, "slo0", idle_wait=0.002)
    rep.start()
    try:
        body = request_json(rep.address + "/generate",
                            {"prompt": PROMPTS[0], "timeout": 60.0},
                            idempotency_key="slo-gen", timeout=60.0)
        assert len(body["emitted"]) == 6
        with rep._cv:
            srv.step()                  # one more evaluation, idle
            text = srv.metrics_text()
            results = srv.slo.results()
        assert validate_prometheus_text(text) == []
        assert 'kubetpu_slo_ok{slo="ttft_p95"} 1' in text
        assert 'kubetpu_slo_ok{slo="pool_free_pages"} 0' in text
        assert 'kubetpu_slo_burn_rate{slo="ttft_p95",window="fast"}' in text
        assert results["ttft_p95"]["ok"] is True
        assert results["pool_free_pages"]["ok"] is False
        got = request_json(rep.address + "/slo", method="GET")
        assert set(got["results"]) == {"ttft_p95", "pool_free_pages"}
        assert got["results"]["pool_free_pages"]["ok"] is False
    finally:
        rep.shutdown(graceful=False)
