"""The port's SLO engine (``kubetpu_torch.obs.slo``), held to the JAX
package's SLO tests case for case: burn-rate math against hand-computed
windows, multi-window firing and recovery, SLI resolution over live
registries and federated exposition text, windowed-percentile recovery,
and an injected latency fault (the port's ``wire/faults.py``, on the
port router's wire) driving a declared TTFT objective into fast-burn
violation, then recovering when the fault is removed. A parity case
holds the port's engine to the reference's on the same samples at the
same synthetic clock.

All evaluation clocks are SYNTHETIC (``evaluate(now=...)``): the window
math must be testable without sleeping."""

import time

import pytest

from kubetpu_torch.obs.registry import Registry
from kubetpu_torch.obs.slo import (
    BURN_THRESHOLD,
    Objective,
    SloEngine,
    fleet_slos,
    serving_slos,
)

# -- objective declaration ----------------------------------------------------


def test_objective_validation():
    with pytest.raises(ValueError):
        Objective("x", metric="m", threshold=1.0, op="==")
    with pytest.raises(ValueError):
        Objective("x", metric="m", threshold=1.0, target=1.0)
    with pytest.raises(ValueError):
        Objective("x", metric="m", threshold=1.0, reduce="median")
    with pytest.raises(ValueError):
        Objective("x", metric="m", threshold=1.0, percentile=100)
    with pytest.raises(ValueError):
        SloEngine([Objective("a", metric="m", threshold=1),
                   Objective("a", metric="m", threshold=2)])


def test_good_comparison_directions():
    ceil = Objective("lat", metric="m", threshold=0.25)            # "<="
    floor = Objective("pages", metric="m", threshold=4, op=">=")
    assert ceil.good(0.25) and not ceil.good(0.26)
    assert floor.good(4) and not floor.good(3.9)


# -- burn-rate math vs hand-computed windows ----------------------------------


def test_burn_rate_hand_computed_windows():
    """target=0.9 -> error budget 0.1. Feed a scripted verdict sequence
    at synthetic times and check both windows against hand arithmetic:
    burn = bad_fraction / 0.1."""
    obj = Objective("q", metric="m", threshold=10.0, target=0.9)
    eng = SloEngine([obj], fast_window=100.0, slow_window=1000.0,
                    burn_threshold=8.0)    # reachable at budget 0.1
    # value 20 violates (<= 10 is good), value 5 is good
    script = [(0, 5), (10, 20), (20, 20), (30, 5), (40, 20)]
    for t, v in script:
        res = eng.evaluate(source=[("m", {}, float(v))], now=float(t))["q"]
    # at t=40 all five verdicts are inside both windows: 3 bad / 5
    assert res["burn_fast"] == pytest.approx((3 / 5) / 0.1)
    assert res["burn_slow"] == pytest.approx((3 / 5) / 0.1)
    # advance: at t=125 the fast window (t > 25) holds only t=30 good,
    # t=40 bad and the new good one -> 1 bad / 3; slow window has 4 bad/7
    res = eng.evaluate(source=[("m", {}, 5.0)], now=125.0)["q"]
    assert res["burn_fast"] == pytest.approx((1 / 3) / 0.1)
    assert res["burn_slow"] == pytest.approx((3 / 6) / 0.1)


def test_burn_window_eviction_at_slow_horizon():
    obj = Objective("q", metric="m", threshold=1.0, target=0.5)
    eng = SloEngine([obj], fast_window=10.0, slow_window=100.0,
                    burn_threshold=1.5)    # reachable at budget 0.5
    eng.evaluate(source=[("m", {}, 9.0)], now=0.0)       # bad
    res = eng.evaluate(source=[("m", {}, 0.0)], now=150.0)["q"]
    # the t=0 bad verdict fell off the slow ring entirely
    assert res["burn_slow"] == 0.0 and res["burn_fast"] == 0.0


def test_firing_needs_both_windows_and_recovers_fast():
    """The multiwindow rule: a sustained violation fires (both windows
    over threshold); the moment the fast window goes good again, firing
    clears even while the slow window still remembers the incident."""
    obj = Objective("q", metric="m", threshold=1.0, target=0.99)
    eng = SloEngine([obj], fast_window=60.0, slow_window=3600.0)
    t = 0.0
    for _ in range(10):                      # 10 min of total violation
        res = eng.evaluate(source=[("m", {}, 5.0)], now=t)["q"]
        t += 60.0
    assert res["burn_fast"] == pytest.approx(100.0)      # 1.0 / 0.01
    assert res["burn_slow"] == pytest.approx(100.0)
    assert res["firing"] and res["ok"] is False
    # recovery: good evaluations refill the fast window
    for _ in range(3):
        res = eng.evaluate(source=[("m", {}, 0.5)], now=t)["q"]
        t += 30.0
    assert res["burn_fast"] < BURN_THRESHOLD
    assert not res["firing"]
    assert res["burn_slow"] > BURN_THRESHOLD   # the hour still remembers


# -- SLI resolution -----------------------------------------------------------


def test_ratio_and_reduce_over_sample_list():
    samples = [
        ("kubetpu_nodes", {"state": "healthy"}, 3.0),
        ("kubetpu_nodes", {"state": "suspect"}, 1.0),
        ("kubetpu_serving_pages_free", {"component": "a"}, 12.0),
        ("kubetpu_serving_pages_free", {"component": "b"}, 2.0),
    ]
    avail = fleet_slos(min_healthy_fraction=0.9)[0]
    floor = serving_slos(min_free_pages=4)[0]
    eng = SloEngine([avail, floor])
    out = eng.evaluate(source=samples, now=0.0)
    assert out["node_availability"]["value"] == pytest.approx(0.75)
    assert out["node_availability"]["ok"] is False
    # min-reduce reports the WORST replica across the federated scrape
    assert out["pool_free_pages"]["value"] == 2.0
    assert out["pool_free_pages"]["ok"] is False


def test_ratio_zero_denominator_is_total_violation_not_absent():
    """All nodes evicted: kubetpu_nodes still renders (zeros), the
    availability ratio is 0/0 — that must read 0% available and burn,
    never 'no data'. The worst outage cannot be the silent one."""
    samples = [("kubetpu_nodes", {"state": "healthy"}, 0.0),
               ("kubetpu_nodes", {"state": "suspect"}, 0.0)]
    eng = SloEngine(fleet_slos(min_healthy_fraction=0.9))
    res = eng.evaluate(source=samples, now=0.0)["node_availability"]
    assert res["value"] == 0.0 and res["ok"] is False
    assert res["burn_fast"] > 0
    # the series itself being gone is still absent, though
    res = eng.evaluate(source=[("other", {}, 1.0)],
                       now=1.0)["node_availability"]
    assert res["value"] is None


def test_absent_series_yields_no_verdict():
    eng = SloEngine([Objective("q", metric="missing", threshold=1.0)])
    res = eng.evaluate(source=[("other", {}, 1.0)], now=0.0)["q"]
    assert res["value"] is None and res["ok"] is None
    assert res["burn_fast"] == 0.0 and not res["firing"]
    # degraded scrape text (unparseable) degrades to absent, not a crash
    res = eng.evaluate(source="not prometheus {{{", now=1.0)["q"]
    assert res["value"] is None


def test_percentile_from_exposition_text_nearest_quantile():
    """Against federated TEXT only rendered quantiles exist — the
    engine picks the nearest one (documented degradation)."""
    reg = Registry()
    h = reg.histogram("kubetpu_serving_latency_seconds", op="ttft")
    for v in (0.1, 0.2, 0.3):
        h.observe(v)
    obj = serving_slos(ttft_p95_s=0.25)[0]         # p95 -> nearest is 0.99
    eng = SloEngine([obj])
    res = eng.evaluate(source=reg.render(), now=0.0)["ttft_p95"]
    assert res["value"] == pytest.approx(0.3)
    assert res["ok"] is False


def test_percentile_over_federated_scrape_judges_worst_replica():
    """A federated scrape carries one summary per replica; a latency
    ceiling must judge the WORST one — a degraded replica can't hide
    behind a healthy sibling that happens to parse first."""
    samples = [
        ("kubetpu_serving_latency_seconds",
         {"op": "ttft", "component": "a", "quantile": "0.99"}, 0.1),
        ("kubetpu_serving_latency_seconds",
         {"op": "ttft", "component": "b", "quantile": "0.99"}, 2.0),
    ]
    obj = serving_slos(ttft_p95_s=0.25)[0]
    eng = SloEngine([obj])
    res = eng.evaluate(source=samples, now=0.0)["ttft_p95"]
    assert res["value"] == pytest.approx(2.0)
    assert res["ok"] is False


def test_windowed_percentile_recovers_on_live_registry():
    """The naive-snapshot trap: a cumulative reservoir's p95 never
    forgets an incident. Against a LIVE registry the engine windows the
    reservoir by per-evaluation cursors, so once the bad samples age out
    of the fast window the SLI recovers."""
    reg = Registry()
    h = reg.histogram("kubetpu_serving_latency_seconds", op="ttft")
    obj = serving_slos(ttft_p95_s=0.25)[0]
    eng = SloEngine([obj], registry=reg, fast_window=100.0)
    for _ in range(20):
        h.observe(0.5)                              # the incident
    assert eng.evaluate(now=0.0)["ttft_p95"]["ok"] is False
    for _ in range(20):
        h.observe(0.01)                             # healthy again
    # within the same fast window the bad samples still dominate p95
    assert eng.evaluate(now=50.0)["ttft_p95"]["ok"] is False
    # past the window only the post-t=0 observations (the healthy ones,
    # bracketed by the t=0 cursor) are in view
    res = eng.evaluate(now=140.0)["ttft_p95"]
    assert res["value"] == pytest.approx(0.01)
    assert res["ok"] is True
    # and a window with NO bracketed observations reads ABSENT (no
    # verdict), never "0.0 = perfect"
    res = eng.evaluate(now=400.0)["ttft_p95"]
    assert res["value"] is None and res["ok"] is None


# -- gauge export -------------------------------------------------------------


def test_slo_gauges_render_on_bound_registry():
    reg = Registry()
    reg.gauge("kubetpu_serving_pages_free").set(2)
    eng = SloEngine(serving_slos(min_free_pages=4), registry=reg)
    eng.evaluate(now=0.0)
    text = reg.render()
    assert 'kubetpu_slo_value{slo="pool_free_pages"} 2' in text
    assert 'kubetpu_slo_threshold{slo="pool_free_pages"} 4' in text
    assert 'kubetpu_slo_ok{slo="pool_free_pages"} 0' in text
    assert 'kubetpu_slo_burn_rate{slo="pool_free_pages",window="fast"}' in text
    assert 'kubetpu_slo_burn_rate{slo="pool_free_pages",window="slow"}' in text
    assert 'kubetpu_slo_firing{slo="pool_free_pages"}' in text
    assert 'kubetpu_slo_evaluations_total{slo="pool_free_pages"} 1' in text
    assert 'kubetpu_slo_violations_total{slo="pool_free_pages"} 1' in text
    # cold start with a totally-violating gauge: fires immediately (no
    # history of health to hold the page back)
    assert eng.firing() == ["pool_free_pages"]
    assert 'kubetpu_slo_data{slo="pool_free_pages"} 1' in text
    # when the SLI goes absent the data bit flips so the frozen value/ok
    # gauges read as stale, not as fresh health — and cli.obs says so
    from kubetpu.cli.obs import render_slo

    eng2 = SloEngine(serving_slos(ttft_p95_s=0.25), registry=Registry())
    eng2.registry.histogram("unrelated")
    eng2.evaluate(now=0.0)
    text2 = eng2.registry.render()
    assert 'kubetpu_slo_data{slo="ttft_p95"} 0' in text2
    assert "no data" in render_slo(text2, "replica")
    # an unreachable burn threshold is a loud config error, not a
    # silently dead page
    with pytest.raises(ValueError):
        SloEngine(serving_slos(min_free_pages=4, target=0.9))


def test_maybe_evaluate_throttles():
    reg = Registry()
    reg.gauge("kubetpu_serving_pages_free").set(9)
    eng = SloEngine(serving_slos(min_free_pages=4), registry=reg)
    eng.maybe_evaluate(interval=30.0)
    eng.maybe_evaluate(interval=30.0)     # inside the interval: skipped
    assert ("kubetpu_slo_evaluations_total"
            '{slo="pool_free_pages"} 1') in reg.render().replace("\n", "")


# -- the acceptance pin: fault-driven TTFT burn + recovery --------------------


def test_injected_latency_fault_fires_ttft_slo_then_recovers():
    """A seeded ``wire/faults.py`` delay on the port router's ``/healthz``
    drives a client-observed TTFT objective into fast-burn violation
    within one evaluation window; clearing the injector recovers it. The
    TTFT histogram is the serving-shaped series, the engine runs over the
    live registry (windowed percentiles), and the JAX package's ``cli.obs
    slo`` view renders the firing state."""
    from kubetpu.cli.obs import render_slo
    from kubetpu_torch.router import RouterServer
    from kubetpu_torch.wire.faults import FaultInjector, RoutePolicy
    from kubetpu_torch.wire.httpcommon import request_json

    # thresholds sized for loaded CI boxes: a healthy local HTTP round
    # trip stays well under 150 ms even throttled; the injected 400 ms
    # delay clears it by design, not by luck
    inj = FaultInjector(seed=7, routes={
        "/healthz": RoutePolicy(delay=1.0, delay_s=0.4)})
    router = RouterServer(faults=inj)
    router.start()
    reg = Registry()
    hist = reg.histogram("kubetpu_serving_latency_seconds", op="ttft")
    eng = SloEngine(serving_slos(ttft_p95_s=0.15),
                    registry=reg, fast_window=10.0, slow_window=100.0)

    def observe_ttft(n):
        for _ in range(n):
            t0 = time.perf_counter()
            request_json(router.address + "/healthz")
            hist.observe(time.perf_counter() - t0)

    try:
        t = 0.0
        observe_ttft(4)                      # every call eats the delay
        for _ in range(4):                   # one evaluation window of bad
            res = eng.evaluate(now=t)["ttft_p95"]
            t += 2.5
        assert res["value"] >= 0.4 and res["ok"] is False
        assert res["burn_fast"] >= BURN_THRESHOLD
        assert res["firing"], res
        text = reg.render()
        assert 'kubetpu_slo_firing{slo="ttft_p95"} 1' in text
        assert "FIRING" in render_slo(text, "replica")

        inj.clear()                          # the network heals
        observe_ttft(6)
        t += 10.0                            # past the fast window
        for _ in range(4):
            res = eng.evaluate(now=t)["ttft_p95"]
            t += 2.5
        assert res["value"] < 0.15 and res["ok"] is True
        assert res["burn_fast"] < BURN_THRESHOLD
        assert not res["firing"], res
        text = reg.render()
        assert 'kubetpu_slo_firing{slo="ttft_p95"} 0' in text
        assert "FIRING" not in render_slo(text, "replica")
    finally:
        router.shutdown()


# -- parity with the reference engine ----------------------------------------


def _parity_objectives(mod):
    """The canned sets plus a ratio objective, built from *mod* (the
    port's or the reference's ``obs.slo``)."""
    return (mod.serving_slos(ttft_p95_s=0.2, itl_p99_s=0.05,
                             queue_wait_p99_s=0.1, min_free_pages=8)
            + [mod.Objective("healthy_frac", metric="kubetpu_nodes",
                             labels={"state": "healthy"},
                             ratio_of="kubetpu_nodes", threshold=0.75,
                             op=">=", target=0.95)])


def _fill(reg, rng, step):
    """One step's observations, drawn from *rng*, into *reg*."""
    for op, scale in (("ttft", 0.3), ("itl", 0.08), ("queue_wait", 0.15)):
        h = reg.histogram("kubetpu_serving_latency_seconds", cap=64, op=op)
        for _ in range(rng.randrange(1, 12)):
            h.observe(rng.random() * scale)
    reg.gauge("kubetpu_serving_pages_free").set(rng.randrange(0, 20))
    reg.gauge("kubetpu_nodes", state="healthy").set(rng.randrange(0, 5))
    reg.gauge("kubetpu_nodes", state="suspect").set(step % 3)


@pytest.mark.parametrize("source", ["registry", "text", "samples"])
def test_engine_results_equal_the_reference(source):
    """The same objectives over the same samples (a live registry, its
    exposition text, or the parsed sample list) at the same synthetic
    clock give the same ``results()`` — values, verdicts, burn rates and
    firing — from the port's engine and the JAX package's, step by step
    past the fast window's horizon, with the gauges rendered alike."""
    import random

    from kubetpu.obs import registry as ref_registry
    from kubetpu.obs import slo as ref_slo
    from kubetpu_torch.obs import registry as port_registry
    from kubetpu_torch.obs import slo as port_slo

    regs = {"port": port_registry.Registry(), "ref": ref_registry.Registry()}
    out = {"port": port_registry.Registry(), "ref": ref_registry.Registry()}
    engines = {
        "port": port_slo.SloEngine(_parity_objectives(port_slo),
                                   registry=out["port"], fast_window=30.0,
                                   slow_window=120.0),
        "ref": ref_slo.SloEngine(_parity_objectives(ref_slo),
                                 registry=out["ref"], fast_window=30.0,
                                 slow_window=120.0),
    }
    parse = {"port": port_registry.parse_prometheus_text,
             "ref": ref_registry.parse_prometheus_text}
    rngs = {k: random.Random(99) for k in regs}
    for step in range(24):
        now = 5.0 * step
        for k in regs:
            _fill(regs[k], rngs[k], step)
        results = {}
        for k, eng in engines.items():
            if source == "registry":
                src = regs[k]
            elif source == "text":
                src = regs[k].render()
            else:
                src = parse[k](regs[k].render())
            eng.evaluate(src, now=now)
            results[k] = eng.results()
        assert results["port"] == results["ref"], (step, source)
    assert any(r["firing"] for r in results["port"].values())
    assert out["port"].render() == out["ref"].render()
