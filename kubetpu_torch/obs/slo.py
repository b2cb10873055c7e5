"""Declarative SLOs with multi-window burn rates (port of
``kubetpu/obs/slo.py``, stdlib only as there): the judgment layer over the
metrics registry, and the decision surface the prefix-affinity router and
autoscaler consume: ``router_slos()`` is the canned set
``kubetpu_torch.router.RouterServer`` evaluates over its federated scrape
to shed/queue by SLO class, and whose fast-window burn the autoscaler
folds into its hot signal.

The registry records *what happened*; an SLO says *whether that is
acceptable* and *how fast the error budget is burning*. One
``Objective`` declares a service-level indicator as a selector over
Prometheus-shaped samples (metric name + label subset, optionally a
percentile for summary metrics, optionally a ratio) plus the threshold
that makes an evaluation "good":

    Objective("ttft_p95", metric="kubetpu_serving_latency_seconds",
              labels={"op": "ttft"}, percentile=95, threshold=0.25)
    Objective("pool_floor", metric="kubetpu_serving_pages_free",
              threshold=4, op=">=", reduce="min")
    Objective("availability", metric="kubetpu_nodes",
              labels={"state": "healthy"}, ratio_of="kubetpu_nodes",
              threshold=0.99, op=">=")

``SloEngine.evaluate`` runs every objective against a snapshot source —
a live ``Registry``, raw Prometheus exposition text (the controller's
already-federated fleet scrape), or a pre-parsed sample list — and
feeds each verdict into two ring-buffered windows (fast, default 5 min;
slow, default 1 h). The burn rate of a window is the SRE spelling:

    burn(window) = bad_fraction(window) / (1 - target)

i.e. how many times faster than "exactly spending the budget" the
objective is failing; sustained total violation of a target-0.99
objective reads 100. ``firing`` requires BOTH windows over the
``burn_threshold`` (default 14.4, the classic fast-page multiwindow
rule): the fast window makes a fresh outage visible within one
evaluation window, and makes recovery visible the moment recent
evaluations go good again, while the slow window keeps one blip from
paging — once there is an hour of history for it to weigh; at cold
start a totally-violating first evaluation fires immediately (there is
no evidence of health to hold the page back).

Percentile SLIs and recovery — the part naive snapshotting gets wrong:
a cumulative reservoir's p95 never recovers after an incident (the bad
samples sit in the reservoir forever). Against a LIVE registry the
engine therefore evaluates percentiles over a WINDOWED view: it ring-
buffers per-evaluation reservoir cursors and, while the histogram is
below its reservoir cap (where the reservoir is an exact append-only
log), computes the percentile over only the observations that arrived
inside the fast window. Past the cap the reservoir starts replacing and
the engine falls back to the full-reservoir estimate (slow-moving, but
never wrong about the long run). Against exposition TEXT (fleet
federation) only the rendered quantiles exist, so the nearest rendered
quantile is used as-is — documented degradation, not a silent lie.

Evaluations render as gauges on the bound registry so any scrape (and
``python -m kubetpu.cli.obs slo``, which reads them over HTTP) sees them:

    kubetpu_slo_value{slo=...}            latest SLI value
    kubetpu_slo_threshold{slo=...}
    kubetpu_slo_ok{slo=...}               1 good / 0 violating
    kubetpu_slo_data{slo=...}             0 = SLI absent: value/ok above
                                          are the last definite verdict,
                                          stale, not current health
    kubetpu_slo_burn_rate{slo=...,window="fast"|"slow"}
    kubetpu_slo_firing{slo=...}
    kubetpu_slo_evaluations_total{slo=...} / kubetpu_slo_violations_total

Stdlib only; imports nothing from the port outside ``obs``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

from kubetpu_torch.obs.registry import Histogram, Registry, parse_prometheus_text

FAST_WINDOW = 300.0      # 5 min
SLOW_WINDOW = 3600.0     # 1 h
BURN_THRESHOLD = 14.4    # the SRE fast-page multiwindow constant


@dataclass(frozen=True)
class Objective:
    """One declarative SLO. ``op`` is the GOOD comparison: ``"<="`` for
    ceilings (latency), ``">="`` for floors (free pages, availability).
    ``target`` is the fraction of evaluations that must be good — the
    error budget is ``1 - target``. ``reduce`` folds multiple matching
    samples (a federated fleet scrape): "sum", "min", "max", "first"."""

    name: str
    metric: str
    threshold: float
    labels: Dict[str, str] = field(default_factory=dict)
    percentile: Optional[float] = None   # summary metrics only
    op: str = "<="
    target: float = 0.99
    ratio_of: Optional[str] = None       # denominator metric (summed)
    reduce: str = "sum"
    description: str = ""

    def __post_init__(self):
        if self.op not in ("<=", ">="):
            raise ValueError("op must be '<=' or '>='")
        if not 0.0 < self.target < 1.0:
            raise ValueError("target must be in (0, 1)")
        if self.reduce not in ("sum", "min", "max", "first"):
            raise ValueError("reduce must be sum/min/max/first")
        if self.percentile is not None and not 0 < self.percentile < 100:
            raise ValueError("percentile must be in (0, 100)")

    def good(self, value: float) -> bool:
        return value <= self.threshold if self.op == "<=" \
            else value >= self.threshold


def _pct_of(sorted_buf: List[float], p: float) -> float:
    """Nearest-rank percentile of a pre-sorted list (the repo-wide
    ``Histogram.percentile`` convention); 0.0 when empty."""
    if not sorted_buf:
        return 0.0
    idx = min(len(sorted_buf) - 1,
              max(0, int(round(p / 100.0 * (len(sorted_buf) - 1)))))
    return sorted_buf[idx]


class _Track:
    """Per-objective mutable state: the (t, ok) verdict ring (pruned at
    the slow horizon, so the deque IS the slow window), an incremental
    bad-verdict count over it (the slow burn must not rescan an hour of
    1 Hz evaluations every step), and, for live-registry percentile
    SLIs, the reservoir cursors."""

    __slots__ = ("verdicts", "bad", "cursors")

    def __init__(self) -> None:
        self.verdicts: deque = deque()       # (t, ok: bool)
        self.bad = 0                         # bad verdicts in the deque
        self.cursors: deque = deque()        # (t, reservoir length)


class SloEngine:
    """Evaluate declared objectives over snapshots; keep burn windows."""

    def __init__(
        self,
        objectives: List[Objective],
        registry: Optional[Registry] = None,
        fast_window: float = FAST_WINDOW,
        slow_window: float = SLOW_WINDOW,
        burn_threshold: float = BURN_THRESHOLD,
    ) -> None:
        names = [o.name for o in objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names in {names}")
        for o in objectives:
            # total violation burns at 1/(1-target); a threshold above
            # that can NEVER fire — a silently dead page is worse than a
            # loud config error
            if burn_threshold > 1.0 / (1.0 - o.target) + 1e-9:
                raise ValueError(
                    f"objective {o.name!r}: burn_threshold "
                    f"{burn_threshold} is unreachable at target "
                    f"{o.target} (max burn {1.0 / (1.0 - o.target):.1f})")
        self.objectives = list(objectives)
        self.registry = registry
        self.fast_window = float(fast_window)
        self.slow_window = float(slow_window)
        self.burn_threshold = float(burn_threshold)
        self._lock = threading.Lock()
        self._tracks: Dict[str, _Track] = {o.name: _Track()
                                           for o in objectives}
        self._last: Dict[str, dict] = {}
        self._last_auto = 0.0

    # -- value resolution ----------------------------------------------------

    def _find_histogram(self, reg: Registry,
                        obj: Objective) -> Optional[Histogram]:
        for name, labels, kind, inst in reg.snapshot():
            if (name == obj.metric and kind == "summary"
                    and all(dict(labels).get(k) == str(v)
                            for k, v in obj.labels.items())):
                return inst
        return None

    def _windowed_percentile(self, obj: Objective, hist: Histogram,
                             now: float) -> float:
        """Percentile over the observations that arrived inside the fast
        window — exact while the reservoir is below cap (append-only);
        falls back to the full-reservoir estimate past it."""
        track = self._tracks[obj.name]
        count, buf = hist.tail()
        if count > len(buf):
            return _pct_of(sorted(buf), obj.percentile)   # past cap
        start = 0
        for t, cur_len in track.cursors:
            if t <= now - self.fast_window:
                start = cur_len       # latest cursor at/before window start
            else:
                break
        track.cursors.append((now, len(buf)))
        # only fast-window lookups read cursors: keep the newest one at
        # or before the window start plus everything after it
        while (len(track.cursors) > 2
               and track.cursors[1][0] <= now - self.fast_window):
            track.cursors.popleft()
        if start >= len(buf):
            return None     # no observations inside the window: the SLI
            # is ABSENT (no verdict, burn decays), never "0.0 = perfect"
        return _pct_of(sorted(buf[start:]), obj.percentile)

    @staticmethod
    def _match(samples, metric: str, want: Dict[str, str],
               need_quantile: bool = False):
        out = []
        for name, labels, value in samples:
            if name != metric:
                continue
            if not all(labels.get(k) == str(v) for k, v in want.items()):
                continue
            if need_quantile != ("quantile" in labels):
                continue
            out.append((labels, value))
        return out

    def _resolve(self, obj: Objective, source, now: float, samples_of):
        """The objective's SLI value from *source* (live Registry or a
        parsed sample list), or None when the series is absent.
        *samples_of* lazily yields the parsed sample view of the source,
        computed at most once per evaluation — a registry render sorts
        every reservoir, far too dear to repeat per objective."""
        if isinstance(source, Registry) and obj.percentile is not None:
            hist = self._find_histogram(source, obj)
            if hist is None or hist.count == 0:
                return None
            return self._windowed_percentile(obj, hist, now)
        samples = samples_of()
        if obj.percentile is not None:
            cands = self._match(samples, obj.metric, obj.labels,
                                need_quantile=True)
            if not cands:
                return None
            want_q = obj.percentile / 100.0
            # a federated scrape carries one summary PER REPLICA (extra
            # component/node labels): pick the nearest rendered quantile
            # within each series, then judge the WORST replica — max for
            # ceilings, min for floors — so one degraded replica can't
            # hide behind a healthy one that happens to parse first
            groups: Dict[Tuple, List[Tuple[float, float]]] = {}
            for labels, value in cands:
                key = tuple(sorted((k, v) for k, v in labels.items()
                                   if k != "quantile"))
                groups.setdefault(key, []).append(
                    (abs(float(labels["quantile"]) - want_q), value))
            per_series = [min(g)[1] for g in groups.values()]
            return (max(per_series) if obj.op == "<=" else min(per_series))
        cands = self._match(samples, obj.metric, obj.labels)
        if not cands:
            return None
        vals = [v for _, v in cands]
        num = {"sum": sum, "min": min, "max": max,
               "first": lambda xs: xs[0]}[obj.reduce](vals)
        if obj.ratio_of is None:
            return num
        den = sum(v for _, v in self._match(samples, obj.ratio_of, {}))
        if den:
            return num / den
        # 0/0 with the numerator series still rendering is 0% — an
        # all-nodes-dead fleet must read as total violation, not as "no
        # data" (the worst outage cannot be the one that goes silent)
        return 0.0

    # -- burn windows --------------------------------------------------------

    def _burn(self, obj: Objective, track: _Track, now: float,
              window: float) -> float:
        """Bad fraction of the verdicts inside *window*, over budget.
        Verdicts are time-ordered, so the fast window is a reversed scan
        that stops at the window edge; the slow window is the whole
        (slow-horizon-pruned) deque with its incremental bad count —
        neither rescans history that cannot be in view."""
        if window >= self.slow_window:
            n, bad = len(track.verdicts), track.bad
        else:
            n = bad = 0
            for t, ok in reversed(track.verdicts):
                if t <= now - window:
                    break
                n += 1
                bad += not ok
        if not n:
            return 0.0
        return (bad / n) / max(1.0 - obj.target, 1e-9)

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, source=None, now: Optional[float] = None) -> dict:
        """Evaluate every objective against *source* (default: the bound
        registry; or exposition text, or a parsed sample list) at time
        *now* (default wall clock — tests pass synthetic timestamps).
        Returns {objective name: result dict} and refreshes the
        ``kubetpu_slo_*`` gauges on the bound registry."""
        if source is None:
            source = self.registry
            if source is None:
                raise ValueError("no source and no bound registry")
        if isinstance(source, str):
            try:
                source = parse_prometheus_text(source)
            except ValueError:
                source = []          # degraded scrape: series go absent
        now = time.time() if now is None else float(now)
        out: Dict[str, dict] = {}
        parsed: List = []      # one-element lazy cache per evaluation

        def samples_of():
            if not isinstance(source, Registry):
                return source
            if not parsed:
                parsed.append(parse_prometheus_text(source.render()))
            return parsed[0]

        with self._lock:
            for obj in self.objectives:
                track = self._tracks[obj.name]
                value = self._resolve(obj, source, now, samples_of)
                ok: Optional[bool] = None
                if value is not None:
                    ok = obj.good(value)
                    track.verdicts.append((now, ok))
                    track.bad += not ok
                # prune even when the SLI is absent: an outage whose
                # traffic then stops must AGE OUT of the slow window,
                # not freeze burn_slow at 100 over stale verdicts
                while (track.verdicts
                       and track.verdicts[0][0] <= now - self.slow_window):
                    _t, old_ok = track.verdicts.popleft()
                    track.bad -= not old_ok
                burn_fast = self._burn(obj, track, now, self.fast_window)
                burn_slow = self._burn(obj, track, now, self.slow_window)
                firing = (burn_fast >= self.burn_threshold
                          and burn_slow >= self.burn_threshold)
                out[obj.name] = {
                    "value": value,
                    "threshold": obj.threshold,
                    "op": obj.op,
                    "target": obj.target,
                    "ok": ok,
                    "burn_fast": burn_fast,
                    "burn_slow": burn_slow,
                    "firing": firing,
                }
                self._export(obj, out[obj.name])
            self._last = out
            self._last_auto = time.monotonic()
        return out

    def maybe_evaluate(self, interval: float = 1.0, source=None) -> None:
        """Throttled evaluate — the hot-loop spelling (a serving step
        calls this; at most one evaluation per *interval* seconds)."""
        if time.monotonic() - self._last_auto >= interval:
            self.evaluate(source=source)

    def results(self) -> Dict[str, dict]:
        """The last evaluation's results (empty before the first)."""
        with self._lock:
            return dict(self._last)

    def firing(self) -> List[str]:
        """Names of objectives currently firing — the autoscaler's one
        bit per objective."""
        return [n for n, r in self.results().items() if r.get("firing")]

    def _export(self, obj: Objective, res: dict) -> None:
        """Refresh the kubetpu_slo_* gauges (caller holds the lock)."""
        if self.registry is None:
            return
        reg = self.registry
        reg.counter("kubetpu_slo_evaluations_total", slo=obj.name).inc()
        reg.gauge("kubetpu_slo_threshold", slo=obj.name).set(obj.threshold)
        # gauges cannot be un-rendered, so an SLI that has gone absent
        # would leave its last value/ok frozen on every future scrape —
        # the data bit marks them stale instead of letting "no data"
        # impersonate the last definite verdict
        reg.gauge("kubetpu_slo_data", slo=obj.name).set(
            1.0 if res["value"] is not None else 0.0)
        if res["value"] is not None:
            reg.gauge("kubetpu_slo_value", slo=obj.name).set(res["value"])
            reg.gauge("kubetpu_slo_ok", slo=obj.name).set(
                1.0 if res["ok"] else 0.0)
            if not res["ok"]:
                reg.counter("kubetpu_slo_violations_total",
                            slo=obj.name).inc()
        for window, burn in (("fast", res["burn_fast"]),
                             ("slow", res["burn_slow"])):
            reg.gauge("kubetpu_slo_burn_rate", slo=obj.name,
                      window=window).set(burn)
        reg.gauge("kubetpu_slo_firing", slo=obj.name).set(
            1.0 if res["firing"] else 0.0)


# -- canned objective sets ----------------------------------------------------


def serving_slos(
    ttft_p95_s: Optional[float] = None,
    itl_p99_s: Optional[float] = None,
    queue_wait_p99_s: Optional[float] = None,
    min_free_pages: Optional[int] = None,
    target: float = 0.99,
) -> List[Objective]:
    """The serving-replica objective set — pass only the
    thresholds you care about. Latency SLIs select the
    ``kubetpu_serving_latency_seconds{op=...}`` histograms; the pool
    floor selects the paged server's free-pages gauge (min-reduced so a
    federated scrape reports the WORST replica)."""
    out: List[Objective] = []
    if ttft_p95_s is not None:
        out.append(Objective(
            "ttft_p95", metric="kubetpu_serving_latency_seconds",
            labels={"op": "ttft"}, percentile=95, threshold=ttft_p95_s,
            target=target, description="time to first token, p95"))
    if itl_p99_s is not None:
        out.append(Objective(
            "itl_p99", metric="kubetpu_serving_latency_seconds",
            labels={"op": "itl"}, percentile=99, threshold=itl_p99_s,
            target=target, description="inter-token latency, p99"))
    if queue_wait_p99_s is not None:
        out.append(Objective(
            "queue_wait_p99", metric="kubetpu_serving_latency_seconds",
            labels={"op": "queue_wait"}, percentile=99,
            threshold=queue_wait_p99_s, target=target,
            description="admission-queue wait, p99"))
    if min_free_pages is not None:
        out.append(Objective(
            "pool_free_pages", metric="kubetpu_serving_pages_free",
            threshold=float(min_free_pages), op=">=", reduce="min",
            target=target, description="paged-pool free-pages floor"))
    return out


def router_slos(
    route_p99_s: Optional[float] = None,
    ttft_p50_s: Optional[float] = None,
    queue_wait_p99_s: Optional[float] = None,
    min_free_pages: Optional[int] = None,
    max_queue_depth: Optional[int] = None,
    target: float = 0.99,
) -> List[Objective]:
    """The data-plane objective set: what the
    ``kubetpu_torch.router.RouterServer`` evaluates over its FEDERATED
    ``/metrics`` each refresh — the router's own end-to-end route
    latency plus the WORST replica's serving SLIs (federated percentile
    resolution already judges max-for-ceilings / min-for-floors, so one
    page-starved replica fires the set). The router sheds/queues by SLO
    class while any fast window burns; the autoscaler reads the same
    verdicts to scale."""
    out: List[Objective] = []
    if route_p99_s is not None:
        out.append(Objective(
            "route_p99", metric="kubetpu_router_latency_seconds",
            labels={"op": "route"}, percentile=99, threshold=route_p99_s,
            target=target, description="router end-to-end route, p99"))
    if ttft_p50_s is not None:
        out.append(Objective(
            "fleet_ttft_p50", metric="kubetpu_serving_latency_seconds",
            labels={"op": "ttft"}, percentile=50, threshold=ttft_p50_s,
            target=target,
            description="worst replica time to first token, p50"))
    if queue_wait_p99_s is not None:
        out.append(Objective(
            "fleet_queue_wait_p99",
            metric="kubetpu_serving_latency_seconds",
            labels={"op": "queue_wait"}, percentile=99,
            threshold=queue_wait_p99_s, target=target,
            description="worst replica admission-queue wait, p99"))
    if min_free_pages is not None:
        out.append(Objective(
            "fleet_free_pages", metric="kubetpu_serving_pages_free",
            threshold=float(min_free_pages), op=">=", reduce="min",
            target=target,
            description="tightest replica paged-pool free pages"))
    if max_queue_depth is not None:
        out.append(Objective(
            "fleet_queue_depth", metric="kubetpu_serving_queue_depth",
            threshold=float(max_queue_depth), op="<=", reduce="max",
            target=target,
            description="deepest replica admission queue"))
    return out


def disagg_slos(
    itl_p99_s: Optional[float] = None,
    ttft_p95_s: Optional[float] = None,
    queue_wait_p99_s: Optional[float] = None,
    min_free_pages: Optional[int] = None,
    handoff_success: Optional[float] = None,
    target: float = 0.99,
) -> List[Objective]:
    """The disaggregated-fleet objective set, evaluated over
    the router's FEDERATED ``/metrics`` like ``router_slos``. The two
    pools fail differently, so the set watches both halves: the DECODE
    pool's inter-token latency ceiling and free-page floor (decode ITL
    no longer pays for anyone's prompts — this is the number
    disaggregation exists to protect), the PREFILL pool's admission
    queue wait, the client-visible route latency (the router-side
    number that INCLUDES the handoff wire hop — serving-side TTFT is
    recorded at the prefill source and excludes it), and the handoff
    success ratio
    (``kubetpu_handoffs_total{result="committed"}`` over all outcomes
    — a fleet quietly degrading to colocated serving via refused
    handoffs still meets latency SLOs while silently losing the
    topology; this objective makes that visible)."""
    out: List[Objective] = []
    if itl_p99_s is not None:
        out.append(Objective(
            "disagg_itl_p99", metric="kubetpu_serving_latency_seconds",
            labels={"op": "itl"}, percentile=99, threshold=itl_p99_s,
            target=target,
            description="decode-pool inter-token latency, p99 "
                        "(worst replica)"))
    if ttft_p95_s is not None:
        # deliberately the ROUTER's route latency, not the serving
        # ttft histogram: serving records TTFT at the PREFILL source
        # when the first token materializes — BEFORE the freeze/ship/
        # commit/adoption sequence that delivers it — so it
        # structurally excludes exactly the wire latency
        # disaggregation adds. The route op covers pick -> final
        # upstream answer including the 409-chase to the decode
        # replica: the client-visible number.
        out.append(Objective(
            "disagg_route_p95", metric="kubetpu_router_latency_seconds",
            labels={"op": "route"}, percentile=95, threshold=ttft_p95_s,
            target=target,
            description="client-visible routed-request latency incl. "
                        "the handoff hop, p95"))
    if queue_wait_p99_s is not None:
        out.append(Objective(
            "disagg_queue_wait_p99",
            metric="kubetpu_serving_latency_seconds",
            labels={"op": "queue_wait"}, percentile=99,
            threshold=queue_wait_p99_s, target=target,
            description="prefill-pool admission-queue wait, p99"))
    if min_free_pages is not None:
        out.append(Objective(
            "disagg_free_pages", metric="kubetpu_serving_pages_free",
            threshold=float(min_free_pages), op=">=", reduce="min",
            target=target,
            description="tightest decode-pool free-pages floor"))
    if handoff_success is not None:
        out.append(Objective(
            "disagg_handoff_success", metric="kubetpu_handoffs_total",
            labels={"result": "committed"},
            ratio_of="kubetpu_handoffs_total",
            threshold=float(handoff_success), op=">=", target=target,
            description="fraction of prefill->decode handoffs that "
                        "committed"))
    return out


def fleet_slos(
    min_healthy_fraction: float = 0.99,
    schedule_p99_s: Optional[float] = None,
    max_pending_pods: Optional[int] = None,
    target: float = 0.99,
) -> List[Objective]:
    """Controller-level objectives over the federated fleet scrape:
    node availability (healthy / all breaker states), scheduler latency,
    and a pending-queue ceiling."""
    out = [Objective(
        "node_availability", metric="kubetpu_nodes",
        labels={"state": "healthy"}, ratio_of="kubetpu_nodes",
        threshold=min_healthy_fraction, op=">=", target=target,
        description="fraction of nodes breaker-healthy")]
    if schedule_p99_s is not None:
        out.append(Objective(
            "schedule_p99", metric="kubetpu_schedule_latency_seconds",
            labels={"op": "schedule_pod"}, percentile=99,
            threshold=schedule_p99_s, target=target,
            description="pod schedule latency, p99"))
    if max_pending_pods is not None:
        out.append(Objective(
            "pending_pods", metric="kubetpu_pending_pods",
            threshold=float(max_pending_pods), op="<=", target=target,
            description="pods waiting for capacity"))
    return out
