"""The port of ``kubetpu.obs``, the observability spine (stdlib only; no
torch, no jax):

- ``registry`` — typed instruments (Counter, Gauge, bounded-reservoir
  Histogram) in a thread-safe ``Registry`` with Prometheus text
  exposition, plus ``parse_prometheus_text`` / ``validate_prometheus_text``
  / ``federate``, which the router uses to merge replica scrapes into one
  fleet ``/metrics``;
- ``trace`` — spans into a bounded process tracer, with the context
  carried over the wire in ``X-Kubetpu-Trace-Id`` / ``X-Kubetpu-Parent-Span``;
- ``events`` — a bounded structured event log, ``merge_events`` and
  ``validate_events_jsonl`` for ``GET /events``;
- ``slo`` — declarative objectives with fast/slow burn windows over a
  registry, exposition text or samples, rendered as ``kubetpu_slo_*``
  gauges; ``serving_slos`` / ``router_slos`` / ``disagg_slos`` /
  ``fleet_slos`` are the canned sets;
- ``profile`` — the sampled serving profiler: a per-phase step breakdown
  and first-call counters per device leg, off by default;
- ``exporter`` — ``MetricsServer``, any registry (and event logs) over
  HTTP.

The series names, labels and text are the JAX package's byte for byte.
"""

from kubetpu_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    default_registry,
    federate,
    install_process_gauges,
    parse_prometheus_text,
    validate_prometheus_text,
)
from kubetpu_torch.obs.trace import (
    Tracer,
    attach_wire_context,
    current_span_id,
    current_trace_id,
    span,
    tracer,
    wire_headers,
)
from kubetpu_torch.obs.events import (
    EventLog,
    event_log,
    merge_events,
    validate_events_jsonl,
)
from kubetpu_torch.obs.slo import (
    Objective,
    SloEngine,
    disagg_slos,
    fleet_slos,
    router_slos,
    serving_slos,
)
from kubetpu_torch.obs.profile import ServingProfiler

__all__ = [
    "Counter",
    "EventLog",
    "Gauge",
    "Histogram",
    "Objective",
    "Registry",
    "ServingProfiler",
    "SloEngine",
    "Tracer",
    "attach_wire_context",
    "current_span_id",
    "current_trace_id",
    "default_registry",
    "disagg_slos",
    "event_log",
    "federate",
    "fleet_slos",
    "router_slos",
    "install_process_gauges",
    "merge_events",
    "parse_prometheus_text",
    "serving_slos",
    "span",
    "tracer",
    "validate_events_jsonl",
    "validate_prometheus_text",
    "wire_headers",
]
