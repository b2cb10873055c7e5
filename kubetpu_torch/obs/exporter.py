"""``MetricsServer`` — publish any ``Registry`` (and the process tracer)
over HTTP (port of ``kubetpu/obs/exporter.py``).

The serving replicas (DecodeServer / PagedDecodeServer and friends) are
in-process objects with registries but no wire surface of their own; this
tiny stdlib server is the slot-server wire path: point it at one or more
registries (and event logs) and scrape

    GET /metrics      merged Prometheus text of every attached registry
    GET /healthz      liveness
    GET /trace/<id>   finished spans of one trace from the process tracer
    GET /events       attached event logs as JSON Lines, (ts, seq)-merged;
                      ``?kind=...`` filters, ``?limit=N`` keeps the tail

``python -m kubetpu.cli.obs --scrape URL`` reads these endpoints over
HTTP. Threaded, ephemeral-port friendly (port 0), same lifecycle shape as
the wire servers (start/shutdown).
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Union

from kubetpu_torch.obs import trace as obs_trace
from kubetpu_torch.obs.events import EventLog, merge_events
from kubetpu_torch.obs.registry import Registry
from kubetpu_torch.wire.httpcommon import (
    serve_events_jsonl,
    write_json,
    write_text,
)


class MetricsServer:
    """Expose named registries at ``/metrics`` + traces at ``/trace/<id>``
    + event logs at ``/events``."""

    def __init__(self, registries: Dict[str, Registry],
                 host: str = "127.0.0.1", port: int = 0,
                 events: Union[EventLog, Dict[str, EventLog],
                               None] = None) -> None:
        """*registries*: {component name -> Registry}; with more than one,
        every series gains a ``component="<name>"`` label via federation
        so two replicas' histograms never collide. *events*: one
        ``EventLog`` (a single replica's ``server.events``) or a
        {component name -> EventLog} map, served merged at /events."""
        self.registries = dict(registries)
        if events is None:
            events = {}
        elif isinstance(events, EventLog):
            events = {next(iter(registries), "replica"): events}
        self.event_logs: Dict[str, EventLog] = dict(events)
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: N802 — quiet
                pass

            def do_GET(self):  # noqa: N802
                url = urllib.parse.urlsplit(self.path)
                if url.path == "/healthz":
                    write_json(self, 200, {"ok": True})
                elif url.path == "/metrics":
                    write_text(self, 200, exporter.render())
                elif url.path == "/events":
                    serve_events_jsonl(self, exporter.render_events)
                elif url.path.startswith("/trace/"):
                    tid = url.path[len("/trace/"):]
                    spans = obs_trace.tracer().spans(tid)
                    write_json(self, 200, {"trace": tid, "spans": spans})
                else:
                    write_json(self, 404, {"error": f"no route {self.path}"})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    def render(self) -> str:
        from kubetpu_torch.obs.registry import federate

        if len(self.registries) == 1:
            return next(iter(self.registries.values())).render()
        return federate(
            "", {name: reg.render() for name, reg in self.registries.items()},
            label="component",
        )

    def render_events(self, kind: Optional[str] = None,
                      limit: Optional[int] = None) -> str:
        evs = merge_events(self.event_logs, limit=None)
        if kind is not None:
            evs = [e for e in evs if e.get("kind") == kind]
        if limit is not None and limit >= 0:
            evs = evs[-limit:] if limit else []
        return "".join(json.dumps(e) + "\n" for e in evs)

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> str:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="kubetpu-obs-exporter",
            daemon=True,
        )
        self._thread.start()
        return self.address

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
