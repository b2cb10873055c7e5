"""Typed metric instruments and a thread-safe registry with Prometheus
text exposition (port of ``kubetpu/obs/registry.py``; stdlib only, as
there).

The series names, label order and text format are the JAX package's byte
for byte, so a dashboard or the reference's validator reads the port's
``metrics_text()`` as it reads the JAX server's:

- **thread-safe, lock-cheap**: each instrument carries its own small lock,
  so a scrape never blocks a writer for longer than one value copy;
- **bounded memory**: histograms keep a fixed-size reservoir, exact
  percentiles below the cap and uniform reservoir sampling above it
  (every observation kept with probability cap/count); count and sum stay
  exact;
- **Prometheus text**: ``Registry.render()`` emits ``# TYPE`` per metric
  and histograms as summaries with ``quantile`` labels plus
  ``_count``/``_sum``; ``validate_prometheus_text`` is the check of that
  text;
- **label order is preserved** (not sorted), so the emitted series match
  byte for byte across scrapes.

``default_registry()`` is the process-wide registry the wire client's
counters land on. ``parse_prometheus_text`` reads the text back, and
``federate`` merges peer scrapes into one exposition (the router's fleet
``/metrics``, the exporter's multi-registry merge).
"""

from __future__ import annotations

import random
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

# label values may contain anything except unescaped quotes/newlines;
# names follow the Prometheus grammar
_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SERIES_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<value>[^\s]+)"
    r"(?:\s+(?P<ts>[0-9]+))?$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')

_QUANTILES = (0.5, 0.9, 0.99)


def _fmt(v: float) -> str:
    """Prometheus sample value: integers render bare (``1``, not ``1.0``)
    so counter lines stay byte-stable and greppable."""
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label_value(v: str) -> str:
    """Prometheus label-value escaping: backslash, quote AND newline —
    a raw newline inside a label would split the series line and corrupt
    the whole exposition."""
    return (v.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _unescape_label_value(s: str) -> str:
    """Inverse of ``_escape_label_value`` — a proper left-to-right scan
    (sequential ``str.replace`` calls mangle adjacent escapes: ``\\\\"``
    must decode to ``\\"``, not ``"``)."""
    out: List[str] = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            nxt = s[i + 1]
            out.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt,
                                                             "\\" + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _fmt_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    body = ",".join(
        '%s="%s"' % (k, _escape_label_value(str(v))) for k, v in labels
    )
    return "{" + body + "}"


class Counter:
    """Monotonic counter. Name it ``*_total`` by convention."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value; ``fn`` makes it a collect-time callback gauge
    (evaluated at render, so scrape-cost state like queue depth needs no
    per-mutation bookkeeping)."""

    def __init__(self, fn: Optional[Callable[[], float]] = None) -> None:
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn = fn

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:  # noqa: BLE001 — a scrape must never 500
                return float("nan")
        with self._lock:
            return self._value


class Histogram:
    """Bounded-reservoir histogram reporting p50/p90/p99.

    Below ``cap`` observations the reservoir holds EVERY sample, so the
    percentiles are exact. Past the cap, uniform reservoir sampling
    (Vitter's algorithm R) keeps each of the ``count`` observations with
    equal probability ``cap/count`` — quantiles become unbiased estimates
    with error shrinking as cap grows. ``count`` and ``sum`` stay exact
    throughout. The RNG is seeded per-instrument so a fixed observation
    order replays bit-for-bit (chaos-test determinism discipline)."""

    def __init__(self, cap: int = 2048, seed: int = 0) -> None:
        if cap <= 0:
            raise ValueError("cap must be positive")
        self.cap = cap
        self._lock = threading.Lock()
        self._rng = random.Random(seed)
        self._buf: List[float] = []
        self._count = 0
        self._sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            if len(self._buf) < self.cap:
                self._buf.append(v)
            else:
                j = self._rng.randrange(self._count)
                if j < self.cap:
                    self._buf[j] = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, p: float) -> float:
        """p in [0, 100]; 0.0 with no samples (nearest-rank, matching the
        pre-obs ``LatencyRecorder`` convention so pinned numbers hold)."""
        with self._lock:
            buf = sorted(self._buf)
        if not buf:
            return 0.0
        idx = min(len(buf) - 1,
                  max(0, int(round(p / 100.0 * (len(buf) - 1)))))
        return buf[idx]

    def tail(self) -> Tuple[int, List[float]]:
        """(exact observation count, copy of the reservoir) under the
        lock — the SLO engine's windowed-percentile hook: below the cap
        the reservoir is an append-only log, so an index cursor into it
        delimits exactly the observations that arrived since the cursor
        was taken."""
        with self._lock:
            return self._count, list(self._buf)


class Registry:
    """Get-or-create instrument store, keyed by (name, labels).

    ``counter/gauge/histogram`` return the live instrument (creating it on
    first use); re-requesting the same (name, labels) with a different
    instrument type raises — one name, one type, like Prometheus.
    ``render()`` emits the whole registry as exposition text, grouped by
    metric name with one ``# TYPE`` line each, in first-registration
    order."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # (name, labels) -> instrument; dict preserves insertion order
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], object] = {}
        self._types: Dict[str, str] = {}
        self._help: Dict[str, str] = {}

    def _get(self, kind: str, name: str, help_: str,
             labels: Dict[str, object], factory):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        key = (name, tuple((k, str(v)) for k, v in labels.items()))
        with self._lock:
            got = self._metrics.get(key)
            if got is not None:
                if self._types[name] != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{self._types[name]}, not {kind}"
                    )
                return got
            if name in self._types and self._types[name] != kind:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{self._types[name]}, not {kind}"
                )
            inst = factory()
            self._metrics[key] = inst
            self._types[name] = kind
            if help_:
                self._help[name] = help_
            return inst

    # -- instrument accessors ------------------------------------------------

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get("counter", name, help, labels, Counter)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get("gauge", name, help, labels, Gauge)

    def gauge_fn(self, name: str, fn: Callable[[], float],
                 help: str = "", **labels) -> Gauge:
        """Collect-time gauge: *fn* is evaluated at every render."""
        g = self._get("gauge", name, help, labels, lambda: Gauge(fn=fn))
        return g

    def histogram(self, name: str, help: str = "", cap: int = 2048,
                  **labels) -> Histogram:
        return self._get("summary", name, help, labels,
                         lambda: Histogram(cap=cap))

    # -- exposition ----------------------------------------------------------

    def snapshot(self):
        """[(name, labels, kind, instrument)] in registration order."""
        with self._lock:
            items = list(self._metrics.items())
            types = dict(self._types)
        return [(name, labels, types[name], inst)
                for (name, labels), inst in items]

    def render(self) -> str:
        """Prometheus text exposition of every instrument."""
        lines: List[str] = []
        typed: set = set()
        for name, labels, kind, inst in self.snapshot():
            if name not in typed:
                typed.add(name)
                if name in self._help:
                    lines.append(f"# HELP {name} {self._help[name]}")
                lines.append(f"# TYPE {name} {kind}")
            if kind in ("counter", "gauge"):
                lines.append(f"{name}{_fmt_labels(labels)} {_fmt(inst.value)}")
            else:  # summary
                for q in _QUANTILES:
                    ql = labels + (("quantile", _fmt(q)),)
                    lines.append(
                        f"{name}{_fmt_labels(ql)} "
                        f"{_fmt(inst.percentile(q * 100.0))}"
                    )
                lines.append(
                    f"{name}_count{_fmt_labels(labels)} {_fmt(inst.count)}")
                lines.append(
                    f"{name}_sum{_fmt_labels(labels)} {_fmt(inst.sum)}")
        return "\n".join(lines) + "\n" if lines else ""


# -- standard process gauges --------------------------------------------------

# process start proxy: the first import of this module (the true start
# isn't portably readable; every serving process imports it at boot)
_PROC_START = time.time()


def _build_version() -> str:
    """The version stamped into ``kubetpu_build_info``: the port package's
    constant, or a sentinel."""
    import sys

    mod = sys.modules.get("kubetpu_torch")
    return getattr(mod, "__version__", None) or "0+unknown"


def _rss_bytes() -> float:
    """Resident set size via stdlib ``resource``: ``ru_maxrss`` is
    kilobytes on Linux, bytes on macOS. Peak RSS, not instantaneous —
    enough to spot a leaking replica on a dashboard."""
    import sys

    try:
        import resource

        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return float(rss if sys.platform == "darwin" else rss * 1024)
    except Exception:  # noqa: BLE001 — non-unix: a scrape must never 500
        return float("nan")


def install_process_gauges(registry: Registry, component: str,
                           version: Optional[str] = None) -> None:
    """The standard identification trio every serving registry carries:
    ``kubetpu_build_info{version, component} 1`` (the Prometheus
    build-info idiom — the value is constant, the labels are the payload),
    process uptime seconds, and RSS bytes. Idempotent per registry."""
    registry.gauge("kubetpu_build_info",
                   version=version or _build_version(),
                   component=component).set(1)
    registry.gauge_fn("kubetpu_process_uptime_seconds",
                      lambda: time.time() - _PROC_START)
    registry.gauge_fn("kubetpu_process_rss_bytes", _rss_bytes)


# -- parsing / validation / federation ---------------------------------------


def parse_prometheus_text(text: str):
    """[(name, labels dict, value)] for every sample line; comments and
    blanks skipped. Raises ``ValueError`` on a malformed line — callers
    that must not fail (the federating controller) catch and skip."""
    out = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        m = _SERIES_RE.match(line)
        if m is None:
            raise ValueError(f"malformed series line {lineno}: {raw!r}")
        labels: Dict[str, str] = {}
        body = m.group("labels")
        if body:
            # lenient here (strict grammar checks live in validate): pull
            # every well-formed pair, unescape
            for lm in _LABEL_RE.finditer(body):
                labels[lm.group(1)] = _unescape_label_value(lm.group(2))
        try:
            value = float(m.group("value"))
        except ValueError as e:
            raise ValueError(
                f"bad sample value on line {lineno}: {raw!r}") from e
        out.append((m.group("name"), labels, value))
    return out




def validate_prometheus_text(text: str) -> List[str]:
    """Problems found in *text* as Prometheus exposition (empty = valid):
    malformed lines, unknown TYPE declarations, duplicate series, samples
    under a declared summary/histogram name missing their suffix
    grammar."""
    problems: List[str] = []
    seen: set = set()
    known_types = {"counter", "gauge", "summary", "histogram", "untyped"}
    declared: Dict[str, str] = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.rstrip("\n")
        if not line.strip():
            continue
        if line.startswith("# TYPE"):
            parts = line.split()
            if len(parts) != 4 or not _NAME_RE.match(parts[2]):
                problems.append(f"line {lineno}: malformed TYPE line {raw!r}")
            elif parts[3] not in known_types:
                problems.append(
                    f"line {lineno}: unknown metric type {parts[3]!r}")
            elif parts[2] in declared:
                problems.append(
                    f"line {lineno}: duplicate TYPE for {parts[2]!r}")
            else:
                declared[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _SERIES_RE.match(line.strip())
        if m is None:
            problems.append(f"line {lineno}: malformed series line {raw!r}")
            continue
        try:
            float(m.group("value"))
        except ValueError:
            problems.append(f"line {lineno}: bad value in {raw!r}")
        body = m.group("labels")
        labels: Tuple = ()
        if body is not None:
            pairs = _LABEL_RE.findall(body)
            rebuilt = ",".join('%s="%s"' % (k, v) for k, v in pairs)
            if rebuilt != body.rstrip(","):
                problems.append(
                    f"line {lineno}: malformed label set {{{body}}}")
            labels = tuple(pairs)
        key = (m.group("name"), labels)
        if key in seen:
            problems.append(
                f"line {lineno}: duplicate series {m.group('name')}"
                f"{_fmt_labels(labels)}")
        seen.add(key)
    return problems


def _series_lines(text: str, extra_label: Tuple[str, str]):
    """(name -> type) and relabeled sample lines of *text* with
    *extra_label* appended to every series that doesn't already carry that
    label key (agent capacity series already carry ``node=``)."""
    types: Dict[str, str] = {}
    for line in text.splitlines():
        if line.startswith("# TYPE"):
            parts = line.split()
            if len(parts) == 4:
                types[parts[2]] = parts[3]
    lines: List[str] = []
    for name, labels, value in parse_prometheus_text(text):
        if extra_label[0] not in labels:
            labels = dict(labels)
            labels[extra_label[0]] = extra_label[1]
        lt = tuple((k, v) for k, v in labels.items())
        lines.append(f"{name}{_fmt_labels(lt)} {_fmt(value)}")
    return types, lines


def federate(own: str, scraped: Dict[str, str], label: str = "node") -> str:
    """Merge this process's exposition *own* with *scraped* peer
    expositions ({peer name -> text}), relabeling every peer series with
    ``<label>="<name>"`` — the controller's fleet ``/metrics`` (label
    ``node``) and the exporter's multi-registry merge (``component``).
    Peer ``TYPE`` lines are deduplicated against the local ones; a peer
    text that fails to parse is skipped wholesale (federation must
    degrade, never 500)."""
    out_lines = own.rstrip("\n").splitlines() if own.strip() else []
    typed = {ln.split()[2] for ln in out_lines if ln.startswith("# TYPE")}
    for node in sorted(scraped):
        try:
            types, lines = _series_lines(scraped[node], (label, node))
        except ValueError:
            continue
        for name, kind in types.items():
            if name not in typed:
                typed.add(name)
                out_lines.append(f"# TYPE {name} {kind}")
        out_lines.extend(lines)
    return "\n".join(out_lines) + "\n" if out_lines else ""


# -- process-default registry ------------------------------------------------

_DEFAULT = Registry()


def default_registry() -> Registry:
    """The process-wide registry. The wire CLIENT metrics
    (``kubetpu_wire_requests_total`` / ``_retried_total``) land here.
    Servers create their OWN registries: in-process replicas must not
    share counters."""
    return _DEFAULT
