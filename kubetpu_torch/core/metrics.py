"""Latency metrics (port of ``kubetpu/core/metrics.py``).

``LatencyRecorder`` keeps one bounded reservoir (``obs.registry.Histogram``)
per operation: exact percentiles below the cap, unbiased estimates above it
(uniform reservoir sampling), exact counts throughout. Given a registry,
each operation's histogram registers there as ``<metric>{op="<op>"}``, the
summary series the serving registry renders.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from kubetpu_torch.obs.registry import Histogram, Registry

# per-op reservoir size: exact percentiles for the first 4096 samples of
# each op, unbiased estimates beyond
DEFAULT_CAP = 4096


class LatencyRecorder:
    """Collects per-operation latencies (seconds) and reports percentiles.

    Memory is bounded: each op holds one fixed-size reservoir (``cap``
    samples), never a growing list."""

    def __init__(self, cap: int = DEFAULT_CAP,
                 registry: Optional[Registry] = None,
                 metric: str = "kubetpu_latency_seconds") -> None:
        self._lock = threading.Lock()
        self._cap = cap
        self._hists: Dict[str, Histogram] = {}
        self._registry = registry
        self._metric = metric

    def _hist(self, op: str) -> Histogram:
        with self._lock:
            hist = self._hists.get(op)
            if hist is None:
                if self._registry is not None:
                    hist = self._registry.histogram(
                        self._metric, cap=self._cap, op=op)
                else:
                    hist = Histogram(cap=self._cap)
                self._hists[op] = hist
            return hist

    def record(self, op: str, seconds: float) -> None:
        self._hist(op).observe(seconds)

    def count(self, op: str) -> int:
        with self._lock:
            hist = self._hists.get(op)
        return hist.count if hist is not None else 0

    def percentile(self, op: str, p: float) -> float:
        """p in [0, 100]; returns seconds (0.0 if no samples)."""
        with self._lock:
            hist = self._hists.get(op)
        return hist.percentile(p) if hist is not None else 0.0

    def recent_percentile(self, op: str, p: float,
                          window: int = 128) -> float:
        """Percentile over the LAST *window* observations (seconds; 0.0
        with no samples): the read a live control signal needs, since the
        lifetime reservoir never forgets a burst. Exact while the
        reservoir is below cap (the buffer is an append-only log there);
        past cap it degrades to the full-reservoir estimate."""
        with self._lock:
            hist = self._hists.get(op)
        if hist is None:
            return 0.0
        count, buf = hist.tail()
        if not buf:
            return 0.0
        recent = sorted(buf[-window:] if count <= len(buf) else buf)
        idx = min(len(recent) - 1,
                  max(0, int(round(p / 100.0 * (len(recent) - 1)))))
        return recent[idx]

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            ops = list(self._hists)
        return {
            op: {
                "count": self.count(op),
                "p50_ms": self.percentile(op, 50) * 1e3,
                "p90_ms": self.percentile(op, 90) * 1e3,
                "p99_ms": self.percentile(op, 99) * 1e3,
            }
            for op in ops
        }
