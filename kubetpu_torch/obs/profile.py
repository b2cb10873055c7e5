"""Sampled continuous profiler for the slot servers (port of
``kubetpu/obs/profile.py``): where do a step's milliseconds go, and which
legs ran a shape for the first time?

- **phase breakdown, sampled**: every Nth ``step()`` (``sample_every``)
  is broken into contiguous wall-time phases — ``schedule`` (admission +
  prefill chunk scheduling, host side), ``dispatch`` (queueing the step's
  kernels and its host copy on the card's stream), ``device`` (a wait on
  that step's own copy event, which the SERVER issues only on sampled
  steps — the profiler itself never touches the device), ``materialize``
  (token read + routing) — so an operator reads "step p50 is 9 ms: 1
  host, 6 device, 2 fetch" instead of one opaque number. Un-sampled steps
  and the DISABLED profiler (the default) add zero syncs, zero uploads
  and zero timing calls: the overlap double-buffer is never defeated by
  observability;
- **first-call tracking**: ``watch(leg, fn)`` wraps a device leg and
  counts a call as a "recompile" when it can tell one happened: through
  the function's own cache size where it exposes one (``_cache_size``),
  else by first-seen call signature (shape/dtype tuple). The port's legs
  are eager PyTorch with no cache probe, so the signature path runs: a
  new prompt bucket or a new gamma is the first call that builds a
  kernel library, picks library algorithms and grows the caching
  allocator, and that first call's wall lands in the leg's compile
  seconds. The series keep the reference's names:
  ``kubetpu_jit_recompiles_total{leg=...}`` and
  ``kubetpu_jit_compile_seconds_total{leg=...}``.

Registry series (on the server's own registry):

    kubetpu_profile_sampled_steps_total
    kubetpu_profile_step_seconds_total          wall of sampled steps
    kubetpu_profile_phase_seconds_total{phase=...}
    kubetpu_jit_recompiles_total{leg=...}
    kubetpu_jit_compile_seconds_total{leg=...}

``summary()`` returns the same numbers structured for bench rows,
including ``coverage`` — the fraction of sampled-step wall time the
named phases account for (the acceptance bar is >= 0.9: a breakdown
that loses a tenth of the step is hiding the problem it exists to
find).

Stdlib only; imports nothing from the port outside ``obs`` — the serving
layer owns every device call (including the sampled-step wait).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from kubetpu_torch.obs.registry import Registry


class StepRecord:
    """One sampled step: contiguous phase marks from ``begin_step``.
    ``mark(name)`` closes the current segment — phases tile the step, so
    their sum is the step wall minus only the inter-mark glue."""

    __slots__ = ("t0", "_last", "phases")

    def __init__(self) -> None:
        self.t0 = time.perf_counter()
        self._last = self.t0
        self.phases: Dict[str, float] = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.phases[name] = self.phases.get(name, 0.0) + (now - self._last)
        self._last = now


class ServingProfiler:
    """Sampled phase breakdown + compile tracking for one slot server."""

    def __init__(self, sample_every: int = 16,
                 registry: Optional[Registry] = None) -> None:
        if sample_every < 1:
            raise ValueError("sample_every must be >= 1")
        self.sample_every = int(sample_every)
        self.registry = registry if registry is not None else Registry()
        self._lock = threading.Lock()
        self._step_i = 0
        self._sampled = 0
        self._wall = 0.0
        self._phases: Dict[str, float] = {}
        # compile watch state: leg -> {"sigs": set, "count": int, "s": float}
        self._legs: Dict[str, dict] = {}
        self._watched: Dict[str, Callable] = {}

    # -- sampling -------------------------------------------------------------

    def begin_step(self) -> Optional[StepRecord]:
        """Every ``sample_every``-th call returns a live ``StepRecord``
        (this step is SAMPLED — the server may afford one device sync);
        otherwise None, and the step must do no extra work at all."""
        with self._lock:
            i = self._step_i
            self._step_i += 1
        if i % self.sample_every:
            return None
        return StepRecord()

    def end_step(self, rec: StepRecord) -> None:
        wall = time.perf_counter() - rec.t0
        with self._lock:
            self._sampled += 1
            self._wall += wall
            for name, dt in rec.phases.items():
                self._phases[name] = self._phases.get(name, 0.0) + dt
        reg = self.registry
        reg.counter("kubetpu_profile_sampled_steps_total").inc()
        reg.counter("kubetpu_profile_step_seconds_total").inc(wall)
        for name, dt in rec.phases.items():
            reg.counter("kubetpu_profile_phase_seconds_total",
                        phase=name).inc(dt)

    # -- first-call (compile) tracking ----------------------------------------

    @staticmethod
    def _cache_size(fn) -> Optional[int]:
        probe = getattr(fn, "_cache_size", None)
        if probe is None:
            return None
        try:
            return int(probe())
        except Exception:  # noqa: BLE001 — version drift must not crash serving
            return None

    @staticmethod
    def _signature(args, kwargs) -> tuple:
        def one(a):
            shape = getattr(a, "shape", None)
            if shape is not None:
                return ("arr", tuple(shape), str(getattr(a, "dtype", "")))
            if a is None or isinstance(a, (bool, int, float, str)):
                return ("lit", type(a).__name__)
            return ("obj", type(a).__name__)

        return (tuple(one(a) for a in args),
                tuple(sorted((k, one(v)) for k, v in kwargs.items())))

    def _note_compile(self, leg: str, seconds: float) -> None:
        with self._lock:
            st = self._legs.setdefault(leg, {"sigs": set(), "count": 0,
                                             "s": 0.0})
            st["count"] += 1
            st["s"] += seconds
        self.registry.counter("kubetpu_jit_recompiles_total", leg=leg).inc()
        self.registry.counter("kubetpu_jit_compile_seconds_total",
                              leg=leg).inc(seconds)

    def watch(self, leg: str, fn: Callable) -> Callable:
        """Wrap a compiled leg: a call that triggers a compile (cache
        growth, or an unseen call signature on a function without a
        cache probe) increments the leg's recompile counter and adds the
        call's wall time to its compile seconds. Idempotent per *leg* —
        re-watching returns the SAME wrapper so call sites may wrap
        unconditionally (the paged speculative round leg is re-fetched
        every step). Re-watching the same leg name with a DIFFERENT
        function builds a fresh wrapper over the new function (sharing
        the leg's counters) — returning the cached one would silently
        substitute the old callable at the new call site."""
        cached = self._watched.get(leg)
        if cached is not None and cached.__wrapped__ is fn:
            return cached
        profiler = self
        state = self._legs.setdefault(leg, {"sigs": set(), "count": 0,
                                            "s": 0.0})

        def wrapped(*args, **kwargs):
            before = profiler._cache_size(fn)
            if before is None:
                sig = profiler._signature(args, kwargs)
                fresh = sig not in state["sigs"]
                if fresh:
                    state["sigs"].add(sig)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if before is not None:
                after = profiler._cache_size(fn)
                fresh = after is not None and after > before
            if fresh:
                profiler._note_compile(leg, time.perf_counter() - t0)
            return out

        wrapped.__wrapped__ = fn  # type: ignore[attr-defined]
        self._watched[leg] = wrapped
        return wrapped

    # -- reporting ------------------------------------------------------------

    def summary(self) -> dict:
        """Structured snapshot for bench rows / operators: sampled-step
        count, total wall, per-phase seconds + fraction-of-wall,
        ``coverage`` (sum of phase fractions), and per-leg recompile
        count + compile seconds."""
        with self._lock:
            phases = dict(self._phases)
            wall = self._wall
            sampled = self._sampled
            steps = self._step_i
            legs = {leg: {"recompiles": st["count"],
                          "compile_seconds": round(st["s"], 4)}
                    for leg, st in self._legs.items() if st["count"]}
        phase_out = {
            name: {"seconds": round(dt, 4),
                   "frac": round(dt / wall, 4) if wall else 0.0}
            for name, dt in sorted(phases.items())
        }
        covered = sum(phases.values())
        return {
            "sample_every": self.sample_every,
            "steps": steps,
            "sampled_steps": sampled,
            "sampled_wall_s": round(wall, 4),
            "phases": phase_out,
            "coverage": round(covered / wall, 4) if wall else 0.0,
            "recompiles": legs,
        }
