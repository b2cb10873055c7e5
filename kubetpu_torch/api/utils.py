"""Leveled logging + small map utilities of the KubeDevice-API contract
(a copy of ``kubetpu/api/utils.py``; the port's replica logs through it).

Reference usage: ``utils.Logf(level, fmt, ...)``, ``utils.Errorf``,
``utils.Logb(level) bool``, ``utils.SortedStringKeys(map) []string``
(``gpuschedulerplugin/gpu.go:62,125,133``, ``gpuplugintypes/typeutils.go:66-72``).
Observed levels 0-5: errors at 0, flow at 3-4, dumps at 5 (SURVEY.md §5.5).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Iterable, List, Mapping

_LOCK = threading.Lock()
_LEVEL = int(os.environ.get("KUBETPU_LOG_LEVEL", "1"))
_STREAM = sys.stderr


def set_log_level(level: int) -> None:
    global _LEVEL
    _LEVEL = level


def get_log_level() -> int:
    return _LEVEL


def logb(level: int) -> bool:
    """True if messages at *level* would be emitted (reference: utils.Logb)."""
    return level <= _LEVEL


def logf(level: int, fmt: str, *args: object) -> None:
    """Leveled printf-style log (reference: utils.Logf)."""
    if not logb(level):
        return
    msg = (fmt % args) if args else fmt
    with _LOCK:
        _STREAM.write("kubetpu[%d] %.3f %s\n" % (level, time.time(), msg))


def errorf(fmt: str, *args: object) -> None:
    """Error log, always emitted (reference: utils.Errorf; errors at level 0)."""
    msg = (fmt % args) if args else fmt
    with _LOCK:
        _STREAM.write("kubetpu[E] %.3f %s\n" % (time.time(), msg))


def sorted_string_keys(m: Mapping[str, object] | Iterable[str]) -> List[str]:
    """Sorted list of string keys (reference: utils.SortedStringKeys).

    Deterministic iteration order over resource maps is load-bearing: the
    auto-topology index synthesis and tree construction depend on it
    (reference ``gpu.go:133,149``).
    """
    if isinstance(m, Mapping):
        return sorted(str(k) for k in m.keys())
    return sorted(str(k) for k in m)
