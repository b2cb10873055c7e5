"""Prefix-affinity hashing — the routing key and the consistent ring (port
of ``kubetpu/router/hashring.py``: the same digests, so both packages
place every key alike).

The router's whole reason to exist (the millions-of-users
story) is that prefix-cache hit rate should be a CLUSTER property, not
per-replica luck: two requests sharing a system prompt / few-shot
preamble must land on the replica whose radix tree already
holds that prefix's KV pages. Two pieces make that stable:

- ``prefix_head_key``: the routing key is a digest of the TOKENIZED
  prefix head — the first ``head_tokens`` token ids — not the raw text
  and not the whole prompt. The head is what the radix tree can share
  (same system prompt => same head => same key), while unique tails
  would scatter siblings across the fleet if hashed;
- ``HashRing``: classic consistent hashing with virtual nodes. Each
  replica owns ``vnodes`` points on a 2^64 ring; a key routes to the
  first point clockwise. Adding or removing one replica remaps only the
  arcs that replica owns — ~1/N of the key space — so a scale event
  never cold-starts the whole fleet's prefix caches (pinned by test).
  ``preference(key)`` returns the FULL distinct-replica order from the
  key's position, so load-based fallback walks the same deterministic
  list everywhere.

Digests are ``hashlib`` (process-independent, seed-independent) — a
router restart, or two routers in front of the same fleet, must agree
on every key. Stdlib only.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Dict, List, Optional, Sequence

DEFAULT_HEAD_TOKENS = 32
DEFAULT_HEAD_QUANTUM = 16


def prefix_head_key(tokens: Sequence[int],
                    head_tokens: int = DEFAULT_HEAD_TOKENS,
                    quantum: int = DEFAULT_HEAD_QUANTUM) -> str:
    """Stable routing key for a tokenized prompt: hex digest of the
    cacheable HEAD. Long prompts key on their first *head_tokens* ids —
    prompts sharing a head share a key whatever their tails. A prompt
    that fits ENTIRELY inside the head keys on its page-aligned prefix
    (*quantum* = the paged pool's page size, capped one token short —
    the radix tree's publishable-prefix rule): hashing the unique tail
    token would scatter same-family siblings across the fleet, which is
    exactly the luck this router exists to remove. Prompts with no
    cacheable prefix at all (shorter than a page) key on themselves —
    nothing is shareable, so any stable spread is correct."""
    if head_tokens <= 0:
        raise ValueError("head_tokens must be positive")
    if quantum <= 0:
        raise ValueError("quantum must be positive")
    n = min(len(tokens), head_tokens)
    if n >= len(tokens):
        n = ((len(tokens) - 1) // quantum) * quantum
        if n <= 0:
            n = len(tokens)
    head = ",".join(str(int(t)) for t in tokens[:n])
    return hashlib.sha1(
        b"kubetpu-prefix-head:" + head.encode()).hexdigest()


def _point(label: str) -> int:
    """One ring position in [0, 2^64) from a label digest."""
    return int.from_bytes(
        hashlib.sha1(label.encode()).digest()[:8], "big")


class HashRing:
    """Consistent hash ring over replica names with virtual nodes.

    Not thread-safe by itself — the router mutates it under its own
    lock (membership changes ride registration/removal, never the
    per-request path)."""

    def __init__(self, vnodes: int = 64) -> None:
        if vnodes <= 0:
            raise ValueError("vnodes must be positive")
        self.vnodes = vnodes
        self._points: List[int] = []          # sorted ring positions
        self._owner: Dict[int, str] = {}      # position -> replica name
        self._members: Dict[str, List[int]] = {}

    def __len__(self) -> int:
        return len(self._members)

    def members(self) -> List[str]:
        return sorted(self._members)

    def add(self, name: str) -> None:
        """Idempotent: re-adding an existing member is a no-op (the
        points are a pure function of the name, so re-inserting them
        would change nothing anyway)."""
        if name in self._members:
            return
        pts = []
        for i in range(self.vnodes):
            p = _point(f"kubetpu-ring:{name}#{i}")
            # vanishingly unlikely 64-bit collision: skip the point
            # rather than silently overwrite another member's arc
            if p in self._owner:
                continue
            self._owner[p] = name
            bisect.insort(self._points, p)
            pts.append(p)
        self._members[name] = pts

    def remove(self, name: str) -> None:
        for p in self._members.pop(name, ()):
            del self._owner[p]
            i = bisect.bisect_left(self._points, p)
            if i < len(self._points) and self._points[i] == p:
                self._points.pop(i)

    def lookup(self, key: str) -> Optional[str]:
        """The key's primary owner (None on an empty ring)."""
        pref = self.preference(key, n=1)
        return pref[0] if pref else None

    def preference(self, key: str, n: Optional[int] = None) -> List[str]:
        """Distinct replica names in ring order starting at *key*'s
        position — index 0 is the affinity target, the rest the
        deterministic fallback order (at most *n* names)."""
        if not self._points:
            return []
        want = len(self._members) if n is None else min(n, len(self._members))
        start = bisect.bisect_right(self._points, _point(f"key:{key}"))
        out: List[str] = []
        seen = set()
        for i in range(len(self._points)):
            owner = self._owner[self._points[(start + i) % len(self._points)]]
            if owner not in seen:
                seen.add(owner)
                out.append(owner)
                if len(out) >= want:
                    break
        return out
