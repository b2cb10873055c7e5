"""Shared-prefix KV reuse: a host-side radix tree over token-ID prefixes
whose nodes own page-granular spans of the paged server's page pool (port
of ``kubetpu/jobs/prefix_cache.py``, host Python line for line).

KV at position ``p`` depends only on ``tokens[0..p]`` and the params
(causal attention, RoPE by absolute position), so two requests with the
same token prefix compute bit-identical KV for it: one can map the other's
pages.

- the tree's unit of sharing is the PAGE: a node owns ``k`` physical pool
  pages covering ``k * page_size`` token positions. Children are keyed by
  their edge's first page of tokens, so sibling edges never collide and
  splits only happen at page boundaries;
- ``match(tokens)`` returns the longest full-page cached prefix and the
  deepest node, which the caller pins for the lifetime of the slot that
  maps the pages. Eviction only removes unpinned frontier nodes (LRU by a
  logical clock), so mapped pages are never reclaimed under a live reader;
- ``insert(tokens, pages)`` publishes a retiring slot's prompt KV by
  DONATING the slot's physical pages (ownership transfer, no device copy);
  pages the tree already covers are not consumed and go back to the pool;
- copy-on-write is structural: a slot maps shared pages read-only as the
  leading prefix of its page table and starts prefill past them, so every
  write it issues lands on private pages.

The host DRAM tier: an evicted node may keep its span as host buffers (a
dict of CPU ``torch`` tensors in the pool's stored dtype and layout, page
axis 1 — numpy has no bfloat16) under a byte budget, and a later match
fills it back into the pool.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence, Set, Tuple


class PrefixNode:
    """One radix-tree node: a page-granular span of cached tokens.

    ``tokens`` has length ``len(pages) * page_size``; ``pages`` are
    physical pool page indices the node OWNS (the pool's accounting
    oracle counts them as tree-owned). ``refcount`` counts live slots
    pinning this node as their deepest match; ``stamp`` is the LRU
    logical clock.

    Host tier: a node holds its span in exactly ONE tier — either
    ``pages`` (HBM, host is None) or ``host`` (a stored-layout dict of
    CPU tensors with the page axis at position 1, pages empty).
    Host-tier nodes always form the BOTTOM FRONTIER of the tree (no
    host node ever has an HBM descendant), so a match that reaches the
    host tier never strands mapped HBM pages below unmapped spans."""

    __slots__ = ("tokens", "pages", "children", "parent", "refcount",
                 "stamp", "host", "host_bytes")

    def __init__(self, tokens: Tuple[int, ...], pages: List[int],
                 parent: Optional["PrefixNode"]) -> None:
        self.tokens = tokens
        self.pages = list(pages)
        self.children: Dict[Tuple[int, ...], "PrefixNode"] = {}
        self.parent = parent
        self.refcount = 0
        self.stamp = 0
        self.host: Optional[Dict[str, "object"]] = None
        self.host_bytes = 0


class RadixPrefixCache:
    """Radix tree of page-granular token prefixes over a shared page pool.

    The tree never touches device memory — it trades in physical page
    INDICES. Allocation/free of the underlying pages stays with the
    paged server's free-list; the tree only records ownership while a
    prefix is cached, and hands pages back via ``evict``/``clear``.

    ``max_pages`` bounds the tree's total owned pages (the
    ``prefix_cache_pages`` budget); ``insert`` refuses (truncates) past
    it — the caller evicts first if it wants room.
    """

    def __init__(self, page_size: int, max_pages: int,
                 host_budget_bytes: int = 0) -> None:
        if page_size <= 0:
            raise ValueError("page_size must be positive")
        if max_pages <= 0:
            raise ValueError("max_pages must be positive (0 pages = "
                             "construct no cache at all)")
        if host_budget_bytes < 0:
            raise ValueError("host_budget_bytes must be >= 0")
        self.page_size = page_size
        self.max_pages = max_pages
        # byte budget for the eviction-to-host tier (0 = off).
        # ``total_pages`` counts HBM pages only; host occupancy is
        # tracked in bytes because stored-layout page size depends on
        # the model config and kv_int8 (int8 + scales pairs).
        self.host_budget_bytes = host_budget_bytes
        self.host_bytes = 0
        self.spilled_pages = 0
        self.root = PrefixNode((), [], None)
        self.total_pages = 0
        self._clock = 0

    # -- internal helpers ----------------------------------------------------

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _key(self, tokens: Sequence[int], i: int) -> Tuple[int, ...]:
        return tuple(tokens[i:i + self.page_size])

    @staticmethod
    def _common(a: Sequence[int], b: Sequence[int]) -> int:
        n = min(len(a), len(b))
        i = 0
        while i < n and a[i] == b[i]:
            i += 1
        return i

    def _walk(self, tokens: Sequence[int], stamp: bool,
              through_host: bool = False):
        """The one greedy radix walk every operation shares — match,
        missing_pages and insert must agree on exactly which full pages
        of *tokens* the tree covers, or the budget math (plan with
        ``missing_pages``, consume with ``insert``) desynchronizes.

        Returns ``(node, i, pages, deepest, div_child, div_jp, segs)``:
        the last FULLY-traversed node, the covered token count ``i``
        (page-aligned), the physical pages covering ``tokens[:i]`` in
        order, the deepest node touched (``None`` on a zero match),
        when the walk stopped mid-child that child plus how many of its
        pages matched (``None, 0`` otherwise), and ``segs`` — the
        ``(node, pages_covered)`` trail in path order. ``stamp``
        refreshes the LRU clock on every node touched (a hit is a use).

        ``through_host=False`` (the HBM-only view) stops BEFORE
        descending into a host-tier child; ``through_host=True`` walks across the tier boundary — host
        segs contribute to ``i`` but not to ``pages`` (they own no
        physical pages until filled)."""
        ps = self.page_size
        node = self.root
        i = 0
        pages: List[int] = []
        deepest: Optional[PrefixNode] = None
        segs: List[Tuple[PrefixNode, int]] = []
        while len(tokens) - i >= ps:
            child = node.children.get(self._key(tokens, i))
            if child is None:
                break
            if child.host is not None and not through_host:
                break
            j = self._common(child.tokens, tokens[i:])
            jp = j // ps
            if jp == 0:  # defensive: keyed lookup guarantees jp >= 1
                break
            if stamp:
                child.stamp = self._tick()
            pages.extend(child.pages[:jp])
            segs.append((child, jp))
            i += jp * ps
            deepest = child
            if j < len(child.tokens):
                return node, i, pages, deepest, child, jp, segs
            node = child
        return node, i, pages, deepest, None, 0, segs

    # -- queries -------------------------------------------------------------

    def match(self, tokens: Sequence[int]):
        """Longest cached full-page prefix of *tokens*.

        Returns ``(matched_tokens, pages, node)`` where ``pages`` are the
        physical pages covering ``tokens[:matched_tokens]`` in order and
        ``node`` is the deepest node touched (``None`` on a zero match).
        Does NOT pin — callers that map the pages must ``pin(node)``
        before anything else can run. Every node on the path gets a fresh
        LRU stamp (a hit is a use, even of the ancestors). Coverage
        stops at the HBM/host tier boundary — only mappable pages count
        (use ``match_tiered`` for the cross-tier view)."""
        _, i, pages, deepest, _, _, _ = self._walk(tokens, stamp=True)
        return i, pages, deepest

    def match_tiered(self, tokens: Sequence[int]):
        """Longest cached full-page prefix of *tokens* across BOTH
        tiers. Returns ``(matched_tokens, segs)`` with ``segs`` the
        ``(node, pages_covered)`` trail in path order; a seg whose node
        has ``host is not None`` is a host-tier span the caller must
        FILL (allocate pool pages, upload, ``promote``) before it can
        be mapped. Host nodes form the bottom frontier, so the trail is
        always an HBM run followed by a host run."""
        _, i, _, _, _, _, segs = self._walk(tokens, stamp=True,
                                            through_host=True)
        return i, segs

    def missing_pages(self, tokens: Sequence[int]) -> int:
        """How many NEW pages ``insert(tokens, ...)`` would need — the
        budget/eviction planner's question. Read-only (no stamps).
        Host-covered spans COUNT as missing: insert adopts donated
        pages into them, which consumes HBM budget just like a fresh
        attach."""
        _, i, _, _, _, _, _ = self._walk(tokens, stamp=False)
        return (len(tokens) - i) // self.page_size

    # -- pinning -------------------------------------------------------------

    def pin(self, node: PrefixNode) -> None:
        node.refcount += 1

    def release(self, node: PrefixNode) -> None:
        if node.refcount <= 0:
            raise AssertionError("release without a matching pin")
        node.refcount -= 1

    # -- publication ---------------------------------------------------------

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> Set[int]:
        """Publish ``tokens`` (full pages only: ``len(tokens)`` must be a
        multiple of ``page_size`` and equal ``len(pages) * page_size``)
        by donating the aligned physical *pages*.

        Returns the set of page indices the tree CONSUMED (took
        ownership of). Pages covering spans the tree already holds in
        HBM are not consumed — the caller frees them. Host-tier spans
        on the walk ADOPT the matching donated pages (the retiring slot
        recomputed bit-identical KV — causal attention over the same
        tokens and params) and drop their host buffers, so a
        re-published prefix re-enters the fast tier with no upload.
        Consumption is clamped to the remaining ``max_pages`` budget;
        the donated suffix is truncated to a contiguous prefix of it,
        never fragmented — and adoption stops at the first host node
        that no longer fits, so an HBM attach never lands below an
        unfilled host span (the frontier invariant)."""
        ps = self.page_size
        if len(tokens) != len(pages) * ps:
            raise ValueError("tokens must cover exactly len(pages) pages")
        node, i, _, _, div_child, div_jp, segs = self._walk(
            tokens, stamp=True, through_host=True)
        if div_child is not None and len(tokens) - i >= ps:
            # diverged mid-child with a full page still to attach: split
            # at the page boundary so the shared span becomes its own
            # node and the new branch can attach beside the old suffix
            node = self._split(div_child, div_jp)
            segs[-1] = (node, div_jp)
        consumed: Set[int] = set()
        off = 0
        for child, jp in segs:
            span_pages = len(child.tokens) // ps
            if child.host is not None:
                if (jp < span_pages
                        or self.total_pages + span_pages > self.max_pages):
                    # trailing partial host coverage (no donated pages
                    # for the tail) or out of budget: leave the rest of
                    # the path in the host tier and attach nothing
                    # below it
                    return consumed
                child.pages = list(pages[off:off + span_pages])
                self.host_bytes -= child.host_bytes
                child.host = None
                child.host_bytes = 0
                self.total_pages += span_pages
                consumed.update(child.pages)
            off += jp
        remaining = (len(tokens) - i) // ps
        budget_room = self.max_pages - self.total_pages
        remaining = min(remaining, max(0, budget_room))
        if remaining <= 0:
            return consumed
        new_tokens = tuple(tokens[i:i + remaining * ps])
        new_pages = list(pages[i // ps: i // ps + remaining])
        leaf = PrefixNode(new_tokens, new_pages, node)
        leaf.stamp = self._tick()
        node.children[self._key(new_tokens, 0)] = leaf
        self.total_pages += remaining
        consumed.update(new_pages)
        return consumed

    def _split(self, child: PrefixNode, jp: int) -> PrefixNode:
        """Split *child* at page *jp* into (prefix mid, suffix child);
        returns the new mid node. Pure bookkeeping — no page moves, and
        the child keeps its identity so existing pins stay valid (a pin
        on the suffix protects the mid transitively: mid has a child)."""
        ps = self.page_size
        assert 0 < jp * ps < len(child.tokens)
        parent = child.parent
        mid = PrefixNode(child.tokens[:jp * ps], child.pages[:jp], parent)
        mid.stamp = child.stamp
        if child.host is not None:
            # host-tier split: slice the stored-layout buffers along the
            # page axis (axis 1), copying so neither half keeps the full
            # base buffer alive — byte accounting must track real memory
            old = child.host_bytes
            mid.host = {k: v[:, :jp].clone()
                        for k, v in child.host.items()}
            child.host = {k: v[:, jp:].clone()
                          for k, v in child.host.items()}
            mid.host_bytes = sum(a.nbytes for a in mid.host.values())
            child.host_bytes = sum(a.nbytes for a in child.host.values())
            self.host_bytes += mid.host_bytes + child.host_bytes - old
        suffix_tokens = child.tokens[jp * ps:]
        child.tokens = suffix_tokens
        child.pages = child.pages[jp:]
        child.parent = mid
        mid.children[self._key(suffix_tokens, 0)] = child
        parent.children[self._key(mid.tokens, 0)] = mid
        return mid

    # -- eviction ------------------------------------------------------------

    def evict(self, n_pages: int, gather=None) -> List[int]:
        """Reclaim >= *n_pages* HBM pages from LRU refcount-0 frontier
        nodes (oldest stamp first; evicting one can expose its parent as
        the next candidate). Returns the freed physical pages — the
        caller appends them to the pool free-list. May return fewer than
        asked when everything left is pinned or an ancestor of a pin.

        Spill: with *gather* set (``pages -> stored-layout
        dict``, the paged server's device->host barrier leg), a victim's
        KV is gathered into host buffers under ``host_budget_bytes``
        before its pages are freed — the node STAYS in the tree as a
        host-tier entry a later match can fill back. Without gather (or
        when the payload doesn't fit even after host-LRU eviction), the
        victim and its host-only subtree are dropped as before.

        One DFS to seed the candidate heap, then O(log n) per victim —
        this runs on the admission path under pool pressure, where a
        per-victim full-tree rescan would stack host latency onto an
        already-stalling TTFT. Only a victim's parent can become newly
        evictable (nothing else changes), so it alone is re-examined.
        A frontier victim is an HBM node with no HBM or pinned
        descendants — host children below it are fine (they spill with
        it, structurally) — which degenerates to the pre-tier "leaf"
        rule when the host tier is off."""
        hbm_below: Dict[int, int] = {}
        pins_below: Dict[int, int] = {}
        order: List[PrefixNode] = []
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            order.append(n)
            stack.extend(n.children.values())
        for n in reversed(order):   # children precede parents here
            hbm_below[id(n)] = sum(
                hbm_below[id(c)] + (1 if c.pages else 0)
                for c in n.children.values())
            pins_below[id(n)] = sum(
                pins_below[id(c)] + c.refcount
                for c in n.children.values())

        def eligible(n: PrefixNode) -> bool:
            return (bool(n.pages) and n.refcount == 0
                    and hbm_below[id(n)] == 0 and pins_below[id(n)] == 0)

        heap: List[Tuple[int, int, PrefixNode]] = []
        seq = 0                      # tie-break: never compare nodes
        for n in order:
            if eligible(n):
                heap.append((n.stamp, seq, n))
                seq += 1
        heapq.heapify(heap)
        freed: List[int] = []
        while len(freed) < n_pages and heap:
            _, _, victim = heapq.heappop(heap)
            if not victim.pages:
                continue            # stale entry: already processed
            parent = victim.parent
            spilled = False
            if gather is not None and self.host_budget_bytes > 0:
                payload = gather(victim.pages)
                nbytes = sum(a.nbytes for a in payload.values())
                if self._host_reserve(nbytes):
                    victim.host = payload
                    victim.host_bytes = nbytes
                    self.host_bytes += nbytes
                    self.spilled_pages += len(victim.pages)
                    spilled = True
            freed.extend(victim.pages)
            self.total_pages -= len(victim.pages)
            victim.pages = []
            if not spilled:
                self._drop_subtree(victim)
            up = parent
            while up is not None and up is not self.root:
                hbm_below[id(up)] -= 1
                up = up.parent
            if (parent is not None and parent is not self.root
                    and eligible(parent)):
                heapq.heappush(heap, (parent.stamp, seq, parent))
                seq += 1
        return freed

    def promote(self, node: PrefixNode, pages: Sequence[int]) -> None:
        """Host -> HBM fill commit: the paged server uploaded *node*'s
        host buffers into freshly-allocated pool *pages*; take ownership
        and drop the host copy. Callers promote TOP-DOWN along the match
        path so an HBM node never appears below a still-host ancestor,
        and must have made ``max_pages`` room first."""
        ps = self.page_size
        assert node.host is not None and not node.pages, \
            "promote() target is not a host-tier node"
        assert len(pages) * ps == len(node.tokens), \
            "promote() page count does not cover the node span"
        assert self.total_pages + len(pages) <= self.max_pages, \
            "promote() past the HBM page budget"
        node.pages = list(pages)
        self.host_bytes -= node.host_bytes
        node.host = None
        node.host_bytes = 0
        self.total_pages += len(pages)
        node.stamp = self._tick()

    def _host_reserve(self, nbytes: int) -> bool:
        """Make room for *nbytes* under ``host_budget_bytes`` by
        dropping LRU unpinned host-tier LEAVES (a dropped leaf can
        expose its host parent as the next candidate). Returns False —
        reserving nothing — when the payload can't fit even with the
        whole evictable host tier gone."""
        if self.host_budget_bytes <= 0 or nbytes > self.host_budget_bytes:
            return False
        while self.host_bytes + nbytes > self.host_budget_bytes:
            victim: Optional[PrefixNode] = None
            for n in self.nodes():
                if n.host is None or n.children or n.refcount != 0:
                    continue
                if victim is None or n.stamp < victim.stamp:
                    victim = n
            if victim is None:
                return False
            self.host_bytes -= victim.host_bytes
            victim.host = None
            victim.host_bytes = 0
            victim.parent.children.pop(self._key(victim.tokens, 0), None)
            victim.parent = None
        return True

    def _drop_subtree(self, node: PrefixNode) -> None:
        """Detach *node* and release the host buffers of its (host-only,
        unpinned — the eviction frontier guarantees both) subtree."""
        parent = node.parent
        if parent is not None:
            parent.children.pop(self._key(node.tokens, 0), None)
        node.parent = None
        stack = [node]
        while stack:
            n = stack.pop()
            if n.host is not None:
                self.host_bytes -= n.host_bytes
                n.host = None
                n.host_bytes = 0
            stack.extend(n.children.values())

    def clear(self) -> List[int]:
        """Drop the whole tree, returning every owned HBM page. Host
        buffers go with it (a host entry surviving
        a flush would later fill pages into a tree path that no longer
        exists). Only valid when nothing is pinned (asserted) — the
        paged server calls this from ``warmup``, whose contract already
        requires an idle server."""
        pages: List[int] = []
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            assert n.refcount == 0, "clear() under a live pin"
            pages.extend(n.pages)
            n.host = None
            n.host_bytes = 0
            stack.extend(n.children.values())
        self.root.children.clear()
        self.total_pages = 0
        self.host_bytes = 0
        return pages

    # -- introspection / the accounting oracle -------------------------------

    def nodes(self) -> List[PrefixNode]:
        out: List[PrefixNode] = []
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            out.append(n)
            stack.extend(n.children.values())
        return out

    def n_nodes(self) -> int:
        return len(self.nodes())

    def owned_pages(self) -> Set[int]:
        pages: List[int] = []
        for n in self.nodes():
            pages.extend(n.pages)
        owned = set(pages)
        assert len(owned) == len(pages), "tree owns a page twice"
        return owned

    def host_nodes(self) -> List[PrefixNode]:
        return [n for n in self.nodes() if n.host is not None]

    def check(self) -> None:
        """Structural invariants: span lengths page-exact, child keys
        consistent, page ownership disjoint, total_pages exact, no
        negative refcounts — plus the tier half: every node
        holds its span in exactly one tier, host spans are page-exact
        in stored layout, host bytes sum to the tracked total under
        budget, and no host node has an HBM descendant (the frontier).
        AssertionError on violation — the pool oracle's tree half."""
        ps = self.page_size
        total = 0
        hbytes = 0
        seen: Set[int] = set()
        stack = [(self.root, True, False)]
        while stack:
            n, is_root, under_host = stack.pop()
            if not is_root:
                assert len(n.tokens) >= ps, "empty non-root node"
                assert n.refcount >= 0, "negative refcount"
                if n.host is not None:
                    assert not n.pages, (
                        "node owns HBM pages AND host buffers for the "
                        "same span")
                    assert len(n.tokens) % ps == 0, "ragged host span"
                    npg = len(n.tokens) // ps
                    for name, arr in n.host.items():
                        assert arr.shape[1] == npg, (
                            f"host buffer {name} covers {arr.shape[1]} "
                            f"pages, span needs {npg}")
                    assert n.host_bytes == sum(
                        a.nbytes for a in n.host.values()), \
                        "stale per-node host_bytes"
                    hbytes += n.host_bytes
                else:
                    assert n.host_bytes == 0, "host_bytes without host"
                    assert len(n.tokens) == len(n.pages) * ps, (
                        f"node span {len(n.tokens)} tokens != "
                        f"{len(n.pages)} pages * {ps}")
                    assert not under_host, (
                        "HBM node below a host-tier ancestor")
                for p in n.pages:
                    assert p not in seen, f"page {p} owned twice"
                    seen.add(p)
                total += len(n.pages)
            for key, child in n.children.items():
                assert key == tuple(child.tokens[:ps]), "mis-keyed child"
                assert child.parent is n, "broken parent link"
                stack.append((child, False,
                              under_host or (not is_root
                                             and n.host is not None)))
        assert total == self.total_pages, (
            f"total_pages {self.total_pages} != counted {total}")
        assert total <= self.max_pages, "tree exceeds its page budget"
        assert hbytes == self.host_bytes, (
            f"host_bytes {self.host_bytes} != counted {hbytes}")
        assert hbytes <= max(self.host_budget_bytes, 0), \
            "host tier past its byte budget"
