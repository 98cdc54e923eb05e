"""Host-side page allocator for the paged KV cache (the pool manager).

Copied verbatim from ``repro/serve/kv_pool.py`` (pure Python and numpy;
the port never imports the JAX package), so the reference's own pool
scenarios run unchanged against this copy.

The device state (:class:`repro_torch.models.attention.PagedKVCache`) is
dumb storage: a pool of ``[num_pages, page_size, KVH, Dh]`` pages per layer and
per-slot page tables.  THIS class owns the policy: a global free list of
physical pages, per-slot ownership, and the ``[slots, max_pages]`` int32
table mirror the scheduler uploads before every decode segment.

Since the prefix-cache PR the pool is **content-addressed**: pages are
refcounted, and a radix trie over full-page token chunks
(:meth:`admit_prefix` / :meth:`register_prefix`) lets N slots map the SAME
physical pages for a shared prompt prefix — the prefix is prefilled once,
ever.  A slot that must write into a page another reference still needs
(the partial last page of a matched prefix, or an in-page fork point)
gets a private copy first: :meth:`admit_prefix` allocates the
copy-on-write destination and reports the ``(src, dst)`` pair for the
engine's batched device-side page copy.  Retired prompts stay in the trie
(refcount 1, index-only) until capacity pressure evicts them
least-recently-used, leaf-first.

Contract (asserted by :meth:`check`, tested under scheduler churn):

* physical page 0 is the NULL page — never allocated, the landing zone
  for every unallocated table entry's (masked, unread) traffic;
* every non-null page's refcount equals (# slot tables referencing it)
  + (1 if the trie indexes it); a page is free exactly when its
  refcount is 0 (no leak, no double-free);
* shared pages are never written: full-page trie matches are complete
  and immutable, partial matches are COWed before the suffix prefill,
  and decode appends land past the prompt in slot-private pages;
* admission allocates exactly ``ceil(len/page_size) - matched_full``
  fresh pages for the prompt (matched pages cost a refcount bump, zero
  prefill compute) and RESERVES the slot's worst-case growth
  (:meth:`reserve`) so decode-time :meth:`ensure` calls can never
  exhaust the pool mid-run — a request that cannot reserve simply waits
  in the queue (backpressure, not a mid-flight abort).  All admission
  COW happens before the reservation is drawn down, so the accounting
  stays exact;
* decode growth (:meth:`ensure`) adds pages one boundary at a time;
  retirement (:meth:`release`) drops the slot's references — pages the
  trie still indexes are retained for future prefix hits.

Sizing: :func:`recommended_pages` provisions the dense worst case plus
segment-overshoot headroom — safe but savings-free.  Real deployments set
``ServeConfig.pool_pages`` from expected traffic (mean context, not
``max_seq``); the pool then admission-gates when fragmentation would
otherwise overcommit, which is the scheduler's backpressure signal.
Index-only pages count as reclaimable for that gate — they are evicted
on demand, never block an admission.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["KVPool", "PrefixAdmit", "pages_for", "recommended_pages",
           "table_width_for"]


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to hold ``tokens`` tokens: ceil(tokens / page_size)."""
    return -(-tokens // page_size)


def table_width_for(max_seq: int, page_size: int, headroom: int = 0) -> int:
    """Logical pages per slot: ceil((max_seq + headroom) / page_size).

    ``headroom`` covers decode-segment overshoot (power-of-two quantized
    segments may write up to a segment past a request's budget)."""
    return pages_for(max_seq + headroom, page_size)


def recommended_pages(slots: int, max_seq: int, page_size: int,
                      headroom: int = 0) -> int:
    """Worst-case pool size: every slot at max_seq (+headroom), plus the
    null page.  A safe default — pools sized below it are the point."""
    return slots * table_width_for(max_seq, page_size, headroom) + 1


@dataclasses.dataclass(frozen=True)
class PrefixAdmit:
    """Outcome of :meth:`KVPool.admit_prefix` for one admission.

    ``matched_len`` tokens of the prompt are already resident (their K/V
    need no prefill); ``shared_full`` of the slot's pages are full-page
    trie hits (mapped read-only); ``cow`` is the device page copy the
    engine must run before the suffix prefill — ``(src, dst)`` physical
    ids, or None when the match ended exactly on a page boundary."""

    matched_len: int = 0
    shared_full: int = 0
    cow: Optional[Tuple[int, int]] = None


class _Node:
    """One radix-trie node = one FULL page of ``page_size`` tokens.

    Children are keyed by their exact token chunk, so the trie is a
    page-granular radix tree over prompt prefixes; ``stamp`` is the LRU
    clock eviction orders index-only leaves by."""

    __slots__ = ("chunk", "page", "children", "parent", "stamp")

    def __init__(self, chunk: Tuple[int, ...], page: int,
                 parent: Optional["_Node"], stamp: int):
        self.chunk = chunk
        self.page = page
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.stamp = stamp


class KVPool:
    """Global free list + per-slot page tables over a fixed page pool,
    with a refcounted prefix-sharing trie on top."""

    def __init__(self, num_pages: int, page_size: int, slots: int,
                 table_width: int, prefix_cache: bool = True):
        if num_pages < 2:
            raise ValueError(f"pool needs >= 2 pages (got {num_pages}): "
                             "page 0 is reserved as the null page")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.slots = int(slots)
        self.table_width = int(table_width)
        self.prefix_cache = bool(prefix_cache)
        # LIFO free list: recently-released pages are re-used first (their
        # contents are dead anyway and they are likelier cache-warm)
        self.free: Deque[int] = collections.deque(range(1, num_pages))
        # pages withheld from allocation by the chaos harness (simulated
        # external memory pressure): refcount 0 but NOT free — see seize()
        self.seized: List[int] = []
        self.owned: List[List[int]] = [[] for _ in range(slots)]
        self.reserved: List[int] = [0] * slots   # worst-case pages promised
        self.tables = np.zeros((slots, table_width), np.int32)
        self.refcnt: List[int] = [0] * num_pages
        self.allocs = 0          # page references handed to slots (audited)
        self.releases = 0        # page references returned
        # the prefix trie: root children + a page -> node reverse map
        self._root: Dict[Tuple[int, ...], _Node] = {}
        self._node_of: Dict[int, _Node] = {}
        self._clock = itertools.count()
        # prefix-cache telemetry (benchmarks surface these)
        self.prefix_queries = 0
        self.prefix_hit_tokens = 0
        self.prompt_tokens = 0
        self.cow_copies = 0
        self.evictions = 0

    # ------------------------------------------------------------- queries
    def available(self) -> int:
        return len(self.free)

    def evictable(self) -> int:
        """Index-only pages (refcount 1, trie only): reclaimable on
        demand, so they never block an admission."""
        return sum(1 for pid in self._node_of if self.refcnt[pid] == 1)

    def reclaimable(self) -> int:
        """Pages an allocation could draw on: free now, or evictable."""
        return len(self.free) + self.evictable()

    def unpromised(self) -> int:
        """Reclaimable pages not already promised to active slots'
        future growth."""
        outstanding = sum(max(r - len(o), 0)
                          for r, o in zip(self.reserved, self.owned))
        return self.reclaimable() - outstanding

    def can_fit(self, tokens: int, slot: int) -> bool:
        """Would :meth:`ensure` for ``tokens`` total tokens succeed?"""
        need = pages_for(tokens, self.page_size) - len(self.owned[slot])
        return need <= self.reclaimable()

    def can_reserve(self, worst_tokens: int, shared_pages: int = 0) -> bool:
        """Could a NEW slot reserving ``worst_tokens`` of growth be
        admitted without ever failing an :meth:`ensure` later?

        ``shared_pages`` full-page prefix hits (:meth:`match_prefix`)
        are mapped by refcount bump, not drawn from the free list, so
        they tighten the gate — prefix sharing IS extra admission
        capacity, exactly."""
        need = min(pages_for(worst_tokens, self.page_size),
                   self.table_width) - shared_pages
        return need <= self.unpromised()

    def reserve(self, slot: int, worst_tokens: int) -> None:
        """Promise ``worst_tokens`` of total coverage to ``slot`` — gated
        by :meth:`can_reserve` at admission, so every later ensure() up
        to the reservation is guaranteed to find free pages."""
        self.reserved[slot] = min(pages_for(worst_tokens, self.page_size),
                                  self.table_width)

    def slot_pages(self, slot: int) -> int:
        return len(self.owned[slot])

    def table(self) -> np.ndarray:
        """A copy of the [slots, table_width] table for device upload."""
        return self.tables.copy()

    def shared_page_refs(self) -> int:
        """Live slot-table entries served by a page another slot (or the
        same prompt earlier) already owns — physical pages saved NOW."""
        live = [pid for pages in self.owned for pid in pages]
        return len(live) - len(set(live))

    def index_pages(self) -> int:
        """Pages the prefix trie currently indexes."""
        return len(self._node_of)

    def occupancy(self) -> float:
        """Fraction of usable pages not on the free list."""
        usable = self.num_pages - 1
        return (usable - len(self.free)) / max(usable, 1)

    # ----------------------------------------------------- prefix sharing
    def _usable_prefix(self, tokens: Sequence[int]) -> Tuple[int, ...]:
        """Matchable span of a prompt: everything but the last token —
        prefill must process >= 1 real token to produce sampling logits."""
        return tuple(int(t) for t in tokens[:-1])

    def _walk(self, toks: Tuple[int, ...]
              ) -> Tuple[List[_Node], Optional[_Node], int]:
        """Radix walk: longest chain of full-page chunk matches, then the
        best in-page partial (a child whose chunk starts with the
        remaining tokens — the COW fork point)."""
        nodes: List[_Node] = []
        children = self._root
        i = 0
        ps = self.page_size
        while i + ps <= len(toks):
            node = children.get(toks[i:i + ps])
            if node is None:
                break
            nodes.append(node)
            children = node.children
            i += ps
        rem = toks[i:i + ps]
        best, best_j = None, 0
        for node in children.values():
            j = 0
            for a, b in zip(node.chunk, rem):
                if a != b:
                    break
                j += 1
            if j > best_j:
                best, best_j = node, j
        return nodes, best, best_j

    def match_prefix(self, tokens: Sequence[int]) -> Tuple[int, int]:
        """Read-only trie probe: (matched_tokens, full_pages_matched).

        The admission gate uses this BEFORE committing anything —
        ``full_pages_matched`` feeds :meth:`can_reserve`'s
        ``shared_pages`` so backpressure accounts for sharing."""
        if not self.prefix_cache:
            return 0, 0
        nodes, _partial, j = self._walk(self._usable_prefix(tokens))
        return len(nodes) * self.page_size + j, len(nodes)

    def admit_prefix(self, slot: int, tokens: Sequence[int]) -> PrefixAdmit:
        """Map every trie-matched prefix page into ``slot``'s table.

        Full-page matches are mapped read-only (refcount++, zero prefill
        compute).  A partial match — the remaining < page_size tokens are
        a strict prefix of some indexed page's chunk — maps a FRESH page
        instead and reports ``cow=(src, dst)``: the engine copies src's
        contents device-side, then the suffix prefill overwrites from
        ``matched_len`` on.  Must be called on an empty slot, before
        :meth:`reserve`/:meth:`alloc` finish the admission."""
        assert not self.owned[slot], f"slot {slot} admitted while occupied"
        self.prefix_queries += 1
        self.prompt_tokens += len(tokens)
        if not self.prefix_cache:
            return PrefixAdmit()
        nodes, partial, j = self._walk(self._usable_prefix(tokens))
        stamp = next(self._clock)
        for node in nodes:
            pid = node.page
            self.refcnt[pid] += 1
            self.tables[slot, len(self.owned[slot])] = pid
            self.owned[slot].append(pid)
            self.allocs += 1
            node.stamp = stamp
        cow = None
        if partial is not None and j > 0:
            partial.stamp = stamp
            src = partial.page
            dst = self._draw_page(protect={src})
            self.tables[slot, len(self.owned[slot])] = dst
            self.owned[slot].append(dst)
            self.allocs += 1
            cow = (src, dst)
            self.cow_copies += 1
        matched = len(nodes) * self.page_size + j
        self.prefix_hit_tokens += matched
        return PrefixAdmit(matched_len=matched, shared_full=len(nodes),
                           cow=cow)

    def register_prefix(self, slot: int, tokens: Sequence[int]) -> int:
        """Index ``slot``'s now-prefilled FULL prompt pages in the trie.

        Call after the prompt's K/V are resident.  Pages whose chunk is
        already indexed (this slot matched them, or another slot raced
        the registration) just refresh their LRU stamp; fresh full pages
        gain a trie reference (refcount++) and will serve future
        admissions — including after this slot retires.  Returns the
        number of newly indexed pages."""
        if not self.prefix_cache:
            return 0
        toks = tuple(int(t) for t in tokens)
        ps = self.page_size
        n_full = min(len(toks) // ps, len(self.owned[slot]))
        children, parent = self._root, None
        added = 0
        stamp = next(self._clock)
        for pageidx in range(n_full):
            chunk = toks[pageidx * ps:(pageidx + 1) * ps]
            node = children.get(chunk)
            if node is None:
                pid = self.owned[slot][pageidx]
                node = _Node(chunk, pid, parent, stamp)
                children[chunk] = node
                self._node_of[pid] = node
                self.refcnt[pid] += 1
                added += 1
            node.stamp = stamp
            children, parent = node.children, node
        return added

    def _evict_one(self, protect=()) -> bool:
        """Drop the least-recently-used index-only LEAF from the trie,
        returning its page to the free list.  Leaf-first keeps the trie
        consistent (an evicted interior node would orphan descendants
        that remain perfectly servable)."""
        victim = None
        for pid, node in self._node_of.items():
            if (self.refcnt[pid] != 1 or node.children or pid in protect):
                continue
            if victim is None or node.stamp < victim.stamp:
                victim = node
        if victim is None:
            return False
        siblings = (victim.parent.children if victim.parent is not None
                    else self._root)
        del siblings[victim.chunk]
        del self._node_of[victim.page]
        self.refcnt[victim.page] = 0
        self.free.append(victim.page)
        self.evictions += 1
        return True

    def _draw_page(self, protect=()) -> int:
        """Pop a free page, evicting index-only pages if the list is dry."""
        if not self.free and not self._evict_one(protect):
            raise RuntimeError(
                f"KV pool exhausted: 0 free of {self.num_pages - 1} and "
                "nothing evictable (size the pool with "
                "ServeConfig.pool_pages)")
        pid = self.free.pop()
        self.refcnt[pid] = 1
        return pid

    def clear_index(self) -> int:
        """Drop the whole prefix trie; index-only pages return to the
        free list.  Returns the number of pages freed."""
        freed = 0
        for pid in list(self._node_of):
            self.refcnt[pid] -= 1
            if self.refcnt[pid] == 0:
                self.free.append(pid)
                freed += 1
        self._node_of.clear()
        self._root.clear()
        return freed

    # ------------------------------------------------- chaos: seized pages
    def seize(self, n: int) -> int:
        """Withhold up to ``n`` FREE pages from allocation (the chaos
        harness's simulated external memory pressure).  Seized pages stay
        refcount 0 but leave the free list, so every admission gate and
        ensure() sees a genuinely smaller pool; :meth:`check` accounts
        for them.  Returns the number actually seized."""
        taken = 0
        while taken < n and self.free:
            self.seized.append(self.free.pop())
            taken += 1
        return taken

    def unseize(self) -> int:
        """Return every seized page to the free list (pressure relief)."""
        n = len(self.seized)
        self.free.extend(self.seized)
        self.seized.clear()
        return n

    # -------------------------------------------- snapshot: index transfer
    def export_index(self) -> List[Dict]:
        """Serialize the prefix trie for a serving snapshot: one dict per
        node — physical page id, its full-page token chunk, and the
        parent's page id (None at the root) — in parent-before-child
        order, so :meth:`adopt_index` can rebuild linkage in one pass."""
        out: List[Dict] = []
        stack = [(node, None) for node in self._root.values()]
        while stack:
            node, parent_page = stack.pop()
            out.append({"page": int(node.page),
                        "chunk": [int(t) for t in node.chunk],
                        "parent": parent_page})
            stack.extend((c, int(node.page))
                         for c in node.children.values())
        return out

    def adopt_index(self, nodes: Sequence[Dict]) -> int:
        """Rebuild a previously exported trie into THIS (empty) pool.

        The restore path: page ids in ``nodes`` refer to physical pages
        of a same-sized pool, so each adopted page leaves the free list
        and gains the trie's refcount.  The caller is responsible for
        writing the page *contents* back into the device state.  Returns
        the number of pages adopted."""
        assert all(not o for o in self.owned) and not self._node_of, \
            "adopt_index needs an empty pool"
        if not self.prefix_cache or not nodes:
            return 0
        adopt = {int(n["page"]) for n in nodes}
        assert all(0 < p < self.num_pages for p in adopt), \
            f"snapshot page ids out of range for a {self.num_pages}-page pool"
        self.free = collections.deque(p for p in self.free
                                      if p not in adopt)
        stamp = next(self._clock)
        for nd in nodes:
            pid = int(nd["page"])
            chunk = tuple(int(t) for t in nd["chunk"])
            parent = (self._node_of[int(nd["parent"])]
                      if nd["parent"] is not None else None)
            node = _Node(chunk, pid, parent, stamp)
            siblings = parent.children if parent is not None else self._root
            siblings[chunk] = node
            self._node_of[pid] = node
            self.refcnt[pid] = 1
        return len(adopt)

    # ----------------------------------------------------------- lifecycle
    def ensure(self, slot: int, tokens: int) -> int:
        """Grow slot ``slot`` to cover ``tokens`` total tokens; returns the
        number of pages newly allocated.  Raises on pool exhaustion or
        table overflow — the scheduler admission-gates so decode-time
        growth never fails in a correctly-sized deployment."""
        need = pages_for(tokens, self.page_size)
        if need > self.table_width:
            raise ValueError(
                f"slot {slot}: {tokens} tokens need {need} pages "
                f"> table_width {self.table_width}")
        grow = need - len(self.owned[slot])
        while grow > len(self.free) and self._evict_one():
            pass
        if grow > len(self.free):
            raise RuntimeError(
                f"KV pool exhausted: slot {slot} needs {grow} more pages, "
                f"{len(self.free)} free of {self.num_pages - 1} "
                "(size the pool with ServeConfig.pool_pages)")
        for _ in range(max(grow, 0)):
            pid = self.free.pop()
            self.refcnt[pid] = 1
            self.tables[slot, len(self.owned[slot])] = pid
            self.owned[slot].append(pid)
            self.allocs += 1
        return max(grow, 0)

    # admission vocabulary: a new prompt allocates exactly ceil(len/page)
    alloc = ensure

    def release(self, slot: int) -> int:
        """Retire a slot: drop its page references + reservation, zero its
        table.  Pages the trie still indexes are RETAINED for future
        prefix hits (refcount stays >= 1); everything else is freed."""
        n = len(self.owned[slot])
        for pid in self.owned[slot]:
            self.refcnt[pid] -= 1
            self.releases += 1
            if self.refcnt[pid] == 0:
                self.free.append(pid)
        self.owned[slot] = []
        self.reserved[slot] = 0
        self.tables[slot, :] = 0
        return n

    # ----------------------------------------------------------- invariants
    def check(self) -> None:
        """Assert the pool invariants (cheap; tests call it every step)."""
        free_set = set(self.free)
        assert len(free_set) == len(self.free), "double-free in the free list"
        assert 0 not in free_set, "null page leaked into the free list"
        seized_set = set(self.seized)
        assert len(seized_set) == len(self.seized), "page seized twice"
        assert not (seized_set & free_set), "page both seized and free"
        assert 0 not in seized_set, "null page seized"
        for pid in seized_set:
            assert self.refcnt[pid] == 0, \
                f"seized page {pid} has refcount {self.refcnt[pid]}"
        slot_refs: collections.Counter = collections.Counter()
        for slot, pages in enumerate(self.owned):
            assert len(pages) == len(set(pages)), \
                f"slot {slot} maps a page twice"
            for j, pid in enumerate(pages):
                assert pid != 0, f"slot {slot} owns the null page"
                assert pid not in free_set, \
                    f"page {pid} both free and owned by slot {slot}"
                assert self.tables[slot, j] == pid, "table/ownership skew"
                slot_refs[pid] += 1
            assert (self.tables[slot, len(pages):] == 0).all(), \
                f"slot {slot}: stale table entries past its allocation"
        for pid in range(1, self.num_pages):
            want = slot_refs[pid] + (1 if pid in self._node_of else 0)
            assert self.refcnt[pid] == want, \
                (f"page {pid}: refcount {self.refcnt[pid]} != "
                 f"{slot_refs[pid]} slot refs + "
                 f"{int(pid in self._node_of)} index refs")
            assert (self.refcnt[pid] == 0) == (pid in free_set
                                               or pid in seized_set), \
                f"page {pid}: refcount {self.refcnt[pid]} vs free-list skew"
        assert self.refcnt[0] == 0, "null page refcounted"
        # trie structure: reverse map exact, linkage consistent, and the
        # sharing closure (a slot maps a node only with all its ancestors,
        # so an index-only node never has a slot-referenced descendant)
        def walk(children, parent):
            for chunk, node in children.items():
                assert node.chunk == chunk and node.parent is parent
                assert self._node_of.get(node.page) is node, \
                    f"trie page {node.page} reverse-map skew"
                assert len(chunk) == self.page_size
                if self.refcnt[node.page] == 1:
                    bad = [c.page for c in node.children.values()
                           if self.refcnt[c.page] > 1]
                    assert not bad, \
                        (f"index-only page {node.page} has slot-referenced "
                         f"children {bad}")
                walk(node.children, node)
        walk(self._root, None)
        reachable = sum(1 for _ in self._iter_nodes())
        assert reachable == len(self._node_of), "orphaned trie nodes"

    def _iter_nodes(self):
        stack = list(self._root.values())
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    def all_free(self) -> bool:
        return len(self.free) == self.num_pages - 1

    def __repr__(self) -> str:
        used = self.num_pages - 1 - len(self.free)
        return (f"KVPool(pages={self.num_pages}, page_size={self.page_size},"
                f" used={used}, free={len(self.free)},"
                f" indexed={len(self._node_of)},"
                f" allocs={self.allocs}, releases={self.releases})")
