"""Paged KV-cache bookkeeping: refcounted page pool + radix prefix index.

A copy of ``repro.serve.kv_pool`` (numpy only), kept so that the port
imports nothing of the JAX package; its policy is unchanged, and
``tests/test_torch_kv_pool.py`` holds its actions against the reference's.

The serving engine's paged mode replaces the dense per-lane ``max_seq``
caches with ONE physical arena of fixed-size pages per attention layer
(``models/attention.init_paged_cache``).  This module owns every HOST-side
decision about that arena — which physical page backs which logical page of
which lane, when a page is shared, copied, or freed — and stays completely
device-free so the policy is testable on its own: every mutation that must
reach the device arena is returned as an ACTION list the engine applies:

    ("clear", pid)            reset page ``pid``'s pos_ids to -1 (stale
                              slots must never look valid to a new owner)
    ("copy", src, dst, keep)  copy page ``src`` into ``dst``, keeping the
                              first ``keep`` slots' pos_ids valid and
                              clearing the rest (copy-on-write)

Page identity: physical page 0 is the permanent NULL page — never
allocated, never written, pos_ids forever -1.  Unmapped page-table entries
point at it, so device gathers need no validity branch: null slots are
masked by position like any empty slot.

Sharing model (vLLM/SGLang-style radix cache at page granularity):

* A lane's prompt pages are inserted into a radix tree when its prefill
  completes.  FULL pages become internal nodes (chains extend beneath
  them); a trailing partial page becomes a leaf with its fill count.
* ``admit`` walks the tree with a new prompt: fully matched FULL pages are
  mapped SHARED (lane refcount bumped, zero copies, prefill for that span
  skipped entirely); the first divergence inside a page triggers
  COPY-ON-WRITE — the matching slots are kept, the rest cleared, and the
  lane owns the copy (it will keep writing into that page).
* The tree itself holds pages independently of lane refcounts; a page is
  freed only when no lane references it AND no tree node names it.  When
  the free list runs dry, least-recently-hit leaf nodes are evicted until
  a page frees; when every page is lane-held the allocation raises
  ``PoolExhaustedError`` for the engine's preemption path to handle.

Exactness: sharing never changes values — a shared page holds exactly the
K/V a dense engine would recompute for the same prefix at the same
absolute positions, so the paged engine's outputs are bit-identical to the
dense engine's (enforced by tests/test_torch_paged.py).

Overload is a POLICY, not a crash: when neither the free list nor the
prefix index can supply a page, allocation raises ``PoolExhaustedError``
— typed, recoverable, bookkeeping left consistent — and the serving
engine answers with lane preemption: ``swap_out`` hands back the lane's
(logical, physical) mapping and releases it (the engine copies the page
payloads to host memory first), ``swap_in`` later rebinds the same
logical pages to fresh physical pages for the engine to scatter the
saved payload into.  The round trip is pure data movement — bit-identical
KV, any physical placement.  Pools may be sized far below the worst-case
``lanes * pages_per_lane`` (only one lane's worth + 2 is required);
admission control and preemption manage the rest.
"""
from __future__ import annotations

import numpy as np

Action = tuple  # ("clear", pid) | ("copy", src, dst, keep)


class PoolExhaustedError(RuntimeError):
    """Typed, RECOVERABLE allocation failure: the arena has no free page
    and no evictable tree leaf (every page is lane-held).

    Carries ``actions`` — the device actions accumulated before the
    failure (evictions that DID free pages still need their clears
    applied).  Pool bookkeeping stays consistent: after the caller
    applies ``actions``, every ``check()`` invariant holds, no page is
    leaked, and every lane's mapping is exactly what it was plus any
    pages the failing call managed to map (re-running the call is
    idempotent for those).  The serving engine treats this as memory
    pressure — preempt a lane and retry — never as a crash."""

    def __init__(self, actions, msg: str = "page pool exhausted: "
                 "no free page and no evictable tree leaf"):
        super().__init__(msg)
        self.actions: list[Action] = list(actions)


class _Node:
    """One page of a registered prompt prefix: ``tokens`` (1..page_size)
    under the parent's prefix, backed by physical page ``page``."""

    __slots__ = ("tokens", "page", "fill", "children", "parent", "stamp")

    def __init__(self, tokens: tuple, page: int, parent):
        self.tokens = tokens
        self.page = page
        self.fill = len(tokens)
        self.children: list[_Node] = []
        self.parent = parent
        self.stamp = 0


def _common(a, b) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class PagedKVPool:
    """Host bookkeeping for the paged KV arena (no device state).

    ``table`` is the (lanes, pages_per_lane) int32 physical-page map the
    engine ships to the device each step; entry 0 = unmapped (null page).
    """

    def __init__(self, n_pages: int, page_size: int, lanes: int,
                 pages_per_lane: int):
        # one lane's worst-case mapping + the null page + 1 spare: enough
        # that a LONE resident lane always completes, which is what makes
        # preemption a guaranteed-progress policy (preempted lanes hold
        # zero pages).  Pools smaller than every lane's combined worst
        # case are legal — admission control + preemption manage the
        # concurrency, raising PoolExhaustedError instead of corrupting.
        assert n_pages >= pages_per_lane + 2, (
            "pool must out-size one lane's worst-case mapping + 1 spare",
            n_pages, lanes, pages_per_lane)
        self.n = n_pages
        self.ps = page_size
        self.lanes = lanes
        self.mp = pages_per_lane
        # free stack; page 0 is the null page and is never allocated
        self._free = list(range(n_pages - 1, 0, -1))
        self.ref = np.zeros(n_pages, np.int32)          # lane references
        self.table = np.zeros((lanes, pages_per_lane), np.int32)
        self._root = _Node((), 0, None)
        self._node_of_page: dict[int, _Node] = {}       # tree references
        self._clock = 0
        self.stats: dict[str, int] = {}
        self.reset_stats()

    # -- stats ------------------------------------------------------------
    def reset_stats(self) -> None:
        self.stats = {"prefix_hits": 0, "prefix_hit_tokens": 0,
                      "cow_copies": 0, "evictions": 0, "pages_peak": 0,
                      "swap_outs": 0, "swap_ins": 0}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def tree_pages(self) -> int:
        return len(self._node_of_page)

    @property
    def evictable_pages(self) -> int:
        """Tree-held pages no lane references: what eviction can reclaim
        (leaf by leaf — a held chain frees bottom-up, so the COUNT is
        reachable even when individual nodes aren't leaves yet).  The
        engine's admission control reads ``free_pages + evictable_pages``
        as the pool's real headroom."""
        return sum(1 for pid in self._node_of_page if self.ref[pid] == 0)

    # -- allocation core --------------------------------------------------
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _alloc(self, actions: list[Action], protect: int = 0) -> int:
        """Pop a clean page, evicting prefix-index leaves if needed.
        ``protect`` pins one page (a COW SOURCE about to be copied from):
        eviction must not clear it out from under the pending copy."""
        if not self._free:
            self._evict_one(actions, protect)
        pid = self._free.pop()
        assert pid != protect, "allocated the COW source as its own copy"
        self.stats["pages_peak"] = max(
            self.stats["pages_peak"], self.n - 1 - len(self._free))
        return pid

    def _release_page(self, pid: int, actions: list[Action]) -> None:
        """Drop one lane reference; free (with a clear) when nothing —
        lane or tree — names the page anymore."""
        assert pid != 0 and self.ref[pid] > 0, pid
        self.ref[pid] -= 1
        if self.ref[pid] == 0 and pid not in self._node_of_page:
            actions.append(("clear", pid))
            self._free.append(pid)

    def _evict_one(self, actions: list[Action], protect: int = 0) -> None:
        """Free the least-recently-hit evictable tree leaf's page.
        ``protect`` exempts one page — the COW source a pending copy in
        this very action batch still reads from."""
        victim = None
        stack = [self._root]
        while stack:
            node = stack.pop()
            stack.extend(node.children)
            if node is self._root or node.children or node.page == protect:
                continue  # only leaves are reachable-consistent to drop
            if victim is None or node.stamp < victim.stamp:
                victim = node
        if victim is None:
            # typed + recoverable: carries the clears of any pages earlier
            # eviction rounds in this batch DID free (the caller must
            # still apply them); bookkeeping is left fully consistent
            raise PoolExhaustedError(actions)
        self._drop_node(victim, actions)
        self.stats["evictions"] += 1
        if not self._free:
            # victim's page was still lane-held; keep evicting
            self._evict_one(actions, protect)

    def _drop_node(self, node: _Node, actions: list[Action]) -> None:
        node.parent.children.remove(node)
        del self._node_of_page[node.page]
        if self.ref[node.page] == 0:
            actions.append(("clear", node.page))
            self._free.append(node.page)

    # -- lane lifecycle ---------------------------------------------------
    def lane_release(self, lane: int) -> list[Action]:
        """Free every page the lane maps (finish / reset)."""
        actions: list[Action] = []
        for j in range(self.mp):
            pid = int(self.table[lane, j])
            if pid:
                self._release_page(pid, actions)
        self.table[lane] = 0
        return actions

    def admit(self, lane: int, prompt: list[int]) -> tuple[int, list[Action]]:
        """Map the longest registered prefix of ``prompt`` into the lane.

        Returns ``(shared_len, actions)``: the lane's prefill may start at
        position ``shared_len``.  Capped at ``len(prompt) - 1`` so at least
        one prompt token is always fed (the boundary logit needs it), and
        at the lane's page budget.  Fully matched FULL pages map shared;
        a partial match copies-on-write (the lane keeps writing there).
        """
        assert not self.table[lane].any(), ("admit on a mapped lane", lane)
        actions: list[Action] = []
        limit = min(len(prompt) - 1, self.mp * self.ps)
        node, depth = self._root, 0
        while depth < limit:
            best, best_m = None, 0
            for child in node.children:
                m = min(_common(child.tokens, prompt[depth:depth + child.fill]),
                        limit - depth)
                if m > best_m:
                    best, best_m = child, m
            if best is None:
                break
            best.stamp = self._tick()
            j = depth // self.ps
            if best_m == best.fill == self.ps:
                # whole full page matches: share it, zero copies
                self.table[lane, j] = best.page
                self.ref[best.page] += 1
                depth += self.ps
                node = best
                continue
            # divergence (or partial node) inside the page: COW — keep the
            # matching slots, clear the rest, lane owns the copy.  The
            # source page is PINNED through the allocation: an eviction
            # triggered here must not clear it before the copy runs.  If
            # the pool is so tight that the source is the only evictable
            # leaf, skip the partial share (the lane just prefills the
            # page itself) rather than corrupt or crash.
            try:
                dst = self._alloc(actions, protect=best.page)
            except PoolExhaustedError:
                break
            actions.append(("copy", best.page, dst, best_m))
            self.table[lane, j] = dst
            self.ref[dst] += 1
            self.stats["cow_copies"] += 1
            depth += best_m
            break
        if depth:
            self.stats["prefix_hits"] += 1
            self.stats["prefix_hit_tokens"] += depth
        return depth, actions

    # -- preemption: swap-out / swap-in ----------------------------------
    def swap_out(self, lane: int) -> tuple[list[tuple[int, int]], list[Action]]:
        """Preemption, host side: return the lane's mapped ``(logical_j,
        physical_pid)`` pairs in logical order, then release every lane
        reference (same bookkeeping as ``lane_release``).

        ORDERING CONTRACT: the engine must READ the returned pages'
        payloads off the device arena BEFORE applying the returned
        actions — the release clears any page nothing else holds.  Pages
        the tree (or a co-sharing lane) still references survive
        untouched, but the swap payload carries their content anyway, so
        swap-in restores the lane as owned copies and never depends on
        what sharing outlived the preemption."""
        mapped = [(j, int(self.table[lane, j])) for j in range(self.mp)
                  if self.table[lane, j]]
        self.stats["swap_outs"] += 1
        return mapped, self.lane_release(lane)

    def swap_in(self, lane: int, js: list[int]
                ) -> tuple[list[int], list[Action]]:
        """Resume, host side: back every logical page index in ``js`` with
        a FRESH physical page (the rebind — swapped content comes back to
        DIFFERENT physical pages; the engine scatters the saved payload
        into the returned pids, in ``js`` order).

        Transactional: if the pool cannot supply every page, all pages
        mapped so far are released again and ``PoolExhaustedError``
        carries the combined actions — the lane is left exactly as it
        was (unmapped), so the engine retries on a later iteration.
        Recoverable backpressure, not a crash."""
        assert not self.table[lane].any(), ("swap_in on a mapped lane", lane)
        actions: list[Action] = []
        got: list[int] = []
        try:
            for j in js:
                pid = self._alloc(actions)
                self.table[lane, j] = pid
                self.ref[pid] += 1
                got.append(pid)
        except PoolExhaustedError:
            for j, pid in zip(js, got):
                self.table[lane, j] = 0
                self._release_page(pid, actions)
            raise PoolExhaustedError(
                actions, "swap_in: pool cannot host the resumed lane yet")
        self.stats["swap_ins"] += 1
        return got, actions

    def ensure_writable(self, lane: int, pos0: int, count: int) -> list[Action]:
        """Back every logical page the span [pos0, pos0+count) writes into
        with a lane-owned physical page.  Shared (tree) pages are only ever
        mapped for spans BELOW the lane's write position, so a mapped page
        here is already exclusively writable (its tree-registered slots are
        immutable; the lane appends beyond them)."""
        actions: list[Action] = []
        for j in range(pos0 // self.ps, (pos0 + count - 1) // self.ps + 1):
            assert j < self.mp, (lane, pos0, count, j)
            pid = int(self.table[lane, j])
            if pid == 0:
                pid = self._alloc(actions)
                self.table[lane, j] = pid
                self.ref[pid] += 1
            assert self.ref[pid] == 1, ("write into a shared page", lane, j)
        return actions

    def register_prompt(self, lane: int, prompt: list[int]) -> None:
        """Insert the lane's (fully prefilled) prompt pages into the radix
        tree so later submissions can share them.  Full pages become
        internal nodes; a trailing partial page becomes a leaf.  Existing
        identical nodes are reused (another lane registered first) — the
        lane's duplicate pages simply stay lane-owned until release."""
        node, n = self._root, len(prompt)
        for j in range(min((n + self.ps - 1) // self.ps, self.mp)):
            toks = tuple(prompt[j * self.ps:min((j + 1) * self.ps, n)])
            hit = next((c for c in node.children if c.tokens == toks), None)
            if hit is not None:
                hit.stamp = self._tick()
                if hit.fill < self.ps:
                    return      # partial nodes are leaves
                node = hit
                continue
            pid = int(self.table[lane, j])
            if pid == 0 or pid in self._node_of_page:
                return  # truncated prompt page / page already registered
            child = _Node(toks, pid, node)
            child.stamp = self._tick()
            node.children.append(child)
            self._node_of_page[pid] = child
            if child.fill < self.ps:
                return
            node = child

    def truncate(self, lane: int, keep: int, end: int) -> list[Action]:
        """Speculative-decode rollback: withdraw the lane's KV writes for
        positions [``keep``, ``end``) — rejected draft tokens.

        Pages wholly inside the rejected span are pure-decode pages the
        lane owns exclusively (speculation starts strictly after prefill,
        so no prompt slot and no tree node can sit at or beyond ``keep``):
        unmap + release them, which clears and frees any page nothing
        else holds.  The boundary page keeps its first ``keep % ps``
        slots (committed tokens, and — for the page straddling the
        prompt/decode boundary — registered prompt slots, which always
        lie below ``keep``) and clears the rejected tail via a SELF-copy
        action: ("copy", pid, pid, keep%ps) reuses the COW machinery's
        keep-semantics as an in-page pos_ids truncation.  Exactness never
        depends on this (stale slots hold positions >= keep, masked for
        every query until genuinely overwritten); it keeps the arena
        bit-identical to a vanilla decode's and returns over-allocated
        pages to the pool while the lane is still running."""
        actions: list[Action] = []
        if keep >= end:
            return actions
        # release pages wholly rejected: logical j covering [j*ps, (j+1)*ps)
        for j in range(-(-keep // self.ps), (end - 1) // self.ps + 1):
            pid = int(self.table[lane, j])
            if pid:
                assert pid not in self._node_of_page and self.ref[pid] == 1, (
                    "speculative write landed on a shared page", lane, j)
                self._release_page(pid, actions)
                self.table[lane, j] = 0
        fill = keep % self.ps
        if fill:
            pid = int(self.table[lane, keep // self.ps])
            if pid:
                actions.append(("copy", pid, pid, fill))
        return actions

    def cap_window(self, lane: int, next_pos: int, window: int) -> list[Action]:
        """Sliding-window archs: unmap pages wholly behind the window of
        every future query (positions < next_pos - window).  Masking keeps
        correctness either way; this caps the lane's LIVE page count at
        ~window/page_size (+1 partial)."""
        actions: list[Action] = []
        for j in range(self.mp):
            pid = int(self.table[lane, j])
            if pid and (j + 1) * self.ps - 1 < next_pos - window:
                self._release_page(pid, actions)
                self.table[lane, j] = 0
        return actions

    def flush_tree(self) -> list[Action]:
        """Evict every registered prefix (warmup isolation, tests)."""
        actions: list[Action] = []
        while self._node_of_page:
            for node in list(self._node_of_page.values()):
                if not node.children:
                    self._drop_node(node, actions)
        return actions

    # -- invariants (tests) ----------------------------------------------
    def check(self) -> None:
        """Assert the global accounting invariants (fuzz-test hook)."""
        free = set(self._free)
        assert 0 not in free and len(free) == len(self._free)
        mapped = set(int(p) for p in self.table.ravel() if p)
        assert not (mapped & free), "mapped page on the free list"
        assert not (set(self._node_of_page) & free), "tree page on free list"
        # lane refcounts == number of table entries naming the page
        counts = np.zeros(self.n, np.int32)
        for p in self.table.ravel():
            counts[p] += 1
        counts[0] = 0
        assert (counts == self.ref).all(), "refcount drift"
        # every non-null page is exactly free, lane-held, or tree-held
        held = mapped | set(self._node_of_page)
        assert len(free) + len(held) == self.n - 1, "page leak"
        # tree structure: node_of_page matches reachable nodes
        reach = {}
        stack = list(self._root.children)
        while stack:
            nd = stack.pop()
            reach[nd.page] = nd
            stack.extend(nd.children)
        assert reach == self._node_of_page, "unreachable tree node"
