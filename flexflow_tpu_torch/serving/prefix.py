"""Radix-tree prefix cache over the paged KV pool.

A copy of ``flexflow_tpu.serving.prefix`` (host-only bookkeeping; it
touches no tensor): trie nodes own one pool block each and the tokens its
rows hold; a match maps the longest cached prefix (at least one full
block) into an admitted slot's block table by refcount, never by copy; a
hit whose boundary falls inside a block schedules a copy-on-write clone;
fully-prefilled requests' prompt blocks are adopted when their slot is
released; least-recently-used unreferenced leaves are evicted under pool
pressure or past ``--prefix-cache-blocks``. The trie lives on the engine
and outlives serve() runs. Poison invalidation and the fleet's affinity
probe come with the resilience and fleet slices.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from .scheduler import BlockAllocator


class PrefixNode:
    """One trie node = one pool block + the tokens its rows hold."""

    __slots__ = ("tokens", "block", "children", "parent", "last_used")

    def __init__(self, tokens: Tuple[int, ...], block: Optional[int],
                 parent: Optional["PrefixNode"] = None):
        self.tokens = tokens
        self.block = block
        self.children: List["PrefixNode"] = []
        self.parent = parent
        self.last_used = 0


def _lcp(a: Tuple[int, ...], b: Tuple[int, ...]) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class PrefixCache:
    """Host-side radix tree mapping token prefixes onto refcounted pool
    blocks (module docstring has the design). Pure deterministic host
    bookkeeping — children keep insertion order, ties resolve first-won
    — so the serving schedule stays a function of the submission
    sequence."""

    def __init__(self, allocator: BlockAllocator, block_size: int,
                 max_blocks: int = 0):
        self.allocator = allocator
        self.block_size = int(block_size)
        # steady-state retention cap in blocks (0 = unbounded; pressure
        # eviction runs either way)
        self.max_blocks = int(max_blocks or 0)
        self.root = PrefixNode((), None)
        self.n_blocks = 0
        self._tick = 0
        # counters (the engine folds these into ServingStats)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.inserts = 0

    # ----------------------------------------------------------- matching
    def _touch(self, node: PrefixNode) -> None:
        self._tick += 1
        node.last_used = self._tick

    def _walk(self, tokens, cap: int, touch: bool
              ) -> Tuple[List[int], int]:
        bs = self.block_size
        cap = max(int(cap), 0)
        node = self.root
        matched = 0
        blocks: List[int] = []
        toks = tuple(int(t) for t in tokens[:cap])
        while matched < cap:
            best: Optional[PrefixNode] = None
            best_lcp = 0
            for child in node.children:
                m = _lcp(child.tokens, toks[matched:matched
                                            + len(child.tokens)])
                if m > best_lcp:
                    best, best_lcp = child, m
            if best is None or best_lcp == 0:
                break
            blocks.append(best.block)  # type: ignore[arg-type]
            matched += best_lcp
            if touch:
                self._touch(best)
            if best_lcp < len(best.tokens) or len(best.tokens) < bs:
                break  # partial credit or a partial (leaf) node: stop
            node = best
        return blocks, matched

    def match(self, tokens, cap: int) -> Tuple[List[int], int]:
        """Longest cached prefix of ``tokens[:cap]`` in (block ids,
        matched token count); a match below one full block is a miss —
        the returned ids are NOT yet pinned (the admission path takes
        its shares via ``BlockAllocator.share`` before anything can
        evict them)."""
        blocks, matched = self._walk(tokens, cap, touch=True)
        if matched < self.block_size:
            self.misses += 1
            return [], 0
        self.hits += 1
        return blocks, matched

    # ---------------------------------------------------------- insertion
    def peek(self, tokens, cap: int) -> int:
        """Matched-token count only, no LRU touch and no counters: the
        fleet router's cache-affinity probe."""
        _blocks, matched = self._walk(tokens, cap, touch=False)
        return matched if matched >= self.block_size else 0

    def insert(self, tokens, blocks: List[int]) -> int:
        """Adopt a request's prefilled blocks for ``tokens`` (block ``i``
        holds ``tokens[i*bs:(i+1)*bs]``); returns how many blocks the
        trie newly retained (each retained block gains one allocator
        reference). Exact duplicates dedup against existing nodes; a
        partial node whose tokens are a prefix of the incoming (longer)
        segment is UPGRADED to the longer block — live sharers of the
        old block keep their own references, so nothing they map
        changes."""
        if self.n_blocks == 0 and not blocks:
            return 0
        bs = self.block_size
        toks = tuple(int(t) for t in tokens)
        # only cache whole-block-or-better prompts: a sub-block prefix
        # can never be matched (the match floor) so retaining it would
        # only pin pool capacity
        if len(toks) < bs:
            return 0
        node = self.root
        adopted = 0
        for i, blk in enumerate(blocks):
            seg = toks[i * bs:(i + 1) * bs]
            if not seg:
                break
            existing = None
            upgrade = None
            covered = None
            for child in node.children:
                if child.tokens == seg:
                    existing = child
                    break
                if len(child.tokens) < len(seg) and \
                        seg[:len(child.tokens)] == child.tokens:
                    upgrade = upgrade or child
                elif len(child.tokens) >= len(seg) and \
                        child.tokens[:len(seg)] == seg:
                    covered = covered or child
            if existing is not None:
                self._touch(existing)
                if len(seg) < bs:
                    break  # duplicate partial tail: nothing below it
                node = existing
                continue
            if covered is not None:
                # an existing node already covers this (shorter) partial
                # segment with more tokens — keep the richer one
                self._touch(covered)
                break
            if upgrade is not None:
                # longer evidence for a partial node: adopt the new
                # block, release the old one's trie reference
                self.allocator.share([blk])
                old = upgrade.block
                upgrade.block = blk
                upgrade.tokens = seg
                self._touch(upgrade)
                if old is not None:
                    self.allocator.free([old])
                adopted += 1
                self.inserts += 1
                if len(seg) < bs:
                    break
                node = upgrade
                continue
            self.allocator.share([blk])
            child = PrefixNode(seg, blk, parent=node)
            self._touch(child)
            node.children.append(child)
            self.n_blocks += 1
            adopted += 1
            self.inserts += 1
            if len(seg) < bs:
                break
            node = child
        if self.max_blocks and self.n_blocks > self.max_blocks:
            self.evict(self.n_blocks - self.max_blocks)
        return adopted

    # ----------------------------------------------------------- eviction
    def _evictable(self) -> List[PrefixNode]:
        out: List[PrefixNode] = []

        def rec(node: PrefixNode) -> None:
            for child in node.children:
                rec(child)
                if not child.children and child.block is not None and \
                        self.allocator.refcount(child.block) == 1:
                    out.append(child)

        rec(self.root)
        return out

    def evict(self, n_blocks: int) -> int:
        """Free up to ``n_blocks`` pool blocks by removing least-
        recently-used leaf nodes no live request references (allocator
        refcount 1 = the trie's own). Removing a leaf may expose its
        parent; the sweep loops until satisfied or nothing is
        evictable. Frees go through ``BlockAllocator.free`` — the one
        decrement path — so the refcount laws hold."""
        freed = 0
        while freed < n_blocks:
            cands = self._evictable()
            if not cands:
                break
            victim = min(cands, key=lambda nd: nd.last_used)
            victim.parent.children.remove(victim)  # type: ignore[union-attr]
            self.allocator.free([victim.block])  # type: ignore[list-item]
            self.n_blocks -= 1
            freed += 1
            self.evictions += 1
        return freed

    def invalidate(self, blocks: List[int]) -> int:
        """Remove every node whose block is in ``blocks``, with its whole
        subtree (a poisoned parent poisons the path to its children),
        returning each removed node's trie reference; the count removed.
        The quarantine and decode-fault release calls it with the suspect
        request's blocks: a prompt block the trie cached at prefill may
        have been poisoned in place since, and must be neither re-matched
        by the victim's retry nor served to anyone else."""
        bad = {int(b) for b in blocks}
        removed: List[int] = []

        def reap(node: PrefixNode) -> None:
            if node.block is not None:
                removed.append(node.block)
            for child in node.children:
                reap(child)

        def rec(node: PrefixNode) -> None:
            keep = []
            for child in node.children:
                if child.block is not None and child.block in bad:
                    reap(child)
                else:
                    rec(child)
                    keep.append(child)
            node.children = keep

        rec(self.root)
        if removed:
            self.n_blocks -= len(removed)
            self.allocator.free(removed)
        return len(removed)

    def clear(self, free: bool = True) -> None:
        """Drop every node. ``free=True`` returns the trie's references
        through the allocator; ``free=False`` when the allocator itself is
        being reset."""
        if free:
            blocks: List[int] = []

            def rec(node: PrefixNode) -> None:
                for child in node.children:
                    rec(child)
                    if child.block is not None:
                        blocks.append(child.block)

            rec(self.root)
            if blocks:
                self.allocator.free(blocks)
        self.root = PrefixNode((), None)
        self.n_blocks = 0
