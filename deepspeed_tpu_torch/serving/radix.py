"""Radix-tree prefix index with copy-on-write sharing (port of
deepspeed_tpu/serving/radix.py).

A trie over token sequences at block granularity on top of the block pool
(serving/kv_blocks.py): each node owns one full pool block of
``block_size`` tokens, keyed by that block's token tuple, valid only beneath
its ancestors (a K/V entry depends on every preceding token and on its
absolute position).

  * match-on-admit: walk the trie along the new prompt; every exact-block
    hit is pinned and named in the slot's table, and its prefill is
    skipped. When the walk stops at a child that shares only part of its
    block, that block is forked: a fresh block is allocated, the engine
    copies the shared block into it on the device, and the slot's table
    names the fork, because the suffix prefill and the decode steps will
    overwrite part of it while the original may be shared.
  * insert-on-finish: a finished request donates its prompt's full blocks
    to the trie instead of freeing them; blocks whose key is already cached
    are freed.
  * LRU eviction: when admission needs more blocks than the free list
    holds, unpinned leaves are evicted oldest first.
  * readmit: a preempted request's resume re-pins whatever full prompt
    blocks the trie still holds (the swap-in skips them) and allocates
    the rest.

All host-side policy over integers; the only device work is the one-block
copy the engine runs per fork (inference/engine.block_copy_program).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from deepspeed_tpu_torch.serving.errors import (EngineInvariantError,
                                                KVLifecycleError)
from deepspeed_tpu_torch.serving.kv_blocks import BlockKVPool


class RadixNode:
    """One cached full block: ``key`` is its block_size-token tuple,
    ``block`` the pool block holding those tokens' KV."""

    __slots__ = ("key", "block", "parent", "children", "last_used")

    def __init__(self, key, block, parent):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: Dict[tuple, "RadixNode"] = {}
        self.last_used = 0

    def __repr__(self):
        return (f"RadixNode(block={self.block}, depth_key={self.key!r:.40}, "
                f"children={len(self.children)})")


class _SlotRecord:
    """Host state of one admitted slot's block ownership."""

    __slots__ = ("prompt", "matched_nodes", "owned")

    def __init__(self, prompt, matched_nodes, owned):
        self.prompt = prompt
        self.matched_nodes = matched_nodes   # pinned full-block trie nodes
        self.owned = owned                   # private blocks, table order


class PrefixCache:
    """Couples the block pool and the radix trie into the serving engine's
    admit/finish protocol, with the hit/miss/COW/eviction counters (also
    into ``registry``'s ``serving/prefix_hit_tokens``,
    ``serving/prefix_miss_tokens``, ``serving/blocks_cowed`` and
    ``serving/blocks_evicted`` when one is given)."""

    def __init__(self, pool: BlockKVPool, registry=None):
        self.pool = pool
        self.registry = registry
        self.root = RadixNode(None, None, None)
        self._records: Dict[int, _SlotRecord] = {}
        self._tick = 0
        # fits() then admit() run the same match walk back to back (and
        # fits re-runs every step while the queue head waits on blocks):
        # the last match is kept, guarded by a trie-structure counter
        self._mut = 0
        self._match_memo = None  # (prompt_key, full, partial, mut)
        self.hit_tokens = 0
        self.miss_tokens = 0
        self.blocks_cowed = 0
        self.blocks_evicted = 0

    # ------------------------------------------------------------- match
    def _touch(self, node: RadixNode) -> None:
        self._tick += 1
        while node is not None and node.parent is not None:
            node.last_used = self._tick
            node = node.parent

    def match(self, prompt: Sequence[int], cap: int
              ) -> Tuple[List[RadixNode], Optional[Tuple[RadixNode, int]]]:
        """Longest cached prefix of ``prompt[:cap]``: a chain of exact
        full-block nodes, plus at most one trailing (node, p) partial
        overlap of 1 <= p < block_size tokens (the COW-fork candidate).
        ``cap`` is prompt_len - 1 in practice: one prompt token stays
        unmatched so the suffix prefill has a position to pick the first
        generated token from."""
        bs = self.pool.block_size
        node, full, t = self.root, [], 0
        while cap - t >= bs:
            child = node.children.get(tuple(prompt[t:t + bs]))
            if child is None:
                break
            full.append(child)
            node = child
            t += bs
        partial = None
        remaining = prompt[t:cap]
        if remaining:
            best_p = 0
            for key, child in node.children.items():
                p = 0
                for a, b in zip(key, remaining):
                    if a != b:
                        break
                    p += 1
                if p > best_p:
                    best_p, partial = p, (child, p)
        return full, partial

    def _match_memoized(self, prompt: Sequence[int]):
        """match(prompt, len - 1), kept from fits() to admit(). match()
        depends only on the trie's structure, so the memo holds exactly
        while ``_mut`` is unchanged."""
        key = tuple(prompt)
        memo = self._match_memo
        if memo is not None and memo[0] == key and memo[3] == self._mut:
            return memo[1], memo[2]
        full, partial = self.match(prompt, len(prompt) - 1)
        self._match_memo = (key, full, partial, self._mut)
        return full, partial

    # ------------------------------------------------------------ admit
    def evictable_count(self) -> int:
        return sum(1 for _ in self._iter_evictable())

    def _iter_evictable(self):
        stack = [self.root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if (node is not self.root and not node.children
                    and self.pool.ref[node.block] == 0):
                yield node

    def evict_node(self, node: RadixNode) -> None:
        """Remove one leaf from the trie and free its block. Raises on a
        pinned block or an interior node (its children's KV depends on
        it)."""
        if node.children:
            raise KVLifecycleError(
                f"evicting interior radix node {node!r}: its children's "
                f"cached KV is only valid beneath it")
        if self.pool.ref[node.block] != 0:
            raise KVLifecycleError(
                f"evicting pinned block {node.block} "
                f"(refcount {self.pool.ref[node.block]})")
        del node.parent.children[node.key]
        self._mut += 1
        self.pool.free_block(node.block)
        self.blocks_evicted += 1
        if self.registry is not None:
            self.registry.counter("serving/blocks_evicted").inc()

    def _evict_lru(self, n_needed: int) -> None:
        """Evict unpinned leaves oldest first until the free list holds
        ``n_needed`` blocks (an eviction may expose its parent, so the
        candidates are re-scanned every round)."""
        while self.pool.free_count < n_needed:
            victims = sorted(self._iter_evictable(),
                             key=lambda nd: nd.last_used)
            if not victims:
                raise EngineInvariantError(
                    f"need {n_needed} blocks, have {self.pool.free_count} "
                    f"free and nothing evictable (admission gating bug)")
            self.evict_node(victims[0])

    def _evictable_cascade(self, exclude=frozenset()) -> int:
        """Blocks the LRU pass could eventually free: a node counts iff its
        whole subtree (itself included) is unpinned and outside
        ``exclude``. Evicting leaves exposes their parents, so a clean
        3-deep chain yields 3 blocks although only its leaf is evictable
        now; counting leaves alone would deadlock admission on pools barely
        bigger than one request."""

        def walk(node):
            clean = node is self.root or (
                self.pool.ref[node.block] == 0
                and node.block not in exclude)
            n = 0
            for child in node.children.values():
                cn, cclean = walk(child)
                n += cn
                clean = clean and cclean
            if node is not self.root and clean:
                n += 1
            return n, clean

        return walk(self.root)[0]

    def fits(self, prompt: Sequence[int], total_tokens: int) -> bool:
        """Admission predicate: can ``blocks_for(total_tokens)`` minus the
        shared full-match blocks be served from free + eventually-evictable
        blocks? Matched blocks are excluded from the evictable side:
        admit() pins them before evicting."""
        full, _partial = self._match_memoized(prompt)
        matched = {node.block for node in full}
        need = self.pool.blocks_for(total_tokens) - len(full)
        return need <= (self.pool.free_count
                        + self._evictable_cascade(matched))

    def admit(self, slot: int, prompt: Sequence[int], total_tokens: int
              ) -> Tuple[int, List[Tuple[int, int]]]:
        """Build slot ``slot``'s block table for a request needing
        ``total_tokens`` of KV (prompt + max_new): share the matched
        prefix, allocate the rest. Returns ``(matched_len, copies)``:
        ``matched_len`` prompt tokens are already cached (prefill only the
        suffix), and ``copies`` is the [(src, dst)] block-copy list the
        engine runs before the suffix prefill (the COW forks)."""
        pool = self.pool
        bs = pool.block_size
        prompt = list(prompt)
        full, partial = self._match_memoized(prompt)
        self._match_memo = None
        n_total = pool.blocks_for(total_tokens)
        # (the partial COW source needs no pin: even if evicted and
        # reallocated, nothing writes it before the copy the engine issues
        # right after this call, and the device runs work in issue order)
        table = self._pin_evict_build(slot, full, n_total)
        owned: List[int] = []
        copies: List[Tuple[int, int]] = []
        matched = len(full) * bs
        if partial is not None:
            node, p = partial
            fork = pool.alloc_block()
            copies.append((node.block, fork))
            table[len(full)] = fork
            owned.append(fork)
            matched += p
            self.blocks_cowed += 1
            self._touch(node)
            if self.registry is not None:
                self.registry.counter("serving/blocks_cowed").inc()
        owned.extend(self._alloc_rest(table, len(full) + len(owned), n_total))
        self._records[slot] = _SlotRecord(prompt, full, owned)
        pool.invalidate_tables()
        miss = len(prompt) - matched
        self.hit_tokens += matched
        self.miss_tokens += miss
        if self.registry is not None:
            self.registry.counter("serving/prefix_hit_tokens").inc(matched)
            self.registry.counter("serving/prefix_miss_tokens").inc(miss)
        return matched, copies

    def _pin_evict_build(self, slot: int, full: List[RadixNode],
                         n_total: int):
        """Admit's and readmit's table: pin the matched chain before
        evicting (a matched unpinned leaf must not be evicted for its own
        admission), make room, write the matched blocks at the head of the
        slot's table row and touch the chain. Returns the host row."""
        pool = self.pool
        for node in full:
            pool.pin(node.block)
        self._evict_lru(n_total - len(full))
        table = pool.tables[slot]
        table[:] = pool.sentinel
        for j, node in enumerate(full):
            table[j] = node.block
        if full:
            self._touch(full[-1])
        return table

    def _alloc_rest(self, table, start_j: int, n_total: int) -> List[int]:
        """Private blocks for table positions ``start_j .. n_total``."""
        owned: List[int] = []
        for j in range(start_j, n_total):
            blk = self.pool.alloc_block()
            table[j] = blk
            owned.append(blk)
        return owned

    def readmit(self, slot: int, prompt: Sequence[int],
                total_tokens: int) -> int:
        """Rebuild a preempted request's table on resume: re-pin the full
        prompt-prefix blocks the trie still holds (the same tokens at the
        same positions, so the swap-in skips them), allocate private blocks
        for the rest, and record the slot so a later finish or preemption
        donates as usual. No fork (a partly shared block comes back from
        the host copy) and no hit/miss accounting (a re-match saves an
        upload, not prefill compute). Returns the number of re-pinned
        leading blocks: the caller uploads the blocks from there on."""
        pool = self.pool
        prompt = list(prompt)
        full, _partial = self._match_memoized(prompt)
        self._match_memo = None
        n_total = pool.blocks_for(total_tokens)
        table = self._pin_evict_build(slot, full, n_total)
        owned = self._alloc_rest(table, len(full), n_total)
        self._records[slot] = _SlotRecord(prompt, full, owned)
        pool.invalidate_tables()
        return len(full)

    # ----------------------------------------------------------- finish
    def finish(self, slot: int, donate_upto: Optional[int] = None) -> None:
        """Release slot ``slot``: unpin its shared prefix, donate its
        prompt's full private blocks to the trie, and free everything else
        (the partial prompt tail and every decode block: matching runs
        against prompts only).

        ``donate_upto`` caps the donation at the tokens the slot computed:
        a request preempted or cancelled mid chunked prefill has written
        only that many positions, and a block with an unwritten tail would
        serve garbage to every later match."""
        rec = self._records.pop(slot, None)
        if rec is None:
            return
        pool = self.pool
        bs = pool.block_size
        for node in rec.matched_nodes:
            pool.unpin(node.block)
        parent = rec.matched_nodes[-1] if rec.matched_nodes else self.root
        j = len(rec.matched_nodes)
        owned = list(rec.owned)
        cap = len(rec.prompt) if donate_upto is None \
            else min(len(rec.prompt), donate_upto)
        while owned and (j + 1) * bs <= cap:
            blk = owned.pop(0)
            key = tuple(rec.prompt[j * bs:(j + 1) * bs])
            child = parent.children.get(key)
            if child is not None:
                pool.free_block(blk)       # an identical block is cached
            else:
                child = RadixNode(key, blk, parent)
                parent.children[key] = child
                self._mut += 1
            self._touch(child)
            parent = child
            j += 1
        for blk in owned:
            pool.free_block(blk)
        pool.tables[slot][:] = pool.sentinel
        pool.invalidate_tables()

    # -------------------------------------------------------- telemetry
    def hit_rate(self) -> float:
        total = self.hit_tokens + self.miss_tokens
        return self.hit_tokens / total if total else 0.0

    def cached_blocks(self) -> int:
        """Blocks currently owned by the trie (shared + evictable)."""
        n, stack = 0, [self.root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            n += node is not self.root
        return n
