"""Host-side bookkeeping for the paged KV cache (DESIGN.md §5.7).

The device side of paging is dumb on purpose: one flat block arena per
layer run (``transformer.init_cache_paged``), a ``(batch, NB)`` int32
block table uploaded per call, and kernels/scatters that indirect every
read/write through it. Everything stateful lives here, in plain numpy/
Python, where it is deterministic and trivially testable:

* **BlockPool** — the physical allocator: a LIFO free list (block ids
  descending, so two identical runs allocate identical block sequences)
  plus per-block refcounts. Block 0 is the reserved *null block*: never
  allocated, never written (the device write path drops stores whose
  table entry is 0), the sentinel target for dead table entries.
* **PrefixCache** — refcounted immutable prompt-prefix blocks, keyed by
  a per-block chain of (parent entry, block token content). Requests
  sharing a prompt header point their table rows at the same physical
  blocks; admission prefills only the unshared tail. A partial match
  inside one block is a **copy-on-write fork**: the divergence block is
  copied into a fresh block and the tail prefill starts after the
  copied tokens. Entries hold one pool reference each; eviction is LRU
  over leaf entries whose block no request holds.

Sharing is sound because a KV row at position t is a pure function of
tokens[0..t] (causal stack): two prompts identical through t have
bit-identical KV there, so the blocks are immutable and shareable.
Only FULL blocks that no future decode writes into are ever registered:
a prompt of length n contributes its first ``n // bk`` blocks (the
partially-filled block keeps receiving generated tokens and stays
private).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class BlockPool:
    """Refcounted physical-block allocator over ``blocks`` arena slots.

    Deterministic: the free list is a stack initialized ``blocks-1 … 1``
    (block 0 = reserved null block), so allocation order is a pure
    function of the alloc/free history. ``peak_in_use`` backs the
    peak-KV-bytes benchmark claim."""

    def __init__(self, blocks: int):
        assert blocks >= 2, "need at least the null block + one real block"
        self.blocks = blocks
        self.free: List[int] = list(range(1, blocks))   # pop() -> blocks-1
        self.ref = np.zeros((blocks,), dtype=np.int64)
        self.peak_in_use = 0

    @property
    def in_use(self) -> int:
        return self.blocks - 1 - len(self.free)

    def can_alloc(self, n: int) -> bool:
        return len(self.free) >= n

    def alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` blocks at refcount 1, or ``None`` (and no change)
        if the pool can't satisfy the request."""
        if n < 0 or len(self.free) < n:
            return None
        out = [self.free.pop() for _ in range(n)]
        for b in out:
            self.ref[b] = 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return out

    def incref(self, block: int) -> None:
        assert block != 0 and self.ref[block] > 0, block
        self.ref[block] += 1

    def decref(self, block: int) -> bool:
        """Drop one reference; returns True iff the block was freed."""
        assert block != 0 and self.ref[block] > 0, block
        self.ref[block] -= 1
        if self.ref[block] == 0:
            self.free.append(block)
            return True
        return False


@dataclasses.dataclass
class _Entry:
    eid: int               # unique id; 0 is the implicit root
    block: int             # physical arena block
    tokens: Tuple[int, ...]  # the bk token ids this block holds
    parent: int            # parent entry id (0 = root)
    lru: int               # last-touch clock tick


@dataclasses.dataclass
class PrefixPlan:
    """Admission plan for one request against the prefix cache.

    ``shared`` entries are reused verbatim (the caller increfs their
    blocks into the request's table). ``cow`` is the partial-overlap
    fork: copy ``cow_src`` into a fresh block and start the tail prefill
    ``cow_len`` tokens into it. ``start`` is the first position the tail
    prefill must compute (= len(shared)*bk + cow_len)."""
    shared: List[_Entry]
    cow_src: int = 0       # donor physical block (0 = no fork)
    cow_len: int = 0       # tokens shared inside the divergence block
    start: int = 0


class PrefixCache:
    """LRU-refcounted trie of immutable full prompt-prefix blocks."""

    def __init__(self, bk: int):
        self.bk = bk
        self.entries: Dict[Tuple[int, Tuple[int, ...]], _Entry] = {}
        self.children: Dict[int, List[_Entry]] = {}
        self._next_id = 1
        self._clock = 0

    def __len__(self) -> int:
        return len(self.entries)

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def plan(self, tokens: np.ndarray) -> PrefixPlan:
        """Longest reusable prefix of ``tokens`` (prompt, pre-admission).
        Caps sharing at ``len(tokens) - 1`` so at least one tail token
        remains to prefill (the admission logits come from it)."""
        bk = self.bk
        n = len(tokens)
        tick = self._tick()
        shared: List[_Entry] = []
        parent = 0
        nfull = max(0, (n - 1) // bk)      # full blocks, keeping >= 1 tail
        for i in range(nfull):
            blk = tuple(int(t) for t in tokens[i * bk:(i + 1) * bk])
            e = self.entries.get((parent, blk))
            if e is None:
                break
            e.lru = tick
            shared.append(e)
            parent = e.eid
        start = len(shared) * bk
        # copy-on-write fork: the best partial overlap inside the next
        # block (first-max tie break over insertion order)
        cow_src, cow_len = 0, 0
        cap = min(bk - 1, n - 1 - start)   # keep >= 1 tail token
        if cap > 0:
            nxt = [int(t) for t in tokens[start:start + bk]]
            for child in self.children.get(parent, ()):
                d = 0
                for a, b in zip(child.tokens, nxt):
                    if a != b or d >= cap:
                        break
                    d += 1
                if d > cow_len:
                    cow_src, cow_len = child.block, d
        return PrefixPlan(shared=shared, cow_src=cow_src, cow_len=cow_len,
                          start=start + cow_len)

    def register(self, tokens: np.ndarray, table_row: np.ndarray,
                 pool: BlockPool) -> int:
        """After a successful admission: publish the prompt's full blocks
        (``len // bk`` of them — the partial block stays private). Each
        NEW entry takes one extra pool reference (the cache's own hold).
        Returns the number of entries created."""
        bk = self.bk
        created = 0
        parent = 0
        tick = self._tick()
        for i in range(len(tokens) // bk):
            blk = tuple(int(t) for t in tokens[i * bk:(i + 1) * bk])
            e = self.entries.get((parent, blk))
            if e is None:
                e = _Entry(eid=self._next_id, block=int(table_row[i]),
                           tokens=blk, parent=parent, lru=tick)
                self._next_id += 1
                self.entries[(parent, blk)] = e
                self.children.setdefault(parent, []).append(e)
                pool.incref(e.block)
                created += 1
            else:
                e.lru = tick
            parent = e.eid
        return created

    def _remove(self, e: _Entry) -> None:
        del self.entries[(e.parent, e.tokens)]
        sibs = self.children.get(e.parent)
        if sibs is not None:
            sibs.remove(e)
            if not sibs:
                del self.children[e.parent]

    def evict_lru(self, pool: BlockPool) -> bool:
        """Drop the least-recently-used *leaf* entry whose block only the
        cache still holds (refcount 1). Returns True iff one was evicted
        (its block returns to the free list, NOT zeroed — stale KV in a
        freed block is unreachable: no table points at it, and masked
        positions contribute exact zeros)."""
        best: Optional[_Entry] = None
        for e in self.entries.values():
            if e.eid in self.children:     # interior: children pin it
                continue
            if pool.ref[e.block] != 1:     # some request still holds it
                continue
            if best is None or e.lru < best.lru:
                best = e
        if best is None:
            return False
        self._remove(best)
        pool.decref(best.block)
        return True

    def evict_blocks(self, blocks: Sequence[int], pool: BlockPool) -> int:
        """Poison-purge support: drop every cache entry whose physical
        block is in ``blocks`` (deepest-first so parents become leaves),
        releasing the cache's reference. Returns entries evicted."""
        bset = set(int(b) for b in blocks)
        victims = [e for e in self.entries.values() if e.block in bset]
        evicted = 0
        # children reference parents by eid; removing deepest-first keeps
        # the trie consistent (orphaned subtrees of a poisoned block must
        # go too — their chain includes the poisoned content)
        while victims:
            vids = {v.eid for v in victims}
            orphans = [e for e in self.entries.values()
                       if e.parent in vids and e not in victims]
            if not orphans:
                break
            victims.extend(orphans)
        for e in sorted(victims, key=lambda e: -e.eid):
            if (e.parent, e.tokens) in self.entries:
                self._remove(e)
                pool.decref(e.block)
                evicted += 1
        return evicted
