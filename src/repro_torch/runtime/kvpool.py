"""Paged KV-cache block pool: fixed-size blocks, refcounts, prefix reuse.

Host-side allocator for the serving runtime (no device arrays move through
here): physical KV storage lives in ``[num_blocks, block_size, ...]`` pool
leaves, and each decode slot owns a BLOCK TABLE — logical block ``i`` of
the slot's sequence maps to physical block ``table.blocks[i]``.  Block ids
are layer-agnostic: one allocation addresses every layer's pool leaf.

Reuse contract (vLLM-style; copy-on-write reduces to the block boundary):

* Only FULL, immutable prompt blocks are ever shared.  Blocks register
  under a TOKEN-HASH CHAIN key — nested ``(parent_key, block_tokens)``
  tuples — so a lookup hit guarantees the ENTIRE prefix matches by exact
  tuple equality (python dict hashing; no hash-collision false positives).
* ``match_prefix`` acquires the longest registered chain, capped at the
  prompt length minus one token: the final position always recomputes so
  admission still produces the first generated token's logits.
* A shared block is never written — writes continue in freshly allocated
  blocks from the first unmatched position.  That IS copy-on-write at the
  block boundary: there is no partial-block sharing to copy.
* ``release`` drops a reference.  Refcount-0 registered blocks move to an
  LRU of evictable prefixes (still matchable — a later admission
  resurrects them for free); eviction recycles the least-recently-freed
  one only when the free list runs dry.

Physical block 0 is the reserved NULL block: never allocated, the write
target for masked pad rows and inactive decode slots
(``layers.pool_update_rows`` redirects there).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Dict, List, Sequence, Tuple

import numpy as np


class PoolExhausted(RuntimeError):
    """No free or evictable block available for an allocation."""


@dataclasses.dataclass
class BlockTable:
    """A slot's logical -> physical block mapping."""
    blocks: List[int]
    n_reused: int = 0          # leading blocks acquired from the prefix cache

    def as_array(self, pages: int) -> np.ndarray:
        """Fixed-width [pages] int32 row for the decode/chunk programs;
        unassigned logical blocks point at the null block (0)."""
        arr = np.zeros((pages,), np.int32)
        arr[:len(self.blocks)] = self.blocks
        return arr


class KVPool:
    """Ref-counted block allocator with hash-chain prefix reuse + LRU
    eviction.  ``blocks_in_use`` counts referenced blocks only — cached
    refcount-0 prefixes are reclaimable and excluded (they are free
    capacity that happens to still be matchable)."""

    NULL = 0

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError(f"num_blocks={num_blocks}: need >= 2 (block 0 "
                             "is the reserved null block)")
        if block_size < 1:
            raise ValueError(f"block_size={block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free = deque(range(1, num_blocks))
        self._ref: Dict[int, int] = {}             # bid -> refcount (>= 1)
        self._key_of: Dict[int, tuple] = {}        # registered bid -> chain key
        self._by_key: Dict[tuple, int] = {}        # chain key -> bid
        self._lru: "OrderedDict[int, None]" = OrderedDict()  # evictable bids
        # counters (benchmarks / regression tests read these)
        self.reuse_hits = 0            # admissions that reused >= 1 block
        self.reused_tokens = 0         # prompt tokens skipped via reuse
        self.evictions = 0
        self.peak_blocks_in_use = 0

    # ------------------------------------------------------------ accounting
    @property
    def blocks_in_use(self) -> int:
        return len(self._ref)

    def available(self) -> int:
        return len(self._free) + len(self._lru)

    def can_allocate(self, n: int) -> bool:
        return n <= self.available()

    def _track_peak(self) -> None:
        if len(self._ref) > self.peak_blocks_in_use:
            self.peak_blocks_in_use = len(self._ref)

    # --------------------------------------------------------------- hashing
    def chain_keys(self, tokens: Sequence[int]) -> List[tuple]:
        """One key per FULL block prefix of ``tokens``: key_i embeds
        key_{i-1}, so equal keys imply equal full prefixes."""
        bs = self.block_size
        keys: List[tuple] = []
        parent: tuple = ()
        for i in range(len(tokens) // bs):
            parent = (parent, tuple(int(t) for t in tokens[i * bs:(i + 1) * bs]))
            keys.append(parent)
        return keys

    # ----------------------------------------------------------- reuse paths
    def match_prefix(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest-prefix-match against registered blocks: returns the
        acquired block ids (refcount bumped; caller owns a reference) and
        the number of prompt tokens they cover.  Capped at ``len(tokens) -
        1`` so at least one position always recomputes.  Counters are NOT
        updated here — call ``note_reuse`` once the admission commits
        (a failed admission releases the blocks without counting)."""
        cap = max(0, (len(tokens) - 1) // self.block_size)
        got: List[int] = []
        for key in self.chain_keys(tokens)[:cap]:
            bid = self._by_key.get(key)
            if bid is None:
                break
            got.append(bid)
        for bid in got:
            self._acquire(bid)
        # peak_blocks_in_use is NOT updated here: a failed admission
        # releases these blocks again, and counting them would overstate
        # the concurrent footprint.  ``allocate`` / ``note_reuse`` track
        # the peak once the admission's full block set is committed.
        return got, len(got) * self.block_size

    def note_reuse(self, n_blocks: int) -> None:
        """Count a committed admission's reuse (see ``match_prefix``)."""
        if n_blocks > 0:
            self.reuse_hits += 1
            self.reused_tokens += n_blocks * self.block_size
        self._track_peak()

    def _acquire(self, bid: int) -> None:
        if bid in self._ref:
            self._ref[bid] += 1
        else:                          # cached refcount-0 prefix: resurrect
            self._lru.pop(bid)
            self._ref[bid] = 1

    def register(self, blocks: Sequence[int], tokens: Sequence[int]) -> None:
        """Hash-register a freshly prefilled table's FULL prompt blocks so
        later admissions can reuse them.  Already-registered ids keep
        their key; a key another block already owns is left to that block
        (two racing identical prompts dedup to the first)."""
        for bid, key in zip(blocks, self.chain_keys(tokens)):
            if bid in self._key_of or key in self._by_key:
                continue
            self._key_of[bid] = key
            self._by_key[key] = bid

    # ---------------------------------------------------------- alloc / free
    def allocate(self, n: int) -> List[int]:
        """Take ``n`` fresh blocks (refcount 1), evicting least-recently-
        freed cached prefixes if the free list runs dry."""
        if not self.can_allocate(n):
            raise PoolExhausted(f"need {n} blocks, "
                                f"{self.available()} available")
        out: List[int] = []
        for _ in range(n):
            if not self._free:
                self._evict_one()
            bid = self._free.popleft()
            self._ref[bid] = 1
            out.append(bid)
        self._track_peak()
        return out

    def _evict_one(self) -> None:
        bid, _ = self._lru.popitem(last=False)     # least recently freed
        del self._by_key[self._key_of.pop(bid)]
        self._free.append(bid)
        self.evictions += 1

    def release(self, blocks: Sequence[int]) -> None:
        """Drop one reference per block.  Registered blocks whose refcount
        hits 0 stay matchable on the eviction LRU; unregistered ones
        return to the free list immediately."""
        for bid in blocks:
            r = self._ref[bid] - 1
            if r > 0:
                self._ref[bid] = r
                continue
            del self._ref[bid]
            if bid in self._key_of:
                self._lru[bid] = None
                self._lru.move_to_end(bid)         # most recently freed
            else:
                self._free.append(bid)
