"""Set-associative LRU cache model (§3.2 / §5.2 of the paper).

The paper attaches a cache model to the trace replay: every traced memory
access is looked up by virtual address; a miss marks the vertex as a
*memory-access vertex* (it goes to RAM and pays the latency alpha).  The paper's
HPCG/LULESH case studies use a write-through 2-way set-associative L1 with
64-byte lines and LRU eviction; that is the default here.
"""
from __future__ import annotations

import numpy as np


class NoCache:
    """Every access goes to RAM (the paper's 'No Cache' baseline rows)."""

    def access(self, addr: int, is_write: bool = False) -> bool:
        return False  # never a hit

    def access_block(self, addrs, is_write=None) -> np.ndarray:
        """Batch lookup: every access misses."""
        return np.zeros(len(addrs), dtype=bool)

    def reset(self) -> None:
        pass


class SetAssociativeCache:
    """Write-through, write-allocate, LRU, set-associative cache.

    ``access`` returns True on hit.  Stores are write-through: they always
    update RAM, but (following the paper's vertex classification, where a
    vertex is a memory-access vertex iff it is a cache *miss*) a store hit is
    not counted as a RAM access vertex — the write-through traffic is posted
    and does not stall the dependence chain.
    """

    def __init__(self, size_bytes: int = 32 * 1024, line_bytes: int = 64,
                 ways: int = 2) -> None:
        if size_bytes % (line_bytes * ways):
            raise ValueError("cache size must be a multiple of line*ways")
        self.size_bytes = size_bytes
        self.line_bytes = line_bytes
        self.ways = ways
        self.n_sets = size_bytes // (line_bytes * ways)
        self.reset()

    def reset(self) -> None:
        # each set is a small list of tags in LRU order (index 0 = LRU)
        self._sets = [[] for _ in range(self.n_sets)]
        self.hits = 0
        self.misses = 0

    def access(self, addr: int, is_write: bool = False) -> bool:
        line = addr // self.line_bytes
        s = self._sets[line % self.n_sets]
        tag = line // self.n_sets
        try:
            s.remove(tag)           # hit: refresh LRU position
            s.append(tag)
            self.hits += 1
            return True
        except ValueError:
            self.misses += 1        # miss: allocate (write-allocate policy)
            if len(s) >= self.ways:
                s.pop(0)
            s.append(tag)
            return False

    def access_block(self, addrs, is_write=None) -> np.ndarray:
        """Vectorized batch lookup over an address array.

        Returns the per-access hit mask and updates the cumulative
        ``hits`` / ``misses`` counters exactly as the equivalent sequence
        of scalar ``access`` calls would (sets are independent, so accesses
        are replayed per set in their original relative order).

        ``is_write`` is accepted for signature parity with ``access``; the
        hit/miss outcome is read/write-agnostic under write-allocate LRU.
        """
        addrs = np.asarray(addrs, dtype=np.int64)
        k = len(addrs)
        hits = np.zeros(k, dtype=bool)
        if k == 0:
            return hits
        lines = addrs // self.line_bytes
        set_idx = lines % self.n_sets
        tags = lines // self.n_sets
        order = np.argsort(set_idx, kind="stable")
        sets_sorted = set_idx[order]
        tags_sorted = tags[order].tolist()
        # run boundaries: one contiguous slice per referenced set
        bounds = np.flatnonzero(np.diff(sets_sorted)) + 1
        starts = np.concatenate(([0], bounds))
        ends = np.concatenate((bounds, [k]))
        n_hits = 0
        hit_l = hits.tolist()
        order_l = order.tolist()
        for b, e in zip(starts.tolist(), ends.tolist()):
            s = self._sets[sets_sorted[b]]
            for i in range(b, e):
                tag = tags_sorted[i]
                try:
                    s.remove(tag)        # hit: refresh LRU position
                    s.append(tag)
                    hit_l[order_l[i]] = True
                    n_hits += 1
                except ValueError:       # miss: allocate (write-allocate)
                    if len(s) >= self.ways:
                        s.pop(0)
                    s.append(tag)
        self.hits += n_hits
        self.misses += k - n_hits
        return np.asarray(hit_l, dtype=bool)

    @property
    def miss_rate(self) -> float:
        total = self.hits + self.misses
        return self.misses / total if total else 0.0


def make_cache(size_bytes: int | None, line_bytes: int = 64, ways: int = 2):
    """None or 0 -> NoCache (paper baseline); else set-associative LRU."""
    if not size_bytes:
        return NoCache()
    return SetAssociativeCache(size_bytes, line_bytes, ways)
