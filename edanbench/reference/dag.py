"""A plain scalar tracer and the eDAG it builds.

The tracing semantics are those of the paper's Algorithm 1 as the original
per-element tracers apply them, with no cache (every load and store goes to
RAM and is a memory-access vertex) and unlimited virtual registers:

* every load, store and ALU operation is one vertex, in program order;
* a load depends on the values that index it and on the last store to its
  byte address (a true dependency through memory);
* a store depends on the stored value and on the values that index it;
* an ALU operation depends on its operands.

Arrays are laid out one after another from ``0x4000_0000``, each aligned to
64 bytes, elements row-major.  The eDAG keeps the memory flag of every
vertex and the edge list, each edge once, sorted by destination and then
source.
"""
from __future__ import annotations

from array import array
from typing import Optional

import numpy as np

_OPS = {
    "+": lambda a, b: a + b, "-": lambda a, b: a - b,
    "*": lambda a, b: a * b, "/": lambda a, b: a / b,
    "max": max, "min": min,
}


class Value:
    """A traced scalar: its value and the vertex that produced it (None for
    a constant)."""

    __slots__ = ("val", "vid")

    def __init__(self, val, vid: Optional[int]):
        self.val = val
        self.vid = vid


class Array:
    """A numpy array whose element loads and stores are traced."""

    def __init__(self, tracer: "Tracer", arr: np.ndarray):
        self.tr = tracer
        self.arr = arr
        self.itemsize = arr.itemsize
        self.base = tracer._alloc(arr.nbytes)

    def _addr(self, idx: tuple) -> int:
        flat = int(np.ravel_multi_index(idx, self.arr.shape))
        return self.base + flat * self.itemsize

    def load(self, *idx) -> Value:
        idx = tuple(int(i) for i in idx)
        return Value(self.arr[idx], self.tr._load(self._addr(idx)))

    def store(self, idx, value) -> None:
        if not isinstance(idx, tuple):
            idx = (idx,)
        idx = tuple(int(i) for i in idx)
        val = value.val if isinstance(value, Value) else value
        self.arr[idx] = val
        dep = value.vid if isinstance(value, Value) else None
        self.tr._store(self._addr(idx), dep)


class Tracer:
    """Emits the eDAG of a program run element by element."""

    def __init__(self):
        self.mem = bytearray()
        self.src = array("q")
        self.dst = array("q")
        self._heap = 0x4000_0000
        self._last_store: dict = {}

    def _alloc(self, nbytes: int) -> int:
        base = self._heap
        self._heap += (nbytes + 63) & ~63
        return base

    def array(self, arr, name: str = "") -> Array:
        return Array(self, np.array(arr, copy=True))

    def zeros(self, shape, name: str = "") -> Array:
        return Array(self, np.zeros(shape, dtype=np.float64))

    def const(self, v) -> Value:
        return Value(v, None)

    def _vertex(self, is_mem: bool, deps) -> int:
        v = len(self.mem)
        self.mem.append(1 if is_mem else 0)
        for d in sorted(set(deps)):
            if d != v:
                self.src.append(d)
                self.dst.append(v)
        return v

    def _load(self, addr: int) -> int:
        w = self._last_store.get(addr)
        return self._vertex(True, () if w is None else (w,))

    def _store(self, addr: int, dep: Optional[int]) -> None:
        v = self._vertex(True, () if dep is None else (dep,))
        self._last_store[addr] = v

    def alu(self, op, *operands, label: Optional[str] = None) -> Value:
        fn = _OPS[op] if isinstance(op, str) else op
        vals = [o.val if isinstance(o, Value) else o for o in operands]
        deps = [o.vid for o in operands
                if isinstance(o, Value) and o.vid is not None]
        v = self._vertex(False, deps)
        return Value(fn(*vals) if len(vals) > 1 else fn(vals[0]), v)

    def dag(self) -> "Dag":
        return Dag(np.frombuffer(bytes(self.mem), dtype=np.uint8).astype(bool),
                   np.frombuffer(self.src, dtype=np.int64).copy(),
                   np.frombuffer(self.dst, dtype=np.int64).copy())


class Dag:
    """A finished eDAG: ``is_mem[v]`` for every vertex, and the edges
    ``src -> dst`` sorted by destination, then source."""

    def __init__(self, is_mem: np.ndarray, src: np.ndarray, dst: np.ndarray):
        self.is_mem = is_mem
        self.n = len(is_mem)
        order = np.lexsort((src, dst))
        self.src, self.dst = src[order], dst[order]
        counts = np.bincount(self.dst, minlength=self.n)
        # successors of each vertex in ascending order
        by_src = np.lexsort((self.dst, self.src))
        self.succ = self.dst[by_src]
        self.succ_ptr = np.concatenate(
            ([0], np.cumsum(np.bincount(self.src, minlength=self.n))))
        self.indeg = counts
