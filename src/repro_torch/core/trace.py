"""Scalar trace frontend — the paper's Algorithm 1 (§3.1-3.2).

Two entry points:

1. ``build_edag_from_trace``: the *literal* Algorithm 1 — consumes an
   instruction trace in the paper's format (Fig 5: ``insn ; data_addr``),
   keeps a ``curr_vs`` map from storage location (register name or memory
   address) to its last producing vertex, and adds true-dependency edges.
   ``false_deps=True`` additionally keeps WAR/WAW edges (Fig 6a mode).

2. ``Tracer``: an array-DSL tracing interpreter used to generate large traces
   programmatically (PolyBench / HPCG / LULESH kernels).  It is the QEMU-TCG
   plugin's stand-in: kernels are executed once in Python and every scalar
   load/store/ALU op becomes a vertex with a real byte address, so the cache
   model (§3.2) is address-accurate.  Registers are *virtual and unlimited*
   (the paper's §7 wish), with an optional bounded register file that
   reproduces spill-induced extra dependencies (§3.2.1, §5.1 trmm study).
"""
from __future__ import annotations

import re
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np

from .cache import NoCache
from .graph import EDag


# --------------------------------------------------------------------------
# 1. Literal Algorithm 1 over a textual instruction trace (paper Fig 5 format)
# --------------------------------------------------------------------------

_LOADS = {"lb", "lh", "lw", "ld", "lbu", "lhu", "lwu", "flw", "fld"}
_STORES = {"sb", "sh", "sw", "sd", "fsw", "fsd"}
_BRANCHES = {"beq", "bne", "blt", "bge", "bltu", "bgeu", "beqz", "bnez"}
_MEM_RE = re.compile(r"(-?\d+)\((\w+)\)")


def _parse_insn(text: str):
    """Returns (opcode, operand list)."""
    parts = text.strip().split(None, 1)
    op = parts[0]
    ops = [o.strip() for o in parts[1].split(",")] if len(parts) > 1 else []
    return op, ops


def build_edag_from_trace(lines: Sequence[str], cache=None,
                          false_deps: bool = False) -> EDag:
    """Algorithm 1 of the paper, over Fig-5-format trace lines.

    dep_vals(v) are the registers read and (for loads) the memory address;
    targets(v) are the registers/addresses written.  Only true (RAW) edges are
    added unless ``false_deps``.
    """
    cache = cache or NoCache()
    g = EDag()
    curr_vs: dict = {}          # storage location -> last writer vertex
    readers: dict = {}          # storage location -> vertices that read it
    for line in lines:
        line = line.strip()
        if not line:
            continue
        if ";" in line:
            insn, addr_s = line.split(";", 1)
            data_addr = int(addr_s.strip(), 16)
        else:
            insn, data_addr = line, None
        op, ops = _parse_insn(insn)

        dep_vals, targets = [], []
        is_mem, nbytes = False, 0.0
        if op in _LOADS:
            rd = ops[0]
            m = _MEM_RE.match(ops[1])
            dep_vals.append(m.group(2))                     # address register
            if data_addr is not None:
                dep_vals.append(("M", data_addr))           # RAW through memory
                hit = cache.access(data_addr, is_write=False)
                is_mem = not hit
                nbytes = 8.0 if op in ("ld", "fld") else 4.0
            targets.append(rd)
        elif op in _STORES:
            rs2 = ops[0]
            m = _MEM_RE.match(ops[1])
            dep_vals += [rs2, m.group(2)]
            if data_addr is not None:
                hit = cache.access(data_addr, is_write=True)
                is_mem = not hit
                nbytes = 8.0 if op in ("sd", "fsd") else 4.0
                targets.append(("M", data_addr))
        elif op in _BRANCHES:
            dep_vals += [o for o in ops[:-1] if not o.lstrip("-").isdigit()]
        elif op == "li":
            targets.append(ops[0])
        elif op in ("mv", "fmv.d", "fmv.s", "sext.w"):
            dep_vals.append(ops[1])
            targets.append(ops[0])
        elif op in ("j", "jal", "jalr", "ret", "nop"):
            pass
        else:                                               # ALU r-type / i-type
            targets.append(ops[0])
            for o in ops[1:]:
                if not re.fullmatch(r"-?\d+", o):
                    dep_vals.append(o)

        v = g.add_vertex(cost=1.0, is_mem=is_mem, nbytes=nbytes, label=op)
        deps = set()
        for val in dep_vals:
            if val == "zero":
                continue
            dep_v = curr_vs.get(val)
            if dep_v is not None:
                deps.add(dep_v)                             # RAW (true) edges
        if false_deps:
            for t in targets:
                w = curr_vs.get(t)
                if w is not None:
                    deps.add(w)                             # WAW
                for r in readers.get(t, ()):  # WAR
                    deps.add(r)
        for d in sorted(deps):
            if d != v:
                g.add_edge(d, v)
        for val in dep_vals:
            if val != "zero":
                readers.setdefault(val, []).append(v)
        for t in targets:
            curr_vs[t] = v
            readers[t] = []
    return g


# --------------------------------------------------------------------------
# 2. Array-DSL tracing interpreter (programmatic trace generation at scale)
# --------------------------------------------------------------------------

class Value:
    """A traced scalar: python value + id of the vertex that produced it."""

    __slots__ = ("val", "vid")

    def __init__(self, val, vid: Optional[int]):
        self.val = val
        self.vid = vid

    def __repr__(self):
        return f"Value({self.val}, v{self.vid})"


class TracedArray:
    """A numpy array whose element accesses are traced with real addresses."""

    def __init__(self, tracer: "Tracer", arr: np.ndarray, name: str):
        self.tr = tracer
        self.arr = arr
        self.name = name
        self.base = tracer._alloc(arr.nbytes)
        self.itemsize = arr.itemsize

    def _addr(self, idx) -> int:
        if not isinstance(idx, tuple):
            idx = (idx,)
        flat = int(np.ravel_multi_index(tuple(int(i) for i in idx), self.arr.shape))
        return self.base + flat * self.itemsize

    def addr_block(self, *idx_arrays) -> np.ndarray:
        """Vectorized ``_addr``: byte addresses for arrays of indices."""
        flat = np.ravel_multi_index(
            tuple(np.asarray(ix, dtype=np.int64) for ix in idx_arrays),
            self.arr.shape)
        return self.base + flat * self.itemsize

    def load(self, *idx) -> Value:
        """Load element; idx components may be ints or Values (pointer chase)."""
        idx_vids = [i.vid for i in idx if isinstance(i, Value)]
        idx = tuple(int(i.val) if isinstance(i, Value) else int(i) for i in idx)
        addr = self._addr(idx)
        return self.tr._load(addr, self.arr[idx], self.itemsize, idx_vids,
                             label=f"ld {self.name}")

    def store(self, idx, value) -> None:
        if not isinstance(idx, tuple):
            idx = (idx,)
        idx_vids = [i.vid for i in idx if isinstance(i, Value)]
        idx = tuple(int(i.val) if isinstance(i, Value) else int(i) for i in idx)
        addr = self._addr(idx)
        val = value.val if isinstance(value, Value) else value
        self.arr[idx] = val
        dep = value.vid if isinstance(value, Value) else None
        self.tr._store(addr, dep, self.itemsize, idx_vids,
                       label=f"st {self.name}")


_OPS = {
    "+": lambda a, b: a + b, "-": lambda a, b: a - b,
    "*": lambda a, b: a * b, "/": lambda a, b: a / b,
    "max": max, "min": min,
}


class Tracer:
    """Tracing interpreter emitting an eDAG (Algorithm 1 semantics).

    * unlimited virtual registers by default (``max_regs=None``);
    * ``max_regs=K`` simulates a bounded register file with LRU spilling:
      evicted live values are written to a spill slot (a store vertex) and
      transparently reloaded on next use (a load vertex), reproducing the
      spill-induced dependence chains of §3.2.1 / §5.1;
    * every load/store consults the cache model; misses become memory-access
      vertices (is_mem=True).
    """

    def __init__(self, cache=None, max_regs: Optional[int] = None,
                 false_deps: bool = False, spill_policy: str = "fifo"):
        self.g = EDag()
        self.cache = cache or NoCache()
        self.false_deps = false_deps
        self.max_regs = max_regs
        # "fifo" evicts the oldest live range (Chaitin-style: longest live
        # range spills first — this is what makes trmm's accumulator spill,
        # §5.1); "lru" evicts the least recently touched value.
        self.spill_policy = spill_policy
        self._heap = 0x4000_0000
        self._arrays: list = []          # TracedArrays, in allocation order
        self._curr_vs: dict = {}         # memory address -> last store vertex
        self._readers: dict = {}         # memory address -> reader vertices
        # bounded-register-file emulation state
        self._live: OrderedDict = OrderedDict()   # orig vid -> None
        self._spill_addr: dict = {}      # orig vid -> spill address
        self._resident: dict = {}        # orig vid -> currently usable vid

    # ------------------------------------------------------------ allocation
    def _alloc(self, nbytes: int) -> int:
        base = self._heap
        self._heap += (nbytes + 63) & ~63        # 64-byte align allocations
        return base

    def array(self, arr: np.ndarray, name: str = "") -> TracedArray:
        ta = TracedArray(self, np.array(arr, copy=True), name)
        self._arrays.append(ta)
        return ta

    def zeros(self, shape, name: str = "", dtype=np.float64) -> TracedArray:
        ta = TracedArray(self, np.zeros(shape, dtype=dtype), name)
        self._arrays.append(ta)
        return ta

    def object_sizes(self) -> dict:
        """Footprint bytes per traced data object, by array name.

        Same-named arrays (or repeated unnamed ones, which all land under
        ``""``) accumulate — the footprint is what a placement decision
        must fit into local capacity, so aliased names share one budget
        entry.  This is the size table ``placement.objects_from_edag``
        consumes; without it, object sizes fall back to traffic sums."""
        sizes: dict = {}
        for ta in self._arrays:
            sizes[ta.name] = sizes.get(ta.name, 0) + int(ta.arr.nbytes)
        return sizes

    # -------------------------------------------------------- register model
    def _touch(self, vid: int) -> int:
        """Mark vid used; with a bounded register file, reload if spilled."""
        if self.max_regs is None or vid is None:
            return vid
        cur = self._resident.get(vid, vid)
        if cur in self._live:
            if self.spill_policy == "lru":
                self._live.move_to_end(cur)
            return cur
        # value was spilled: emit a reload depending on the spill store
        addr = self._spill_addr[vid]
        hit = self.cache.access(addr, is_write=False)
        rv = self.g.add_vertex(cost=1.0, is_mem=not hit, nbytes=8.0,
                               label="ld spill")
        w = self._curr_vs.get(addr)
        if w is not None:
            self.g.add_edge(w, rv)
        self._resident[vid] = rv
        self._resident[rv] = rv
        self._admit(rv, orig=vid)
        return rv

    def _admit(self, vid: int, orig: Optional[int] = None) -> None:
        if self.max_regs is None:
            return
        while len(self._live) >= self.max_regs:
            evict, _ = self._live.popitem(last=False)
            # spill the evicted live value
            addr = self._spill_addr.get(evict)
            if addr is None:
                addr = self._spill_addr[evict] = self._alloc(8)
            # map back to original id so future reloads find the slot
            for o, r in list(self._resident.items()):
                if r == evict:
                    self._spill_addr[o] = addr
            hit = self.cache.access(addr, is_write=True)
            sv = self.g.add_vertex(cost=1.0, is_mem=not hit, nbytes=8.0,
                                   label="st spill")
            if evict < sv:
                self.g.add_edge(evict, sv)
            self._curr_vs[addr] = sv
        self._live[vid] = None

    # ----------------------------------------------------------- vertex emit
    def _load_vid(self, addr: int, itemsize: float, dep_vids, label="ld") -> int:
        """Emit one load vertex; ``dep_vids`` are producer ids (index
        values), touched through the register model in order."""
        hit = self.cache.access(addr, is_write=False)
        deps = set()
        for iv in dep_vids:
            iv2 = self._touch(iv)
            if iv2 is not None:
                deps.add(iv2)
        w = self._curr_vs.get(addr)
        if w is not None:
            deps.add(w)
        v = self.g.add_vertex(cost=1.0, is_mem=not hit,
                              nbytes=float(itemsize), label=label)
        for d in sorted(deps):
            self.g.add_edge(d, v)
        self._readers.setdefault(addr, []).append(v)
        self._admit(v)
        self._resident[v] = v
        return v

    def _load(self, addr: int, pyval, itemsize: int, idx_vids, label="ld") -> Value:
        return Value(pyval, self._load_vid(addr, itemsize, idx_vids, label))

    def _store_vid(self, addr: int, itemsize: float, dep_vids,
                   label="st") -> int:
        """Emit one store vertex depending on ``dep_vids`` (stored value
        first, then index values — the scalar-path touch order)."""
        hit = self.cache.access(addr, is_write=True)
        deps = set()
        for iv in dep_vids:
            iv2 = self._touch(iv)
            if iv2 is not None:
                deps.add(iv2)
        if self.false_deps:
            w = self._curr_vs.get(addr)
            if w is not None:
                deps.add(w)                                  # WAW
            deps.update(self._readers.get(addr, ()))         # WAR
        v = self.g.add_vertex(cost=1.0, is_mem=not hit,
                              nbytes=float(itemsize), label=label)
        for d in sorted(deps):
            if d != v:
                self.g.add_edge(d, v)
        self._curr_vs[addr] = v
        self._readers[addr] = []
        return v

    def _store(self, addr: int, dep_vid, itemsize: int, idx_vids, label="st") -> int:
        dep_vids = ([dep_vid] if dep_vid is not None else []) + list(idx_vids)
        return self._store_vid(addr, itemsize, dep_vids, label)

    def _alu_vid(self, dep_vids, label="alu") -> int:
        """Emit one ALU vertex over producer ids (register-model touched)."""
        deps = set()
        for iv in dep_vids:
            if iv is not None:
                deps.add(self._touch(iv))
        v = self.g.add_vertex(cost=1.0, is_mem=False, nbytes=0.0, label=label)
        for d in sorted(deps):
            self.g.add_edge(d, v)
        self._admit(v)
        self._resident[v] = v
        return v

    def alu(self, op: str, *operands, label: Optional[str] = None) -> Value:
        """ALU vertex: op in {+,-,*,/,max,min} or a callable."""
        fn = _OPS[op] if isinstance(op, str) else op
        vals = [o.val if isinstance(o, Value) else o for o in operands]
        v = self._alu_vid(
            [o.vid for o in operands if isinstance(o, Value)
             and o.vid is not None],
            label or (op if isinstance(op, str) else "alu"))
        result = fn(*vals) if len(vals) > 1 else fn(vals[0])
        return Value(result, v)

    def const(self, v) -> Value:
        return Value(v, None)

    # ------------------------------------------------------- bulk emission
    # Vertex kinds for emit_block op arrays.
    LOAD, STORE, ALU = 0, 1, 2

    def _needs_scalar_replay(self) -> bool:
        """Tracer modes with per-op global state (the bounded-register-file
        spill model, WAR/WAW tracking) run blocks through the scalar
        emitters op by op instead of the vectorized fast path."""
        return self.max_regs is not None or self.false_deps

    def _emit_block_scalar(self, kind, addr, nbytes, deps, label) -> np.ndarray:
        """Replay a block through the scalar emitters in program order.

        Semantically identical to the vectorized path — same vertices,
        edges and cache-access stream — but additionally applies the
        §3.2.1 register model: operand touches may emit spill reloads and
        admissions may emit spill stores *between* the block's own ops,
        exactly as the per-element API would.  Dependency entries at or
        above the block's first (virtual) vertex id are positional
        references to earlier block ops and are remapped onto the ids
        those ops actually received."""
        kind = np.asarray(kind, dtype=np.int64)
        k = len(kind)
        if k == 0:
            return np.zeros(0, dtype=np.int64)
        addr = (np.full(k, -1, dtype=np.int64) if addr is None
                else np.asarray(addr, dtype=np.int64))
        nb = np.where(kind == self.ALU, 0.0,
                      np.broadcast_to(np.asarray(nbytes, dtype=np.float64),
                                      (k,)))
        labels = [label] * k if isinstance(label, str) else list(label)
        if deps is not None:
            deps = np.asarray(deps, dtype=np.int64)
            if deps.ndim == 1:
                deps = deps[:, None]
        base = self.g.n_vertices
        out = np.empty(k, dtype=np.int64)
        for i in range(k):
            dvs = []
            if deps is not None:
                for dep in deps[i]:
                    if dep < 0:
                        continue
                    dvs.append(int(out[dep - base]) if dep >= base
                               else int(dep))
            kd = kind[i]
            if kd == self.LOAD:
                out[i] = self._load_vid(int(addr[i]), float(nb[i]), dvs,
                                        labels[i])
            elif kd == self.STORE:
                out[i] = self._store_vid(int(addr[i]), float(nb[i]), dvs,
                                         labels[i])
            else:
                out[i] = self._alu_vid(dvs, labels[i])
        return out

    def emit_block(self, kind, addr=None, nbytes=0.0, deps=None,
                   label="") -> np.ndarray:
        """Append a block of vertices (and their edges) in one batch.

        ``kind``    int array: Tracer.LOAD / STORE / ALU, in *program order* —
                    the cache model replays the block's memory accesses in
                    exactly this order, so a block is semantically identical
                    to the equivalent sequence of scalar ``_load`` /
                    ``_store`` / ``alu`` calls.
        ``addr``    int64 byte addresses for memory ops (ignored for ALU).
        ``nbytes``  scalar or per-op array of access widths.
        ``deps``    (k, d) int64 matrix of *absolute* producer vertex ids,
                    -1 for none.  In-block references to earlier positions
                    are allowed.  RAW dependencies through memory (load after
                    the most recent store to the same address) are derived
                    internally and need not be listed.
        ``label``   one label for the block, or a length-k sequence.

        Returns the new vertex ids, in program order (contiguous on the
        vectorized path; under the bounded-register-file / false-deps
        modes, spill stores and reloads may be interleaved between them).

        Spill-model parameters (set on the ``Tracer``, honored here):

        ``max_regs``    §3.2.1 bounded register file.  ``None`` (default)
                        models the paper's unlimited virtual registers and
                        takes the vectorized fast path.  ``K`` caps live
                        values at K: admitting a vertex beyond capacity
                        evicts one live range (``spill_policy``: "fifo"
                        evicts the oldest — Chaitin-style, what makes
                        trmm's accumulator spill in §5.1 — "lru" the
                        least recently touched), emitting a spill *store*
                        vertex; touching a spilled operand emits a reload
                        *load* vertex depending on that store.  Both go
                        through the cache model, so spill traffic also
                        shifts hit/miss classification.  Blocks then
                        replay op-by-op in program order
                        (``_emit_block_scalar``) so spills land exactly
                        where the per-element API would put them.
        ``false_deps``  Fig 6a mode: stores additionally depend on the
                        previous writer (WAW) and all readers (WAR) of
                        their address.  Also forces the scalar replay —
                        the reader/writer maps are per-op global state.

        Both parameters preserve the emitted vertex/edge/cache-access
        stream byte-for-byte versus the equivalent scalar calls; the §5.1
        trmm study and all 18 PolyBench kernels are asserted exact in
        ``tests/test_vector_engine.py`` across max_regs × false_deps ×
        cache configurations.
        """
        if self._needs_scalar_replay():
            return self._emit_block_scalar(kind, addr, nbytes, deps, label)
        kind = np.asarray(kind, dtype=np.int64)
        k = len(kind)
        if k == 0:
            return np.zeros(0, dtype=np.int64)
        addr = (np.full(k, -1, dtype=np.int64) if addr is None
                else np.asarray(addr, dtype=np.int64))

        # 1. cache lookups in program order (misses become memory vertices)
        mem_pos = np.flatnonzero(kind != self.ALU)
        is_mem = np.zeros(k, dtype=bool)
        if len(mem_pos):
            hits = self.cache.access_block(addr[mem_pos],
                                           is_write=kind[mem_pos] == self.STORE)
            is_mem[mem_pos] = ~hits

        # 2. vertices
        nb = np.where(kind == self.ALU, 0.0,
                      np.broadcast_to(np.asarray(nbytes, dtype=np.float64),
                                      (k,)))
        vids = self.g.add_vertex_block(cost=1.0, is_mem=is_mem, nbytes=nb,
                                       label=label, n=k)
        base = int(vids[0])

        # 3. RAW-through-memory edges for loads: the most recent in-block
        # store to the same address, else the tracer-wide last writer.
        raw_src: list = []
        raw_dst: list = []
        if len(mem_pos):
            m_addr = addr[mem_pos]
            m_write = kind[mem_pos] == self.STORE
            M = len(mem_pos)
            order = np.lexsort((np.arange(M), m_addr))
            a_s = m_addr[order]
            w_s = m_write[order]
            grp_start = np.empty(M, dtype=bool)
            grp_start[0] = True
            np.not_equal(a_s[1:], a_s[:-1], out=grp_start[1:])
            gid = np.cumsum(grp_start) - 1
            # segmented running "latest write position": tag write positions
            # with gid*M+pos so the cummax never crosses an address group
            t = np.where(w_s, gid * M + np.arange(M), np.int64(-1))
            c = np.maximum.accumulate(t)
            has_w = c >= gid * M
            last_w = np.where(has_w, c - gid * M, -1)
            load_s = ~w_s
            # in-block RAW: map sorted positions back to program positions
            lw = last_w[load_s]
            lpos = mem_pos[order[load_s]]            # program pos of each load
            in_blk = lw >= 0
            raw_src.append(vids[mem_pos[order[lw[in_blk]]]])
            raw_dst.append(vids[lpos[in_blk]])
            # external RAW: last writer before this block, via the dict
            ext_addrs = a_s[load_s][~in_blk]
            ext_dst = vids[lpos[~in_blk]]
            if len(ext_addrs):
                get = self._curr_vs.get
                ext_src = np.fromiter(
                    (get(int(a), -1) for a in ext_addrs),
                    dtype=np.int64, count=len(ext_addrs))
                ok = ext_src >= 0
                raw_src.append(ext_src[ok])
                raw_dst.append(ext_dst[ok])

        # 4. explicit dependency edges
        dep_src: list = []
        dep_dst: list = []
        if deps is not None:
            deps = np.asarray(deps, dtype=np.int64)
            if deps.ndim == 1:
                deps = deps[:, None]
            for j in range(deps.shape[1]):
                col = deps[:, j]
                ok = col >= 0
                dep_src.append(col[ok])
                dep_dst.append(vids[ok])
        src = np.concatenate(raw_src + dep_src) if raw_src or dep_src \
            else np.zeros(0, dtype=np.int64)
        dst = np.concatenate(raw_dst + dep_dst) if raw_dst or dep_dst \
            else np.zeros(0, dtype=np.int64)
        if len(src):
            keep = src != dst
            src, dst = src[keep], dst[keep]
            # dedup (u, v) pairs — the scalar path's per-vertex dep set
            uniq = np.unique(src * np.int64(base + k) + dst)
            src, dst = uniq // (base + k), uniq % (base + k)
            self.g.add_edge_block(src, dst)

        # 5. advance the last-writer map: dict(zip) keeps the latest store
        st_pos = np.flatnonzero(kind == self.STORE)
        if len(st_pos):
            self._curr_vs.update(
                zip(addr[st_pos].tolist(), vids[st_pos].tolist()))
        return vids

    def load_block(self, addrs, nbytes: float = 8.0, deps=None,
                   label: str = "ld") -> np.ndarray:
        """Emit one load vertex per address; returns their vertex ids.

        ``deps`` may carry extra (k,) or (k, d) producer vids (e.g. pointer-
        chase index values); RAW edges from the last writer of each address
        are added automatically."""
        addrs = np.asarray(addrs, dtype=np.int64)
        kind = np.full(len(addrs), self.LOAD, dtype=np.int64)
        return self.emit_block(kind, addrs, nbytes, deps, label)

    def store_block(self, addrs, value_vids=None, nbytes: float = 8.0,
                    label: str = "st") -> np.ndarray:
        """Emit one store vertex per address, depending on ``value_vids``."""
        addrs = np.asarray(addrs, dtype=np.int64)
        kind = np.full(len(addrs), self.STORE, dtype=np.int64)
        return self.emit_block(kind, addrs, nbytes, value_vids, label)

    def alu_block(self, *dep_arrays, n: Optional[int] = None,
                  label: str = "alu") -> np.ndarray:
        """Emit a block of ALU vertices; ``dep_arrays`` are producer vids."""
        if n is None:
            n = len(dep_arrays[0])
        kind = np.full(n, self.ALU, dtype=np.int64)
        deps = (np.column_stack([np.broadcast_to(
            np.asarray(d, dtype=np.int64), (n,)) for d in dep_arrays])
            if dep_arrays else None)
        return self.emit_block(kind, None, 0.0, deps, label)

    def block(self) -> "BlockBuilder":
        """Start an affine loop-nest block (see BlockBuilder)."""
        return BlockBuilder(self)

    # ---------------------------------------------------------------- output
    @property
    def edag(self) -> EDag:
        return self.g


class SlotRef:
    """Handle to one slot (one op per loop iteration) of a BlockBuilder."""

    __slots__ = ("pos",)

    def __init__(self, pos: int):
        self.pos = pos


class BlockBuilder:
    """Affine loop-nest emitter: appends numpy blocks of vertices/edges.

    Describes the *body* of a counted loop as a sequence of slots — one op
    per iteration each — then emits every iteration at once.  Slot
    declaration order is within-iteration program order, and iterations are
    laid out iteration-major, so the emitted vertex/cache-access stream is
    byte-for-byte the order the equivalent scalar loop would produce:

        b = tr.block()
        a   = b.load(A.addr_block(i_idx, k_idx))      # A[i,k] per iteration
        c   = b.load(B.addr_block(k_idx, j_idx))      # B[k,j]
        m   = b.alu(a, c, label="*")
        acc = b.scan(m, init=acc0.vid, label="+")     # loop-carried chain
        out = b.emit()
        final = Value(value, out.last(acc))

    Dependency operands may be SlotRefs (same iteration), absolute vid
    arrays (one producer per iteration), a scalar vid (loop-invariant
    producer), or None (constants).  ``scan`` adds the loop-carried edge
    from the previous iteration's slot vertex (``init`` feeds iteration 0).
    RAW edges through memory are derived by ``emit_block``.

    Spill-model interaction: when the owning ``Tracer`` has a bounded
    register file (``max_regs=K``) or false dependencies enabled, the
    emitted nest replays through the scalar emitters in program order, so
    spill stores/reloads interleave between slot vertices exactly as in
    the per-element API.  ``scan`` orders its loop-carried operand
    *first* for this reason: the reference kernels write
    ``acc = alu(acc, x)`` and the register model touches operands left to
    right, so the accumulator's reload (if it was evicted) lands before
    ``x``'s — keeping block-emitted traces byte-identical to
    ``apps/reference.py`` even under register pressure (§5.1).
    """

    def __init__(self, tr: Tracer):
        self.tr = tr
        self._slots: list = []
        self._n: Optional[int] = None

    # ------------------------------------------------------------- slots
    def _check_n(self, n: int) -> None:
        if self._n is None:
            self._n = int(n)
        elif self._n != n:
            raise ValueError(f"slot length {n} != block length {self._n}")

    def _dep_array(self, dep) -> Optional[np.ndarray]:
        """Normalize one dependency operand to a (n,) int64 vid array."""
        if dep is None:
            return None
        if isinstance(dep, SlotRef):
            return None  # resolved at emit time (needs base vid)
        if np.ndim(dep) == 0:
            v = -1 if dep is None else int(dep)
            return np.full(self._n, v, dtype=np.int64)
        arr = np.asarray(
            [(-1 if d is None else int(d)) for d in dep]
            if not isinstance(dep, np.ndarray) else dep, dtype=np.int64)
        self._check_n(len(arr))
        return arr

    def _add(self, kind, addr, nbytes, deps, label, scan_init=None):
        ref = SlotRef(len(self._slots))
        self._slots.append(dict(kind=kind, addr=addr, nbytes=nbytes,
                                deps=deps, label=label, scan_init=scan_init))
        return ref

    def load(self, addrs, nbytes: float = 8.0, deps=(),
             label: str = "ld") -> SlotRef:
        addrs = np.asarray(addrs, dtype=np.int64).ravel()
        self._check_n(len(addrs))
        return self._add(Tracer.LOAD, addrs, nbytes, list(deps), label)

    def store(self, addrs, value=None, nbytes: float = 8.0,
              label: str = "st") -> SlotRef:
        addrs = np.asarray(addrs, dtype=np.int64).ravel()
        self._check_n(len(addrs))
        deps = [] if value is None else [value]
        return self._add(Tracer.STORE, addrs, nbytes, deps, label)

    def alu(self, *deps, label: str = "alu") -> SlotRef:
        if self._n is None:
            for d in deps:
                if d is not None and not isinstance(d, SlotRef) \
                        and np.ndim(d):
                    self._check_n(len(d))
                    break
        if self._n is None:
            raise ValueError("block length unknown; add a load/store first "
                             "or pass an array operand")
        return self._add(Tracer.ALU, None, 0.0, list(deps), label)

    def scan(self, *deps, init=None, label: str = "alu") -> SlotRef:
        """ALU slot with a loop-carried dependency on its own previous
        iteration (accumulator chains); ``init`` is the vid feeding
        iteration 0 (None for a constant seed)."""
        ref = self.alu(*deps, label=label)
        self._slots[ref.pos]["scan_init"] = -1 if init is None else int(init)
        return ref

    # -------------------------------------------------------------- emit
    def emit(self) -> "BlockResult":
        n, S = self._n, len(self._slots)
        tr = self.tr
        if not S or not n:
            return BlockResult(np.zeros(0, dtype=np.int64), 0, 0)
        base = tr.g.n_vertices
        k = n * S
        kind = np.empty(k, dtype=np.int64)
        addr = np.full(k, -1, dtype=np.int64)
        nbytes = np.zeros(k, dtype=np.float64)
        labels: list = [""] * S
        it = np.arange(n, dtype=np.int64)
        dep_cols: list = []
        for s, slot in enumerate(self._slots):
            kind[s::S] = slot["kind"]
            if slot["addr"] is not None:
                addr[s::S] = slot["addr"]
            nbytes[s::S] = slot["nbytes"]
            labels[s] = slot["label"]
            cols = []
            if slot["scan_init"] is not None:
                # the loop-carried operand comes first: the scalar kernels
                # write ``acc = alu(acc, m)``, and the register-model replay
                # touches operands in column order, so spills/reloads land
                # exactly where the per-element tracer would put them
                prev = base + (it - 1) * S + s
                prev[0] = slot["scan_init"]
                cols.append(prev)
            for dep in slot["deps"]:
                if dep is None:
                    continue
                if isinstance(dep, SlotRef):
                    if dep.pos >= s:
                        raise ValueError("slot dependency must reference an "
                                         "earlier slot")
                    cols.append(base + it * S + dep.pos)
                else:
                    cols.append(self._dep_array(dep))
            for c in cols:
                dep_cols.append((s, c))
        d_max = max((sum(1 for p, _ in dep_cols if p == s)
                     for s in range(S)), default=0)
        deps = np.full((k, d_max), -1, dtype=np.int64)
        col_fill = [0] * S
        for s, c in dep_cols:
            deps[s::S, col_fill[s]] = c
            col_fill[s] += 1
        vids = tr.emit_block(kind, addr, nbytes, deps, labels * n)
        self._slots = []
        self._n = None
        return BlockResult(vids, n, S)


class BlockResult:
    """Vertex ids of an emitted BlockBuilder nest, addressable by slot."""

    def __init__(self, vids: np.ndarray, n: int, n_slots: int):
        self.all_vids = vids
        self.n = n
        self.n_slots = n_slots

    def vids(self, ref: SlotRef) -> np.ndarray:
        """Vertex ids of one slot across all iterations."""
        return self.all_vids[ref.pos::self.n_slots]

    def last(self, ref: SlotRef) -> Optional[int]:
        """Vertex id of the slot in the final iteration (scan results)."""
        v = self.vids(ref)
        return int(v[-1]) if len(v) else None
