"""Execution DAG (eDAG) — the paper's central data structure (§2.1, §2.2, §3.3.1).

Vertices are executed operations (instructions of the scalar frontend);
edges are *true* (RAW) data dependencies.  The structure is append-only and
is finalized into flat numpy arrays on the host; every analysis (T-inf,
memory layering, start/finish schedule, latency sweeps) is one pass of the
level kernel over a tensor on the selected backend's device, exploiting the
invariant that vertices are inserted in a topological order (every edge
satisfies src < dst).

``_finalize`` computes every derived array once — predecessor CSR, successor
CSR, in-degrees, topological levels and the edge partition by destination
level — and caches them.  The longest-path recurrence
``F[v] = base[v] + max(0, max_u F[u])`` runs in the CUDA level kernel (or its
plain version on the CPU) for one cost vector (``_accumulate``) and for a
whole matrix of cost vectors in one level sweep (``_accumulate_batch``).

Storage discipline (million-vertex traces):

* The default build path is *streaming*: scalar appends batch into small
  pending buffers and block appends (``add_vertex_block`` /
  ``add_edge_block``, the tracer's bulk path) land directly as typed numpy
  chunks — no per-element Python objects are ever created.  ``_finalize``
  then runs a counting-sort merge: each edge chunk is stable-sorted by dst
  on its own and chunks whose dst ranges do not interleave (the tracer's
  natural output — every emitted block's edges target the new block's
  vertex range) are simply concatenated, which equals the global stable
  sort without argsorting the full edge stream.  The list-based build
  (``EDag(legacy_build=True)`` or ``$EDAN_LEGACY_BUILD=1``) is kept as the
  bit-identical reference the streaming path is tested against.
* All index arrays (edges, CSR pointers, levels) are stored as **int32** —
  half the memory and device transfer of int64 at paper scale.  Growth past
  the int32 boundary raises ``IndexOverflowError`` (never a silent
  wraparound); ``trace_digest`` hashes a canonical int64 byte encoding, so
  digests are identical across index widths and equal to the reference
  package's on the same trace.
* ``EDag.from_arrays`` adopts already-finalized (dst-sorted) arrays
  zero-copy — the entry point ``core.trace_store`` memory-maps traces
  from disk through; adopted graphs are immutable.
"""
from __future__ import annotations

import hashlib
import os
from collections import OrderedDict

import numpy as np
import torch
from dataclasses import dataclass
from typing import Optional, Sequence

# Cache budget for the (n_vertices, chunk) working set of batched latency
# sweeps; the auto chunk keeps roughly this many bytes live per pass.  The
# crossover bench (benchmarks/perf_core.py::bench_sweep_chunks, gemm N=32 /
# 139k vertices) peaks at chunks of 12-24 (~13-26 MB working set) and falls
# off both at 6 and at 48, so the budget targets the middle of that basin.
_SWEEP_CACHE_BUDGET = 16 * 1024 * 1024
_SWEEP_CHUNK_MIN = 4
_SWEEP_CHUNK_MAX = 24

#: Storage dtype of every index array (edges, CSR pointers, levels).  int32
#: halves index memory and device transfer versus int64; the engine-wide
#: invariant is that every vertex id, edge count and CSR pointer value fits,
#: which `_check_index_limit` enforces at insertion time.
_INDEX_DTYPE = np.int32

#: First count that no longer fits the int32 index space.  Vertex and edge
#: counts must stay strictly below it: CSR pointer values run up to n_edges,
#: and the replay engine's slot chains use the vertex count itself as the
#: zero-sentinel row index.  Tests monkeypatch this module attribute to a
#: small value to exercise the guard wiring without 2^31-element arrays.
_INDEX_LIMIT = 2 ** 31

# Scalar appends batch into pending Python lists of at most this many
# elements before being flushed into a typed numpy chunk.
_CHUNK_FLUSH = 4096


class IndexOverflowError(OverflowError):
    """An eDAG grew past the int32 index space (2^31 - 1 vertices/edges).

    Raised by the build APIs *before* any array could wrap around.
    """


def _check_index_limit(count: int, what: str) -> None:
    """Raise ``IndexOverflowError`` if ``count`` no longer fits the int32
    index discipline (``count >= 2**31``)."""
    if count >= _INDEX_LIMIT:
        raise IndexOverflowError(
            f"eDAG {what} count {count} exceeds the int32 index space "
            f"(max {_INDEX_LIMIT - 1}); indices are stored as int32 and "
            f"silent wraparound would corrupt the CSR.  Trace at a coarser "
            f"block granularity.")


def _auto_sweep_chunk(n_vertices: int) -> int:
    """Trace-size-aware chunk for multi-point sweeps: small traces take the
    whole sweep in one pass, large traces are chunked so the (n, chunk)
    cost matrix stays cache-resident."""
    if n_vertices <= 0:
        return _SWEEP_CHUNK_MAX
    chunk = _SWEEP_CACHE_BUDGET // (8 * n_vertices)
    return int(max(_SWEEP_CHUNK_MIN, min(_SWEEP_CHUNK_MAX, chunk)))


class _ChunkedArray:
    """Append-only growable typed array used by the streaming build path.

    Scalar appends batch into a small pending Python list (flushed to a
    numpy chunk every ``_CHUNK_FLUSH`` elements); block appends land as one
    chunk each.  ``concat`` materializes the single flat array and
    collapses the chunk list onto it, so a later append + re-finalize only
    concatenates the new tail."""

    __slots__ = ("_dtype", "_chunks", "_pend", "_n")

    def __init__(self, dtype) -> None:
        self._dtype = np.dtype(dtype)
        self._chunks: list = []
        self._pend: list = []
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def append(self, x) -> None:
        self._pend.append(x)
        self._n += 1
        if len(self._pend) >= _CHUNK_FLUSH:
            self._flush()

    def extend(self, arr) -> None:
        arr = np.array(arr, dtype=self._dtype, copy=True)  # never alias
        if not len(arr):
            return
        self._flush()
        self._chunks.append(arr)
        self._n += len(arr)

    def _flush(self) -> None:
        if self._pend:
            self._chunks.append(np.asarray(self._pend, dtype=self._dtype))
            self._pend = []

    def concat(self) -> np.ndarray:
        self._flush()
        if not self._chunks:
            return np.zeros(0, dtype=self._dtype)
        out = (self._chunks[0] if len(self._chunks) == 1
               else np.concatenate(self._chunks))
        self._chunks = [out]
        return out


class _EdgeChunks:
    """Chunked CSR-friendly edge storage for the streaming build path.

    Each chunk keeps int32 (src, dst) arrays plus dst-range metadata
    (internal sortedness, min, max).  ``collect`` produces the canonical
    dst-sorted edge arrays via a counting-sort merge: chunks are
    stable-sorted by dst individually and concatenated whenever consecutive
    dst ranges do not interleave (``max(dst_i) <= min(dst_{i+1})``), which
    equals the global stable sort — equal dst values across the boundary
    keep insertion order either way.  Interleaved ranges fall back to one
    global stable (radix) argsort over the original stream."""

    __slots__ = ("_chunks", "_pend_src", "_pend_dst", "_n")

    def __init__(self) -> None:
        self._chunks: list = []     # (src, dst, dst_sorted, dmin, dmax)
        self._pend_src: list = []
        self._pend_dst: list = []
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def append(self, u: int, v: int) -> None:
        self._pend_src.append(u)
        self._pend_dst.append(v)
        self._n += 1
        if len(self._pend_src) >= _CHUNK_FLUSH:
            self._flush()

    def extend(self, src, dst) -> None:
        self._flush()
        s = np.array(src, dtype=_INDEX_DTYPE, copy=True)   # never alias
        self._add_chunk(s, np.array(dst, dtype=_INDEX_DTYPE, copy=True))
        self._n += len(s)

    def _flush(self) -> None:
        # pending elements were already counted by append: _add_chunk
        # only stores, it never touches _n
        if self._pend_src:
            self._add_chunk(
                np.asarray(self._pend_src, dtype=_INDEX_DTYPE),
                np.asarray(self._pend_dst, dtype=_INDEX_DTYPE))
            self._pend_src = []
            self._pend_dst = []

    def _add_chunk(self, s: np.ndarray, d: np.ndarray) -> None:
        if not len(d):
            return
        srt = bool((d[1:] >= d[:-1]).all())
        self._chunks.append((s, d, srt, int(d.min()), int(d.max())))

    def collect(self):
        """Return the (src, dst) edge arrays in canonical dst-sorted order
        (the exact permutation of a global stable sort by dst)."""
        self._flush()
        chunks = self._chunks
        if not chunks:
            z = np.zeros(0, dtype=_INDEX_DTYPE)
            return z, z.copy()
        merge_ok = all(chunks[i][4] <= chunks[i + 1][3]
                       for i in range(len(chunks) - 1))
        if merge_ok:
            ss, ds = [], []
            for s, d, srt, _, _ in chunks:
                if not srt:
                    o = np.argsort(d, kind="stable")
                    s, d = s[o], d[o]
                ss.append(s)
                ds.append(d)
            src = ss[0] if len(ss) == 1 else np.concatenate(ss)
            dst = ds[0] if len(ds) == 1 else np.concatenate(ds)
        else:
            src = np.concatenate([c[0] for c in chunks])
            dst = np.concatenate([c[1] for c in chunks])
            o = np.argsort(dst, kind="stable")
            src, dst = src[o], dst[o]
        # collapse to one sorted chunk: a later append + re-finalize merges
        # against this prefix instead of re-sorting it (stable-sorting a
        # prefix preserves the insertion order of equal dst values, so the
        # collapsed form sorts to the same global permutation)
        self._chunks = [(src, dst, True,
                         int(dst[0]) if len(dst) else 0,
                         int(dst[-1]) if len(dst) else 0)]
        return src, dst


def _legacy_build_default() -> bool:
    v = os.environ.get("EDAN_LEGACY_BUILD", "").strip().lower()
    return v in ("1", "true", "yes", "on")


@dataclass
class MemLayering:
    """Result of the §3.3.1 layer decomposition.

    ``level[v]`` is the number of memory vertices on the heaviest
    (memory-vertex-count) path ending at ``v``, inclusive of ``v`` when it is
    itself a memory vertex.  Memory vertex ``v`` therefore belongs to layer
    ``level[v]`` (1-based); ``depth`` is the paper's memory depth D and
    ``work`` its memory work W.  ``layer_sizes[i]`` is W_{i+1}.
    """

    level: np.ndarray
    depth: int
    work: int
    layer_sizes: np.ndarray

    @property
    def D(self) -> int:  # noqa: N802 - paper notation
        return self.depth

    @property
    def W(self) -> int:  # noqa: N802 - paper notation
        return self.work


class EDag:
    """Append-only execution DAG with topological-order analyses.

    ``legacy_build=True`` (or ``$EDAN_LEGACY_BUILD=1``) selects the
    Python-list build path, the bit-identical reference of the default
    streaming path."""

    def __init__(self, *, legacy_build: Optional[bool] = None) -> None:
        self._legacy = (_legacy_build_default() if legacy_build is None
                        else bool(legacy_build))
        if self._legacy:
            self._cost: list = []
            self._is_mem: list = []
            self._nbytes: list = []
            self._label: list = []
            self._src: list = []
            self._dst: list = []
        else:
            self._cost = _ChunkedArray(np.float64)
            self._is_mem = _ChunkedArray(bool)
            self._nbytes = _ChunkedArray(np.float64)
            self._label_runs: list = []   # (count, str) tuples | label lists
            self._labels_cache: Optional[list] = None
            self._edges = _EdgeChunks()
        self._adopted = False
        self._finalized = False
        self._indptr: Optional[np.ndarray] = None
        # per-vertex latency-class overlay (disaggregation planning): not
        # part of the finalized arrays or the trace digest — a class map
        # re-prices vertices, it never changes the graph
        self._mem_class: Optional[np.ndarray] = None
        self._mem_class_names: Optional[list] = None
        self._mem_class_digest_memo: Optional[str] = None

    # ------------------------------------------------------------------ build
    def _mutable(self) -> None:
        if self._adopted:
            raise ValueError(
                "this EDag adopted finalized arrays (EDag.from_arrays / "
                "trace_store) and is immutable")

    def _push_label(self, label: str, count: int) -> None:
        self._labels_cache = None
        runs = self._label_runs
        if runs and isinstance(runs[-1], tuple) and runs[-1][1] == label:
            runs[-1] = (runs[-1][0] + count, label)
        else:
            runs.append((count, label))

    def add_vertex(self, cost: float = 1.0, is_mem: bool = False,
                   nbytes: float = 0.0, label: str = "") -> int:
        """Add a vertex; returns its id.  Ids are assigned in insertion order."""
        self._mutable()
        vid = len(self._cost)
        _check_index_limit(vid + 1, "vertex")
        self._cost.append(float(cost))
        self._is_mem.append(bool(is_mem))
        self._nbytes.append(float(nbytes))
        if self._legacy:
            self._label.append(label)
        else:
            self._push_label(label, 1)
        self._finalized = False
        return vid

    def add_vertex_block(self, cost, is_mem, nbytes, label: str = "",
                         n: Optional[int] = None) -> np.ndarray:
        """Bulk-append ``n`` vertices; returns their contiguous id array.

        ``cost`` / ``is_mem`` / ``nbytes`` may each be a scalar (broadcast) or
        an array of length ``n``; ``label`` is one string shared by the whole
        block or a length-``n`` sequence of per-vertex labels.
        """
        self._mutable()
        if n is None:
            for arr in (cost, is_mem, nbytes):
                if np.ndim(arr):
                    n = len(arr)
                    break
            else:
                raise ValueError("block size not inferable from scalars")
        base = len(self._cost)
        _check_index_limit(base + n, "vertex")
        if not isinstance(label, str) and len(label) != n:
            raise ValueError("label sequence length mismatch")
        cost_b = np.broadcast_to(np.asarray(cost, dtype=np.float64), (n,))
        mem_b = np.broadcast_to(np.asarray(is_mem, dtype=bool), (n,))
        nb_b = np.broadcast_to(np.asarray(nbytes, dtype=np.float64), (n,))
        if self._legacy:
            self._cost.extend(cost_b.tolist())
            self._is_mem.extend(mem_b.tolist())
            self._nbytes.extend(nb_b.tolist())
            self._label.extend([label] * n if isinstance(label, str)
                               else label)
            self._finalized = False
            return np.arange(base, base + n, dtype=np.int64)
        self._cost.extend(cost_b)
        self._is_mem.extend(mem_b)
        self._nbytes.extend(nb_b)
        if isinstance(label, str):
            self._push_label(label, n)
        else:
            self._labels_cache = None
            arr = np.asarray(label)
            if arr.ndim == 1 and arr.dtype.kind in "US":
                # Per-vertex label lists dominate resident Python-object
                # overhead at million-vertex scale (one str per vertex);
                # store them as int32 codes into a tiny palette instead.
                pal, codes = np.unique(arr, return_inverse=True)
                self._label_runs.append((codes.astype(np.int32),
                                         pal.tolist()))
            else:
                self._label_runs.append(list(label))
        self._finalized = False
        return np.arange(base, base + n, dtype=np.int64)

    def add_edge(self, u: int, v: int) -> None:
        """Add the true-dependency edge u -> v.  Requires u < v (topo insert)."""
        self._mutable()
        if not (0 <= u < v < len(self._cost)):
            raise ValueError(f"edge ({u},{v}) violates topological insertion order")
        _check_index_limit(self.n_edges + 1, "edge")
        if self._legacy:
            self._src.append(u)
            self._dst.append(v)
        else:
            self._edges.append(int(u), int(v))
        self._finalized = False

    def add_edge_block(self, src, dst) -> None:
        """Bulk-append edges.  Every edge must satisfy 0 <= src < dst < n."""
        self._mutable()
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if src.shape != dst.shape:
            raise ValueError("src/dst length mismatch")
        if src.size == 0:
            return
        n = len(self._cost)
        if not ((src >= 0).all() and (src < dst).all() and (dst < n).all()):
            bad = np.nonzero(~((src >= 0) & (src < dst) & (dst < n)))[0][0]
            raise ValueError(
                f"edge ({src[bad]},{dst[bad]}) violates topological insertion order")
        _check_index_limit(self.n_edges + len(src), "edge")
        if self._legacy:
            self._src.extend(src.tolist())
            self._dst.extend(dst.tolist())
        else:
            self._edges.extend(src, dst)
        self._finalized = False

    # --------------------------------------------------------------- finalize
    def _finalize(self) -> None:
        if self._finalized:
            return
        if self._legacy:
            cost = np.asarray(self._cost, dtype=np.float64)
            is_mem = np.asarray(self._is_mem, dtype=bool)
            nbytes = np.asarray(self._nbytes, dtype=np.float64)
            src = np.asarray(self._src, dtype=np.int64)
            dst = np.asarray(self._dst, dtype=np.int64)
            if len(dst) and np.any(np.diff(dst) < 0):   # keep CSR by dst
                order = np.argsort(dst, kind="stable")
                src, dst = src[order], dst[order]
            src = src.astype(_INDEX_DTYPE)
            dst = dst.astype(_INDEX_DTYPE)
        else:
            cost = self._cost.concat()
            is_mem = self._is_mem.concat()
            nbytes = self._nbytes.concat()
            src, dst = self._edges.collect()
        self._install(cost, is_mem, nbytes, src, dst)

    def _install(self, cost, is_mem, nbytes, src, dst,
                 derived: Optional[dict] = None) -> None:
        """Install finalized arrays and compute (or adopt) every derived
        structure: CSRs, in-degrees, levels and the level partition.
        ``src``/``dst`` must already be in canonical dst-sorted order."""
        self.cost = cost
        self.is_mem = is_mem
        self.nbytes = nbytes
        self.src, self.dst = src, dst
        n = len(cost)
        d = derived or {}
        if "indptr" in d:
            self._indptr = d["indptr"]
        else:
            counts = (np.bincount(dst, minlength=n) if len(dst)
                      else np.zeros(n, dtype=np.int64))
            self._indptr = np.concatenate(
                ([0], np.cumsum(counts))).astype(_INDEX_DTYPE)

        # successor CSR (edges sorted by src) — hoisted here from the
        # scheduler so repeated `simulate` calls share one build
        if "succ_dst" in d:
            self.succ_dst = d["succ_dst"]
            self.succ_indptr = d["succ_indptr"]
        else:
            order = np.argsort(src, kind="stable")
            self.succ_dst = dst[order]
            scounts = (np.bincount(src, minlength=n) if len(src)
                       else np.zeros(n, dtype=np.int64))
            self.succ_indptr = np.concatenate(
                ([0], np.cumsum(scounts))).astype(_INDEX_DTYPE)
        self.indeg = np.diff(self._indptr)
        self._sim_lists_cache = None

        # topological levels via level-synchronous Kahn: level[v] = length of
        # the longest edge path ending at v; all preds of a level-l vertex
        # live in levels < l, which is what licenses the segmented updates.
        if "level" in d:
            level = d["level"]
        else:
            level = np.zeros(n, dtype=_INDEX_DTYPE)
            indeg = self.indeg.copy()
            frontier = np.nonzero(indeg == 0)[0]
            lvl = 0
            while frontier.size:
                level[frontier] = lvl
                starts = self.succ_indptr[frontier]
                counts = self.succ_indptr[frontier + 1] - starts
                total = int(counts.sum())
                if total == 0:
                    break
                # gather the concatenated out-edge ranges of the frontier
                offs = np.repeat(np.cumsum(counts) - counts, counts)
                idx = np.repeat(starts, counts) + np.arange(total) - offs
                targets = self.succ_dst[idx]
                cand, cnt = np.unique(targets, return_counts=True)
                indeg[cand] -= cnt
                frontier = cand[indeg[cand] == 0]
                lvl += 1
        self.level = level
        self.n_levels = int(level.max()) + 1 if n else 0

        # partition edges by destination level (ascending), sorted by dst
        # within each level.  Every in-edge of a vertex lands in that
        # vertex's own level slice, so one segmented max per run of equal
        # dst fully resolves F[dst] for the level.  The same partition
        # builder serves the simulator's order-augmented replay graphs.
        from .backend import LevelCSR, build_level_partition
        if "esrc" in d:
            lv = LevelCSR(n=n, n_levels=self.n_levels, esrc=d["esrc"],
                          run_dst=d["run_dst"], run_starts=d["run_starts"],
                          run_lens=d["run_lens"], run_ptr=d["run_ptr"],
                          elevel_ptr=d["elevel_ptr"])
        else:
            lv = build_level_partition(src, dst, level, n)
        self._level_csr_cache = lv
        self._trace_digest: Optional[str] = None
        self._replay_plans: OrderedDict = OrderedDict()
        # device copies of the arrays above (``_device_is_mem``, the
        # scheduler's ``_graph_dev``) describe the previous finalize
        self._is_mem_dev = None
        self._sched_dev = None
        self._esrc_lv = lv.esrc
        self._elevel_ptr = lv.elevel_ptr
        self._run_starts = lv.run_starts
        self._run_dst = lv.run_dst
        self._run_lens = lv.run_lens
        self._run_ptr = lv.run_ptr
        self._finalized = True

    @classmethod
    def from_arrays(cls, cost, is_mem, nbytes, src, dst, *,
                    labels: Optional[Sequence[str]] = None,
                    derived: Optional[dict] = None) -> "EDag":
        """Adopt finalized arrays without going through the append path.

        The arrays are adopted as-is — memory-mapped inputs stay
        memory-mapped.  ``src``/``dst`` must be in canonical dst-sorted
        order (verified; out-of-order inputs are stable-sorted, which
        materializes a copy).  ``derived`` may carry precomputed derived
        arrays (``level``, ``indptr``, ``succ_dst``/``succ_indptr``,
        ``esrc``/``elevel_ptr``/``run_starts``/``run_dst``/``run_lens``/
        ``run_ptr``) to skip their recomputation.  The resulting graph is
        finalized and immutable (the build APIs raise)."""
        cost = np.asarray(cost, dtype=np.float64)
        is_mem = np.asarray(is_mem, dtype=bool)
        nbytes = np.asarray(nbytes, dtype=np.float64)
        src = np.asarray(src, dtype=_INDEX_DTYPE)
        dst = np.asarray(dst, dtype=_INDEX_DTYPE)
        n = len(cost)
        _check_index_limit(n, "vertex")
        _check_index_limit(len(src), "edge")
        if len(is_mem) != n or len(nbytes) != n:
            raise ValueError("vertex array length mismatch")
        if src.shape != dst.shape or src.ndim != 1:
            raise ValueError("src/dst shape mismatch")
        if labels is not None and len(labels) != n:
            raise ValueError("label sequence length mismatch")
        if len(src):
            if not ((src >= 0).all() and (src < dst).all()
                    and (int(dst.max()) < n)):
                raise ValueError("edges violate topological insertion order")
            if np.any(np.diff(dst) < 0):
                order = np.argsort(dst, kind="stable")
                src, dst = src[order], dst[order]
        g = cls()
        g._adopted = True
        g._labels: Optional[list] = list(labels) if labels is not None \
            else None
        g._install(cost, is_mem, nbytes, src, dst, derived=derived)
        return g

    def _level_csr(self):
        """The finalize-time edge partition as a ``backend.LevelCSR`` view
        (the structure the level kernel consumes)."""
        self._finalize()
        return self._level_csr_cache

    def _sim_lists(self):
        """Successor CSR + in-degrees as C-contiguous int32 memoryviews,
        cached for the discrete-event simulator's inner loop.  Scalar
        indexing of a memoryview returns plain Python ints at near-list
        speed with none of the ~28 bytes/element Python-object overhead of
        ``.tolist()`` — the difference between ~13 MB and ~100 MB of loop
        state on a million-vertex trace.  The in-degree entry is the
        numpy array itself; the event loop copies it per run (it is
        mutated)."""
        self._finalize()
        if self._sim_lists_cache is None:
            self._sim_lists_cache = (
                memoryview(np.ascontiguousarray(self.succ_dst,
                                                dtype=_INDEX_DTYPE)),
                memoryview(np.ascontiguousarray(self.succ_indptr,
                                                dtype=_INDEX_DTYPE)),
                np.ascontiguousarray(self.indeg, dtype=_INDEX_DTYPE))
        return self._sim_lists_cache

    # ------------------------------------------------------------- properties
    @property
    def n_vertices(self) -> int:
        if self._adopted:
            return len(self.cost)
        return len(self._cost)

    @property
    def n_edges(self) -> int:
        if self._adopted:
            return len(self.src)
        return len(self._src) if self._legacy else len(self._edges)

    def labels(self) -> Sequence[str]:
        if self._adopted:
            if self._labels is None:
                self._labels = [""] * self.n_vertices
            return self._labels
        if self._legacy:
            return self._label
        if self._labels_cache is None:
            out: list = []
            for r in self._label_runs:
                if isinstance(r, tuple):
                    if isinstance(r[1], str):       # (count, str) run
                        out.extend([r[1]] * r[0])
                    else:                           # (codes, palette) block
                        pal = r[1]
                        out.extend(pal[c] for c in r[0].tolist())
                else:
                    out.extend(r)
            self._labels_cache = out
        return self._labels_cache

    def preds(self, v: int) -> np.ndarray:
        self._finalize()
        lo, hi = self._indptr[v], self._indptr[v + 1]
        return self.src[lo:hi]

    def trace_digest(self) -> str:
        """Stable content hash of the simulation-relevant trace state.

        Covers exactly what the §4 simulator's schedule depends on —
        vertex count, the (canonically dst-sorted) edge list and the
        memory classification ``is_mem``.  Costs, byte counts and labels
        do not enter (the machine model prices vertices from alpha/unit,
        not ``cost``), so relabeling a trace keeps its digest.  Any
        mutation through ``add_vertex*`` / ``add_edge*`` invalidates the
        memo and yields a new digest.

        Edges are hashed through a canonical int64 byte encoding
        regardless of storage dtype, so digests are identical across index
        widths and equal to the reference package's on the same trace.
        """
        self._finalize()
        if self._trace_digest is None:
            h = hashlib.sha256()
            h.update(np.int64(self.n_vertices).tobytes())
            h.update(np.ascontiguousarray(self.src, dtype=np.int64).tobytes())
            h.update(np.ascontiguousarray(self.dst, dtype=np.int64).tobytes())
            h.update(np.packbits(self.is_mem).tobytes())
            self._trace_digest = h.hexdigest()
        return self._trace_digest

    # ------------------------------------------------------- latency classes
    def set_mem_classes(self, classes, names: Optional[Sequence[str]] = None
                        ) -> None:
        """Tag every vertex with a latency class id (local/remote/pooled…).

        ``classes`` is a length-``n_vertices`` integer array (``None``
        clears the overlay — scalar-alpha semantics).  Class ids of
        non-memory vertices are ignored (they always cost ``unit``), but
        memory vertices must stay below the number of columns of any
        class-vector alpha row later swept over this graph.  ``names``
        optionally labels the classes (e.g. ``["local", "remote"]``) for
        reports.  The overlay is *orthogonal to the trace digest*: it
        re-prices vertices without changing the graph, so scalar-alpha
        schedule-cache entries stay valid; class-vector replay plans are
        keyed by ``mem_class_digest`` instead and memoized in-process
        only."""
        if classes is None:
            self._mem_class = None
            self._mem_class_names = None
            self._mem_class_digest_memo = None
            return
        classes = np.ascontiguousarray(
            np.asarray(classes, dtype=_INDEX_DTYPE))
        if classes.ndim != 1 or len(classes) != self.n_vertices:
            raise ValueError(
                f"class map must be a ({self.n_vertices},) integer array, "
                f"got shape {classes.shape}")
        if len(classes) and int(classes.min()) < 0:
            raise ValueError("class ids must be >= 0")
        self._mem_class = classes
        self._mem_class_names = list(names) if names is not None else None
        self._mem_class_digest_memo = None

    @property
    def mem_classes(self) -> Optional[np.ndarray]:
        """The per-vertex latency-class overlay, or ``None`` (scalar)."""
        return self._mem_class

    @property
    def mem_class_names(self) -> Optional[list]:
        return self._mem_class_names

    def n_mem_classes(self) -> int:
        """Number of latency classes the overlay uses (1 when unset)."""
        c = self._mem_class
        if c is None or not len(c):
            return 1
        return int(c.max()) + 1

    def mem_class_digest(self) -> str:
        """Stable hash of the class overlay (the in-process key for
        class-vector replay plans).  ``"scalar"`` when no overlay is set —
        distinct from every sha256 hex digest."""
        if self._mem_class is None:
            return "scalar"
        if self._mem_class_digest_memo is None:
            h = hashlib.sha256()
            h.update(np.ascontiguousarray(self._mem_class,
                                          dtype=np.int64).tobytes())
            self._mem_class_digest_memo = h.hexdigest()
        return self._mem_class_digest_memo

    def mem_class_column(self, n_classes: int) -> np.ndarray:
        """Per-vertex gather index for class-vector cost columns.

        Validates the overlay against alpha rows of width ``n_classes``
        and zeroes the (ignored) class ids of non-memory vertices so the
        gather ``alphas.T[cls]`` is always in range.  An unset overlay
        maps every vertex to class 0 — a one-class alpha row then prices
        exactly like the scalar path."""
        self._finalize()
        cls = self._mem_class
        if cls is None:
            return np.zeros(self.n_vertices, dtype=_INDEX_DTYPE)
        if len(cls) != self.n_vertices:
            raise ValueError(
                f"class map length {len(cls)} no longer matches the eDAG "
                f"({self.n_vertices} vertices); call set_mem_classes again")
        cls = np.where(self.is_mem, cls, 0).astype(_INDEX_DTYPE)
        hi = int(cls.max()) if len(cls) else 0
        if hi >= n_classes:
            raise ValueError(
                f"alpha rows carry {n_classes} class columns but the "
                f"class map uses id {hi}")
        return cls

    # -------------------------------------------------------------- analyses
    def _device_is_mem(self, device: torch.device) -> torch.Tensor:
        """``is_mem`` as a bool tensor on ``device`` (memoized)."""
        memo = getattr(self, "_is_mem_dev", None)
        if memo is None or memo[0] != str(device):
            memo = (str(device), torch.from_numpy(
                np.array(self.is_mem, dtype=bool)).to(device))
            self._is_mem_dev = memo
        return memo[1]

    def _accumulate(self, base: np.ndarray,
                    backend: Optional[str] = None) -> np.ndarray:
        """F[v] = base[v] + max(0, F[u] for u in preds(v)).

        One pass of the level kernel over a single column with the clamp
        on.  This single recurrence yields finish times (base=cost),
        memory levels (base=is_mem) and other longest-path style
        recurrences; the predecessor maxima clamp at 0 (a vertex can
        always start at time 0)."""
        self._finalize()
        base = np.asarray(base, dtype=np.float64)
        if len(self._esrc_lv) == 0:
            return base.copy()
        from .backend import device_for, level_accumulate
        dev = device_for(backend)
        F = torch.from_numpy(np.array(base, dtype=np.float64)).to(dev)
        level_accumulate(self._level_csr(), F.view(-1, 1), clamp=True,
                         backend=backend)
        return F.cpu().numpy()

    def _accumulate_batch(self, base: np.ndarray) -> np.ndarray:
        """Batched longest-path recurrence over a cost matrix.

        ``base`` has shape (n_sweep, n): one cost vector per sweep point.
        Returns F of the same shape, computed in a single level pass.
        """
        self._finalize()
        base = np.atleast_2d(np.asarray(base, dtype=np.float64))
        if base.shape[1] != self.n_vertices:
            raise ValueError(f"cost matrix must have {self.n_vertices} columns")
        from .backend import device_for
        F = torch.from_numpy(np.ascontiguousarray(base.T)).to(device_for())
        return self._accumulate_batch_nk(F).cpu().numpy().T

    def _accumulate_batch_nk(self, F: torch.Tensor,
                             backend: Optional[str] = None) -> torch.Tensor:
        """In-place batched recurrence over an (n, n_sweep) cost tensor on
        the backend's device, through the level kernel."""
        self._finalize()
        from .backend import level_accumulate
        return level_accumulate(self._level_csr(), F, clamp=True,
                                backend=backend)

    def t1(self) -> float:
        """Total work T1 = sum of vertex costs (§2.2)."""
        self._finalize()
        return float(self.cost.sum())

    def finish_times(self, cost: Optional[np.ndarray] = None) -> np.ndarray:
        self._finalize()
        return self._accumulate(self.cost if cost is None else cost)

    def finish_times_batch(self, costs: np.ndarray) -> np.ndarray:
        """Finish times for a (n_sweep, n) matrix of cost vectors at once."""
        return self._accumulate_batch(costs)

    def t_inf(self, cost: Optional[np.ndarray] = None) -> float:
        """Span / critical-path length T-inf (§2.2)."""
        F = self.finish_times(cost)
        return float(F.max()) if len(F) else 0.0

    def t_inf_batch(self, costs: np.ndarray) -> np.ndarray:
        """Span for each row of a (n_sweep, n) cost matrix, one level pass."""
        self._finalize()
        costs = np.atleast_2d(np.asarray(costs, dtype=np.float64))
        if costs.shape[1] == 0:
            return np.zeros(costs.shape[0])
        from .backend import device_for
        F = torch.from_numpy(np.ascontiguousarray(costs.T)).to(device_for())
        return self._accumulate_batch_nk(F).amax(dim=0).cpu().numpy()

    def t_inf_sweep_mem(self, alphas, unit: float = 1.0,
                        chunk: Optional[int] = None,
                        backend: Optional[str] = None,
                        replay_dtype: Optional[str] = None, *,
                        policy=None) -> np.ndarray:
        """Span at each alpha for the standard memory cost model
        (alpha for RAM-access vertices, ``unit`` otherwise) — builds the
        (n, n_sweep) cost matrix directly, skipping the transpose copy.

        Points are processed ``chunk`` at a time to keep the (n, chunk)
        working set cache-resident on large traces; by default the chunk
        is picked from the trace size (``_auto_sweep_chunk``), so small
        traces run the whole sweep in one pass.

        The cost pattern is the replay pattern (alpha / unit columns),
        so the pass dispatches through ``backend.replay_accumulate`` under
        the policy's backend and replay dtype: the cost matrix is built on
        the device and only the (k,) spans come back, bit-identical to the
        float64 pass under every policy.

        ``alphas`` may also be an ``(n_sweep, n_classes)`` matrix of
        latency-class vectors: each memory vertex is then priced by its
        class's alpha (``set_mem_classes``) via a per-vertex gather."""
        self._finalize()
        from .backend import column_quanta
        from .plan import ExecPolicy
        pol = ExecPolicy.resolve(backend=backend, replay_dtype=replay_dtype,
                                 policy=policy)
        alphas = np.asarray(alphas, dtype=np.float64)
        if self.n_vertices == 0 or len(alphas) == 0:
            return np.zeros(len(alphas))
        dev = pol.device()
        mem = self._device_is_mem(dev)[:, None]
        cls = (torch.from_numpy(self.mem_class_column(alphas.shape[1])
                                ).to(dev)
               if alphas.ndim == 2 else None)
        chunk = (_auto_sweep_chunk(self.n_vertices) if chunk is None
                 else max(int(chunk), 1))
        lv = self._level_csr()
        out = []
        for i in range(0, len(alphas), chunk):
            a = torch.from_numpy(np.ascontiguousarray(alphas[i:i + chunk])
                                 ).to(dev)
            cost = a.T[cls] if cls is not None else a[None, :]
            F = torch.where(mem, cost, float(unit)).contiguous()
            pol.accumulate(lv, F,
                           column_quanta(alphas[i:i + chunk], unit),
                           clamp=True)
            out.append(F.amax(dim=0).cpu().numpy())
        return np.concatenate(out)

    def start_finish(self, cost: Optional[np.ndarray] = None):
        """Eq 6-7: greedy unlimited-parallelism start/finish times S(v), F(v)."""
        self._finalize()
        c = self.cost if cost is None else np.asarray(cost, dtype=np.float64)
        F = self._accumulate(c)
        S = F - c
        return S, F

    def parallelism(self) -> float:
        """Average degree of parallelism T1 / T-inf (§2.2)."""
        ti = self.t_inf()
        return self.t1() / ti if ti > 0 else 0.0

    def mem_layers(self, is_mem: Optional[np.ndarray] = None) -> MemLayering:
        """§3.3.1 layer decomposition of memory-access vertices.

        ``is_mem`` may override the stored memory classification (the HLO
        frontend uses this to layer *collectives on one mesh axis*)."""
        self._finalize()
        mem = self.is_mem if is_mem is None else np.asarray(is_mem, dtype=bool)
        level = self._accumulate(mem.astype(np.float64)).astype(np.int64)
        mem_levels = level[mem]
        depth = int(mem_levels.max()) if mem_levels.size else 0
        work = int(mem.sum())
        sizes = (np.bincount(mem_levels, minlength=depth + 1)[1:]
                 if depth else np.zeros(0, dtype=np.int64))
        return MemLayering(level=level, depth=depth, work=work, layer_sizes=sizes)

    def critical_path(self, cost: Optional[np.ndarray] = None) -> list:
        """One critical path (vertex ids, topologically ordered)."""
        self._finalize()
        c = self.cost if cost is None else np.asarray(cost, dtype=np.float64)
        F = self._accumulate(c)
        if not len(F):
            return []
        v = int(np.argmax(F))
        path = [v]
        while True:
            ps = self.preds(v)
            if not len(ps):
                break                     # reached a source vertex
            # the max-finish predecessor lies on the critical path:
            # F[v] = c[v] + max_u F[u] by construction
            u = int(ps[np.argmax(F[ps])])
            v = u
            path.append(v)
        path.reverse()
        return path

    # ------------------------------------------------------------------ misc
    def subgraph_stats(self) -> dict:
        self._finalize()
        return dict(n_vertices=self.n_vertices, n_edges=self.n_edges,
                    n_mem=int(self.is_mem.sum()),
                    bytes_total=float(self.nbytes.sum()))

    def array_nbytes(self) -> dict:
        """Bytes of every finalized and derived host array: the graph's
        CSR footprint, which the service's batch packing charges."""
        self._finalize()
        lv = self._level_csr_cache
        arrs = dict(cost=self.cost, is_mem=self.is_mem, nbytes=self.nbytes,
                    src=self.src, dst=self.dst, indptr=self._indptr,
                    succ_dst=self.succ_dst, succ_indptr=self.succ_indptr,
                    indeg=self.indeg, level=self.level, esrc=lv.esrc,
                    elevel_ptr=lv.elevel_ptr, run_starts=lv.run_starts,
                    run_dst=lv.run_dst, run_lens=lv.run_lens,
                    run_ptr=lv.run_ptr)
        return {k: int(v.nbytes) for k, v in arrs.items()}


def concat_edags(graphs: Sequence[EDag]) -> EDag:
    """Block-diagonal union of K eDAGs: member k's vertex ``v`` becomes
    union vertex ``offsets[k] + v``.

    Each member keeps its insertion order and every edge is offset with its
    block, so the union keeps the topological insertion invariant (src <
    dst) and no edge crosses a block boundary.  Because the blocks are
    disconnected, every level-synchronous analysis of the union restricted
    to block k is bit-identical to analyzing member k alone, while the
    levels of independent members interleave: the level kernel sees wider
    levels and ``max_k n_levels_k`` serial steps instead of ``sum_k``.
    ``EDagSuite`` (``core/suite.py``) maps union results back to
    members."""
    u = EDag()
    for g in graphs:
        g._finalize()
        n = g.n_vertices
        if n == 0:
            continue
        base = u.add_vertex_block(g.cost, g.is_mem, g.nbytes,
                                  label=list(g.labels()), n=n)[0]
        if len(g.src):
            u.add_edge_block(g.src + np.int64(base), g.dst + np.int64(base))
    return u
