"""Discrete-event simulator standing in for gem5 (§4) — batched across sweeps.

Memory-access vertices occupy one of ``m`` memory issue slots for ``alpha``
cycles; other vertices execute with ``unit`` cost on unbounded (or
``compute_slots``-bounded) ALU slots.

Two engines implement the identical machine model:

* ``simulate_reference`` — the per-event heapq loop, host-only numpy, the
  exact-equality oracle and the per-point fallback.

* ``simulate_batch`` — the sweep-batched engine behind ``latency_sweep``.
  All jobs of a resource class share one service time, so the greedy slot
  heap always pops the finish of the job issued ``m`` slots earlier
  (``S_j = max(R_j, F_{j-m})``), and the issue order is the static sort by
  ``(R(v), E(v), v)`` (ready time, largest-vid enabling predecessor, vid).
  One instrumented reference run records the issue orders (the schedule);
  one pass of the level kernel over the order-augmented eDAG (RAW edges
  plus slot chains) then evaluates every sweep point at once, on the
  policy's device, and a check on the same device that the recorded order
  still sorts by ``(R, E, v)`` certifies each point.  F and R never leave
  the device between replay and check; only the (k,) makespans and
  verdicts come to the host.  Points whose order differs are re-recorded
  from a fresh master, so the result is always bit-identical to the
  reference engine per point.

Recorded schedules are reused within one call (all alpha points share one
plan), within one process (a small per-``EDag`` LRU of ``_ReplayPlan``
objects) and across processes (``core/schedule_cache``, keyed by the
trace digest, in the reference package's on-disk formats).  Every reused
schedule goes through the same per-point verification as a fresh one, so
reuse never changes results.  A plan rebuilt from a memory-mapped cache
entry copies the maps once, into its device tensors.

``sweep_grid`` evaluates the full alpha × m × compute_slots product: one
plan per (m, compute_slots) pair and one stacked replay per plan over the
whole alpha axis, chunked under the policy's memory budget.
"""
from __future__ import annotations

import contextlib
import heapq
import time
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from . import backend as _bk
from . import schedule_cache as _sc
from .graph import EDag
from .plan import ExecPolicy, SweepSpec
from .spans import grid_span, span, spanned

# Below this many sweep points the recording run cannot amortize.
_MIN_BATCH_POINTS = 2
# Per-EDag in-process plan memo: one entry per (m, compute_slots) pair.
_PLAN_MEMO_CAP = 8

#: Schedule-reuse counters, shared with ``schedule_cache.stats`` (one
#: object): ``memory_hits`` (plans served from the per-EDag memo),
#: ``disk_hits``, ``misses``, ``record_runs`` (instrumented reference runs),
#: ``record_seconds`` (their serial host time, plan build included),
#: ``stores`` and ``quarantined``.
stats = _sc.stats


# --------------------------------------------------------------- event loop

def _event_loop(is_mem, sim_lists, m: int, alpha: float, unit: float,
                compute_slots: int, record: bool = False):
    """The §3.3.1 greedy event loop (the seed engine), optionally recording
    the schedule: per-vertex finish times and the per-class issue orders.

    ``sim_lists`` carries the successor CSR + in-degrees as int32
    memoryviews/arrays (``EDag._sim_lists``): scalar memoryview indexing
    returns plain Python ints at near-list speed without materializing
    ~28-bytes-per-element ``tolist()`` copies, and the recorded issue
    orders land in preallocated int32 arrays — together this keeps the
    loop's footprint at a few bytes per vertex even on million-vertex
    traces.  The event semantics are the frozen seed reference and must
    never change."""
    sdst_l, sptr_l, indeg0 = sim_lists
    n = len(indeg0)
    indeg_l = memoryview(np.array(indeg0, dtype=np.int32))

    events: list = []       # (finish_time, vid)
    mem_wait: list = []     # (ready_time, vid) heap, FIFO by readiness
    slots: list = [0.0] * m # next free time per memory issue slot
    heapq.heapify(slots)
    alu: list = [0.0] * compute_slots if compute_slots else None
    if alu:
        heapq.heapify(alu)
    if record:
        pops = np.empty(n, dtype=np.int32)
        O_mem = np.empty(n, dtype=np.int32)
        O_alu = np.empty(n if compute_slots else 0, dtype=np.int32)
        n_pops = n_mem = n_alu = 0

    def start(v: int, t: float) -> None:
        nonlocal n_alu
        if is_mem[v]:
            heapq.heappush(mem_wait, (t, v))
        elif alu is not None:
            st = max(t, alu[0])
            heapq.heapreplace(alu, st + unit)
            heapq.heappush(events, (st + unit, v))
            if record:
                O_alu[n_alu] = v
                n_alu += 1
        else:
            heapq.heappush(events, (t + unit, v))

    for v in range(n):
        if not indeg_l[v]:
            start(v, 0.0)

    def drain_mem(now: float) -> None:
        nonlocal n_mem
        # issue every waiting memory access onto the earliest-free slot
        while mem_wait:
            rt, v = mem_wait[0]
            st = max(rt, slots[0])
            heapq.heappop(mem_wait)
            heapq.heapreplace(slots, st + alpha)
            heapq.heappush(events, (st + alpha, v))
            if record:
                O_mem[n_mem] = v
                n_mem += 1

    drain_mem(0.0)
    makespan = 0.0
    while events:
        t, v = heapq.heappop(events)
        makespan = max(makespan, t)
        if record:
            pops[n_pops] = v
            n_pops += 1
        for ei in range(sptr_l[v], sptr_l[v + 1]):
            d = sdst_l[ei]
            indeg_l[d] -= 1
            if indeg_l[d] == 0:
                start(d, t)
        drain_mem(t)
    if record:
        return makespan, pops[:n_pops], O_mem[:n_mem].copy(), \
            O_alu[:n_alu].copy()
    return makespan


def _event_loop_classes(is_mem, sim_lists, m: int, alpha_vec, classes,
                        unit: float, compute_slots: int,
                        record: bool = False):
    """Class-vector twin of ``_event_loop``: memory vertex ``v`` occupies
    its slot for ``alpha_vec[classes[v]]`` cycles.

    Same machine model and event semantics, one extra record: with
    per-vertex service times the homogeneous slot-chain identity
    ``S_j = max(R_j, F_{j-m})`` no longer holds, so the recording tracks
    *slot provenance* instead — ``prov[j]`` is the issue index of the job
    whose finish time was popped off the replace-min slot heap when job
    ``j`` entered service (-1 for a slot still free at t=0).  The replay
    plan wires ``O_mem[prov[j]] -> O_mem[j]`` queue edges through the
    unchanged level kernel and ``_verify_slots`` certifies per column
    that the recorded provenance is a greedy execution for the replayed
    alphas.  The seed loop above stays frozen; this twin only runs in
    class mode.  When every class shares one alpha the popped slot
    *values* coincide with the seed loop's at every step (tuple
    tie-breaks pick a slot, never a value), so makespans collapse
    bit-identically to the scalar engine."""
    sdst_l, sptr_l, indeg0 = sim_lists
    n = len(indeg0)
    indeg_l = memoryview(np.array(indeg0, dtype=np.int32))
    alpha_l = [float(a) for a in alpha_vec]
    cls_l = memoryview(np.ascontiguousarray(classes, dtype=np.int32))

    events: list = []       # (finish_time, vid)
    mem_wait: list = []     # (ready_time, vid) heap, FIFO by readiness
    # (next free time, issue index of the job that freed it; -1 = a slot
    # still free at t=0)
    slots: list = [(0.0, -1)] * m
    heapq.heapify(slots)
    alu: list = [0.0] * compute_slots if compute_slots else None
    if alu:
        heapq.heapify(alu)
    n_mem = 0
    if record:
        pops = np.empty(n, dtype=np.int32)
        O_mem = np.empty(n, dtype=np.int32)
        O_alu = np.empty(n if compute_slots else 0, dtype=np.int32)
        prov = np.empty(n, dtype=np.int32)
        n_pops = n_alu = 0

    def start(v: int, t: float) -> None:
        nonlocal n_alu
        if is_mem[v]:
            heapq.heappush(mem_wait, (t, v))
        elif alu is not None:
            st = max(t, alu[0])
            heapq.heapreplace(alu, st + unit)
            heapq.heappush(events, (st + unit, v))
            if record:
                O_alu[n_alu] = v
                n_alu += 1
        else:
            heapq.heappush(events, (t + unit, v))

    for v in range(n):
        if not indeg_l[v]:
            start(v, 0.0)

    def drain_mem(now: float) -> None:
        nonlocal n_mem
        while mem_wait:
            rt, v = mem_wait[0]
            ft, creator = slots[0]
            st = max(rt, ft)
            heapq.heappop(mem_wait)
            f = st + alpha_l[cls_l[v]]
            heapq.heapreplace(slots, (f, n_mem))
            heapq.heappush(events, (f, v))
            if record:
                O_mem[n_mem] = v
                prov[n_mem] = creator
            n_mem += 1

    drain_mem(0.0)
    makespan = 0.0
    while events:
        t, v = heapq.heappop(events)
        makespan = max(makespan, t)
        if record:
            pops[n_pops] = v
            n_pops += 1
        for ei in range(sptr_l[v], sptr_l[v + 1]):
            d = sdst_l[ei]
            indeg_l[d] -= 1
            if indeg_l[d] == 0:
                start(d, t)
        drain_mem(t)
    if record:
        return makespan, pops[:n_pops], O_mem[:n_mem].copy(), \
            O_alu[:n_alu].copy(), prov[:n_mem].copy()
    return makespan


def simulate_reference(g: EDag, m: int = 4, alpha: float = 200.0,
                       unit: float = 1.0, compute_slots: int = 0) -> float:
    """Simulated makespan via the retained per-event heapq engine.

    This is the seed engine, kept verbatim as the ground truth the batched
    engine is property-tested against (exact float equality)."""
    g._finalize()
    if g.n_vertices == 0:
        return 0.0
    return _event_loop(g.is_mem, g._sim_lists(), m, float(alpha),
                       float(unit), compute_slots)


def simulate_reference_classes(g: EDag, alphas, m: int = 4,
                               unit: float = 1.0,
                               compute_slots: int = 0) -> float:
    """Per-vertex latency-class makespan via the per-event reference loop.

    ``alphas`` is one latency vector indexed by the eDAG's class tags
    (``EDag.set_mem_classes``); vertices without a class map price as
    class 0.  This is the exact-equality oracle the class-mode batched
    engine is property-tested against."""
    g._finalize()
    if g.n_vertices == 0:
        return 0.0
    alphas = np.asarray(alphas, dtype=np.float64)
    cls = g.mem_class_column(len(alphas))
    return _event_loop_classes(g.is_mem, g._sim_lists(), int(m), alphas,
                               cls, float(unit), int(compute_slots))


def simulate(g: EDag, m: int = 4, alpha: float = 200.0,
             unit: float = 1.0, compute_slots: int = 0) -> float:
    """Simulated makespan of the eDAG under the §3.3.1 machine model.

    ``compute_slots``>0 bounds ALU issue width — a realism knob the cost
    model deliberately ignores (its C is latency-independent), standing in
    for gem5's microarchitectural detail in the §4 validation."""
    return simulate_reference(g, m=m, alpha=alpha, unit=unit,
                              compute_slots=compute_slots)


# -------------------------------------------------------------- replay plan

def _slot_qpred(rank: np.ndarray, O_mem: np.ndarray, O_alu: np.ndarray,
                m: int, cs: int, n: int) -> np.ndarray:
    """Queue predecessors implied by the issue orders, in rank space:
    ``qpred[r]`` is the rank of the vertex issued ``m`` (or ``cs``) slots
    earlier on the same resource; vertices without one point at the zero
    sentinel row ``n``."""
    qpred = np.full(n, n, dtype=np.int32)
    if len(O_mem) > m:
        qpred[rank[O_mem[m:]]] = rank[O_mem[:-m]]
    if cs and len(O_alu) > cs:
        qpred[rank[O_alu[cs:]]] = rank[O_alu[:-cs]]
    return qpred


def _prov_qpred(rank: np.ndarray, O_mem: np.ndarray, O_alu: np.ndarray,
                prov: np.ndarray, m: int, cs: int, n: int) -> np.ndarray:
    """Queue predecessors from recorded slot provenance (class mode): job
    ``j``'s slot edge points at the job whose finish was popped when ``j``
    issued (``prov[j]``; -1 is the zero sentinel).  ALU jobs keep the
    homogeneous ``cs``-chain."""
    qpred = np.full(n, n, dtype=np.int32)
    has = np.nonzero(prov >= 0)[0]
    if len(has):
        qpred[rank[O_mem[has]]] = rank[O_mem[prov[has]]]
    if cs and len(O_alu) > cs:
        qpred[rank[O_alu[cs:]]] = rank[O_alu[:-cs]]
    return qpred


def _prov_check_arrays(prov: np.ndarray, m: int):
    """Verification scaffolding for a recorded slot-provenance array:
    ``(prov_ok, t_chk, need_chk)`` as ``_verify_slots`` consumes them.

    ``prov_ok`` is the structural screen — greedy pops the m initial zeros
    first, then only real finishes; ``t_chk[i]`` is the last issue step at
    which finish ``i`` sits in the slot heap, checked for the ``need_chk``
    subset where that window is non-empty."""
    W = len(prov)
    k0 = min(m, W)
    prov_ok = bool(
        (prov[:k0] == -1).all() and
        (W <= k0 or ((prov[k0:] >= 0).all() and
                     (prov[k0:] < np.arange(k0, W)).all())))
    pop_step = np.full(W, W, dtype=np.int64)
    has = np.nonzero(prov >= 0)[0]
    pop_step[prov[has]] = has
    t_chk = np.minimum(pop_step - 1, W - 1)
    need_chk = np.nonzero(t_chk > np.arange(W))[0].astype(np.int64)
    return prov_ok, t_chk, need_chk


def _aug_level_valid(level, asrc: np.ndarray, adst: np.ndarray,
                     n: int) -> bool:
    """Whether a stored level assignment is usable for the augmented
    graph: a 1-D array of n values in ``[0, n)`` (a longest path has at
    most n-1 edges, which also bounds the per-level arrays the partition
    builder allocates) that respects every augmented edge."""
    return (getattr(level, "ndim", 0) == 1 and len(level) == n and
            (n == 0 or (level.min() >= 0 and level.max() < n)) and
            (len(asrc) == 0 or bool((level[asrc] < level[adst]).all())))


def _attach_queue_partition(lv, dst_r: np.ndarray, qpred: np.ndarray,
                            level: np.ndarray) -> None:
    """Attach slot chains to a level partition: ``qpred`` plus the
    by-level partition of vertices whose only predecessor is their queue
    predecessor."""
    n = lv.n
    lv.qpred = qpred
    qdst = np.nonzero(qpred < n)[0]
    qonly = qdst[np.bincount(dst_r, minlength=n)[qdst] == 0]
    if len(qonly):
        qonly = qonly[np.argsort(level[qonly], kind="stable")]
        counts = np.bincount(level[qonly], minlength=lv.n_levels)
        lv.qonly_ptr = np.concatenate(
            ([0], np.cumsum(counts))).astype(np.int32)
        lv.qonly_dst = qonly.astype(np.int32)


def _to_dev(a, device, dtype=None):
    return None if a is None else torch.from_numpy(
        np.array(a, dtype=dtype)).to(device)


def _graph_dev(g: EDag, device: torch.device) -> SimpleNamespace:
    """The predecessor CSR the enabler pass reads, on ``device``
    (memoized on the eDAG)."""
    memo = getattr(g, "_sched_dev", None)
    if memo is None or memo[0] != str(device):
        memo = (str(device), SimpleNamespace(
            indptr=_to_dev(g._indptr, device, np.int64),
            src=_to_dev(g.src, device, np.int64)))
        g._sched_dev = memo
    return memo[1]


class _ReplayPlan:
    """Recorded schedule of one master run, ready for batched replay.

    Holds the order-augmented eDAG in pop-order relabeling (a topological
    order of the augmented graph) as a ``backend.LevelCSR`` on the host,
    plus the issue orders and the arrays the per-point verification needs;
    ``dev(device)`` hands their device copies, made once per device.

    ``level`` may carry a level assignment of the augmented graph made
    earlier (a suite's block build); it is checked against the augmented
    edges and recomputed if it does not respect them.  ``level_aug`` keeps
    the assignment in use, so a suite built later reuses it."""

    __slots__ = ("n", "m", "cs", "topo", "rank", "lv", "is_mem_topo",
                 "O_mem", "O_alu", "Om_rel", "Oa_rel", "level_aug", "prov",
                 "cls_topo", "prov_ok", "t_chk", "need_chk", "_dev")

    def __init__(self, g: EDag, topo: np.ndarray, O_mem: np.ndarray,
                 O_alu: np.ndarray, m: int, cs: int,
                 level: Optional[np.ndarray] = None,
                 prov: Optional[np.ndarray] = None,
                 classes: Optional[np.ndarray] = None):
        n = g.n_vertices
        self.n, self.m, self.cs = n, m, cs
        # the recorded pop order is a linear extension of the augmented
        # DAG: slot chains strictly increase finish times
        rank = np.empty(n, dtype=np.int32)
        rank[topo] = np.arange(n, dtype=np.int32)
        self.topo, self.rank = topo, rank
        self.O_mem, self.O_alu = O_mem, O_alu
        self.Om_rel = rank[O_mem]
        self.Oa_rel = rank[O_alu] if cs else np.zeros(0, dtype=np.int32)
        self.is_mem_topo = g.is_mem[topo]
        self._dev = None

        # class mode: per-vertex class gather column (pop-order space) and
        # the slot-provenance record plus its verification scaffolding
        self.prov = prov
        self.cls_topo = (np.ascontiguousarray(classes[topo])
                         if classes is not None else None)
        if prov is not None:
            self.prov_ok, self.t_chk, self.need_chk = \
                _prov_check_arrays(prov, m)
            qpred = _prov_qpred(rank, O_mem, O_alu, prov, m, cs, n)
        else:
            self.prov_ok = True
            self.t_chk = self.need_chk = None
            qpred = _slot_qpred(rank, O_mem, O_alu, m, cs, n)
        src_r, dst_r = rank[g.src], rank[g.dst]
        qdst = np.nonzero(qpred < n)[0].astype(np.int32)
        asrc = np.concatenate([src_r, qpred[qdst]])
        adst = np.concatenate([dst_r, qdst])
        if level is not None and not _aug_level_valid(level, asrc, adst, n):
            level = None
        if level is None:
            level = _bk.levelize(asrc, adst, n)
        self.level_aug = level
        lv = _bk.build_level_partition(src_r, dst_r, level, n)
        _attach_queue_partition(lv, dst_r, qpred, level)
        self.lv = lv

    def dev(self, device: torch.device) -> SimpleNamespace:
        """The plan's verification arrays as tensors on ``device``."""
        if self._dev is None or self._dev[0] != str(device):
            self._dev = (str(device), SimpleNamespace(
                is_mem_topo=_to_dev(self.is_mem_topo, device, bool),
                cls_topo=_to_dev(self.cls_topo, device, np.int64),
                rank=_to_dev(self.rank, device, np.int64),
                O_mem=_to_dev(self.O_mem, device, np.int64),
                O_alu=_to_dev(self.O_alu, device, np.int64),
                Om_rel=_to_dev(self.Om_rel, device, np.int64),
                Oa_rel=_to_dev(self.Oa_rel, device, np.int64),
                prov=_to_dev(self.prov, device, np.int64),
                t_chk=_to_dev(self.t_chk, device, np.int64),
                need_chk=_to_dev(self.need_chk, device, np.int64)))
        return self._dev[1]

    @spanned("edan.replay")
    def replay(self, alphas: np.ndarray, unit: float,
               policy: Optional[ExecPolicy] = None):
        """Evaluate all points at once: returns finish times F and ready
        times R, both (n+1, k) float64 tensors on the policy's device in
        pop-order vertex space (the last row is the zero sentinel the slot
        chains bottom out on).  The pass runs through
        ``ExecPolicy.accumulate``, so F and R are bit-identical to the
        float64 pass under every dtype policy.

        ``alphas`` may be 2-D ``(k, n_classes)`` on a class-mode plan:
        each memory vertex then gathers its own class's alpha."""
        pol = ExecPolicy.resolve(policy=policy)
        dev = pol.device()
        d = self.dev(dev)
        a = torch.from_numpy(np.ascontiguousarray(alphas,
                                                  dtype=np.float64)).to(dev)
        cost = a.T[d.cls_topo] if alphas.ndim == 2 else a[None, :]
        F = torch.empty((self.n + 1, len(alphas)), dtype=torch.float64,
                        device=dev)
        F[:-1] = torch.where(d.is_mem_topo[:, None], cost, float(unit))
        F[-1] = 0.0
        R = torch.zeros_like(F)
        pol.accumulate(self.lv, F, _bk.column_quanta(alphas, unit),
                       clamp=False, R_out=R)
        return F, R

    def array_nbytes(self) -> dict:
        """Byte sizes of the plan's live host arrays, keyed by name (the
        augmented partition is the same order of size as the trace's own
        CSR)."""
        lv = self.lv
        arrs = dict(topo=self.topo, rank=self.rank, O_mem=self.O_mem,
                    O_alu=self.O_alu, Om_rel=self.Om_rel,
                    Oa_rel=self.Oa_rel, is_mem_topo=self.is_mem_topo,
                    level_aug=self.level_aug, esrc=lv.esrc,
                    run_dst=lv.run_dst, run_starts=lv.run_starts,
                    run_lens=lv.run_lens, run_ptr=lv.run_ptr,
                    elevel_ptr=lv.elevel_ptr)
        for name in ("qpred", "qonly_ptr", "qonly_dst"):
            a = getattr(lv, name, None)
            if a is not None:
                arrs[name] = a
        for name in ("prov", "cls_topo", "t_chk", "need_chk"):
            a = getattr(self, name)
            if a is not None:
                arrs[name] = a
        return {k: int(np.asarray(v).nbytes) for k, v in arrs.items()}


def _enabler_pass(g: EDag, rank: torch.Tensor, F: torch.Tensor,
                  R: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """E(v) = max vid among predecessors u with F(u) == R(v), for the
    vertex subset ``T`` (original ids, sorted, int64 on F's device).
    Returns (|T|, k) int64; -1 rows for vertices with no predecessors.

    Offset stepping over the predecessor lists: step ``off`` compares the
    ``off``-th predecessor of every vertex that has one."""
    gd = _graph_dev(g, F.device)
    out = torch.full((len(T), F.shape[1]), -1, dtype=torch.int64,
                     device=F.device)
    start = gd.indptr[T]
    counts = gd.indptr[T + 1] - start
    if not len(T):
        return out
    RT = R[rank[T]]
    for off in range(int(counts.max())):
        live = torch.nonzero(counts > off).flatten()
        u = gd.src[start[live] + off]
        cand = torch.where(F[rank[u]] == RT[live], u[:, None],
                           torch.full_like(u[:, None], -1))
        out[live] = torch.maximum(out[live], cand)
    return out


def _verify_class(g: EDag, rank: torch.Tensor, F: torch.Tensor,
                  R: torch.Tensor, O: torch.Tensor,
                  O_rel: torch.Tensor) -> torch.Tensor:
    """Check per point, on F's device, that ``O`` is the (R, E, vid)-sorted
    issue order: R nondecreasing along O; at R ties the enabler vid E
    (computed only for the tied positions) and then the vid break the
    tie.  Returns a (k,) bool tensor."""
    k = F.shape[1]
    if len(O) < 2:
        return torch.ones(k, dtype=torch.bool, device=F.device)
    RO = R[O_rel]
    lo, hi = RO[:-1], RO[1:]
    less = lo < hi
    pair_ok = less
    # equality only matters on rows that are not strictly increasing at
    # every point — compute it on those candidates, not the full matrix
    cand = torch.nonzero(~less.all(dim=1)).flatten()
    if len(cand):
        eqc = lo[cand] == hi[cand]
        has_tie = eqc.any(dim=1)
        tie = cand[has_tie]
        if len(tie):
            eqt = eqc[has_tie]
            T = torch.unique(torch.cat([O[tie], O[tie + 1]]))
            E_T = _enabler_pass(g, rank, F, R, T)
            e_lo = E_T[torch.searchsorted(T, O[tie])]
            e_hi = E_T[torch.searchsorted(T, O[tie + 1])]
            v_lo = O[tie][:, None]
            v_hi = O[tie + 1][:, None]
            tie_ok = (e_lo < e_hi) | ((e_lo == e_hi) & (v_lo < v_hi))
            pair_ok = less.clone()
            pair_ok[tie] = torch.where(eqt, tie_ok, less[tie])
    return pair_ok.all(dim=0)


def _verify_slots(plan: _ReplayPlan, F: torch.Tensor) -> torch.Tensor:
    """Check per point, on F's device, that the recorded slot provenance is
    a greedy replace-min execution for this point's finish times (class
    mode): the popped values ``Vo`` are nondecreasing and no finish still
    in the heap at its last resident step ``t_chk[i]`` lies below the
    value popped there."""
    k = F.shape[1]
    W = len(plan.O_mem)
    if W == 0:
        return torch.ones(k, dtype=torch.bool, device=F.device)
    if not plan.prov_ok:
        return torch.zeros(k, dtype=torch.bool, device=F.device)
    d = plan.dev(F.device)
    Fo = F[d.Om_rel]                         # (W, k), issue order
    Vo = torch.zeros_like(Fo)
    has = torch.nonzero(d.prov >= 0).flatten()
    Vo[has] = Fo[d.prov[has]]
    if W > 1:
        ok = ((Vo[1:] - Vo[:-1]) >= 0).all(dim=0)
    else:
        ok = torch.ones(k, dtype=torch.bool, device=F.device)
    nc = d.need_chk
    if len(nc):
        ok &= (Fo[nc] >= Vo[d.t_chk[nc]]).all(dim=0)
    return ok


# ----------------------------------------------------------- schedule reuse

def _memo_plan(g: EDag, key, plan: _ReplayPlan) -> None:
    memo = getattr(g, "_replay_plans", None)
    if memo is None:
        return
    memo[key] = plan
    memo.move_to_end(key)
    while len(memo) > _PLAN_MEMO_CAP:
        memo.popitem(last=False)


def _validate_schedule(g: EDag, m: int, cs: int, topo, O_mem,
                       O_alu) -> Optional[np.ndarray]:
    """Structurally validate a candidate schedule; returns the rank array
    (the inverse of ``topo``) or None.

    ``topo`` must be a permutation that linearizes the DAG edges, the slot
    chains the issue orders imply must run forward in it, and the orders
    must partition the memory / ALU vertex sets.  Whether the candidate is
    the right schedule for a sweep point is then decided by the per-point
    (R, E, vid) verification: a wrong but well-formed schedule costs a
    re-record, never a wrong makespan."""
    n = g.n_vertices
    W = int(g.is_mem.sum())
    for arr in (topo, O_mem, O_alu):
        if getattr(arr, "ndim", 0) != 1:
            return None
    if len(topo) != n or len(O_mem) != W or \
            len(O_alu) != ((n - W) if cs else 0):
        return None
    for arr in (topo, O_mem, O_alu):
        if len(arr) and not ((arr >= 0) & (arr < n)).all():
            return None
    if (np.bincount(topo, minlength=n) != 1).any():
        return None
    rank = np.empty(n, dtype=np.int32)
    rank[topo] = np.arange(n, dtype=np.int32)
    if len(g.src) and not (rank[g.src] < rank[g.dst]).all():
        return None                   # not a linear extension of the eDAG
    # the slot chains must run forward in rank too: with the check above
    # every augmented edge then satisfies src < dst
    if len(O_mem) > m and not \
            (rank[O_mem[:-m]] < rank[O_mem[m:]]).all():
        return None
    if cs and len(O_alu) > cs and not \
            (rank[O_alu[:-cs]] < rank[O_alu[cs:]]).all():
        return None
    if W and (np.bincount(O_mem, minlength=n) !=
              g.is_mem.astype(np.int64)).any():
        return None
    if cs and len(O_alu) and \
            (np.bincount(O_alu, minlength=n) !=
             (~g.is_mem).astype(np.int64)).any():
        return None
    return rank


def _plan_from_cache(g: EDag, m: int, cs: int, topo, O_mem, O_alu,
                     level) -> Optional[_ReplayPlan]:
    """Rebuild a replay plan from persisted arrays, or None if they fail
    ``_validate_schedule``."""
    if _validate_schedule(g, m, cs, topo, O_mem, O_alu) is None:
        return None
    return _ReplayPlan(g, topo, O_mem, O_alu, m, cs, level=level)


def _get_plan(g: EDag, key) -> Optional[_ReplayPlan]:
    """Look up a reusable replay plan: the per-EDag memo, then, for scalar
    keys ``(m, cs, unit)``, the persistent schedule cache.  Class-mode
    plans have no disk format (the overlay is not part of the digest)."""
    memo = getattr(g, "_replay_plans", None)
    if memo is not None and key in memo:
        memo.move_to_end(key)
        stats.add("memory_hits")
        return memo[key]
    if key[0] != "classes" and g.n_vertices >= _sc.min_vertices():
        m, cs, unit = key
        got = _sc.load(g.trace_digest(), m, cs, g.n_vertices, unit)
        if got is not None:
            plan = _plan_from_cache(g, m, cs, *got)
            if plan is not None:
                stats.add("disk_hits")
                _memo_plan(g, key, plan)
                return plan
    stats.add("misses")
    return None


@contextlib.contextmanager
def _recording(rerecord: bool = False):
    """One schedule recording: counted in ``record_runs``, its host time
    added to ``record_seconds``, and spanned as ``edan.sched.record`` (or
    ``edan.sched.rerecord`` for points the plan in hand did not
    certify)."""
    stats.add("record_runs")
    t0 = time.perf_counter()
    with span("edan.sched.rerecord" if rerecord else "edan.sched.record"):
        yield
    stats.add("record_seconds", time.perf_counter() - t0)


def _record_plan(g: EDag, sim_lists, m: int, cs: int, a0: float,
                 unit: float, persist: bool, rerecord: bool = False):
    """One instrumented reference run -> (master makespan, replay plan);
    when ``persist`` the plan is memoized and, for traces of at least
    ``schedule_cache.min_vertices()``, stored on disk."""
    with _recording(rerecord):
        mk0, topo, O_mem, O_alu = _event_loop(
            g.is_mem, sim_lists, m, a0, unit, cs, record=True)
        plan = _ReplayPlan(g, topo, O_mem, O_alu, m, cs)
    if persist:
        _memo_plan(g, (m, cs, float(unit)), plan)
        if g.n_vertices >= _sc.min_vertices():
            _sc.store(g.trace_digest(), m, cs, g.n_vertices, unit,
                      topo, O_mem, O_alu, plan.level_aug)
    return mk0, plan


def _record_plan_classes(g: EDag, sim_lists, m: int, cs: int, a0,
                         cls: np.ndarray, unit: float, key, persist: bool,
                         rerecord: bool = False):
    """Class-mode twin of ``_record_plan`` (slot provenance recorded)."""
    with _recording(rerecord):
        mk0, topo, O_mem, O_alu, prov = _event_loop_classes(
            g.is_mem, sim_lists, m, a0, cls, unit, cs, record=True)
        plan = _ReplayPlan(g, topo, O_mem, O_alu, m, cs, prov=prov,
                           classes=cls)
    if persist:
        _memo_plan(g, key, plan)
    return mk0, plan


def _reference_points(g: EDag, spec: SweepSpec, m: int,
                      cs: int) -> np.ndarray:
    """The degenerate-model path: one reference event loop per caller
    point, literally — no dedupe, no replay."""
    out = np.zeros(spec.n_points)
    sim_lists = g._sim_lists()
    if spec.class_mode:
        cls = g.mem_class_column(spec.alphas.shape[1])
        for i in range(spec.n_points):
            out[i] = _event_loop_classes(g.is_mem, sim_lists, m,
                                         spec.alphas[i], cls, spec.unit, cs)
    else:
        for i, a in enumerate(spec.alphas):
            out[i] = _event_loop(g.is_mem, sim_lists, m, float(a),
                                 spec.unit, cs)
    return out


def _batch_uniq(g: EDag, alphas: np.ndarray, m: int, cs: int, unit: float,
                pol: ExecPolicy, classes: bool = False) -> np.ndarray:
    """The batched engine over a sorted-unique, finite-positive alpha axis
    (scalar alphas, or class-vector rows when ``classes``): record →
    chunked replay → verify on the device → re-record stragglers.

    Class mode records slot provenance (``_event_loop_classes``) and adds
    the slot check to the order check; its plans are memoized under the
    class overlay's digest."""
    P = len(alphas)
    out = np.zeros(P)
    n = g.n_vertices
    sim_lists = g._sim_lists()
    cls = g.mem_class_column(alphas.shape[1]) if classes else None
    key = (("classes", m, cs, float(unit), g.mem_class_digest())
           if classes else (m, cs, float(unit)))
    remaining = np.arange(P)
    plan = _get_plan(g, key) if pol.use_cache else None
    mk0: Optional[float] = None       # master makespan; None for reused plans
    persist = pol.use_cache and plan is None
    first = True                      # no plan has been tried yet
    while remaining.size:
        reused = plan is not None and mk0 is None
        if plan is None:
            a0 = alphas[remaining[0]]
            if classes:
                mk0, plan = _record_plan_classes(g, sim_lists, m, cs, a0, cls,
                                                 unit, key, persist,
                                                 rerecord=not first)
            else:
                mk0, plan = _record_plan(g, sim_lists, m, cs, float(a0),
                                         unit, persist, rerecord=not first)
            # only the sweep's first recording is worth keeping: later
            # ones are per-point fallbacks for tie-shifted orders
            persist = False
        ok = np.zeros(remaining.size, dtype=bool)
        chunk = pol.points_chunk(n, remaining.size)
        for c0 in range(0, remaining.size, chunk):
            sel = remaining[c0:c0 + chunk]
            F, R = plan.replay(alphas[sel], unit, policy=pol)
            with span("edan.verify"):
                d = plan.dev(F.device)
                okc = _verify_class(g, d.rank, F, R, d.O_mem, d.Om_rel)
                if classes:
                    okc &= _verify_slots(plan, F)
                if cs:
                    okc &= _verify_class(g, d.rank, F, R, d.O_alu, d.Oa_rel)
                okc = okc.cpu().numpy()
                mk = F.amax(dim=0).cpu().numpy()
            out[sel[okc]] = mk[okc]
            ok[c0:c0 + chunk] = okc
        if not ok[0] and mk0 is not None:
            # the master's own schedule always certifies; if the check ever
            # disagrees, trust its recorded makespan and keep making progress
            out[remaining[0]] = mk0
            ok[0] = True
        if reused and not ok.all():
            # let the next fresh recording replace the memoized plan
            persist = pol.use_cache
        remaining = remaining[~ok]
        plan, mk0 = None, None
        first = False
    return out


def _batch_for_pair(g: EDag, spec: SweepSpec, m: int, cs: int,
                    pol: ExecPolicy) -> np.ndarray:
    """One (m, compute_slots) configuration over the spec's whole alpha
    axis, results in caller order."""
    if g.n_vertices == 0 or spec.n_points == 0:
        return np.zeros(spec.n_points)
    if spec.degenerate(m):
        return _reference_points(g, spec, m, cs)
    res = _batch_uniq(g, spec.uniq, m, cs, spec.unit, pol,
                      classes=spec.class_mode)
    return spec.restore(res)


def simulate_batch(g: EDag, alphas, m: int = 4, unit: float = 1.0,
                   compute_slots: int = 0,
                   backend: Optional[str] = None,
                   mem_budget: Optional[int] = None,
                   use_cache: bool = True,
                   replay_dtype: Optional[str] = None, *,
                   policy: Optional[ExecPolicy] = None) -> np.ndarray:
    """Simulated makespans for a whole latency sweep in one batched pass.

    Bit-identical to ``[simulate_reference(g, m, a, unit, compute_slots)
    for a in alphas]``: the recorded issue order is re-verified for every
    point, with fresh recordings wherever it shifts.  ``use_cache`` reuses
    recorded schedules within the process; ``mem_budget`` bounds the bytes
    of one stacked replay chunk; ``backend`` / ``replay_dtype`` choose the
    device and the dtype policy.  Unsorted or duplicate ``alphas`` are
    deduped and sorted internally; results come back in caller order.

    ``alphas`` may also be a 2-D ``(P, n_classes)`` matrix of
    latency-class vectors, each point bit-identical to
    ``simulate_reference_classes``."""
    g._finalize()
    pol = ExecPolicy.resolve(backend=backend, replay_dtype=replay_dtype,
                             mem_budget=mem_budget, use_cache=use_cache,
                             policy=policy)
    spec = SweepSpec.make(alphas, ms=(m,), compute_slots=(compute_slots,),
                          unit=unit)
    with grid_span():
        return _batch_for_pair(g, spec, spec.ms[0], spec.css[0], pol)


def latency_sweep(g: EDag, alphas, m: int = 4, unit: float = 1.0,
                  compute_slots: int = 0, batch: Optional[bool] = None,
                  backend: Optional[str] = None,
                  mem_budget: Optional[int] = None,
                  use_cache: bool = True,
                  replay_dtype: Optional[str] = None, *,
                  policy: Optional[ExecPolicy] = None) -> np.ndarray:
    """Simulated makespan across a latency sweep (the §4 gem5 protocol).

    The batched engine evaluates the whole sweep in one level pass
    (``batch=False`` forces the per-point reference loop — bit-identical
    either way).  A 2-D ``(P, n_classes)`` alpha matrix sweeps
    latency-class vectors against the eDAG's class overlay."""
    g._finalize()
    pol = ExecPolicy.resolve(backend=backend, replay_dtype=replay_dtype,
                             mem_budget=mem_budget, use_cache=use_cache,
                             policy=policy)
    spec = SweepSpec.make(alphas, ms=(m,), compute_slots=(compute_slots,),
                          unit=unit)
    use_batch = (spec.n_points >= _MIN_BATCH_POINTS if batch is None
                 else bool(batch))
    if use_batch:
        with grid_span():
            return _batch_for_pair(g, spec, spec.ms[0], spec.css[0], pol)
    sim_lists = g._sim_lists()
    m, cs = spec.ms[0], spec.css[0]
    if spec.class_mode:
        cls = g.mem_class_column(spec.alphas.shape[1])
        return np.array([_event_loop_classes(
            g.is_mem, sim_lists, m, a, cls, spec.unit, cs)
            for a in spec.alphas])
    return np.array([_event_loop(g.is_mem, sim_lists, m, float(a),
                                 spec.unit, cs) for a in spec.alphas])


def _sweep_grid_spec(g: EDag, spec: SweepSpec,
                     pol: ExecPolicy) -> np.ndarray:
    """``sweep_grid`` on a pre-normalized query (the report layer calls it
    directly)."""
    g._finalize()
    out = np.zeros((spec.n_points, len(spec.ms), len(spec.css)))
    with grid_span():
        for j, mm in enumerate(spec.ms):
            for l, cs in enumerate(spec.css):
                out[:, j, l] = _batch_for_pair(g, spec, mm, cs, pol)
    return out


def sweep_grid(g: EDag, alphas, ms=(4,), compute_slots=(0,),
               unit: float = 1.0, backend: Optional[str] = None,
               mem_budget: Optional[int] = None,
               use_cache: bool = True,
               replay_dtype: Optional[str] = None, *,
               policy: Optional[ExecPolicy] = None) -> np.ndarray:
    """Simulated makespans over the full alpha × m × compute_slots grid,
    shape ``(len(alphas), len(ms), len(compute_slots))``; entry
    ``[i, j, l]`` is bit-identical to ``simulate_reference(g, m=ms[j],
    alpha=alphas[i], unit=unit, compute_slots=compute_slots[l])``.  One
    recorded schedule per (m, compute_slots) pair, one stacked replay per
    plan over the alpha axis, chunked under the memory budget.  A 2-D
    ``(P, n_classes)`` alpha matrix evaluates the class-vector grid."""
    pol = ExecPolicy.resolve(backend=backend, replay_dtype=replay_dtype,
                             mem_budget=mem_budget, use_cache=use_cache,
                             policy=policy)
    spec = SweepSpec.make(alphas, ms=ms, compute_slots=compute_slots,
                          unit=unit)
    return _sweep_grid_spec(g, spec, pol)
