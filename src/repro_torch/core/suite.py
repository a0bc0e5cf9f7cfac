"""Multi-trace union eDAG suites: whole-suite sweep grids in one level pass.

EDAN's headline results are suite-level (figs 10-13 characterise
PolyBench/HPCG/LULESH at once).  ``EDagSuite`` views K traces as one
block-diagonal union eDAG (``graph.concat_edags``) with a per-vertex
``trace_id`` segment array, and ``suite_sweep_grid`` evaluates the alpha ×
m × compute_slots grid for every member at once:

* **One union replay plan per distinct m.**  Its blocks span the (member,
  m, compute_slots) product.  Each member's recorded schedule (issue
  orders and the augmented levels) comes from the member's in-process plan
  memo, or from one recording run, which then warms that memo.  The
  schedules are concatenated in rank space: slot chains are offset with
  their block, so they never cross a block boundary, and the union's
  augmented levels are the per-block levels unchanged.  One
  ``build_level_partition`` call gives the union ``LevelCSR``, with
  ``seg_ptr`` set to the block boundaries.
* **One stacked (max,+) replay on the device.**  ``_SuitePlan.replay``
  builds F and R as float64 tensors on the policy's device and runs
  ``ExecPolicy.accumulate`` over the union ``LevelCSR`` (the level kernel
  on the card).  Levels of independent blocks interleave, so the serial
  depth is the deepest block's.  Per-block makespans come from
  ``backend.segment_max_rows`` on the device, and each block is certified
  on its device slice ``F[off:off+n]`` by the scheduler's ``_verify_class``
  (and, in class mode, ``_verify_slots``).  Only the per-block makespans
  and certificate masks cross to the host.  The alpha axis rides the
  columns, chunked under the policy's memory budget per replay group
  (``_member_groups``).
* **Bit-exactness per member.**  Any (member, point) the union schedule
  fails to certify falls back to that member's ``simulate_batch`` on the
  same policy, so every entry equals single-trace ``sweep_grid``.
* **Class-vector grids ride the same union.**  A 2-D alpha matrix builds
  the plan from class-mode block schedules (slot provenance instead of
  homogeneous chains), and the F fill gathers each memory row's class
  alpha through the plan's device ``cls_mem`` column.

Schedule reuse has three tiers here: the member memo, the persistent
schedule cache keyed by each member's trace digest (the entries the
single-trace engine reads and writes, so suites and single traces warm
each other across processes), and the recording run.  Class-mode block
schedules are memo-only: the disk format carries no slot provenance.

The analytic side rides the same union: ``suite_t_inf_sweep`` runs one
batched span pass over the union and segments it per trace, and
``metrics.suite_grid_report`` emits per-trace Eq 1-4 tables.
"""
from __future__ import annotations

from collections import OrderedDict
from types import SimpleNamespace
from typing import Optional, Sequence

import numpy as np
import torch

from . import backend as _bk
from . import schedule_cache as _sc
from . import scheduler as _sched
from .counters import Stats
from .graph import EDag, _auto_sweep_chunk, concat_edags
from .plan import ExecPolicy, SweepSpec
from .spans import grid_span, span, spanned
from .scheduler import (_ReplayPlan, _attach_queue_partition,
                        _aug_level_valid, _event_loop, _event_loop_classes,
                        _memo_plan, _prov_check_arrays, _prov_qpred,
                        _recording, _slot_qpred, _sweep_grid_spec, _to_dev,
                        _validate_schedule, _verify_class, _verify_slots,
                        simulate_batch)

# Per-suite union-plan memo, keyed by (member group, pairs, unit, classes).
_SUITE_PLAN_CAP = 8

#: Suite counters: ``plans_built`` (union plans built) and
#: ``fallback_points`` ((member, pair, point) entries the union schedule did
#: not certify, which ``simulate_batch`` answered).
stats = Stats(plans_built=0, fallback_points=0)


class EDagSuite:
    """K member eDAGs viewed as one block-diagonal union trace.

    ``members`` keeps the original graphs (verification and fallbacks run
    against them); ``offsets`` is the (K+1,) block-boundary array in union
    vertex space and ``trace_id`` the per-vertex segment array.  The union
    eDAG (``.union``) is built on first use: only the analytic passes need
    it."""

    def __init__(self, members: Sequence[EDag],
                 names: Optional[Sequence[str]] = None):
        self.members = list(members)
        for g in self.members:
            if not isinstance(g, EDag):
                raise TypeError(f"suite members must be EDag, got {type(g)}")
            g._finalize()
        if names is None:
            names = [f"trace{i}" for i in range(len(self.members))]
        elif len(names) != len(self.members):
            raise ValueError("names length mismatch")
        self.names = list(names)
        counts = np.array([g.n_vertices for g in self.members],
                          dtype=np.int64)
        self.offsets = np.concatenate(([0], np.cumsum(counts)))
        self.trace_id = np.repeat(
            np.arange(len(self.members), dtype=np.int64), counts)
        self._edge_counts = [g.n_edges for g in self.members]
        self._union: Optional[EDag] = None
        self._suite_plans: OrderedDict = OrderedDict()

    @property
    def n_traces(self) -> int:
        return len(self.members)

    @property
    def n_vertices(self) -> int:
        return int(self.offsets[-1])

    def _check_members(self) -> None:
        """Refuse to operate on mutated members: ``EDag`` is append-only,
        so unchanged vertex and edge counts mean every member is the graph
        it was at construction time."""
        for k, g in enumerate(self.members):
            if (g.n_vertices != int(self.offsets[k + 1] - self.offsets[k])
                    or g.n_edges != self._edge_counts[k]):
                raise ValueError(
                    f"suite member {k} ({self.names[k]!r}) was mutated "
                    "after EDagSuite construction; build a new suite")

    @property
    def union(self) -> EDag:
        """The block-diagonal union eDAG (built once, on first use)."""
        self._check_members()
        if self._union is None:
            self._union = concat_edags(self.members)
            self._union._finalize()
        return self._union

    def segment_max(self, values, empty: float = 0.0) -> np.ndarray:
        """Per-trace max of a union-vertex-space array (rows = vertices)."""
        self._check_members()
        v = torch.from_numpy(np.asarray(values, dtype=np.float64))
        return _bk.segment_max_rows(v, self.offsets, empty=empty).numpy()

    def segment_sum(self, values) -> np.ndarray:
        """Per-trace sum of a union-vertex-space array (rows = vertices)."""
        self._check_members()
        v = torch.from_numpy(np.asarray(values, dtype=np.float64))
        return _bk.segment_sum_rows(v, self.offsets).numpy()


# ------------------------------------------------------------- analytic side

def suite_t_inf_sweep(suite: EDagSuite, alphas, unit: float = 1.0,
                      backend: Optional[str] = None,
                      replay_dtype: Optional[str] = None, *,
                      policy: Optional[ExecPolicy] = None) -> np.ndarray:
    """Span T-inf per (trace, alpha) from one union-batched level pass.

    Returns a (K, n_alphas) array; row k is bit-identical to
    ``metrics.t_inf_sweep(member_k, alphas, unit)``.  The cost matrix is
    built on the policy's device, the pass runs through
    ``ExecPolicy.accumulate`` with the clamp, and only the per-trace spans
    come back.  A 2-D ``(P, n_classes)`` alpha matrix prices each member's
    vertices through its own ``set_mem_classes`` overlay."""
    pol = ExecPolicy.resolve(backend=backend, replay_dtype=replay_dtype,
                             policy=policy)
    alphas = np.asarray(alphas, dtype=np.float64)
    suite._check_members()
    K = suite.n_traces
    if K == 0 or suite.n_vertices == 0 or len(alphas) == 0:
        return np.zeros((K, len(alphas)))
    u = suite.union
    dev = pol.device()
    mem = u._device_is_mem(dev)[:, None]
    cls = (torch.from_numpy(np.concatenate(
        [g.mem_class_column(alphas.shape[1]) for g in suite.members])
    ).to(dev) if alphas.ndim == 2 else None)
    chunk = _auto_sweep_chunk(u.n_vertices)
    lv = u._level_csr()
    out = []
    for i in range(0, len(alphas), chunk):
        a = torch.from_numpy(np.ascontiguousarray(alphas[i:i + chunk])
                             ).to(dev)
        cost = a.T[cls] if cls is not None else a[None, :]
        F = torch.where(mem, cost, float(unit)).contiguous()
        pol.accumulate(lv, F, _bk.column_quanta(alphas[i:i + chunk], unit),
                       clamp=True)
        out.append(_bk.segment_max_rows(F, suite.offsets).cpu().numpy())
    return np.concatenate(out, axis=1)


# ------------------------------------------------------------ the suite plan

class _BlockSched:
    """One (member, m, compute_slots) block of a union replay plan: what
    the per-point verification and the fallback need, in member-local rank
    space, and where the block's results land in the grid.

    On class-mode plans the block also carries the recorded slot
    provenance and its verification arrays under the attribute names
    ``_verify_slots`` reads off a ``_ReplayPlan``; ``dev(device)`` hands
    their device copies as ``_ReplayPlan.dev`` does."""

    __slots__ = ("g", "trace", "pair", "m", "cs", "off", "rank",
                 "O_mem", "Om_rel", "O_alu", "Oa_rel",
                 "prov", "prov_ok", "t_chk", "need_chk", "_dev")

    def __init__(self, g: EDag, trace: int, pair: int, m: int, cs: int,
                 off: int, rank, O_mem, O_alu, prov=None):
        self.g = g
        self.trace, self.pair = trace, pair
        self.m, self.cs, self.off = m, cs, off
        self.rank = rank
        self.O_mem, self.O_alu = O_mem, O_alu
        self.Om_rel = rank[O_mem]
        self.Oa_rel = rank[O_alu] if cs else np.zeros(0, dtype=np.int64)
        self.prov = prov
        if prov is not None:
            self.prov_ok, self.t_chk, self.need_chk = \
                _prov_check_arrays(prov, m)
        else:
            self.prov_ok = True
            self.t_chk = self.need_chk = None
        self._dev = None

    def dev(self, device: torch.device) -> SimpleNamespace:
        """The block's verification arrays as tensors on ``device``."""
        if self._dev is None or self._dev[0] != str(device):
            self._dev = (str(device), SimpleNamespace(
                rank=_to_dev(self.rank, device, np.int64),
                O_mem=_to_dev(self.O_mem, device, np.int64),
                O_alu=_to_dev(self.O_alu, device, np.int64),
                Om_rel=_to_dev(self.Om_rel, device, np.int64),
                Oa_rel=_to_dev(self.Oa_rel, device, np.int64),
                prov=_to_dev(self.prov, device, np.int64),
                t_chk=_to_dev(self.t_chk, device, np.int64),
                need_chk=_to_dev(self.need_chk, device, np.int64)))
        return self._dev[1]


class _SuitePlan:
    """Union replay plan over a (member, m, compute_slots) block product:
    one ``LevelCSR`` for the group, per-block verification state, and the
    block boundaries (``seg_ptr``) the per-block makespans reduce over.

    ``cls_mem`` (class-mode plans only) is the per-memory-row latency
    class, aligned with ``mem_rows``."""

    __slots__ = ("n", "lv", "mem_rows", "seg_ptr", "blocks", "cls_mem",
                 "_dev")

    def __init__(self, n: int, lv, mem_rows, seg_ptr, blocks,
                 cls_mem=None):
        self.n = n
        self.lv = lv
        self.mem_rows = mem_rows
        self.seg_ptr = seg_ptr
        self.blocks = blocks
        self.cls_mem = cls_mem
        self._dev = None

    def dev(self, device: torch.device) -> SimpleNamespace:
        """The fill's gather columns as tensors on ``device``."""
        if self._dev is None or self._dev[0] != str(device):
            self._dev = (str(device), SimpleNamespace(
                mem_rows=_to_dev(self.mem_rows, device, np.int64),
                cls_mem=_to_dev(self.cls_mem, device, np.int64)))
        return self._dev[1]

    @spanned("edan.replay")
    def replay(self, alphas: np.ndarray, unit: float,
               pol: Optional[ExecPolicy] = None):
        """All blocks × all points at once: finish and ready times, both
        (n_rows + 1, k) float64 tensors on the policy's device in blockwise
        pop-order row space (the last row is the shared zero sentinel every
        block's slot chains bottom out on).  The pass runs through
        ``ExecPolicy.accumulate``, so F and R are bit-identical to the
        float64 pass under every dtype policy.  ``alphas`` is (k,) scalar
        latencies or, on a class-mode plan, (k, n_classes) rows."""
        pol = ExecPolicy.resolve(policy=pol)
        dev = pol.device()
        d = self.dev(dev)
        a = torch.from_numpy(np.ascontiguousarray(alphas,
                                                  dtype=np.float64)).to(dev)
        F = torch.full((self.n + 1, len(alphas)), float(unit),
                       dtype=torch.float64, device=dev)
        F[d.mem_rows] = a.T[d.cls_mem] if d.cls_mem is not None else a
        F[-1] = 0.0
        R = torch.zeros_like(F)
        pol.accumulate(self.lv, F, _bk.column_quanta(alphas, unit),
                       clamp=False, R_out=R)
        return F, R


def _member_schedule(g: EDag, m: int, cs: int, unit: float, a0: float,
                     use_cache: bool):
    """One member's recorded schedule ``(topo, O_mem, O_alu, level|None,
    fresh)``: the member's plan memo, then the disk (keyed by the member's
    trace digest), else one recording run at ``a0``."""
    n = g.n_vertices
    if use_cache:
        key = (m, cs, float(unit))
        memo = getattr(g, "_replay_plans", None)
        if memo is not None and key in memo:
            p = memo[key]
            memo.move_to_end(key)
            _sched.stats.add("memory_hits")
            return p.topo, p.O_mem, p.O_alu, p.level_aug, False
        if n >= _sc.min_vertices():
            got = _sc.load(g.trace_digest(), m, cs, n, unit)
            if got is not None:
                topo, O_mem, O_alu, level = got
                if _validate_schedule(g, m, cs, topo, O_mem,
                                      O_alu) is not None:
                    _sched.stats.add("disk_hits")
                    return topo, O_mem, O_alu, level, False
        _sched.stats.add("misses")
    with _recording():
        _, topo, O_mem, O_alu = _event_loop(g.is_mem, g._sim_lists(), m, a0,
                                            unit, cs, record=True)
    return topo, O_mem, O_alu, None, True


def _member_schedule_classes(g: EDag, m: int, cs: int, unit: float,
                             a0, cls, use_cache: bool):
    """Class-mode member schedule ``(topo, O_mem, O_alu, prov, level|None,
    fresh)``: the member's plan memo (keyed by the class overlay's digest,
    as the single-trace class engine keys it), else one
    ``_event_loop_classes`` recording at class-vector row ``a0``."""
    if use_cache:
        key = ("classes", m, cs, float(unit), g.mem_class_digest())
        memo = getattr(g, "_replay_plans", None)
        if memo is not None and key in memo:
            p = memo[key]
            memo.move_to_end(key)
            _sched.stats.add("memory_hits")
            return p.topo, p.O_mem, p.O_alu, p.prov, p.level_aug, False
        _sched.stats.add("misses")
    with _recording():
        _, topo, O_mem, O_alu, prov = _event_loop_classes(
            g.is_mem, g._sim_lists(), m, a0, cls, unit, cs, record=True)
    return topo, O_mem, O_alu, prov, None, True


@spanned("edan.suite.plan")
def _build_suite_plan(suite: EDagSuite, pairs, unit: float, a0,
                      use_cache: bool,
                      member_idx: Optional[Sequence[int]] = None,
                      n_classes: Optional[int] = None) -> _SuitePlan:
    """Concatenate the (member, m, compute_slots) block schedules into one
    block-diagonal replay plan: slot chains and DAG edges are offset with
    their block, per-block augmented levels concatenate unchanged, and one
    ``build_level_partition`` call gives the union ``LevelCSR``.
    ``member_idx`` restricts the plan to a replay group; block ``trace``
    ids stay global.  ``n_classes`` switches to class mode: ``a0`` is then
    the master class-vector row, block schedules carry slot provenance, and
    the plan carries the per-memory-row class column ``cls_mem``."""
    if member_idx is None:
        member_idx = range(suite.n_traces)
    classes = n_classes is not None
    n_rows = sum(suite.members[k].n_vertices
                 for k in member_idx) * len(pairs)
    qpred_u = np.full(n_rows, n_rows, dtype=np.int64)
    is_mem_rows = np.zeros(n_rows, dtype=bool)
    cls_rows = np.zeros(n_rows, dtype=np.int64) if classes else None
    src_parts, dst_parts, lvl_parts = [], [], []
    blocks: list = []
    seg_ptr = [0]
    off = 0
    for pair, (m, cs) in enumerate(pairs):
        for k in member_idx:
            g = suite.members[k]
            n = g.n_vertices
            seg_ptr.append(off + n)
            if n == 0:
                blocks.append(None)
                continue
            if classes:
                cls_col = g.mem_class_column(n_classes)
                topo, O_mem, O_alu, prov, level, fresh = \
                    _member_schedule_classes(g, m, cs, unit, a0, cls_col,
                                             use_cache)
            else:
                cls_col = prov = None
                topo, O_mem, O_alu, level, fresh = _member_schedule(
                    g, m, cs, unit, a0, use_cache)
            rank = np.empty(n, dtype=np.int64)
            rank[topo] = np.arange(n)
            if classes:
                qpred = _prov_qpred(rank, O_mem, O_alu, prov, m, cs, n)
            else:
                qpred = _slot_qpred(rank, O_mem, O_alu, m, cs, n)
            qpred = qpred.astype(np.int64)
            src_r, dst_r = rank[g.src], rank[g.dst]
            qdst = np.nonzero(qpred < n)[0]
            asrc = np.concatenate([src_r, qpred[qdst]])
            adst = np.concatenate([dst_r, qdst])
            if level is not None and not _aug_level_valid(
                    np.asarray(level), asrc, adst, n):
                level = None
            if level is None:
                level = _bk.levelize(asrc, adst, n)
            if fresh and use_cache:
                persisted = not classes and n >= _sc.min_vertices() and \
                    _sc.store(g.trace_digest(), m, cs, n, unit, topo,
                              O_mem, O_alu, level)
                if not persisted:
                    # below the disk floor, with persistence off, or in
                    # class mode the member memo is the only tier that
                    # makes this recording reusable: warm it, so a later
                    # single-trace sweep of this member skips recording
                    mkey = (("classes", m, cs, float(unit),
                             g.mem_class_digest()) if classes
                            else (m, cs, float(unit)))
                    _memo_plan(g, mkey,
                               _ReplayPlan(g, topo, O_mem, O_alu, m, cs,
                                           level=level, prov=prov,
                                           classes=cls_col))
            # block offsets: slot chains stay inside their block, missing
            # predecessors point at the shared sentinel row n_rows
            qpred_u[off:off + n] = np.where(qpred < n, qpred + off, n_rows)
            src_parts.append(src_r + off)
            dst_parts.append(dst_r + off)
            lvl_parts.append(np.asarray(level))
            is_mem_rows[off:off + n] = g.is_mem[topo]
            if classes:
                cls_rows[off:off + n] = cls_col[topo]
            blocks.append(_BlockSched(g, k, pair, m, cs, off, rank,
                                      O_mem, O_alu, prov=prov))
            off += n
    empty = np.zeros(0, dtype=np.int64)
    src_u = np.concatenate(src_parts) if src_parts else empty
    dst_u = np.concatenate(dst_parts) if dst_parts else empty
    level_u = np.concatenate(lvl_parts) if lvl_parts else empty
    lv = _bk.build_level_partition(src_u, dst_u, level_u, n_rows)
    _attach_queue_partition(lv, dst_u, qpred_u, level_u)
    lv.seg_ptr = np.asarray(seg_ptr, dtype=np.int64)
    mem_rows = np.flatnonzero(is_mem_rows)
    stats.add("plans_built")
    return _SuitePlan(n_rows, lv, mem_rows, lv.seg_ptr, blocks,
                      cls_mem=cls_rows[mem_rows] if classes else None)


def _memo_suite_plan(suite: EDagSuite, key, plan: _SuitePlan) -> None:
    memo = suite._suite_plans
    memo[key] = plan
    memo.move_to_end(key)
    while len(memo) > _SUITE_PLAN_CAP:
        memo.popitem(last=False)


def _member_groups(suite: EDagSuite, n_pairs: int, P: int,
                   pol: ExecPolicy) -> list:
    """Partition member indices into replay groups under the policy's
    memory budget.  The chunk divisor of a union replay is the plan's row
    count, so one huge member would shrink every member's chunks; a member
    whose own rows (``n_vertices x n_pairs``) cannot fit a full-width (rows,
    P) chunk inside the budget replays as its own group, everything else
    stays in one batched group.  Grouping only changes how chunks are cut,
    never a result."""
    cap_rows = pol.cap_rows(P)
    small: list = []
    groups: list = []
    for k, g in enumerate(suite.members):
        if g.n_vertices * n_pairs > cap_rows:
            groups.append([k])        # streams alone, own chunk size
        else:
            small.append(k)
    if small:
        groups.insert(0, small)       # batched together, wide chunks
    return groups


def _suite_grid_batch(suite: EDagSuite, alphas: np.ndarray, pairs,
                      unit: float, pol: ExecPolicy) -> np.ndarray:
    """The grid over ``pairs``, one union plan and one chunked stacked
    replay per replay group: returns (K, n_alphas, n_pairs) makespans.
    ``alphas`` arrives sorted, unique, finite and positive, 1-D scalars or
    2-D class-vector rows (``suite_sweep_grid``'s ``SweepSpec``)."""
    K, P = suite.n_traces, len(alphas)
    out = np.zeros((K, P, len(pairs)))
    if suite.n_vertices == 0 or P == 0 or not pairs:
        return out
    for idxs in _member_groups(suite, len(pairs), P, pol):
        _group_grid_batch(suite, idxs, out, alphas, pairs, unit, pol)
    return out


def _group_grid_batch(suite: EDagSuite, member_idx, out: np.ndarray,
                      alphas: np.ndarray, pairs, unit: float,
                      pol: ExecPolicy) -> None:
    """One replay group's (member, pair, alpha) product into ``out``
    (global trace indexing): one union plan, one chunked stacked replay on
    the device, per-block verification on device slices, and the
    per-member fallback for whatever the union schedule fails to
    certify."""
    P = len(alphas)
    classes = alphas.ndim == 2
    cls_key = (tuple(suite.members[k].mem_class_digest()
                     for k in member_idx) if classes else None)
    key = (tuple(member_idx), tuple(pairs), float(unit), cls_key)
    plan = suite._suite_plans.get(key) if pol.use_cache else None
    if plan is not None:
        suite._suite_plans.move_to_end(key)
    else:
        a0 = alphas[0] if classes else float(alphas[0])
        plan = _build_suite_plan(
            suite, pairs, unit, a0, pol.use_cache, member_idx=member_idx,
            n_classes=alphas.shape[1] if classes else None)
        if pol.use_cache:
            _memo_suite_plan(suite, key, plan)
    B = len(plan.blocks)
    ok = np.zeros((B, P), dtype=bool)
    chunk = pol.points_chunk(plan.n, P)
    for c0 in range(0, P, chunk):
        cols = np.arange(c0, min(c0 + chunk, P))
        F, R = plan.replay(alphas[cols], unit, pol=pol)
        with span("edan.verify"):
            mk = _bk.segment_max_rows(F[:-1], plan.seg_ptr)
            oks = []
            for blk in plan.blocks:
                if blk is None:       # empty member: makespan 0 everywhere
                    oks.append(torch.ones(len(cols), dtype=torch.bool,
                                          device=F.device))
                    continue
                off, n = blk.off, blk.g.n_vertices
                Fv, Rv = F[off:off + n], R[off:off + n]
                d = blk.dev(F.device)
                okc = _verify_class(blk.g, d.rank, Fv, Rv, d.O_mem, d.Om_rel)
                if blk.prov is not None:
                    okc &= _verify_slots(blk, Fv)
                if blk.cs:
                    okc &= _verify_class(blk.g, d.rank, Fv, Rv, d.O_alu,
                                         d.Oa_rel)
                oks.append(okc)
            # the only transfers: per-block makespans and certificate masks
            mk = mk.cpu().numpy()
            okm = torch.stack(oks).cpu().numpy()
        for b, blk in enumerate(plan.blocks):
            ok[b, cols] = okm[b]
            if blk is not None:
                out[blk.trace, cols[okm[b]], blk.pair] = mk[b, okm[b]]
    if not ok.all():
        # uncertified (block, point)s fall back to the member's own batched
        # engine on the same policy (which re-records and warms the member
        # memo), and the stale union plan is dropped
        if pol.use_cache:
            suite._suite_plans.pop(key, None)
        with span("edan.suite.fallback"):
            for b, blk in enumerate(plan.blocks):
                if blk is None:
                    continue
                bad = np.nonzero(~ok[b])[0]
                if len(bad):
                    stats.add("fallback_points", len(bad))
                    out[blk.trace, bad, blk.pair] = simulate_batch(
                        blk.g, alphas[bad], m=blk.m, unit=unit,
                        compute_slots=blk.cs, policy=pol)


# ------------------------------------------------------------- entry points

def _suite_sweep_grid_spec(suite: EDagSuite, spec: SweepSpec,
                           pol: ExecPolicy) -> np.ndarray:
    """``suite_sweep_grid`` on a pre-normalized query (the report layer
    calls it directly)."""
    with grid_span():
        K = suite.n_traces
        out = np.zeros((K, spec.n_points, len(spec.ms), len(spec.css)))
        suite._check_members()
        if K == 0 or spec.n_points == 0:
            return out
        if spec.bad_costs or min(spec.ms, default=1) < 1:
            # degenerate machine parameters take the per-member engine, which
            # keeps the reference semantics
            for k, g in enumerate(suite.members):
                out[k] = _sweep_grid_spec(g, spec, pol)
            return out
        pairs = spec.pairs
        res = np.zeros((K, spec.n_uniq, len(pairs)))
        # one union plan per distinct m: blocks sharing m have about the same
        # replay depth, so merging their compute_slots variants widens levels
        # without deepening the union
        groups: OrderedDict = OrderedDict()
        for i, (mm, _cs) in enumerate(pairs):
            groups.setdefault(mm, []).append(i)
        for idxs in groups.values():
            res[:, :, idxs] = _suite_grid_batch(
                suite, spec.uniq, [pairs[i] for i in idxs], spec.unit, pol)
        out[:] = spec.restore(res, axis=1).reshape(
            K, spec.n_points, len(spec.ms), len(spec.css))
        return out


def suite_sweep_grid(suite: EDagSuite, alphas, ms=(4,), compute_slots=(0,),
                     unit: float = 1.0, backend: Optional[str] = None,
                     mem_budget: Optional[int] = None,
                     use_cache: bool = True,
                     replay_dtype: Optional[str] = None, *,
                     policy: Optional[ExecPolicy] = None) -> np.ndarray:
    """Simulated makespans for every member over the full grid, in one
    level pass per distinct m (per replay group and column chunk).

    Returns a ``(n_traces, len(alphas), len(ms), len(compute_slots))``
    array whose slice ``[k]`` is bit-identical to ``sweep_grid(
    suite.members[k], alphas, ms, compute_slots, unit)`` under every
    policy.  Duplicate or unsorted alphas come back in caller order;
    degenerate machine parameters (non-positive or non-finite alphas or
    unit, m < 1) take the per-member engine.  A 2-D ``(P, n_classes)``
    alpha matrix evaluates the latency-class grid through the same union,
    certified by the issue-order check plus the per-block provenance
    check."""
    pol = ExecPolicy.resolve(backend=backend, replay_dtype=replay_dtype,
                             mem_budget=mem_budget, use_cache=use_cache,
                             policy=policy)
    spec = SweepSpec.make(alphas, ms=ms, compute_slots=compute_slots,
                          unit=unit)
    return _suite_sweep_grid_spec(suite, spec, pol)


def suite_latency_sweep(suite: EDagSuite, alphas, m: int = 4,
                        unit: float = 1.0, compute_slots: int = 0,
                        backend: Optional[str] = None,
                        mem_budget: Optional[int] = None,
                        use_cache: bool = True,
                        replay_dtype: Optional[str] = None, *,
                        policy: Optional[ExecPolicy] = None) -> np.ndarray:
    """Single-axis suite sweep: ``(n_traces, len(alphas))`` makespans,
    row k bit-identical to ``latency_sweep(suite.members[k], ...)``."""
    pol = ExecPolicy.resolve(backend=backend, replay_dtype=replay_dtype,
                             mem_budget=mem_budget, use_cache=use_cache,
                             policy=policy)
    spec = SweepSpec.make(alphas, ms=(m,), compute_slots=(compute_slots,),
                          unit=unit)
    return _suite_sweep_grid_spec(suite, spec, pol)[:, :, 0, 0]
