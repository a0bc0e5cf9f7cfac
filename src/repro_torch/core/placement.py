"""Object-placement search for memory disaggregation (beyond-paper).

The paper estimates latency sensitivity under one scalar remote latency;
the disaggregation decisions that motivate it are *per-object* — DOLMA
places individual data objects in local vs remote memory under a local
capacity budget.  This module turns EDAN into that planner, and the whole
search rides the class-vector replay engine with no new kernel:

* **Objects are latency classes.**  Each traced data object (a named
  ``TracedArray``, recovered from the eDAG's ``"ld A"`` / ``"st A"``
  vertex labels) becomes its own latency class; a candidate placement
  (object -> local | remote) is then just an alpha *row* whose entries
  are ``alpha_local`` or ``alpha_remote`` per object.  Evaluating many
  candidate placements is one class-mode ``scheduler.simulate_batch``
  call — candidates batch as replay columns of a single stacked (max,+)
  pass (the level kernel, on the policy's device), each bit-identical to
  the per-event reference engine (``simulate_reference_classes``) by the
  engine's own verification.

* **Exhaustive oracle for small object counts.**  With ``n_obj <=
  max_oracle_objects`` every subset of objects is one replay column
  (2^n <= 256), so the oracle is a single batch: the true optimum per
  budget falls out of one pass, and the per-object marginal costs reuse
  the same matrix.

* **Greedy sensitivity-ranked placement for real traces.**  Objects are
  ranked by per-object Eq 3 lambda (``sensitivity.object_sensitivity``:
  ``W_o`` accesses, ``D_o`` chained depth from the shared ``mem_layers``
  pass) per footprint byte — "keep local what hurts most per byte" —
  then packed under the byte budget first-fit in rank order.  The
  all-remote placement is always evaluated alongside, and the report
  keeps the better of the two, so the documented bound holds
  unconditionally:  ``oracle <= greedy <= all_remote``  (the oracle
  minimizes over a superset of the evaluated candidates; all-remote is
  always feasible and always evaluated).

Returned makespans are never model estimates: every number in a
``PlacementReport`` comes out of the verified class-vector replay, so a
fresh replay of the chosen placement reproduces it exactly.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from itertools import combinations
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .graph import EDag
from .plan import ExecPolicy

# Oracle cost is one replay column per subset: 2^8 = 256 columns is one
# comfortable batch; past that the greedy path takes over.
MAX_ORACLE_OBJECTS = 8


@dataclass
class PlacementObject:
    """One traced data object as the placement search sees it.

    ``nbytes`` is the capacity cost of keeping the object local (the
    allocation footprint when a ``Tracer.object_sizes()`` table is
    supplied, else the traffic fallback); ``traffic`` is the bytes its
    accesses actually move — the two differ whenever an object is
    re-touched (traffic > footprint) or partially touched."""
    name: str
    vertices: np.ndarray          # mem-vertex ids touching this object
    nbytes: int                   # local-capacity cost
    traffic: int                  # bytes moved by its accesses
    lam: float = 0.0              # per-object Eq 3 sensitivity (at m)

    @property
    def n_accesses(self) -> int:
        return int(len(self.vertices))


@dataclass
class PlacementReport:
    """Result of one placement search: the chosen placement at ``budget``,
    the makespan-vs-budget curve, and per-object marginal costs.

    Every makespan is a verified class-vector replay result — replaying
    the corresponding placement row reproduces it bit-exactly."""
    method: str                   # "oracle" | "greedy"
    objects: List[PlacementObject]
    alpha_local: float
    alpha_remote: float
    m: int
    compute_slots: int
    unit: float
    budget: int
    local: Tuple[str, ...]        # chosen local set at ``budget``
    makespan: float
    all_local: float              # makespan with every object local
    all_remote: float             # makespan with every object remote
    budgets: np.ndarray           # curve x: local-capacity budgets (bytes)
    curve: np.ndarray             # curve y: best found makespan per budget
    curve_local: List[Tuple[str, ...]] = field(default_factory=list)
    marginal: Dict[str, float] = field(default_factory=dict)

    def rows(self) -> List[dict]:
        """Fig-style makespan-vs-budget table (one dict per budget)."""
        return [dict(budget=int(b), makespan=float(mk),
                     n_local=len(loc), local=",".join(loc))
                for b, mk, loc in zip(self.budgets, self.curve,
                                      self.curve_local)]


def _object_name(label: str) -> Optional[str]:
    if label.startswith("ld ") or label.startswith("st "):
        return label[3:] or "<anon>"
    return None


def objects_from_edag(g: EDag,
                      sizes: Optional[Dict[str, int]] = None
                      ) -> List[PlacementObject]:
    """Recover the traced data objects of an eDAG from its vertex labels.

    Memory vertices group by the object name their ``"ld X"`` / ``"st X"``
    labels carry (``Tracer`` emits these; register spills land under
    ``"spill"``); mem vertices with any other label group under
    ``"<anon>"``.  ``sizes`` — typically ``Tracer.object_sizes()`` —
    supplies allocation footprints; objects missing from it fall back to
    their traffic sum (an upper bound on footprint, so a budget that
    admits the fallback admits the real object too).  Objects come back
    name-sorted for deterministic downstream enumeration."""
    g._finalize()
    labels = g.labels()
    nbytes = g.nbytes
    groups: Dict[str, list] = {}
    for v in np.flatnonzero(g.is_mem):
        name = _object_name(labels[v])
        groups.setdefault(name if name is not None else "<anon>",
                          []).append(int(v))
    out = []
    for name in sorted(groups):
        vids = np.asarray(groups[name], dtype=np.int64)
        traffic = int(nbytes[vids].sum())
        size = int((sizes or {}).get(name, traffic))
        out.append(PlacementObject(name=name, vertices=vids,
                                   nbytes=size, traffic=traffic))
    return out


def object_class_map(g: EDag,
                     objects: Sequence[PlacementObject]) -> np.ndarray:
    """Per-vertex class map giving each object its own latency class.

    Class i = ``objects[i]``; vertices touching no listed object (and
    all non-mem vertices) stay class 0 — harmless, because every
    placement row prices class 0 like its own object anyway and non-mem
    vertices never read their class."""
    cls = np.zeros(g.n_vertices, dtype=np.int32)
    for i, o in enumerate(objects):
        cls[o.vertices] = i
    return cls


def placement_rows(n_obj: int, locals_list: Sequence[Sequence[int]],
                   alpha_local: float,
                   alpha_remote: float) -> np.ndarray:
    """Candidate placements as class-alpha rows: row r prices the objects
    in ``locals_list[r]`` at ``alpha_local`` and the rest at
    ``alpha_remote`` — the placement-as-columns trick."""
    A = np.full((len(locals_list), max(n_obj, 1)), float(alpha_remote))
    for r, loc in enumerate(locals_list):
        idx = list(loc)
        if idx:
            A[r, idx] = float(alpha_local)
    return A


def _evaluate_placements(g: EDag, objects: Sequence[PlacementObject],
                         locals_list: Sequence[Sequence[int]],
                         alpha_local: float, alpha_remote: float,
                         m: int, compute_slots: int, unit: float,
                         pol: ExecPolicy) -> np.ndarray:
    """Makespan per candidate placement, one class-mode batch.

    Installs the object class map as the eDAG's overlay for the call and
    restores whatever overlay was there before — the search must compose
    with callers running their own class sweeps."""
    from .scheduler import simulate_batch
    prev = g.mem_classes
    prev_names = g.mem_class_names
    g.set_mem_classes(object_class_map(g, objects),
                      names=[o.name for o in objects])
    try:
        A = placement_rows(len(objects), locals_list, alpha_local,
                           alpha_remote)
        return simulate_batch(g, A, m=m, compute_slots=compute_slots,
                              unit=unit, policy=pol)
    finally:
        g.set_mem_classes(prev, names=prev_names)


def _default_budgets(objects: Sequence[PlacementObject],
                     order: Sequence[int]) -> np.ndarray:
    """Curve budgets: 0, then every distinct cumulative footprint along
    the given packing order — each point where the feasible set can grow."""
    sizes = np.array([objects[i].nbytes for i in order], dtype=np.int64)
    return np.unique(np.concatenate(([0], np.cumsum(sizes))))


def _rank_objects(g: EDag, objects: List[PlacementObject],
                  m: int) -> List[int]:
    """Greedy packing order: per-object Eq 3 lambda per footprint byte,
    descending — the marginal makespan relief per byte of local
    capacity.  Fills each object's ``lam`` as a side effect.  Ties (and
    zero-size objects, which rank first: free relief) break by larger
    lambda, then name, for determinism."""
    from .sensitivity import object_sensitivity
    sens = object_sensitivity(
        g, {o.name: o.vertices for o in objects}, m=m)
    for o in objects:
        o.lam = float(sens[o.name].lam)
    return sorted(range(len(objects)),
                  key=lambda i: (-(objects[i].lam /
                                   max(objects[i].nbytes, 1)),
                                 -objects[i].lam, objects[i].name))


def _greedy_pack(objects: Sequence[PlacementObject], order: Sequence[int],
                 budget: int) -> Tuple[int, ...]:
    """First-fit in rank order under the byte budget."""
    left = int(budget)
    chosen = []
    for i in order:
        if objects[i].nbytes <= left:
            chosen.append(i)
            left -= objects[i].nbytes
    return tuple(sorted(chosen))


def search_placement(g: EDag, alpha_local: float, alpha_remote: float,
                     budget: int,
                     sizes: Optional[Dict[str, int]] = None,
                     objects: Optional[List[PlacementObject]] = None,
                     budgets=None,
                     m: int = 4, compute_slots: int = 0,
                     unit: float = 1.0, method: str = "auto",
                     max_oracle_objects: int = MAX_ORACLE_OBJECTS,
                     backend: Optional[str] = None,
                     replay_dtype: Optional[str] = None, *,
                     policy: Optional[ExecPolicy] = None) -> PlacementReport:
    """Search the object -> {local, remote} assignment minimizing the
    simulated makespan under a local-capacity byte budget.

    ``method="oracle"`` enumerates every subset (requires ``len(objects)
    <= max_oracle_objects``); ``"greedy"`` packs by lambda-per-byte rank;
    ``"auto"`` picks the oracle exactly when it is affordable.  Both run
    as class-vector replay batches, so every reported makespan is
    bit-identical to the reference event loop for that placement, and
    greedy obeys ``oracle <= greedy <= all_remote`` by construction.

    The report also carries the makespan-vs-budget curve (over
    ``budgets``, default: every distinct cumulative footprint) and each
    object's marginal cost — the makespan increase of remoting only that
    object from the all-local placement, the per-object number a
    DOLMA-style planner negotiates with."""
    pol = ExecPolicy.resolve(backend=backend, replay_dtype=replay_dtype,
                             policy=policy)
    if alpha_local <= 0 or alpha_remote <= 0 or \
            not (np.isfinite(alpha_local) and np.isfinite(alpha_remote)):
        raise ValueError("alpha_local and alpha_remote must be positive "
                         "and finite")
    if budget < 0:
        raise ValueError(f"budget must be >= 0, got {budget}")
    if objects is None:
        objects = objects_from_edag(g, sizes=sizes)
    n_obj = len(objects)
    if method == "auto":
        method = "oracle" if n_obj <= max_oracle_objects else "greedy"
    if method not in ("oracle", "greedy"):
        raise ValueError(f"unknown placement method {method!r}")
    if method == "oracle" and n_obj > max_oracle_objects:
        raise ValueError(
            f"oracle enumeration over {n_obj} objects exceeds "
            f"max_oracle_objects={max_oracle_objects}")

    order = _rank_objects(g, objects, m) if n_obj else []
    budgets = (np.asarray(budgets, dtype=np.int64) if budgets is not None
               else _default_budgets(objects, order))
    if (budgets < 0).any():
        raise ValueError("budgets must be >= 0")

    def run(locals_list):
        return _evaluate_placements(
            g, objects, locals_list, alpha_local, alpha_remote, m,
            compute_slots, unit, pol)

    all_idx = tuple(range(n_obj))
    if method == "oracle":
        subsets = [tuple(s) for r in range(n_obj + 1)
                   for s in combinations(range(n_obj), r)]
        mks = run(subsets)
        size_of = np.array([sum(objects[i].nbytes for i in s)
                            for s in subsets], dtype=np.int64)
        mk_of = dict(zip(subsets, mks))

        def best(b):
            feas = np.flatnonzero(size_of <= b)
            j = feas[np.argmin(mks[feas])]     # () is always feasible
            return subsets[j], float(mks[j])

        curve_sets, curve = zip(*(best(b) for b in budgets)) \
            if len(budgets) else ((), ())
        chosen, chosen_mk = best(budget)
        all_local_mk = float(mk_of[all_idx])
        all_remote_mk = float(mk_of[()])
        marginal = {
            objects[i].name:
                float(mk_of[tuple(j for j in all_idx if j != i)]) -
                all_local_mk
            for i in range(n_obj)}
    else:
        packed = [_greedy_pack(objects, order, int(b)) for b in budgets]
        chosen_pack = _greedy_pack(objects, order, int(budget))
        # one batch: curve candidates + chosen + all-remote + the
        # marginal-cost rows (all local, each leave-one-out)
        loo = [tuple(j for j in all_idx if j != i) for i in all_idx]
        cand = packed + [chosen_pack, (), all_idx] + loo
        mks = run(cand)
        base = len(packed)
        mk_chosen, mk_remote, all_local_mk = \
            (float(mks[base]), float(mks[base + 1]), float(mks[base + 2]))
        all_remote_mk = mk_remote
        marginal = {objects[i].name: float(mks[base + 3 + i]) -
                    all_local_mk for i in range(n_obj)}
        # keep the better of packed and all-remote per point: this is
        # what makes the [oracle, all_remote] bound unconditional
        curve_sets, curve = [], []
        for r in range(base):
            if float(mks[r]) <= mk_remote:
                curve_sets.append(packed[r])
                curve.append(float(mks[r]))
            else:
                curve_sets.append(())
                curve.append(mk_remote)
        if mk_chosen <= mk_remote:
            chosen, chosen_mk = chosen_pack, mk_chosen
        else:
            chosen, chosen_mk = (), mk_remote

    return PlacementReport(
        method=method, objects=list(objects),
        alpha_local=float(alpha_local), alpha_remote=float(alpha_remote),
        m=int(m), compute_slots=int(compute_slots), unit=float(unit),
        budget=int(budget),
        local=tuple(objects[i].name for i in chosen),
        makespan=float(chosen_mk),
        all_local=all_local_mk, all_remote=all_remote_mk,
        budgets=np.asarray(budgets, dtype=np.int64),
        curve=np.asarray(curve, dtype=np.float64),
        curve_local=[tuple(objects[i].name for i in s)
                     for s in curve_sets],
        marginal=marginal)
