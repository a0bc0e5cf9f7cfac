"""The comparison that decides ``correct``: the program's answers against
the plain reference (``edanbench/reference``) at a sample drawn from the
seed.

An answer is exact or wrong: every makespan is a max of sums in which each
finish is one IEEE add, so the program owes the reference's float64 value
bit for bit.  Two numbers are compared, each with the limit 0: ``wrong``,
the answers that differ (or never came), and ``max_rel_gap``, the largest
relative distance of an answer from the reference's.

The control puts the reference, computed in float32, in the program's
place (``precision="float32"``); the comparison has to refuse it.
"""
from __future__ import annotations

import importlib
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .reference import machine

LIMITS = {"wrong": 0, "max_rel_gap": 0.0}
#: the reference simulates a trace's points in worker processes from this
#: many vertices on, in at most this many processes
PARALLEL_VERTICES = 500_000
MAX_WORKERS = 8

Point = Tuple[str, int, int, int]       # (trace, alpha, m, slots) indices


def reference_tracer(cfg: dict):
    """The reference module that traces this configuration, by its
    ``tracer`` key."""
    return importlib.import_module(f"edanbench.reference.{cfg['tracer']}")


def sample_points(rng: np.random.Generator, sizes: Dict[str, int],
                  shape: Tuple[int, int, int], n: int) -> List[Point]:
    """``n`` distinct grid points drawn uniformly, and always the point of
    the largest trace at the largest alpha, fewest memory slots and the
    first slot count (the longest makespan)."""
    names = sorted(sizes)
    P, M, S = shape
    total = len(names) * P * M * S
    flat = rng.choice(total, size=min(n, total), replace=False)
    pts = {(names[f // (P * M * S)], int(f // (M * S) % P),
            int(f // S % M), int(f % S)) for f in flat.tolist()}
    largest = max(names, key=lambda k: (sizes[k], k))
    pts.add((largest, P - 1, 0, 0))
    return sorted(pts)


def reference_values(cfg: dict, seed: int, points: Sequence[Point],
                     grid: dict, precisions: Sequence[str] = ("float64",),
                     workers: int = 1) -> List[Dict[Point, float]]:
    """The reference's makespan at every point, once per precision, tracing
    only the traces the points name; in ``workers`` processes, each tracing
    for itself, where that is more than one (``workers_for``)."""
    names = sorted({p[0] for p in points})
    jobs = [(p[0], int(grid["ms"][p[2]]), float(grid["alphas"][p[1]]),
             float(cfg.get("unit", 1.0)), int(grid["compute_slots"][p[3]]),
             prec) for prec in precisions for p in points]
    workers = min(workers, len(jobs))
    if workers > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(workers, mp_context=ctx,
                                 initializer=_trace_into,
                                 initargs=(cfg, seed, names)) as ex:
            vals = list(ex.map(_makespan, jobs))
    else:
        _trace_into(cfg, seed, names)
        try:
            vals = [_makespan(j) for j in jobs]
        finally:
            _DAGS.clear()
    n = len(points)
    return [dict(zip(points, vals[i * n:(i + 1) * n]))
            for i in range(len(precisions))]


def workers_for(largest: int) -> int:
    """Processes for the reference's points when the largest trace has
    ``largest`` vertices: the event loop is plain Python, so a large
    trace's points go to as many processes as the host has cores, up to
    ``MAX_WORKERS``; a small trace's stay in this process."""
    if largest < PARALLEL_VERTICES:
        return 1
    return max(1, min(os.cpu_count() or 1, MAX_WORKERS))


#: the traced eDAGs of this process (a worker's, or the caller's while
#: ``reference_values`` runs in it)
_DAGS: Dict[str, object] = {}


def _trace_into(cfg: dict, seed: int, names: Sequence[str]) -> None:
    _DAGS.clear()
    _DAGS.update(reference_tracer(cfg).trace(cfg, seed, names=names))


def _makespan(job) -> float:
    name, m, alpha, unit, slots, precision = job
    return machine.makespan(_DAGS[name], m, alpha, unit, slots, precision)


class Tally:
    """Running ``wrong`` and ``max_rel_gap`` over compared values."""

    def __init__(self):
        self.wrong = 0
        self.missed = 0
        self.gap = 0.0
        self.compared = 0

    def add(self, got, want) -> bool:
        """Compare arrays (or scalars) elementwise; True when all equal."""
        got = np.asarray(got, dtype=np.float64)
        want = np.asarray(want, dtype=np.float64)
        self.compared += int(want.size)
        if got.shape != want.shape:
            return False
        ok = bool(np.array_equal(got, want))
        if not ok:
            with np.errstate(divide="ignore", invalid="ignore"):
                rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
            rel = np.where(np.isfinite(rel), rel, 1e300)
            self.gap = max(self.gap, float(rel.max()))
        return ok

    def missing(self, n: int = 1) -> None:
        """Answers that never came (each also one ``wrong``)."""
        self.wrong += n
        self.missed += n

    def result(self) -> dict:
        return {"wrong": self.wrong, "max_rel_gap": self.gap,
                "compared": self.compared, "missed": self.missed}


def check_steps(steps: List[Optional[dict]], points: Sequence[Point],
                ref: Dict[Point, float]) -> dict:
    """Every step's answer at every sampled point against the reference;
    a step that raised misses all of them."""
    t = Tally()
    for out in steps:
        for p in points:
            if out is None:
                t.missing()
            elif not t.add(out[p[0]][p[1:]], ref[p]):
                t.wrong += 1
    return t.result()


def control_steps(n_steps: int, points, ref64, ref32) -> dict:
    """The control's reading: the float32 reference in the program's
    place, over as many steps as the run made."""
    t = Tally()
    for _ in range(max(n_steps, 1)):
        for p in points:
            if not t.add(ref32[p], ref64[p]):
                t.wrong += 1
    return t.result()
