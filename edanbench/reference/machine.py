"""The simulated machine of the EDAN paper (section 4), computed plainly
from a ``dag.Dag``.

The machine: a memory-access vertex waits FIFO by ready time for one of
``m`` memory issue slots and holds it for ``alpha`` cycles; every other
vertex takes ``unit`` cycles, on unbounded ALUs, or, with
``compute_slots`` > 0, on that many ALU slots taken in the order the
vertices become ready.  A vertex is ready when its last predecessor
finishes.  Events are processed in (time, vertex) order.  The makespan is
the last finish time.

``precision="float32"`` rounds every time to float32: it is the control
that the benchmark's comparison has to refuse.
"""
from __future__ import annotations

import heapq

import numpy as np

PRECISIONS = ("float64", "float32")


def _num(precision: str):
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    return float if precision == "float64" else np.float32


def makespan(g, m: int, alpha: float, unit: float = 1.0,
             compute_slots: int = 0, precision: str = "float64"):
    """The simulated makespan of ``g`` on the machine ``(m, alpha, unit,
    compute_slots)``."""
    if g.n == 0:
        return 0.0
    num = _num(precision)
    alpha, unit, zero = num(alpha), num(unit), num(0.0)
    succ = memoryview(np.ascontiguousarray(g.succ, dtype=np.int32))
    sptr = memoryview(np.ascontiguousarray(g.succ_ptr, dtype=np.int32))
    indeg = memoryview(np.array(g.indeg, dtype=np.int32))
    is_mem = g.is_mem.tolist()
    events: list = []
    mem_wait: list = []
    slots = [zero] * m
    alu = [zero] * compute_slots if compute_slots else None
    push, pop, replace = heapq.heappush, heapq.heappop, heapq.heapreplace

    def start(v, t):
        if is_mem[v]:
            push(mem_wait, (t, v))
        elif alu is not None:
            st = max(t, alu[0])
            replace(alu, st + unit)
            push(events, (st + unit, v))
        else:
            push(events, (t + unit, v))

    for v in range(g.n):
        if not indeg[v]:
            start(v, zero)

    def drain():
        while mem_wait:
            rt, v = mem_wait[0]
            st = max(rt, slots[0])
            pop(mem_wait)
            replace(slots, st + alpha)
            push(events, (st + alpha, v))

    drain()
    last = zero
    while events:
        t, v = pop(events)
        last = max(last, t)
        for e in range(sptr[v], sptr[v + 1]):
            d = succ[e]
            indeg[d] -= 1
            if indeg[d] == 0:
                start(d, t)
        drain()
    return float(last)
