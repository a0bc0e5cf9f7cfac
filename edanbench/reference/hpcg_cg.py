"""HPCG's conjugate-gradient solve as the EDAN paper traces it (Table 1):
plain CG on an n^3 grid with the 27-point stencil operator (diagonal 26,
off-diagonal -1), x0 = 0, traced element by element in the reference loop
order.  Frozen: these loops define the workload."""
from __future__ import annotations

import numpy as np

from .dag import Tracer


def neighbor_offsets():
    return [(dx, dy, dz)
            for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
            if not (dx == dy == dz == 0)]


def _nidx(i, j, k, n):
    return (i * n + j) * n + k


def trace_cg(n: int, iters: int, seed: int):
    """The eDAG of ``iters`` CG iterations on an ``n``^3 grid; ``seed``
    draws the right-hand side b."""
    tr = Tracer()
    N = n ** 3
    b_np = np.random.default_rng(seed).standard_normal(N)
    offs = neighbor_offsets()

    b = tr.array(b_np, "b")
    x = tr.zeros(N, "x")
    r = tr.zeros(N, "r")
    p = tr.zeros(N, "p")
    Ap = tr.zeros(N, "Ap")

    for i in range(N):
        v = b.load(i)
        r.store(i, v)
        p.store(i, v)

    def dot(u, v):
        acc = tr.const(0.0)
        for i in range(N):
            acc = tr.alu('+', acc, tr.alu('*', u.load(i), v.load(i)))
        return acc

    def spmv():
        for ix in range(n):
            for iy in range(n):
                for iz in range(n):
                    i = _nidx(ix, iy, iz, n)
                    acc = tr.alu('*', tr.const(26.0), p.load(i))
                    for dx, dy, dz in offs:
                        jx, jy, jz = ix + dx, iy + dy, iz + dz
                        if 0 <= jx < n and 0 <= jy < n and 0 <= jz < n:
                            acc = tr.alu('-', acc, p.load(_nidx(jx, jy, jz, n)))
                    Ap.store(i, acc)

    rs_old = dot(r, r)
    for _ in range(iters):
        spmv()
        pAp = dot(p, Ap)
        alpha = tr.alu(lambda a, c: a / c if abs(c) > 1e-30 else 0.0,
                       rs_old, pAp, label="div")
        for i in range(N):
            x.store(i, tr.alu('+', x.load(i), tr.alu('*', alpha, p.load(i))))
        for i in range(N):
            r.store(i, tr.alu('-', r.load(i), tr.alu('*', alpha, Ap.load(i))))
        rs_new = dot(r, r)
        beta = tr.alu(lambda a, c: a / c if abs(c) > 1e-30 else 0.0,
                      rs_new, rs_old, label="div")
        for i in range(N):
            p.store(i, tr.alu('+', r.load(i), tr.alu('*', beta, p.load(i))))
        rs_old = rs_new
    return tr.dag()


def trace(cfg: dict, seed: int, names=None) -> dict:
    """The configuration's one eDAG, under the name ``"cg"``."""
    return {"cg": trace_cg(int(cfg["n"]), int(cfg["iters"]), seed)}
