"""Reference scalar-path tracers (pre-vectorization implementations), the
port's copy of the reference package's ``apps/reference.py``.

The original per-element scalar tracing loops for PolyBench, HPCG and
LULESH on the port's ``core.trace.Tracer``: host-only numpy code, as the
port's tracers are.  They are the ground truth that the bulk
block-emission ports in ``polybench.py`` / ``hpcg.py`` / ``lulesh.py`` are
held against (exact graph equality, including cache hit/miss
classification, ``tests/test_torch_apps_reference.py``), and the fallback
path for tracer modes the bulk API does not support (bounded register
files, false-dependency tracking).  Their eDAGs are byte for byte the
reference package's.
"""
from __future__ import annotations

import numpy as np

from ..core.trace import Tracer


def _rand(rng, *shape):
    return rng.standard_normal(shape)


# --------------------------------------------------------------------------
# scalar (traced) kernels; each fn(tr, N, rng) builds arrays and runs kernel
# --------------------------------------------------------------------------

def k_2mm(tr: Tracer, N: int, rng) -> None:
    A, B, C, D = (tr.array(_rand(rng, N, N), n) for n in "ABCD")
    tmp = tr.zeros((N, N), "tmp")
    alpha, beta = tr.const(1.5), tr.const(1.2)
    for i in range(N):
        for j in range(N):
            acc = tr.const(0.0)
            for k in range(N):
                a = A.load(i, k); b = B.load(k, j)
                acc = tr.alu('+', acc, tr.alu('*', tr.alu('*', alpha, a), b))
            tmp.store((i, j), acc)
    for i in range(N):
        for j in range(N):
            d = tr.alu('*', D.load(i, j), beta)
            for k in range(N):
                t = tmp.load(i, k); c = C.load(k, j)
                d = tr.alu('+', d, tr.alu('*', t, c))
            D.store((i, j), d)


def k_3mm(tr: Tracer, N: int, rng) -> None:
    A, B, C, D = (tr.array(_rand(rng, N, N), n) for n in "ABCD")
    E, F, G = tr.zeros((N, N), "E"), tr.zeros((N, N), "F"), tr.zeros((N, N), "G")
    def mm(X, Y, Z):
        for i in range(N):
            for j in range(N):
                acc = tr.const(0.0)
                for k in range(N):
                    acc = tr.alu('+', acc, tr.alu('*', X.load(i, k), Y.load(k, j)))
                Z.store((i, j), acc)
    mm(A, B, E); mm(C, D, F); mm(E, F, G)


def k_atax(tr: Tracer, N: int, rng) -> None:
    A = tr.array(_rand(rng, N, N), "A")
    x = tr.array(_rand(rng, N), "x")
    y, tmp = tr.zeros(N, "y"), tr.zeros(N, "tmp")
    for i in range(N):
        acc = tr.const(0.0)
        for j in range(N):
            acc = tr.alu('+', acc, tr.alu('*', A.load(i, j), x.load(j)))
        tmp.store(i, acc)
    for j in range(N):
        acc = y.load(j)
        for i in range(N):
            acc = tr.alu('+', acc, tr.alu('*', A.load(i, j), tmp.load(i)))
        y.store(j, acc)


def k_bicg(tr: Tracer, N: int, rng) -> None:
    A = tr.array(_rand(rng, N, N), "A")
    p, r = tr.array(_rand(rng, N), "p"), tr.array(_rand(rng, N), "r")
    q, s = tr.zeros(N, "q"), tr.zeros(N, "s")
    for i in range(N):
        acc = tr.const(0.0)
        for j in range(N):
            acc = tr.alu('+', acc, tr.alu('*', A.load(i, j), p.load(j)))
        q.store(i, acc)
    for j in range(N):
        acc = tr.const(0.0)
        for i in range(N):
            acc = tr.alu('+', acc, tr.alu('*', A.load(i, j), r.load(i)))
        s.store(j, acc)


def k_doitgen(tr: Tracer, N: int, rng) -> None:
    R = max(2, N // 2)
    A = tr.array(_rand(rng, R, R, N), "A")
    C4 = tr.array(_rand(rng, N, N), "C4")
    s = tr.zeros(N, "sum")
    for r in range(R):
        for q in range(R):
            for p in range(N):
                acc = tr.const(0.0)
                for k in range(N):
                    acc = tr.alu('+', acc, tr.alu('*', A.load(r, q, k), C4.load(k, p)))
                s.store(p, acc)
            for p in range(N):
                A.store((r, q, p), s.load(p))


def k_mvt(tr: Tracer, N: int, rng) -> None:
    A = tr.array(_rand(rng, N, N), "A")
    x1, x2 = tr.array(_rand(rng, N), "x1"), tr.array(_rand(rng, N), "x2")
    y1, y2 = tr.array(_rand(rng, N), "y1"), tr.array(_rand(rng, N), "y2")
    for i in range(N):
        acc = x1.load(i)
        for j in range(N):
            acc = tr.alu('+', acc, tr.alu('*', A.load(i, j), y1.load(j)))
        x1.store(i, acc)
    for i in range(N):
        acc = x2.load(i)
        for j in range(N):
            acc = tr.alu('+', acc, tr.alu('*', A.load(j, i), y2.load(j)))
        x2.store(i, acc)


def k_gemm(tr: Tracer, N: int, rng) -> None:
    A, B, C = (tr.array(_rand(rng, N, N), n) for n in "ABC")
    alpha, beta = tr.const(1.5), tr.const(1.2)
    for i in range(N):
        for j in range(N):
            acc = tr.alu('*', C.load(i, j), beta)
            for k in range(N):
                acc = tr.alu('+', acc,
                             tr.alu('*', tr.alu('*', alpha, A.load(i, k)), B.load(k, j)))
            C.store((i, j), acc)


def k_gemver(tr: Tracer, N: int, rng) -> None:
    A = tr.array(_rand(rng, N, N), "A")
    u1, v1, u2, v2, y, z = (tr.array(_rand(rng, N), n)
                            for n in ("u1", "v1", "u2", "v2", "y", "z"))
    x, w = tr.zeros(N, "x"), tr.zeros(N, "w")
    alpha, beta = tr.const(1.5), tr.const(1.2)
    for i in range(N):
        for j in range(N):
            a = A.load(i, j)
            a = tr.alu('+', a, tr.alu('*', u1.load(i), v1.load(j)))
            a = tr.alu('+', a, tr.alu('*', u2.load(i), v2.load(j)))
            A.store((i, j), a)
    for i in range(N):
        acc = x.load(i)
        for j in range(N):
            acc = tr.alu('+', acc, tr.alu('*', tr.alu('*', beta, A.load(j, i)), y.load(j)))
        x.store(i, acc)
    for i in range(N):
        x.store(i, tr.alu('+', x.load(i), z.load(i)))
    for i in range(N):
        acc = w.load(i)
        for j in range(N):
            acc = tr.alu('+', acc, tr.alu('*', tr.alu('*', alpha, A.load(i, j)), x.load(j)))
        w.store(i, acc)


def k_gesummv(tr: Tracer, N: int, rng) -> None:
    A, B = tr.array(_rand(rng, N, N), "A"), tr.array(_rand(rng, N, N), "B")
    x = tr.array(_rand(rng, N), "x")
    y = tr.zeros(N, "y")
    alpha, beta = tr.const(1.5), tr.const(1.2)
    for i in range(N):
        t = tr.const(0.0); yv = tr.const(0.0)
        for j in range(N):
            t = tr.alu('+', t, tr.alu('*', A.load(i, j), x.load(j)))
            yv = tr.alu('+', yv, tr.alu('*', B.load(i, j), x.load(j)))
        y.store(i, tr.alu('+', tr.alu('*', alpha, t), tr.alu('*', beta, yv)))


def k_symm(tr: Tracer, N: int, rng) -> None:
    A, B, C = (tr.array(_rand(rng, N, N), n) for n in "ABC")
    alpha, beta = tr.const(1.5), tr.const(1.2)
    for i in range(N):
        for j in range(N):
            temp2 = tr.const(0.0)
            for k in range(i):
                ck = C.load(k, j)
                ck = tr.alu('+', ck, tr.alu('*', tr.alu('*', alpha, B.load(i, j)), A.load(i, k)))
                C.store((k, j), ck)
                temp2 = tr.alu('+', temp2, tr.alu('*', B.load(k, j), A.load(i, k)))
            cij = tr.alu('*', beta, C.load(i, j))
            cij = tr.alu('+', cij, tr.alu('*', tr.alu('*', alpha, B.load(i, j)), A.load(i, i)))
            cij = tr.alu('+', cij, tr.alu('*', alpha, temp2))
            C.store((i, j), cij)


def k_syr2k(tr: Tracer, N: int, rng) -> None:
    A, B, C = (tr.array(_rand(rng, N, N), n) for n in "ABC")
    alpha, beta = tr.const(1.5), tr.const(1.2)
    for i in range(N):
        for j in range(i + 1):
            C.store((i, j), tr.alu('*', C.load(i, j), beta))
        for k in range(N):
            for j in range(i + 1):
                c = C.load(i, j)
                c = tr.alu('+', c, tr.alu('*', tr.alu('*', A.load(j, k), alpha), B.load(i, k)))
                c = tr.alu('+', c, tr.alu('*', tr.alu('*', B.load(j, k), alpha), A.load(i, k)))
                C.store((i, j), c)


def k_syrk(tr: Tracer, N: int, rng) -> None:
    A, C = tr.array(_rand(rng, N, N), "A"), tr.array(_rand(rng, N, N), "C")
    alpha, beta = tr.const(1.5), tr.const(1.2)
    for i in range(N):
        for j in range(i + 1):
            C.store((i, j), tr.alu('*', C.load(i, j), beta))
        for k in range(N):
            for j in range(i + 1):
                c = C.load(i, j)
                c = tr.alu('+', c, tr.alu('*', tr.alu('*', alpha, A.load(i, k)), A.load(j, k)))
                C.store((i, j), c)


def k_trmm(tr: Tracer, N: int, rng) -> None:
    """Fig 14: B := alpha * A^T * B, A unit lower triangular."""
    A, B = tr.array(_rand(rng, N, N), "A"), tr.array(_rand(rng, N, N), "B")
    alpha = tr.const(1.5)
    for i in range(N):
        for j in range(N):
            b = B.load(i, j)
            for k in range(i + 1, N):
                b = tr.alu('+', b, tr.alu('*', A.load(k, i), B.load(k, j)))
            B.store((i, j), tr.alu('*', alpha, b))


def k_lu(tr: Tracer, N: int, rng) -> None:
    """In-place LU decomposition (Fig 9's kernel) — loop-carried RAW chains."""
    M = _rand(rng, N, N) + N * np.eye(N)         # diagonally dominant
    A = tr.array(M, "A")
    for i in range(N):
        for j in range(i):
            a = A.load(i, j)
            for k in range(j):
                a = tr.alu('-', a, tr.alu('*', A.load(i, k), A.load(k, j)))
            A.store((i, j), tr.alu('/', a, A.load(j, j)))
        for j in range(i, N):
            a = A.load(i, j)
            for k in range(i):
                a = tr.alu('-', a, tr.alu('*', A.load(i, k), A.load(k, j)))
            A.store((i, j), a)


def k_trisolv(tr: Tracer, N: int, rng) -> None:
    """Forward substitution — inherently sequential."""
    L = tr.array(np.tril(_rand(rng, N, N)) + N * np.eye(N), "L")
    b = tr.array(_rand(rng, N), "b")
    x = tr.zeros(N, "x")
    for i in range(N):
        acc = b.load(i)
        for j in range(i):
            acc = tr.alu('-', acc, tr.alu('*', L.load(i, j), x.load(j)))
        x.store(i, tr.alu('/', acc, L.load(i, i)))


def k_cholesky(tr: Tracer, N: int, rng) -> None:
    M = _rand(rng, N, N)
    M = M @ M.T + N * np.eye(N)
    A = tr.array(M, "A")
    import math
    for i in range(N):
        for j in range(i):
            a = A.load(i, j)
            for k in range(j):
                a = tr.alu('-', a, tr.alu('*', A.load(i, k), A.load(j, k)))
            A.store((i, j), tr.alu('/', a, A.load(j, j)))
        a = A.load(i, i)
        for k in range(i):
            a = tr.alu('-', a, tr.alu('*', A.load(i, k), A.load(i, k)))
        A.store((i, i), tr.alu(lambda v: math.sqrt(abs(v)) + 1e-12, a, label="sqrt"))


def k_durbin(tr: Tracer, N: int, rng) -> None:
    r = tr.array(_rand(rng, N), "r")
    y, z = tr.zeros(N, "y"), tr.zeros(N, "z")
    y.store(0, tr.alu(lambda v: -v, r.load(0), label="neg"))
    beta, alpha = tr.const(1.0), tr.alu(lambda v: -v, r.load(0), label="neg")
    for k in range(1, N):
        beta = tr.alu('*', tr.alu(lambda a: 1 - a * a, alpha, label="1-a2"), beta)
        acc = tr.const(0.0)
        for i in range(k):
            acc = tr.alu('+', acc, tr.alu('*', r.load(k - i - 1), y.load(i)))
        alpha = tr.alu(lambda s, rk, b: -(rk + s) / (b if abs(b) > 1e-9 else 1e-9),
                       acc, r.load(k), beta, label="alpha")
        for i in range(k):
            z.store(i, tr.alu('+', y.load(i), tr.alu('*', alpha, y.load(k - i - 1))))
        for i in range(k):
            y.store(i, z.load(i))
        y.store(k, alpha)


def k_trmm_spill(tr: Tracer, N: int, rng) -> None:
    """trmm compiled under register pressure (§5.1, Fig 14 discussion): the
    accumulator B[i][j] is spilled, i.e. every k-iteration round-trips it
    through memory (load-fma-store), creating the extraneous load/store
    dependence chains that give trmm the fastest-growing memory depth in the
    paper's Fig 13."""
    A, B = tr.array(_rand(rng, N, N), "A"), tr.array(_rand(rng, N, N), "B")
    alpha = tr.const(1.5)
    for i in range(N):
        for j in range(N):
            for k in range(i + 1, N):
                b = B.load(i, j)                     # spilled accumulator:
                b = tr.alu('+', b, tr.alu('*', A.load(k, i), B.load(k, j)))
                B.store((i, j), b)                   # ...store every iter
            B.store((i, j), tr.alu('*', alpha, B.load(i, j)))


REF_POLYBENCH_KERNELS = {
    "2mm": k_2mm, "3mm": k_3mm, "atax": k_atax, "bicg": k_bicg,
    "doitgen": k_doitgen, "mvt": k_mvt, "gemm": k_gemm, "gemver": k_gemver,
    "gesummv": k_gesummv, "symm": k_symm, "syr2k": k_syr2k, "syrk": k_syrk,
    "trmm": k_trmm, "lu": k_lu, "trisolv": k_trisolv,
    "cholesky": k_cholesky, "durbin": k_durbin, "trmm_spill": k_trmm_spill,
}


def trace_kernel_ref(name: str, N: int, cache=None, max_regs=None,
                     false_deps: bool = False, seed: int = 0):
    """Run one kernel under the reference scalar tracer path."""
    rng = np.random.default_rng(seed)
    tr = Tracer(cache=cache, max_regs=max_regs, false_deps=false_deps)
    REF_POLYBENCH_KERNELS[name](tr, N, rng)
    return tr.edag


# --------------------------------------------------------------------------
# HPCG reference scalar CG (original per-element loops)
# --------------------------------------------------------------------------

from .hpcg import build_problem, neighbor_offsets, _nidx  # noqa: E402


def trace_cg_ref(n: int = 8, iters: int = 5, cache=None, seed: int = 0):
    """Scalar-traced CG; returns (eDAG, residual_history)."""
    tr = Tracer(cache=cache)
    N = n ** 3
    b_np = build_problem(n, seed)
    offs = neighbor_offsets()

    b = tr.array(b_np, "b")
    x = tr.zeros(N, "x")
    r = tr.zeros(N, "r")
    p = tr.zeros(N, "p")
    Ap = tr.zeros(N, "Ap")

    # r = b; p = b  (x0 = 0)
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

    res = []
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
        res.append(float(rs_new.val))
    return tr.edag, res


# --------------------------------------------------------------------------
# LULESH reference scalar step (original per-element loops)
# --------------------------------------------------------------------------

from .lulesh import mesh_connectivity  # noqa: E402


def trace_step_ref(ne: int = 6, iters: int = 2, cache=None, seed: int = 0):
    """Scalar-traced leapfrog steps; returns the eDAG."""
    rng = np.random.default_rng(seed)
    conn = mesh_connectivity(ne)
    nnode = (ne + 1) ** 3
    nelem = ne ** 3
    tr = Tracer(cache=cache)

    X = tr.array(rng.standard_normal(nnode), "x")       # 1D coords per axis,
    V = tr.array(np.zeros(nnode), "v")                  # flattened physics
    F = tr.zeros(nnode, "f")
    M = tr.array(np.abs(rng.standard_normal(nnode)) + 1.0, "m")
    E = tr.array(np.abs(rng.standard_normal(nelem)) + 1.0, "e")   # energy
    Q = tr.zeros(nelem, "q")                                      # viscosity
    dt = tr.const(1e-3)

    for _ in range(iters):
        # 1. CalcForceForNodes: gather corners, element physics, scatter-add
        for e in range(nelem):
            corner_vals = [X.load(int(c)) for c in conn[e]]
            vol = corner_vals[0]
            for cv in corner_vals[1:]:
                vol = tr.alu('+', vol, cv)
            en = E.load(e)
            press = tr.alu('*', en, vol)
            qv = Q.load(e)
            press = tr.alu('+', press, qv)
            share = tr.alu('*', press, tr.const(0.125))
            for c in conn[e]:
                f = F.load(int(c))
                F.store(int(c), tr.alu('+', f, share))   # RMW through memory
        # 2. nodal integration: a = F/m; v += a dt; x += v dt; F = 0
        for nd in range(nnode):
            a = tr.alu('/', F.load(nd), M.load(nd))
            v = tr.alu('+', V.load(nd), tr.alu('*', a, dt))
            V.store(nd, v)
            X.store(nd, tr.alu('+', X.load(nd), tr.alu('*', v, dt)))
            F.store(nd, tr.const(0.0))
        # 3. CalcQForElems: gather velocities, update element viscosity/energy
        for e in range(nelem):
            g = V.load(int(conn[e][0]))
            for c in conn[e][1:]:
                g = tr.alu('-', g, V.load(int(c)))
            Q.store(e, tr.alu('*', g, g))
            E.store(e, tr.alu('+', E.load(e), tr.alu('*', Q.load(e), dt)))
    return tr.edag
