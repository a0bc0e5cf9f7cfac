"""The 15 PolyBench/C kernels of the EDAN paper's figures 10-12, traced
element by element in their C reference loop order (all dimensions N;
doitgen's R = max(2, N // 2)).  Frozen: these loops define the workload."""
from __future__ import annotations

import numpy as np

from .dag import Tracer


def _rand(rng, *shape):
    return rng.standard_normal(shape)


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


KERNELS = {
    "2mm": k_2mm, "3mm": k_3mm, "atax": k_atax, "bicg": k_bicg,
    "doitgen": k_doitgen, "mvt": k_mvt, "gemm": k_gemm, "gemver": k_gemver,
    "gesummv": k_gesummv, "symm": k_symm, "syr2k": k_syr2k, "syrk": k_syrk,
    "trmm": k_trmm, "lu": k_lu, "trisolv": k_trisolv,
}


def trace_one(name: str, N: int, seed: int):
    """The eDAG of one kernel at size ``N``; ``seed`` draws its inputs."""
    rng = np.random.default_rng(seed)
    tr = Tracer()
    KERNELS[name](tr, N, rng)
    return tr.dag()


def trace(cfg: dict, seed: int, names=None) -> dict:
    """The eDAGs of ``cfg["kernels"]`` (or of ``names`` among them), by
    kernel name."""
    names = cfg["kernels"] if names is None else names
    return {k: trace_one(k, int(cfg["N"]), seed) for k in names}
