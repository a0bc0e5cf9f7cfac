"""PolyBench-C linear-algebra kernels (§4, §5.1) against the scalar trace API.

The 15 kernels of the paper's Fig 10-13 study plus cholesky/durbin.  All
follow the PolyBench C reference semantics with all problem dimensions = N
(the paper's 'small' preset collapses similarly).  Each traced load/store
hits the cache model with a real byte address, so W/D/lambda/Lambda/B can be
computed exactly as in the paper.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.trace import Tracer, TracedArray, Value


def _rand(rng, *shape):
    return rng.standard_normal(shape)


# --------------------------------------------------------------------------
# scalar (traced) kernels over the bulk block-emission API.
#
# Each kernel keeps its outer loops in Python and emits the innermost loop
# as one BlockBuilder nest (or one uniform block for whole map loops).  Slot
# declaration order reproduces the original per-element program order
# byte-for-byte — including the cache-model access stream — so the emitted
# eDAG is *identical* to the retained scalar reference implementation
# (tests/test_vector_engine.py asserts exact graph equality).  Numeric array
# contents are maintained with the equivalent numpy expressions.
# --------------------------------------------------------------------------

def _ii(N, v):
    """Constant index vector (an address that repeats every iteration)."""
    return np.full(N, v, dtype=np.int64)


def k_2mm(tr: Tracer, N: int, rng) -> None:
    A, B, C, D = (tr.array(_rand(rng, N, N), n) for n in "ABCD")
    tmp = tr.zeros((N, N), "tmp")
    ks = np.arange(N)
    for i in range(N):
        for j in range(N):
            b = tr.block()
            a = b.load(A.addr_block(_ii(N, i), ks), label="ld A")
            bb = b.load(B.addr_block(ks, _ii(N, j)), label="ld B")
            m1 = b.alu(a, label="*")                   # alpha * a
            m2 = b.alu(m1, bb, label="*")
            acc = b.scan(m2, label="+")
            r = b.emit()
            val = 1.5 * float(A.arr[i] @ B.arr[:, j])
            tmp.store((i, j), Value(val, r.last(acc)))
    beta = tr.const(1.2)
    for i in range(N):
        for j in range(N):
            val = 1.2 * float(D.arr[i, j]) + float(tmp.arr[i] @ C.arr[:, j])
            d = tr.alu('*', D.load(i, j), beta)
            b = tr.block()
            t = b.load(tmp.addr_block(_ii(N, i), ks), label="ld tmp")
            c = b.load(C.addr_block(ks, _ii(N, j)), label="ld C")
            m = b.alu(t, c, label="*")
            acc = b.scan(m, init=d.vid, label="+")
            r = b.emit()
            D.store((i, j), Value(val, r.last(acc)))


def k_3mm(tr: Tracer, N: int, rng) -> None:
    A, B, C, D = (tr.array(_rand(rng, N, N), n) for n in "ABCD")
    E, F, G = tr.zeros((N, N), "E"), tr.zeros((N, N), "F"), tr.zeros((N, N), "G")
    ks = np.arange(N)

    def mm(X, Y, Z):
        for i in range(N):
            for j in range(N):
                b = tr.block()
                x = b.load(X.addr_block(_ii(N, i), ks), label="ld")
                y = b.load(Y.addr_block(ks, _ii(N, j)), label="ld")
                m = b.alu(x, y, label="*")
                acc = b.scan(m, label="+")
                r = b.emit()
                Z.store((i, j), Value(float(X.arr[i] @ Y.arr[:, j]),
                                      r.last(acc)))
    mm(A, B, E); mm(C, D, F); mm(E, F, G)


def k_atax(tr: Tracer, N: int, rng) -> None:
    A = tr.array(_rand(rng, N, N), "A")
    x = tr.array(_rand(rng, N), "x")
    y, tmp = tr.zeros(N, "y"), tr.zeros(N, "tmp")
    js = np.arange(N)
    for i in range(N):
        b = tr.block()
        a = b.load(A.addr_block(_ii(N, i), js), label="ld A")
        xv = b.load(x.addr_block(js), label="ld x")
        m = b.alu(a, xv, label="*")
        acc = b.scan(m, label="+")
        r = b.emit()
        tmp.store(i, Value(float(A.arr[i] @ x.arr), r.last(acc)))
    for j in range(N):
        acc0 = y.load(j)
        b = tr.block()
        a = b.load(A.addr_block(js, _ii(N, j)), label="ld A")
        t = b.load(tmp.addr_block(js), label="ld tmp")
        m = b.alu(a, t, label="*")
        acc = b.scan(m, init=acc0.vid, label="+")
        r = b.emit()
        y.store(j, Value(float(acc0.val + A.arr[:, j] @ tmp.arr),
                         r.last(acc)))


def k_bicg(tr: Tracer, N: int, rng) -> None:
    A = tr.array(_rand(rng, N, N), "A")
    p, rr = tr.array(_rand(rng, N), "p"), tr.array(_rand(rng, N), "r")
    q, s = tr.zeros(N, "q"), tr.zeros(N, "s")
    idx = np.arange(N)
    for i in range(N):
        b = tr.block()
        a = b.load(A.addr_block(_ii(N, i), idx), label="ld A")
        pv = b.load(p.addr_block(idx), label="ld p")
        m = b.alu(a, pv, label="*")
        acc = b.scan(m, label="+")
        r = b.emit()
        q.store(i, Value(float(A.arr[i] @ p.arr), r.last(acc)))
    for j in range(N):
        b = tr.block()
        a = b.load(A.addr_block(idx, _ii(N, j)), label="ld A")
        rv = b.load(rr.addr_block(idx), label="ld r")
        m = b.alu(a, rv, label="*")
        acc = b.scan(m, label="+")
        r = b.emit()
        s.store(j, Value(float(A.arr[:, j] @ rr.arr), r.last(acc)))


def k_doitgen(tr: Tracer, N: int, rng) -> None:
    R = max(2, N // 2)
    A = tr.array(_rand(rng, R, R, N), "A")
    C4 = tr.array(_rand(rng, N, N), "C4")
    s = tr.zeros(N, "sum")
    ks = np.arange(N)
    for r_ in range(R):
        for q_ in range(R):
            row = A.arr[r_, q_].copy()
            for p_ in range(N):
                b = tr.block()
                a = b.load(A.addr_block(_ii(N, r_), _ii(N, q_), ks),
                           label="ld A")
                c = b.load(C4.addr_block(ks, _ii(N, p_)), label="ld C4")
                m = b.alu(a, c, label="*")
                acc = b.scan(m, label="+")
                r = b.emit()
                s.store(p_, Value(float(row @ C4.arr[:, p_]), r.last(acc)))
            b = tr.block()
            sv = b.load(s.addr_block(ks), label="ld sum")
            b.store(A.addr_block(_ii(N, r_), _ii(N, q_), ks), value=sv,
                    label="st A")
            b.emit()
            A.arr[r_, q_] = s.arr


def k_mvt(tr: Tracer, N: int, rng) -> None:
    A = tr.array(_rand(rng, N, N), "A")
    x1, x2 = tr.array(_rand(rng, N), "x1"), tr.array(_rand(rng, N), "x2")
    y1, y2 = tr.array(_rand(rng, N), "y1"), tr.array(_rand(rng, N), "y2")
    js = np.arange(N)
    for i in range(N):
        acc0 = x1.load(i)
        b = tr.block()
        a = b.load(A.addr_block(_ii(N, i), js), label="ld A")
        y = b.load(y1.addr_block(js), label="ld y1")
        m = b.alu(a, y, label="*")
        acc = b.scan(m, init=acc0.vid, label="+")
        r = b.emit()
        x1.store(i, Value(float(acc0.val + A.arr[i] @ y1.arr), r.last(acc)))
    for i in range(N):
        acc0 = x2.load(i)
        b = tr.block()
        a = b.load(A.addr_block(js, _ii(N, i)), label="ld A")
        y = b.load(y2.addr_block(js), label="ld y2")
        m = b.alu(a, y, label="*")
        acc = b.scan(m, init=acc0.vid, label="+")
        r = b.emit()
        x2.store(i, Value(float(acc0.val + A.arr[:, i] @ y2.arr), r.last(acc)))


def k_gemm(tr: Tracer, N: int, rng) -> None:
    A, B, C = (tr.array(_rand(rng, N, N), n) for n in "ABC")
    # fully slot-unrolled nest: the iteration space is the (i, j) grid and
    # the k loop is unrolled into slots, so the whole kernel is ONE block
    # (still in exact (i, j, k)-major reference order)
    ii, jj = np.divmod(np.arange(N * N), N)
    b = tr.block()
    ldc = b.load(C.addr_block(ii, jj), label="ld C")
    acc = b.alu(ldc, label="*")                        # beta * c
    for k in range(N):
        a = b.load(A.addr_block(ii, _ii(N * N, k)), label="ld A")
        m1 = b.alu(a, label="*")                       # alpha * a
        bb = b.load(B.addr_block(_ii(N * N, k), jj), label="ld B")
        m2 = b.alu(m1, bb, label="*")
        acc = b.alu(acc, m2, label="+")
    b.store(C.addr_block(ii, jj), value=acc, label="st C")
    b.emit()
    C.arr[:] = 1.2 * C.arr + 1.5 * (A.arr @ B.arr)


def k_gemver(tr: Tracer, N: int, rng) -> None:
    A = tr.array(_rand(rng, N, N), "A")
    u1, v1, u2, v2, y, z = (tr.array(_rand(rng, N), n)
                            for n in ("u1", "v1", "u2", "v2", "y", "z"))
    x, w = tr.zeros(N, "x"), tr.zeros(N, "w")
    js = np.arange(N)
    for i in range(N):
        newrow = (A.arr[i] + u1.arr[i] * v1.arr + u2.arr[i] * v2.arr)
        b = tr.block()
        a = b.load(A.addr_block(_ii(N, i), js), label="ld A")
        l_u1 = b.load(u1.addr_block(_ii(N, i)), label="ld u1")
        l_v1 = b.load(v1.addr_block(js), label="ld v1")
        m1 = b.alu(l_u1, l_v1, label="*")
        a1 = b.alu(a, m1, label="+")
        l_u2 = b.load(u2.addr_block(_ii(N, i)), label="ld u2")
        l_v2 = b.load(v2.addr_block(js), label="ld v2")
        m2 = b.alu(l_u2, l_v2, label="*")
        a2 = b.alu(a1, m2, label="+")
        b.store(A.addr_block(_ii(N, i), js), value=a2, label="st A")
        b.emit()
        A.arr[i] = newrow
    for i in range(N):
        acc0 = x.load(i)
        val = float(acc0.val + 1.2 * (A.arr[:, i] @ y.arr))
        b = tr.block()
        a = b.load(A.addr_block(js, _ii(N, i)), label="ld A")
        m1 = b.alu(a, label="*")                       # beta * a
        l_y = b.load(y.addr_block(js), label="ld y")
        m2 = b.alu(m1, l_y, label="*")
        acc = b.scan(m2, init=acc0.vid, label="+")
        r = b.emit()
        x.store(i, Value(val, r.last(acc)))
    newx = x.arr + z.arr
    b = tr.block()
    l_x = b.load(x.addr_block(js), label="ld x")
    l_z = b.load(z.addr_block(js), label="ld z")
    a = b.alu(l_x, l_z, label="+")
    b.store(x.addr_block(js), value=a, label="st x")
    b.emit()
    x.arr[:] = newx
    for i in range(N):
        acc0 = w.load(i)
        val = float(acc0.val + 1.5 * (A.arr[i] @ x.arr))
        b = tr.block()
        a = b.load(A.addr_block(_ii(N, i), js), label="ld A")
        m1 = b.alu(a, label="*")                       # alpha * a
        l_x = b.load(x.addr_block(js), label="ld x")
        m2 = b.alu(m1, l_x, label="*")
        acc = b.scan(m2, init=acc0.vid, label="+")
        r = b.emit()
        w.store(i, Value(val, r.last(acc)))


def k_gesummv(tr: Tracer, N: int, rng) -> None:
    A, B = tr.array(_rand(rng, N, N), "A"), tr.array(_rand(rng, N, N), "B")
    x = tr.array(_rand(rng, N), "x")
    y = tr.zeros(N, "y")
    alpha, beta = tr.const(1.5), tr.const(1.2)
    js = np.arange(N)
    for i in range(N):
        b = tr.block()
        a = b.load(A.addr_block(_ii(N, i), js), label="ld A")
        x1 = b.load(x.addr_block(js), label="ld x")
        m1 = b.alu(a, x1, label="*")
        t = b.scan(m1, label="+")
        bb = b.load(B.addr_block(_ii(N, i), js), label="ld B")
        x2 = b.load(x.addr_block(js), label="ld x")
        m2 = b.alu(bb, x2, label="*")
        yv = b.scan(m2, label="+")
        r = b.emit()
        tv = Value(float(A.arr[i] @ x.arr), r.last(t))
        yvv = Value(float(B.arr[i] @ x.arr), r.last(yv))
        y.store(i, tr.alu('+', tr.alu('*', alpha, tv), tr.alu('*', beta, yvv)))


def k_symm(tr: Tracer, N: int, rng) -> None:
    A, B, C = (tr.array(_rand(rng, N, N), n) for n in "ABC")
    alpha, beta = tr.const(1.5), tr.const(1.2)
    for i in range(N):
        for j in range(N):
            t2val = float(B.arr[:i, j] @ A.arr[i, :i])
            t2vid = None
            if i:
                ks = np.arange(i)
                newc = C.arr[:i, j] + 1.5 * B.arr[i, j] * A.arr[i, :i]
                b = tr.block()
                ck = b.load(C.addr_block(ks, _ii(i, j)), label="ld C")
                bij = b.load(B.addr_block(_ii(i, i), _ii(i, j)), label="ld B")
                m1 = b.alu(bij, label="*")             # alpha * B[i,j]
                aik = b.load(A.addr_block(_ii(i, i), ks), label="ld A")
                m2 = b.alu(m1, aik, label="*")
                a1 = b.alu(ck, m2, label="+")
                b.store(C.addr_block(ks, _ii(i, j)), value=a1, label="st C")
                bkj = b.load(B.addr_block(ks, _ii(i, j)), label="ld B")
                aik2 = b.load(A.addr_block(_ii(i, i), ks), label="ld A")
                m3 = b.alu(bkj, aik2, label="*")
                t2 = b.scan(m3, label="+")
                r = b.emit()
                t2vid = r.last(t2)
                C.arr[:i, j] = newc
            temp2 = Value(t2val, t2vid)
            cij = tr.alu('*', beta, C.load(i, j))
            cij = tr.alu('+', cij, tr.alu('*', tr.alu('*', alpha, B.load(i, j)),
                                          A.load(i, i)))
            cij = tr.alu('+', cij, tr.alu('*', alpha, temp2))
            C.store((i, j), cij)


def k_syr2k(tr: Tracer, N: int, rng) -> None:
    A, B, C = (tr.array(_rand(rng, N, N), n) for n in "ABC")
    for i in range(N):
        js = np.arange(i + 1)
        newc = C.arr[i, :i + 1] * 1.2
        b = tr.block()
        c = b.load(C.addr_block(_ii(i + 1, i), js), label="ld C")
        m = b.alu(c, label="*")                        # beta * c
        b.store(C.addr_block(_ii(i + 1, i), js), value=m, label="st C")
        b.emit()
        C.arr[i, :i + 1] = newc
        for k in range(N):
            newc = (C.arr[i, :i + 1]
                    + 1.5 * A.arr[:i + 1, k] * B.arr[i, k]
                    + 1.5 * B.arr[:i + 1, k] * A.arr[i, k])
            b = tr.block()
            c = b.load(C.addr_block(_ii(i + 1, i), js), label="ld C")
            ajk = b.load(A.addr_block(js, _ii(i + 1, k)), label="ld A")
            m1 = b.alu(ajk, label="*")                 # a * alpha
            bik = b.load(B.addr_block(_ii(i + 1, i), _ii(i + 1, k)),
                         label="ld B")
            m2 = b.alu(m1, bik, label="*")
            c1 = b.alu(c, m2, label="+")
            bjk = b.load(B.addr_block(js, _ii(i + 1, k)), label="ld B")
            m3 = b.alu(bjk, label="*")                 # b * alpha
            aik = b.load(A.addr_block(_ii(i + 1, i), _ii(i + 1, k)),
                         label="ld A")
            m4 = b.alu(m3, aik, label="*")
            c2 = b.alu(c1, m4, label="+")
            b.store(C.addr_block(_ii(i + 1, i), js), value=c2, label="st C")
            b.emit()
            C.arr[i, :i + 1] = newc


def k_syrk(tr: Tracer, N: int, rng) -> None:
    A, C = tr.array(_rand(rng, N, N), "A"), tr.array(_rand(rng, N, N), "C")
    for i in range(N):
        js = np.arange(i + 1)
        newc = C.arr[i, :i + 1] * 1.2
        b = tr.block()
        c = b.load(C.addr_block(_ii(i + 1, i), js), label="ld C")
        m = b.alu(c, label="*")                        # beta * c
        b.store(C.addr_block(_ii(i + 1, i), js), value=m, label="st C")
        b.emit()
        C.arr[i, :i + 1] = newc
        for k in range(N):
            newc = C.arr[i, :i + 1] + 1.5 * A.arr[i, k] * A.arr[:i + 1, k]
            b = tr.block()
            c = b.load(C.addr_block(_ii(i + 1, i), js), label="ld C")
            aik = b.load(A.addr_block(_ii(i + 1, i), _ii(i + 1, k)),
                         label="ld A")
            m1 = b.alu(aik, label="*")                 # alpha * a
            ajk = b.load(A.addr_block(js, _ii(i + 1, k)), label="ld A")
            m2 = b.alu(m1, ajk, label="*")
            c1 = b.alu(c, m2, label="+")
            b.store(C.addr_block(_ii(i + 1, i), js), value=c1, label="st C")
            b.emit()
            C.arr[i, :i + 1] = newc


def k_trmm(tr: Tracer, N: int, rng) -> None:
    """Fig 14: B := alpha * A^T * B, A unit lower triangular."""
    A, B = tr.array(_rand(rng, N, N), "A"), tr.array(_rand(rng, N, N), "B")
    alpha = tr.const(1.5)
    for i in range(N):
        for j in range(N):
            acc0 = B.load(i, j)
            val = float(acc0.val + A.arr[i + 1:, i] @ B.arr[i + 1:, j])
            vid = acc0.vid
            if i + 1 < N:
                ks = np.arange(i + 1, N)
                b = tr.block()
                a = b.load(A.addr_block(ks, _ii(len(ks), i)), label="ld A")
                bb = b.load(B.addr_block(ks, _ii(len(ks), j)), label="ld B")
                m = b.alu(a, bb, label="*")
                acc = b.scan(m, init=vid, label="+")
                r = b.emit()
                vid = r.last(acc)
            B.store((i, j), tr.alu('*', alpha, Value(val, vid)))


def k_lu(tr: Tracer, N: int, rng) -> None:
    """In-place LU decomposition (Fig 9's kernel) — loop-carried RAW chains."""
    M = _rand(rng, N, N) + N * np.eye(N)         # diagonally dominant
    A = tr.array(M, "A")
    for i in range(N):
        for j in range(i):
            acc0 = A.load(i, j)
            val = float(acc0.val - A.arr[i, :j] @ A.arr[:j, j])
            vid = acc0.vid
            if j:
                ks = np.arange(j)
                b = tr.block()
                a1 = b.load(A.addr_block(_ii(j, i), ks), label="ld A")
                a2 = b.load(A.addr_block(ks, _ii(j, j)), label="ld A")
                m = b.alu(a1, a2, label="*")
                acc = b.scan(m, init=vid, label="-")
                r = b.emit()
                vid = r.last(acc)
            A.store((i, j), tr.alu('/', Value(val, vid), A.load(j, j)))
        for j in range(i, N):
            acc0 = A.load(i, j)
            val = float(acc0.val - A.arr[i, :i] @ A.arr[:i, j])
            vid = acc0.vid
            if i:
                ks = np.arange(i)
                b = tr.block()
                a1 = b.load(A.addr_block(_ii(i, i), ks), label="ld A")
                a2 = b.load(A.addr_block(ks, _ii(i, j)), label="ld A")
                m = b.alu(a1, a2, label="*")
                acc = b.scan(m, init=vid, label="-")
                r = b.emit()
                vid = r.last(acc)
            A.store((i, j), Value(val, vid))


def k_trisolv(tr: Tracer, N: int, rng) -> None:
    """Forward substitution — inherently sequential."""
    L = tr.array(np.tril(_rand(rng, N, N)) + N * np.eye(N), "L")
    bvec = tr.array(_rand(rng, N), "b")
    x = tr.zeros(N, "x")
    for i in range(N):
        acc0 = bvec.load(i)
        val = float(acc0.val - L.arr[i, :i] @ x.arr[:i])
        vid = acc0.vid
        if i:
            js = np.arange(i)
            b = tr.block()
            l_ = b.load(L.addr_block(_ii(i, i), js), label="ld L")
            xv = b.load(x.addr_block(js), label="ld x")
            m = b.alu(l_, xv, label="*")
            acc = b.scan(m, init=vid, label="-")
            r = b.emit()
            vid = r.last(acc)
        x.store(i, tr.alu('/', Value(val, vid), L.load(i, i)))


def k_cholesky(tr: Tracer, N: int, rng) -> None:
    M = _rand(rng, N, N)
    M = M @ M.T + N * np.eye(N)
    A = tr.array(M, "A")
    import math
    for i in range(N):
        for j in range(i):
            acc0 = A.load(i, j)
            val = float(acc0.val - A.arr[i, :j] @ A.arr[j, :j])
            vid = acc0.vid
            if j:
                ks = np.arange(j)
                b = tr.block()
                a1 = b.load(A.addr_block(_ii(j, i), ks), label="ld A")
                a2 = b.load(A.addr_block(_ii(j, j), ks), label="ld A")
                m = b.alu(a1, a2, label="*")
                acc = b.scan(m, init=vid, label="-")
                r = b.emit()
                vid = r.last(acc)
            A.store((i, j), tr.alu('/', Value(val, vid), A.load(j, j)))
        acc0 = A.load(i, i)
        val = float(acc0.val - A.arr[i, :i] @ A.arr[i, :i])
        vid = acc0.vid
        if i:
            ks = np.arange(i)
            b = tr.block()
            a1 = b.load(A.addr_block(_ii(i, i), ks), label="ld A")
            a2 = b.load(A.addr_block(_ii(i, i), ks), label="ld A")
            m = b.alu(a1, a2, label="*")
            acc = b.scan(m, init=vid, label="-")
            r = b.emit()
            vid = r.last(acc)
        A.store((i, i), tr.alu(lambda v: math.sqrt(abs(v)) + 1e-12,
                               Value(val, vid), label="sqrt"))


def k_durbin(tr: Tracer, N: int, rng) -> None:
    r_ = tr.array(_rand(rng, N), "r")
    y, z = tr.zeros(N, "y"), tr.zeros(N, "z")
    y.store(0, tr.alu(lambda v: -v, r_.load(0), label="neg"))
    beta, alpha = tr.const(1.0), tr.alu(lambda v: -v, r_.load(0), label="neg")
    for k in range(1, N):
        beta = tr.alu('*', tr.alu(lambda a: 1 - a * a, alpha, label="1-a2"),
                      beta)
        idx = np.arange(k)
        b = tr.block()
        lr = b.load(r_.addr_block(k - 1 - idx), label="ld r")
        ly = b.load(y.addr_block(idx), label="ld y")
        m = b.alu(lr, ly, label="*")
        accs = b.scan(m, label="+")
        res = b.emit()
        acc = Value(float(r_.arr[:k][::-1] @ y.arr[:k]), res.last(accs))
        alpha = tr.alu(lambda s, rk, bt: -(rk + s) / (bt if abs(bt) > 1e-9
                                                      else 1e-9),
                       acc, r_.load(k), beta, label="alpha")
        newz = y.arr[:k] + alpha.val * y.arr[:k][::-1]
        b = tr.block()
        ly1 = b.load(y.addr_block(idx), label="ld y")
        ly2 = b.load(y.addr_block(k - 1 - idx), label="ld y")
        m = b.alu(alpha.vid, ly2, label="*")
        a = b.alu(ly1, m, label="+")
        b.store(z.addr_block(idx), value=a, label="st z")
        b.emit()
        z.arr[:k] = newz
        b = tr.block()
        lz = b.load(z.addr_block(idx), label="ld z")
        b.store(y.addr_block(idx), value=lz, label="st y")
        b.emit()
        y.arr[:k] = z.arr[:k]
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
            if i + 1 < N:
                ks = np.arange(i + 1, N)
                n_ = len(ks)
                b = tr.block()
                bij = b.load(B.addr_block(_ii(n_, i), _ii(n_, j)),
                             label="ld B")                 # spilled accumulator
                a = b.load(A.addr_block(ks, _ii(n_, i)), label="ld A")
                bkj = b.load(B.addr_block(ks, _ii(n_, j)), label="ld B")
                m = b.alu(a, bkj, label="*")
                ad = b.alu(bij, m, label="+")
                b.store(B.addr_block(_ii(n_, i), _ii(n_, j)), value=ad,
                        label="st B")                      # ...store every iter
                b.emit()
                B.arr[i, j] += float(A.arr[i + 1:, i] @ B.arr[i + 1:, j])
            B.store((i, j), tr.alu('*', alpha, B.load(i, j)))


SCALAR_KERNELS = {
    "2mm": k_2mm, "3mm": k_3mm, "atax": k_atax, "bicg": k_bicg,
    "doitgen": k_doitgen, "mvt": k_mvt, "gemm": k_gemm, "gemver": k_gemver,
    "gesummv": k_gesummv, "symm": k_symm, "syr2k": k_syr2k, "syrk": k_syrk,
    "trmm": k_trmm, "lu": k_lu, "trisolv": k_trisolv,
    "cholesky": k_cholesky, "durbin": k_durbin, "trmm_spill": k_trmm_spill,
}

# the paper's 15 linear-algebra benchmarks (Fig 10-13)
PAPER_15 = ["2mm", "3mm", "atax", "bicg", "doitgen", "mvt", "gemm", "gemver",
            "gesummv", "symm", "syr2k", "syrk", "trmm", "lu", "trisolv"]


def trace_kernel(name: str, N: int, cache=None, max_regs=None,
                 false_deps: bool = False, seed: int = 0):
    """Run one kernel under the tracer; returns the finalized eDAG.

    Always uses the bulk block-emission kernels: under ``max_regs`` /
    ``false_deps`` the blocks replay through the scalar emitters with the
    §3.2.1 bounded-register-file spill model applied op by op, so the §5.1
    register-pressure studies produce eDAGs byte-identical to the retained
    per-element reference implementations (tested in
    tests/test_vector_engine.py)."""
    rng = np.random.default_rng(seed)
    tr = Tracer(cache=cache, max_regs=max_regs, false_deps=false_deps)
    SCALAR_KERNELS[name](tr, N, rng)
    return tr.edag


# --------------------------------------------------------------------------
# PyTorch twins (same math as the scalar kernels' C semantics) for the
# PyTorch-graph frontend and for running on the card.  They run on the
# device of their inputs; no Python control flow depends on the data.
# --------------------------------------------------------------------------

def t_2mm(A, B, C, D, alpha=1.5, beta=1.2):
    return (alpha * A @ B) @ C + beta * D

def t_3mm(A, B, C, D):
    return (A @ B) @ (C @ D)

def t_atax(A, x):
    return A.T @ (A @ x)

def t_bicg(A, p, r):
    return A @ p, A.T @ r

def t_mvt(A, x1, x2, y1, y2):
    return x1 + A @ y1, x2 + A.T @ y2

def t_gemm(A, B, C, alpha=1.5, beta=1.2):
    return alpha * A @ B + beta * C

def _outer(u, v):
    # as jnp.outer forms it: a column times a row
    return u.unsqueeze(1) * v.unsqueeze(0)

def t_gemver(A, u1, v1, u2, v2, y, z, alpha=1.5, beta=1.2):
    A = A + _outer(u1, v1) + _outer(u2, v2)
    x = beta * (A.T @ y) + z
    return A, x, alpha * (A @ x)

def t_gesummv(A, B, x, alpha=1.5, beta=1.2):
    return alpha * (A @ x) + beta * (B @ x)

def t_syrk(A, C, alpha=1.5, beta=1.2):
    return alpha * A @ A.T + beta * C

def t_syr2k(A, B, C, alpha=1.5, beta=1.2):
    return alpha * (A @ B.T + B @ A.T) + beta * C

def _trisolv_step(x, row):
    Li, bi, di, ei = row
    xi = (bi - Li @ x) / di
    return torch.where(ei, xi, x), ()

def t_trisolv(L, b):
    """Forward substitution as a scan over the rows of L.  Row i's inputs
    arrive as scanned slices (its row of L, b_i, L_ii and the one-hot row
    selecting x_i), since a scan body may not index with the step counter;
    ``where`` sets x_i as ``.at[i].set`` does."""
    from torch._higher_order_ops.scan import scan
    eye = torch.eye(b.shape[0], dtype=torch.bool, device=b.device)
    x, _ = scan(_trisolv_step, torch.zeros_like(b),
                (L, b, torch.diagonal(L), eye))
    return x

TORCH_KERNELS = {
    "2mm": t_2mm, "3mm": t_3mm, "atax": t_atax, "bicg": t_bicg,
    "mvt": t_mvt, "gemm": t_gemm, "gemver": t_gemver, "gesummv": t_gesummv,
    "syrk": t_syrk, "syr2k": t_syr2k, "trisolv": t_trisolv,
}

#: each twin's arguments: M an N x N matrix, v an N vector, L a lower
#: triangle with N on its diagonal
TWIN_ARGS = {
    "2mm": "MMMM", "3mm": "MMMM", "atax": "Mv", "bicg": "Mvv",
    "mvt": "Mvvvv", "gemm": "MMM", "gemver": "Mvvvvvv", "gesummv": "MMv",
    "syrk": "MM", "syr2k": "MMM", "trisolv": "Lv",
}


def twin_inputs(name: str, N: int, seed: int = 0) -> list:
    """Seeded float64 numpy inputs of twin ``name`` at size ``N``."""
    rng = np.random.default_rng(seed)
    out = []
    for kind in TWIN_ARGS[name]:
        if kind == "v":
            out.append(rng.standard_normal(N))
        elif kind == "M":
            out.append(rng.standard_normal((N, N)))
        else:
            out.append(np.tril(rng.standard_normal((N, N))) + N * np.eye(N))
    return out


def twin_numpy(name: str, args) -> tuple:
    """What twin ``name`` computes, in float64 numpy (trisolv row by
    row): the oracle the twins are held to."""
    a, b = 1.5, 1.2
    if name == "2mm":
        A, B, C, D = args
        return ((a * A @ B) @ C + b * D,)
    if name == "3mm":
        A, B, C, D = args
        return ((A @ B) @ (C @ D),)
    if name == "atax":
        A, x = args
        return (A.T @ (A @ x),)
    if name == "bicg":
        A, p, r = args
        return A @ p, A.T @ r
    if name == "mvt":
        A, x1, x2, y1, y2 = args
        return x1 + A @ y1, x2 + A.T @ y2
    if name == "gemm":
        A, B, C = args
        return (a * A @ B + b * C,)
    if name == "gemver":
        A, u1, v1, u2, v2, y, z = args
        A = A + np.outer(u1, v1) + np.outer(u2, v2)
        x = b * (A.T @ y) + z
        return A, x, a * (A @ x)
    if name == "gesummv":
        A, B, x = args
        return (a * (A @ x) + b * (B @ x),)
    if name == "syrk":
        A, C = args
        return (a * A @ A.T + b * C,)
    if name == "syr2k":
        A, B, C = args
        return (a * (A @ B.T + B @ A.T) + b * C,)
    L, bv = args
    x = np.zeros_like(bv)
    for i in range(len(bv)):
        x[i] = (bv[i] - L[i, :i] @ x[:i]) / L[i, i]
    return (x,)
