"""HPCG-style conjugate gradient on a 3D 27-point stencil (§5.2).

The paper traces HPCG 3.1's CG phase (setup excluded).  We implement the same
computational core — SpMV over the 27-point stencil operator (diag 26,
off-diag -1), dot products, and AXPYs — in the scalar trace DSL.
The paper's multigrid preconditioner is omitted (plain CG); this keeps the
trace focused on the latency-relevant SpMV/dot pattern and is noted in
DESIGN.md.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.trace import Tracer, Value


def neighbor_offsets():
    return [(dx, dy, dz)
            for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
            if not (dx == dy == dz == 0)]


def build_problem(n: int, seed: int = 0):
    """b for A x = b with A = 27-pt stencil (diag 26, off-diag -1)."""
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(n ** 3)
    return b


def _nidx(i, j, k, n):
    return (i * n + j) * n + k


def spmv_numpy(p: np.ndarray, n: int) -> np.ndarray:
    out = 26.0 * p.copy()
    P = p.reshape(n, n, n)
    O = out.reshape(n, n, n)
    for dx, dy, dz in neighbor_offsets():
        xs = slice(max(0, -dx), n - max(0, dx))
        ys = slice(max(0, -dy), n - max(0, dy))
        zs = slice(max(0, -dz), n - max(0, dz))
        xd = slice(max(0, dx), n - max(0, -dx))
        yd = slice(max(0, dy), n - max(0, -dy))
        zd = slice(max(0, dz), n - max(0, -dz))
        O[xd, yd, zd] -= P[xs, ys, zs]
    return out


# ----------------------------------------------------------------- scalar CG
#
# The CG loops are emitted through the bulk block API (one BlockBuilder nest
# per vector loop, one masked-grid emit_block for the ragged 27-point SpMV).
# Slot order reproduces the per-element reference loop order byte-for-byte
# — including the cache access stream — so the eDAG is identical to
# ``reference.trace_cg_ref`` (asserted by tests/test_vector_engine.py).
# Numeric state is carried by the same vectorized expressions as
# ``reference_solution``, so the residual histories agree exactly.

def _emit_spmv_block(tr: Tracer, p, Ap, n: int) -> None:
    """One SpMV over the 27-point stencil as a single vertex block.

    Per grid point the reference emits [ld p(i); mul; (ld p(j); sub)*
    for each in-bounds neighbor; st Ap(i)].  The ragged neighbor count is
    handled by laying the ops on a (points, 55) grid, masking the
    out-of-bounds slots, and flattening row-major — which is exactly the
    reference program order."""
    offs = np.asarray(neighbor_offsets(), dtype=np.int64)      # (26, 3)
    pts = np.stack(np.meshgrid(np.arange(n), np.arange(n), np.arange(n),
                               indexing="ij"), axis=-1).reshape(-1, 3)
    P = len(pts)
    i_lin = (pts[:, 0] * n + pts[:, 1]) * n + pts[:, 2]
    nb = pts[:, None, :] + offs[None, :, :]                    # (P, 26, 3)
    valid = ((nb >= 0) & (nb < n)).all(axis=-1)                # (P, 26)
    nb_lin = (nb[..., 0] * n + nb[..., 1]) * n + nb[..., 2]

    C = 2 + 2 * len(offs) + 1          # ld, mul, (ld, sub)*26, st
    LOAD, STORE, ALU = tr.LOAD, tr.STORE, tr.ALU
    kind_row = np.empty(C, dtype=np.int64)
    kind_row[0], kind_row[1], kind_row[-1] = LOAD, ALU, STORE
    kind_row[2:-1:2], kind_row[3:-1:2] = LOAD, ALU
    kind_g = np.broadcast_to(kind_row, (P, C)).copy()
    mask_g = np.ones((P, C), dtype=bool)
    mask_g[:, 2:-1:2] = valid
    mask_g[:, 3:-1:2] = valid
    addr_g = np.full((P, C), -1, dtype=np.int64)
    addr_g[:, 0] = p.addr_block(i_lin)
    # out-of-bounds neighbor indices are masked out; clip them into range
    # so the vectorized address computation stays defined everywhere
    addr_g[:, 2:-1:2] = np.where(
        valid, p.addr_block(nb_lin.clip(0, n ** 3 - 1)), -1)
    addr_g[:, -1] = Ap.addr_block(i_lin)

    # vertex ids of the surviving ops, row-major
    mask_f = mask_g.ravel()
    base = tr.g.n_vertices
    vid_f = np.where(mask_f, base + np.cumsum(mask_f) - 1, -1)
    vid_g = vid_f.reshape(P, C)
    # running accumulator vid: forward-fill over the alu columns
    alu_cols = np.concatenate(([1], np.arange(3, C - 1, 2)))
    acc_ff = np.maximum.accumulate(
        np.where(mask_g[:, alu_cols], vid_g[:, alu_cols], -1), axis=1)
    dep0 = np.full((P, C), -1, dtype=np.int64)
    dep1 = np.full((P, C), -1, dtype=np.int64)
    dep0[:, 1] = vid_g[:, 0]                       # mul <- ld p(i)
    dep0[:, 3:-1:2] = acc_ff[:, :-1]               # sub <- previous acc
    dep1[:, 3:-1:2] = vid_g[:, 2:-1:2]             # sub <- ld p(j)
    dep0[:, -1] = acc_ff[:, -1]                    # st  <- final acc

    lbl_row = np.array(["ld p", "*"] + ["ld p", "-"] * len(offs) + ["st Ap"])
    labels = np.broadcast_to(lbl_row, (P, C)).ravel()[mask_f].tolist()
    nb_row = np.where(kind_row == ALU, 0.0, 8.0)
    nbytes = np.broadcast_to(nb_row, (P, C)).ravel()[mask_f]
    deps = np.column_stack((dep0.ravel()[mask_f], dep1.ravel()[mask_f]))
    tr.emit_block(kind_g.ravel()[mask_f], addr_g.ravel()[mask_f],
                  nbytes, deps, labels)


def trace_cg(n: int = 8, iters: int = 5, cache=None, seed: int = 0):
    """Block-traced CG; returns (eDAG, residual_history)."""
    tr = Tracer(cache=cache)
    N = n ** 3
    b_np = build_problem(n, seed)
    idx = np.arange(N)

    b = tr.array(b_np, "b")
    x = tr.zeros(N, "x")
    r = tr.zeros(N, "r")
    p = tr.zeros(N, "p")
    Ap = tr.zeros(N, "Ap")

    # r = b; p = b  (x0 = 0)
    blk = tr.block()
    lb = blk.load(b.addr_block(idx), label="ld b")
    blk.store(r.addr_block(idx), value=lb, label="st r")
    blk.store(p.addr_block(idx), value=lb, label="st p")
    blk.emit()
    r.arr[:] = b.arr
    p.arr[:] = b.arr

    def dot(u, v):
        blk = tr.block()
        lu = blk.load(u.addr_block(idx), label="ld")
        lv = blk.load(v.addr_block(idx), label="ld")
        m = blk.alu(lu, lv, label="*")
        acc = blk.scan(m, label="+")
        res = blk.emit()
        return Value(float(u.arr @ v.arr), res.last(acc))

    def axpy_update(dst, src, coef, op_label):
        """dst[i] (op)= coef * src[i] elementwise, reference slot order."""
        blk = tr.block()
        ld = blk.load(dst.addr_block(idx), label=f"ld {dst.name}")
        ls = blk.load(src.addr_block(idx), label=f"ld {src.name}")
        m = blk.alu(coef.vid, ls, label="*")
        a = blk.alu(ld, m, label=op_label)
        blk.store(dst.addr_block(idx), value=a, label=f"st {dst.name}")
        blk.emit()

    res = []
    rs_old = dot(r, r)
    for _ in range(iters):
        _emit_spmv_block(tr, p, Ap, n)
        Ap.arr[:] = spmv_numpy(p.arr, n)
        pAp = dot(p, Ap)
        alpha = tr.alu(lambda a, c: a / c if abs(c) > 1e-30 else 0.0,
                       rs_old, pAp, label="div")
        axpy_update(x, p, alpha, "+")
        x.arr += alpha.val * p.arr
        axpy_update(r, Ap, alpha, "-")
        r.arr -= alpha.val * Ap.arr
        rs_new = dot(r, r)
        beta = tr.alu(lambda a, c: a / c if abs(c) > 1e-30 else 0.0,
                      rs_new, rs_old, label="div")
        # p = r + beta * p  (reference order: ld r, ld p, mul, add, st p)
        newp = r.arr + beta.val * p.arr
        blk = tr.block()
        lr = blk.load(r.addr_block(idx), label="ld r")
        lp = blk.load(p.addr_block(idx), label="ld p")
        m = blk.alu(beta.vid, lp, label="*")
        a = blk.alu(lr, m, label="+")
        blk.store(p.addr_block(idx), value=a, label="st p")
        blk.emit()
        p.arr[:] = newp
        rs_old = rs_new
        res.append(float(rs_new.val))
    return tr.edag, res


# ------------------------------------------------------------------ torch CG

def spmv_torch(p, n: int):
    """The 27-point stencil product on the device of ``p``.  Each
    neighbour's contribution is read from a zero-padded copy of the grid,
    so the halo adds nothing, as the numpy and scalar versions skip it;
    the neighbours are subtracted in ``neighbor_offsets`` order."""
    P = p.reshape(n, n, n)
    Pp = torch.nn.functional.pad(P, (1, 1, 1, 1, 1, 1))
    out = 26.0 * P
    for dx, dy, dz in neighbor_offsets():
        out = out - Pp[1 - dx:1 - dx + n, 1 - dy:1 - dy + n,
                       1 - dz:1 - dz + n]
    return out.reshape(-1)


def cg_torch(b, n: int, iters: int):
    """Plain CG on the device of ``b``; returns x and the residual history
    (r·r after each iteration).  The iterations are a Python loop, which
    tracing unrolls."""
    x = torch.zeros_like(b)
    r, p, rs_old = b, b, torch.dot(b, b)
    hist = []
    for _ in range(iters):
        Ap = spmv_torch(p, n)
        alpha = rs_old / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / rs_old) * p
        rs_old = rs_new
        hist.append(rs_new)
    return x, torch.stack(hist)


def reference_solution(n: int, iters: int, seed: int = 0):
    """NumPy CG for cross-validation of the traced and torch versions."""
    b = build_problem(n, seed)
    x = np.zeros_like(b)
    r = b.copy(); p = b.copy(); rs_old = r @ r
    hist = []
    for _ in range(iters):
        Ap = spmv_numpy(p, n)
        alpha = rs_old / (p @ Ap)
        x += alpha * p
        r -= alpha * Ap
        rs_new = r @ r
        p = r + (rs_new / rs_old) * p
        rs_old = rs_new
        hist.append(rs_new)
    return x, np.array(hist)
