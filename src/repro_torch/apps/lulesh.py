"""LULESH-style explicit shock hydrodynamics proxy (§5.3).

LULESH 2.0's LagrangeLeapFrog step is approximated by its memory-system
signature: per-element gathers of 8 corner nodes, element-centered physics,
scatter-adds of nodal forces (read-modify-write through memory — elements
sharing a node serialize, the irregular-dependence pattern the paper
highlights), then nodal integration and element quantity updates.  The
physics is simplified (this is a proxy, noted in DESIGN.md); the access
pattern — gather / compute / scatter-add / update — is the LULESH kernel
skeleton.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.backend import device_for
from ..core.trace import Tracer


def mesh_connectivity(ne: int):
    """Hex mesh: (ne)^3 elements over (ne+1)^3 nodes; returns (nelem, 8) ids."""
    nn = ne + 1
    conn = np.zeros((ne ** 3, 8), dtype=np.int64)
    e = 0
    for i in range(ne):
        for j in range(ne):
            for k in range(ne):
                n0 = (i * nn + j) * nn + k
                conn[e] = [n0, n0 + 1, n0 + nn, n0 + nn + 1,
                           n0 + nn * nn, n0 + nn * nn + 1,
                           n0 + nn * nn + nn, n0 + nn * nn + nn + 1]
                e += 1
    return conn


# ------------------------------------------------------------------- scalar
#
# The three phase loops are emitted as one BlockBuilder nest each (uniform
# 8-corner slots), in the exact per-element program order of the reference
# implementation — ``reference.trace_step_ref`` — so the eDAG, including the
# cache-model hit/miss classification and the scatter-add RMW chains through
# F, is byte-for-byte identical (asserted by tests/test_vector_engine.py).

def trace_step(ne: int = 6, iters: int = 2, cache=None, seed: int = 0):
    """Block-traced leapfrog steps; returns the eDAG."""
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

    elems = np.arange(nelem)
    nodes = np.arange(nnode)
    for _ in range(iters):
        # 1. CalcForceForNodes: gather corners, element physics, scatter-add
        b = tr.block()
        corners = [b.load(X.addr_block(conn[:, c]), label="ld x")
                   for c in range(8)]
        vol = corners[0]
        for cv in corners[1:]:
            vol = b.alu(vol, cv, label="+")
        en = b.load(E.addr_block(elems), label="ld e")
        press = b.alu(en, vol, label="*")
        qv = b.load(Q.addr_block(elems), label="ld q")
        press = b.alu(press, qv, label="+")
        share = b.alu(press, label="*")                  # press * 0.125
        for c in range(8):
            f = b.load(F.addr_block(conn[:, c]), label="ld f")
            b.store(F.addr_block(conn[:, c]),            # RMW through memory
                    value=b.alu(f, share, label="+"), label="st f")
        b.emit()
        # 2. nodal integration: a = F/m; v += a dt; x += v dt; F = 0
        b = tr.block()
        lf = b.load(F.addr_block(nodes), label="ld f")
        lm = b.load(M.addr_block(nodes), label="ld m")
        a = b.alu(lf, lm, label="/")
        lv = b.load(V.addr_block(nodes), label="ld v")
        adt = b.alu(a, label="*")                        # a * dt
        v = b.alu(lv, adt, label="+")
        b.store(V.addr_block(nodes), value=v, label="st v")
        lx = b.load(X.addr_block(nodes), label="ld x")
        vdt = b.alu(v, label="*")                        # v * dt
        b.store(X.addr_block(nodes),
                value=b.alu(lx, vdt, label="+"), label="st x")
        b.store(F.addr_block(nodes), label="st f")       # F = 0 (const)
        b.emit()
        # 3. CalcQForElems: gather velocities, update element viscosity/energy
        b = tr.block()
        g = b.load(V.addr_block(conn[:, 0]), label="ld v")
        for c in range(1, 8):
            g = b.alu(g, b.load(V.addr_block(conn[:, c]), label="ld v"),
                      label="-")
        b.store(Q.addr_block(elems), value=b.alu(g, g, label="*"),
                label="st q")
        le = b.load(E.addr_block(elems), label="ld e")
        lq = b.load(Q.addr_block(elems), label="ld q")
        qdt = b.alu(lq, label="*")                       # q * dt
        b.store(E.addr_block(elems),
                value=b.alu(le, qdt, label="+"), label="st e")
        b.emit()
    return tr.edag


# -------------------------------------------------------------------- torch

def _device(device) -> torch.device:
    """``device`` as given, else the selected backend's (the card unless
    ``$EDAN_TORCH_BACKEND`` says otherwise; never the host on its own)."""
    return device_for(None) if device is None else torch.device(device)


def make_torch_step(ne: int, device=None):
    """One leapfrog step over the mesh's connectivity (held on ``device``,
    default the selected backend's):
    ``step(state, _=None) -> (state, sum(e))``, state ``(x, v, e, q, m)``.
    The scatter-add of nodal forces is ``index_add``."""
    conn = torch.as_tensor(mesh_connectivity(ne), device=_device(device))
    flat = conn.reshape(-1)

    def step(state, _=None):
        x, v, e, q, m = state
        corners = x[conn]                                 # (nelem, 8) gather
        vol = corners.sum(dim=1)
        press = e * vol + q
        share = press * 0.125
        f = torch.zeros_like(x).index_add(
            0, flat, share.repeat_interleave(8))          # scatter-add
        a = f / m
        v = v + a * 1e-3
        x = x + v * 1e-3
        gv = v[conn]
        g = gv[:, 0] - gv[:, 1:].sum(dim=1)
        q = g * g
        e = e + q * 1e-3
        return (x, v, e, q, m), torch.sum(e)

    return step


def initial_state(ne: int, seed: int = 0) -> tuple:
    """The seeded float64 numpy state ``(x, v, e, q, m)`` the reference's
    JAX run starts from."""
    rng = np.random.default_rng(seed)
    nnode = (ne + 1) ** 3
    nelem = ne ** 3
    return (rng.standard_normal(nnode), np.zeros(nnode),
            np.abs(rng.standard_normal(nelem)) + 1.0, np.zeros(nelem),
            np.abs(rng.standard_normal(nnode)) + 1.0)


def run_steps(step, state, iters: int):
    """``iters`` steps from ``state``: (final state, stacked sum(e)).  The
    steps are a Python loop, which tracing unrolls."""
    hist = []
    for _ in range(iters):
        state, h = step(state)
        hist.append(h)
    return state, torch.stack(hist)


def run_torch(ne: int = 6, iters: int = 2, seed: int = 0, device=None,
              dtype=torch.float64):
    """``iters`` steps from ``initial_state(ne, seed)`` on ``device``
    (default the selected backend's): (final state, stacked sum(e))."""
    device = _device(device)
    state = tuple(torch.as_tensor(a, dtype=dtype, device=device)
                  for a in initial_state(ne, seed))
    return run_steps(make_torch_step(ne, device), state, iters)


def lulesh_numpy(ne: int, iters: int, seed: int = 0):
    """The leapfrog step in float64 numpy (``np.add.at`` scatter-add): the
    oracle the twin is held to."""
    conn = mesh_connectivity(ne)
    x, v, e, q, m = (a.copy() for a in initial_state(ne, seed))
    hist = []
    for _ in range(iters):
        vol = x[conn].sum(axis=1)
        share = (e * vol + q) * 0.125
        f = np.zeros_like(x)
        np.add.at(f, conn.reshape(-1), np.repeat(share, 8))
        v = v + (f / m) * 1e-3
        x = x + v * 1e-3
        gv = v[conn]
        g = gv[:, 0] - gv[:, 1:].sum(axis=1)
        q = g * g
        e = e + q * 1e-3
        hist.append(e.sum())
    return (x, v, e, q, m), np.array(hist)
