"""Quickstart: EDAN in five minutes, the port's twin of the JAX package's
``examples/quickstart.py``.

1. Trace a scalar kernel -> eDAG -> the paper's metrics (W, D, lambda,
   Lambda, B) with and without a cache.
2. Analyze a PyTorch function's graph the same way (``core.fxgraph``).
3. Ask the question the paper asks: "how much slower does this get per
   nanosecond of added memory latency?" — and check the answer against the
   discrete-event simulator.

The metrics' depths and the simulator's replays run the level kernel (K1)
on the card, or its plain version with ``--device cpu``.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
      [--device cpu] [--n 64]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core import (CostModelParams, Tracer, edag_from_fn, make_cache,
                    memory_cost_bounds, non_memory_cost, report, simulate,
                    total_cost_bounds)
from ._device import add_device_arg, on_device


def scalar(n: int, rng, emit) -> dict:
    emit("== 1. scalar trace: dot product vs pointer chase ==")
    tr = Tracer()
    a = tr.array(rng.standard_normal(n), "a")
    b = tr.array(rng.standard_normal(n), "b")
    acc = tr.const(0.0)
    for i in range(n):
        acc = tr.alu('+', acc, tr.alu('*', a.load(i), b.load(i)))
    dot = report(tr.edag)
    emit(f"dot:   W={dot.W:4d} D={dot.D:2d} lambda={dot.lam:6.1f} "
         f"Lambda={dot.Lam:.4f}  (independent loads -> depth 1)")

    tr = Tracer()
    nxt = tr.array(np.roll(np.arange(n), -1), "next")
    p = nxt.load(0)
    for _ in range(n - 1):
        p = nxt.load(p)
    chase = report(tr.edag)
    emit(f"chase: W={chase.W:4d} D={chase.D:2d} lambda={chase.lam:6.1f} "
         f"Lambda={chase.Lam:.4f}  (dependent loads -> depth = W)")

    # a cache cuts the memory work
    tr = Tracer(cache=make_cache(32 * 1024))
    a = tr.array(rng.standard_normal(n), "a")
    for _ in range(8):
        for i in range(n):
            a.load(i)
    cached = report(tr.edag)
    emit(f"8x reread w/ 32kB cache: W={cached.W} (cold lines only)")
    return dict(dot=dot, chase=chase, cached=cached)


def pytorch_graph(device: str, emit):
    emit("\n== 2. PyTorch frontend: a PyTorch function's eDAG ==")

    def f(x, w1, w2):
        h = torch.tanh(x @ w1)
        return (h @ w2).sum()

    args = [torch.ones(s, device=device) for s in ((32, 64), (64, 128),
                                                   (128, 8))]
    g = edag_from_fn(f, *args, mem_threshold_bytes=1024)
    r = report(g, CostModelParams(m=4, alpha=200.0))
    emit(f"eDAG: {g.n_vertices} vertices, W={r.W}, D={r.D}, "
         f"parallelism={r.parallelism:.1f}, lambda={r.lam:.1f}")
    return g, r


def bounds_vs_simulation(n: int, rng, emit) -> list:
    emit("\n== 3. Eq 2 bounds vs greedy simulation (alpha sweep) ==")
    tr = Tracer()
    A = tr.array(rng.standard_normal((n, n)), "A")
    x = tr.array(rng.standard_normal(n), "x")
    y = tr.zeros(n, "y")
    for i in range(n):
        s = tr.const(0.0)
        for j in range(n):
            s = tr.alu('+', s, tr.alu('*', A.load(i, j), x.load(j)))
        y.store(i, s)
    g = tr.edag
    lay = g.mem_layers()
    C = non_memory_cost(g)
    emit("alpha  mem_lower  simulated  upper   (compute overlaps the memory")
    emit("                                      lower bound; Eq 2's upper "
         "adds C)")
    rows = []
    for alpha in (50, 100, 200, 300):
        mlo, _ = memory_cost_bounds(lay.W, lay.D, 4, alpha)
        _, hi = total_cost_bounds(lay.W, lay.D, 4, alpha, C)
        t = simulate(g, m=4, alpha=alpha)
        rows.append((alpha, mlo, t, hi))
        emit(f"{alpha:5d}  {mlo:9.0f} {t:9.0f} {hi:7.0f}")
    emit(f"\nd(sim)/d(alpha) ~= lambda = "
         f"{lay.W / 4 + (1 - 1 / 4) * lay.D:.1f} (the paper's Eq 3)")
    return rows


def main(argv=None, emit=print) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(ap)
    ap.add_argument("--n", type=int, default=64,
                    help="vector length of part 1 (part 3's matrix is n/4)")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    with on_device(args.device):
        out = scalar(args.n, rng, emit)
        out["graph"], out["graph_report"] = pytorch_graph(args.device, emit)
        out["bounds"] = bounds_vs_simulation(max(args.n // 4, 2), rng, emit)
    return out


if __name__ == "__main__":
    main()
