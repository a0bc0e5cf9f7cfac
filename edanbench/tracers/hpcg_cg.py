"""HPCG's CG solve on an ``n``^3 grid for ``iters`` iterations with no
cache, traced by the program; ``seed`` draws the right-hand side."""
from __future__ import annotations

from repro_torch.apps.hpcg import trace_cg


def build(cfg: dict, seed: int) -> dict:
    g = trace_cg(n=int(cfg["n"]), iters=int(cfg["iters"]), seed=seed)[0]
    g._finalize()
    return {"cg": g}
