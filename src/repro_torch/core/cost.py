"""Memory cost model (§3.3.1, Eq 1-2) — a Brent's-lemma analogue.

Memory-access vertices (cache misses that go to RAM) cost alpha each; m of
them can be issued in parallel; everything else contributes a constant C.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .graph import EDag, MemLayering


@dataclass
class CostModelParams:
    m: int = 4            # memory issue slots (paper's validation uses m=4)
    alpha: float = 200.0  # RAM access latency in cycles (paper §5.2 uses 200)
    alpha0: float = 50.0  # baseline latency for the relative metric (§4.2)
    unit: float = 1.0     # cost of non-memory vertices


def memory_cost_bounds(W: int, D: int, m: int, alpha: float):
    """Eq 1:  max(D, W/m)*alpha  <=  M  <=  ((W-D)/m + D)*alpha."""
    lo = max(D, W / m) * alpha
    hi = ((W - D) / m + D) * alpha
    return lo, hi


def total_cost_bounds(W: int, D: int, m: int, alpha: float, C: float):
    """Eq 2: the Eq-1 bounds plus the constant non-memory cost C."""
    lo, hi = memory_cost_bounds(W, D, m, alpha)
    return lo + C, hi + C


def layered_upper_bound(layer_sizes: np.ndarray, m: int, alpha: float) -> float:
    """The exact greedy per-layer cost  sum_i ceil(W_i/m) * alpha  used in the
    paper's upper-bound derivation; tighter than Eq 1's closed form."""
    return float(np.ceil(np.asarray(layer_sizes) / m).sum() * alpha)


def non_memory_cost(g: EDag, unit: float = 1.0) -> float:
    """C: the paper's validation (§4.2) takes C = #non-memory vertices."""
    g._finalize()
    return float((~g.is_mem).sum() * unit)


def analyze(g: EDag, params: CostModelParams = CostModelParams()):
    """All §3.3.1 quantities for one eDAG under one parameter set."""
    lay: MemLayering = g.mem_layers()
    C = non_memory_cost(g, params.unit)
    lo, hi = total_cost_bounds(lay.W, lay.D, params.m, params.alpha, C)
    return dict(W=lay.W, D=lay.D, C=C, layer_sizes=lay.layer_sizes,
                t_lower=lo, t_upper=hi,
                m=params.m, alpha=params.alpha)
