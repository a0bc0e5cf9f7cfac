"""Latency sensitivity at object and fabric-axis granularity (beyond the
paper).

Applies the paper's Eq 3-4 to other kinds of "memory access":

* ``object_sensitivity`` — the accesses of one traced data object: ``W_o``
  its access count, ``D_o`` its chained depth from one shared
  ``mem_layers`` pass.  It is the ranking key of the greedy disaggregation
  placement (``placement.search_placement``).
* ``collective_sensitivity`` / ``axis_latency_sweep`` /
  ``axis_latency_grid`` / ``suite_axis_latency_grid`` — the collectives on
  one mesh axis of a compiled step: alpha is that axis's per-collective
  latency and m the number of concurrently progressing collective
  channels, so ``lambda_axis = (W_ax - D_ax)/m + D_ax`` is
  d(step_time)/d(alpha_axis).

``collective_sensitivity`` reads a compiled module's HLO text through
``hlo.analyze_collectives``, whose per-axis depths are ``mem_layers``
passes of the level kernel.  The axis grids over its table are closed-form
broadcasts (no level kernel runs, so they take no ``plan.ExecPolicy``);
their (alpha, m) axes go through the same ``plan.SweepSpec`` the replay
sweeps use.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np

from .hlo import analyze_collectives
from .metrics import lambda_abs, lambda_rel
from .plan import SweepSpec

# Default per-collective latencies (seconds) by mesh axis: a tight ring on
# the innermost axis, a larger ring across it, and a slower fabric between
# groups of hosts.  These are order-of-magnitude fabric constants, not
# measurements; they are the reference package's defaults.
DEFAULT_ALPHAS = {
    "model": 1e-6,
    "data": 2e-6,
    "data+model": 2e-6,
    "pod": 10e-6,
    "pod+data": 10e-6,
    "pod+data+model": 10e-6,
}


@dataclass
class AxisSensitivity:
    axis: str
    W: float                # collectives per step on this axis
    D: float                # collective depth (chained) per step
    bytes: float
    lam: float              # d(step)/d(alpha_axis), dimensionless count
    lam_seconds: float      # lam * alpha_axis: seconds lost per step now

    def row(self):
        return dict(axis=self.axis, W=self.W, D=self.D, bytes=self.bytes,
                    lam=self.lam, lam_seconds=self.lam_seconds)


def collective_sensitivity(hlo_text: str,
                           mesh_axis_sizes: Sequence[Tuple[str, int]],
                           m: int = 4,
                           alphas: Dict[str, float] = None) -> dict:
    """Per-axis lambda from a compiled module's HLO text."""
    alphas = dict(DEFAULT_ALPHAS, **(alphas or {}))
    stats = analyze_collectives(hlo_text, mesh_axis_sizes)
    out = {}
    for axis, st in stats["per_axis"].items():
        lam = lambda_abs(st["count"], st["depth"], m)
        a = alphas.get(axis, 5e-6)
        out[axis] = AxisSensitivity(axis=axis, W=st["count"], D=st["depth"],
                                    bytes=st["bytes"], lam=lam,
                                    lam_seconds=lam * a)
    return dict(per_axis=out, raw=stats)


def axis_latency_sweep(per_axis: Dict[str, AxisSensitivity],
                       alphas: Sequence[float],
                       step_seconds: float) -> dict:
    """Batched per-axis fabric-latency sweep (Eq 3-4 over an alpha grid).

    Evaluates every (axis, alpha) pair in one stacked pass: the projected
    step-time deltas are a single ``np.outer`` over the axis lambda vector
    and the alpha grid, and the relative sensitivities one vectorized
    divide over the whole (n_axes, n_alphas) matrix — no Python loop over
    axes or points.  Returns ``{axis: {alphas, lam_seconds, Lam}}``.
    """
    alphas = np.asarray(alphas, dtype=np.float64)
    axes = list(per_axis)
    if not axes:
        return {}
    lam = np.array([per_axis[a].lam for a in axes])
    base = np.maximum(step_seconds -
                      np.array([per_axis[a].lam_seconds for a in axes]), 0.0)
    lam_seconds = np.outer(lam, alphas)                 # (n_axes, n_alphas)
    denom = lam_seconds + base[:, None]
    Lam = np.divide(lam_seconds, denom,
                    out=np.zeros_like(denom), where=denom > 0)
    return {axis: dict(alphas=alphas, lam_seconds=lam_seconds[i],
                       Lam=Lam[i]) for i, axis in enumerate(axes)}


def axis_latency_grid(per_axis: Dict[str, AxisSensitivity],
                      alphas: Sequence[float],
                      ms: Sequence[int],
                      step_seconds: float) -> dict:
    """Eq 3-4 over the full (axis, m, alpha) product in one stacked pass.

    Generalizes ``axis_latency_sweep`` by also sweeping m — the number of
    concurrently-progressing collective channels per chip, i.e. how much
    communication/computation overlap the runtime can sustain.  That is
    the second knob of the disaggregation capacity-planning question
    ("how much latency can we tolerate *if* we also widen the channel
    pool?"), mirroring ``scheduler.sweep_grid`` on the analytic side.

    lambda is recomputed per (axis, m) from the axis's W and D via Eq 3;
    the projected step-time deltas and relative sensitivities then come
    from one broadcast (n_axes, n_ms, n_alphas) expression — no
    Python loop over any axis of the grid (the single-step case of
    ``suite_axis_latency_grid``, which owns the stacked evaluation).
    Returns ``{axis: {alphas, ms, lam (n_ms,), lam_seconds
    (n_ms, n_alphas), Lam (n_ms, n_alphas)}}``.
    """
    return suite_axis_latency_grid({"step": per_axis}, alphas, ms,
                                   {"step": step_seconds})["step"]


def suite_axis_latency_grid(per_axis_by_step: Dict[str, Dict[str,
                                                             AxisSensitivity]],
                            alphas: Sequence[float],
                            ms: Sequence[int],
                            step_seconds: Dict[str, float]) -> dict:
    """Eq 3-4 grids for a whole *suite* of compiled steps in one stacked
    pass — the fabric-side analogue of ``suite_sweep_grid``.

    ``per_axis_by_step`` maps a step name (one compiled module / training
    step) to its per-axis sensitivities; ``step_seconds`` gives each
    step's measured duration.  Every (step, axis) pair is flattened into
    one segment axis and the full (step, axis, m, alpha) product is
    evaluated as a single broadcast expression — no Python loop over any
    grid axis — then regrouped per step.  Each step's table is
    bit-identical to ``axis_latency_grid(per_axis, alphas, ms,
    step_seconds[step])`` (the ops are elementwise, so stacking cannot
    change a bit).  Returns ``{step: {axis: {...}}}`` with the same leaf
    layout as ``axis_latency_grid``."""
    spec = SweepSpec.make(alphas, ms=ms)
    alphas = spec.alphas
    ms_arr = np.asarray(spec.ms, dtype=np.int64)
    rows = [(step, axis) for step, pa in per_axis_by_step.items()
            for axis in pa]
    if not rows:
        return {step: {} for step in per_axis_by_step}
    sens = [per_axis_by_step[s][a] for s, a in rows]
    W = np.array([x.W for x in sens], dtype=np.float64)
    D = np.array([x.D for x in sens], dtype=np.float64)
    base = np.maximum(
        np.array([step_seconds[s] for s, _ in rows]) -
        np.array([x.lam_seconds for x in sens]), 0.0)
    lam = lambda_abs(W[:, None], D[:, None], ms_arr[None, :])
    lam_seconds = lam[:, :, None] * alphas[None, None, :]
    denom = lam_seconds + base[:, None, None]
    Lam = np.divide(lam_seconds, denom,
                    out=np.zeros_like(denom), where=denom > 0)
    out: dict = {step: {} for step in per_axis_by_step}
    for i, (step, axis) in enumerate(rows):
        out[step][axis] = dict(alphas=alphas, ms=ms_arr, lam=lam[i],
                               lam_seconds=lam_seconds[i], Lam=Lam[i])
    return out


def object_sensitivity(g, object_vertices: Dict[str, np.ndarray],
                       m: int = 4,
                       alpha: float = 1.0) -> Dict[str, AxisSensitivity]:
    """Eq 3 per traced data object — the ranking key of the greedy
    disaggregation placement (``placement.search_placement``).

    The paper's axis trick at object granularity: object ``o``'s "memory
    accesses" are its own mem vertices, so ``W_o`` is its access count,
    ``D_o`` its chained depth (distinct levels of the one shared
    ``mem_layers`` pass restricted to ``o``'s vertices — levels that
    chain through *other* objects still count, which is exactly right:
    they serialize ``o``'s accesses too), and ``lambda_o = (W_o-D_o)/m +
    D_o`` approximates d(makespan)/d(alpha_o).  One level pass covers
    every object; each table entry is a closed-form broadcast.

    ``object_vertices`` maps object name -> vertex ids (e.g. from
    ``placement.objects_from_edag``); non-mem ids are ignored.  ``alpha``
    scales ``lam_seconds = lam * alpha`` (cycles here, not seconds —
    the field name follows the fabric-axis table it shares)."""
    g._finalize()
    lay = g.mem_layers()
    out: Dict[str, AxisSensitivity] = {}
    for name, vids in object_vertices.items():
        vids = np.asarray(vids, dtype=np.int64)
        mem_v = vids[g.is_mem[vids]] if len(vids) else vids
        W_o = int(len(mem_v))
        D_o = int(len(np.unique(lay.level[mem_v]))) if W_o else 0
        lam = lambda_abs(W_o, D_o, m) if W_o else 0.0
        out[name] = AxisSensitivity(
            axis=name, W=W_o, D=D_o,
            bytes=float(g.nbytes[mem_v].sum()) if W_o else 0.0,
            lam=lam, lam_seconds=lam * alpha)
    return out


def total_step_sensitivity(per_axis: Dict[str, AxisSensitivity],
                           step_seconds: float) -> dict:
    """Relative sensitivity per axis: Eq 4 with C = everything that is not
    this axis's collectives."""
    out = {}
    for axis, s in per_axis.items():
        C = max(step_seconds - s.lam_seconds, 0.0)
        # express alpha in seconds, so Lambda has units 1/second: the
        # fractional slowdown per second of added per-collective latency.
        out[axis] = lambda_rel(s.lam, s.lam_seconds / max(s.lam, 1e-12), C)
    return out
