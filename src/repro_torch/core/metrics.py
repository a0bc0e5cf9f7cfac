"""Latency-sensitivity and bandwidth metrics (§3.3.2-3.3.3, Eq 3-7)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .cost import CostModelParams, non_memory_cost
from .graph import EDag
from .plan import ExecPolicy, SweepSpec


# ------------------------------------------------------------------- Eq 3-4

def lambda_abs(W: float, D: float, m: int) -> float:
    """Eq 3: absolute memory latency sensitivity  (W-D)/m + D.

    Derivative of the Eq-2 upper bound w.r.t. alpha; equals
    W/m + (1-1/m)*D after rearranging (§3.3.2)."""
    return (W - D) / m + D


def lambda_rel(lam: float, alpha0: float, C: float) -> float:
    """Eq 4: relative sensitivity  Lambda = lambda / (lambda*alpha0 + C)."""
    denom = lam * alpha0 + C
    return lam / denom if denom > 0 else 0.0


# --------------------------------------------------------------------- Eq 5

def cost_vector(g: EDag, alpha, unit: float = 1.0) -> np.ndarray:
    """Per-vertex execution times: alpha for RAM accesses, unit otherwise.

    ``alpha`` may be a 1-D latency-class vector: memory vertex ``v``
    then costs ``alpha[classes[v]]`` per the eDAG's ``set_mem_classes``
    overlay (vertices without an overlay price as class 0)."""
    g._finalize()
    a = np.asarray(alpha, dtype=np.float64)
    if a.ndim == 1:
        cls = g.mem_class_column(len(a))
        return np.where(g.is_mem, a[cls], float(unit))
    return np.where(g.is_mem, float(alpha), float(unit))


def cost_matrix(g: EDag, alphas, unit: float = 1.0) -> np.ndarray:
    """(n_sweep, n) cost matrix: row i is ``cost_vector(g, alphas[i])``.

    A 2-D ``(n_sweep, n_classes)`` input prices each row as a
    latency-class vector against the eDAG's class overlay."""
    g._finalize()
    alphas = np.asarray(alphas, dtype=np.float64)
    if alphas.ndim == 2:
        cls = g.mem_class_column(alphas.shape[1])
        return np.where(g.is_mem[None, :], alphas[:, cls], float(unit))
    return np.where(g.is_mem[None, :], alphas[:, None], float(unit))


def t_inf_sweep(g: EDag, alphas, unit: float = 1.0,
                backend: Optional[str] = None,
                replay_dtype: Optional[str] = None, *,
                policy: Optional[ExecPolicy] = None) -> np.ndarray:
    """Span T-inf at every latency point in one level-synchronous pass.

    The whole alpha sweep is a single batched longest-path evaluation over
    the cost matrix — the vectorized replacement for re-running
    ``g.t_inf(cost_vector(g, a))`` once per point.  The pass runs on the
    policy's device under the replay dtype policy
    (``backend.replay_dtype_policy``) without changing a bit of the
    result."""
    pol = ExecPolicy.resolve(backend=backend, replay_dtype=replay_dtype,
                             policy=policy)
    g._finalize()
    if g.n_vertices == 0:
        return np.zeros(len(np.atleast_1d(alphas)))
    return g.t_inf_sweep_mem(alphas, unit, policy=pol)


def bandwidth_sweep(g: EDag, alphas, unit: float = 1.0,
                    cycles_per_second: float = 1e9,
                    backend: Optional[str] = None,
                    replay_dtype: Optional[str] = None, *,
                    policy: Optional[ExecPolicy] = None) -> np.ndarray:
    """Eq 5 bandwidth at every latency point, from one batched span pass."""
    pol = ExecPolicy.resolve(backend=backend, replay_dtype=replay_dtype,
                             policy=policy)
    g._finalize()
    t_inf = t_inf_sweep(g, alphas, unit, policy=pol)
    moved = float(g.nbytes[g.is_mem].sum())
    out = np.zeros_like(t_inf)
    np.divide(moved * cycles_per_second, t_inf, out=out, where=t_inf > 0)
    return out


def bandwidth_utilization(g: EDag, alpha: float, unit: float = 1.0,
                          cycles_per_second: float = 1e9) -> float:
    """Eq 5: B = sum_v w(v) / T_inf, in bytes/second at the given clock.

    Only RAM-touching traffic counts as moved data (cache hits stay on chip).
    The paper's tables report GB/s at 1 GHz (1 cycle == 1 ns)."""
    g._finalize()
    c = cost_vector(g, alpha, unit)
    t_inf = g.t_inf(c)
    if t_inf <= 0:
        return 0.0
    moved = float(g.nbytes[g.is_mem].sum())
    return moved / t_inf * cycles_per_second


# ------------------------------------------------------------------- Eq 6-7

def data_movement_over_time(g: EDag, alpha: float, tau: float = 1.0,
                            unit: float = 1.0):
    """Eq 6-7: stratify the greedy schedule into ceil(T_inf/tau) phases and
    sum the data moved by vertices active in each phase (Fig 9/15/16).

    Returns (phase_times, U) where U[i] is bytes in flight during phase i."""
    g._finalize()
    c = cost_vector(g, alpha, unit)
    S, F = g.start_finish(c)
    t_inf = float(F.max()) if len(F) else 0.0
    n_phases = int(np.ceil(t_inf / tau)) + 1
    U = np.zeros(n_phases + 1, dtype=np.float64)
    mem = g.is_mem
    w = g.nbytes
    # vertex v is active in phase i iff S(v) <= tau*i <= F(v)
    lo = np.ceil(S[mem] / tau).astype(np.int64)
    hi = np.floor(F[mem] / tau).astype(np.int64)
    wv = w[mem]
    # difference-array trick: +w at lo, -w after hi, then prefix sum
    np.add.at(U, lo, wv)
    np.add.at(U, np.minimum(hi + 1, n_phases), -wv)
    U = np.cumsum(U)[:n_phases]
    return np.arange(n_phases) * tau, U


# ------------------------------------------------------------------ summary

@dataclass
class Report:
    W: int
    D: int
    C: float
    lam: float
    Lam: float
    B_gbs: float
    t1: float
    t_inf: float
    parallelism: float
    layer_sizes: np.ndarray

    def row(self) -> dict:
        return dict(W=self.W, D=self.D, C=self.C, lam=self.lam, Lam=self.Lam,
                    B_gbs=self.B_gbs, t1=self.t1, t_inf=self.t_inf,
                    parallelism=self.parallelism)


def sweep_report(g: EDag, alphas, params: CostModelParams = CostModelParams(),
                 simulate_points: bool = False,
                 compute_slots: int = 0,
                 backend: Optional[str] = None,
                 mem_budget: Optional[int] = None,
                 use_cache: bool = True,
                 replay_dtype: Optional[str] = None, *,
                 policy: Optional[ExecPolicy] = None) -> dict:
    """Full latency sweep in one pass (§3.3 metrics per alpha point).

    The analytic quantities — T-inf, Eq-2 bounds, bandwidth, Lambda — come
    from ONE batched level-synchronous evaluation; W, D, C, lambda are
    alpha-independent and computed once.  With ``simulate_points=True`` the
    §4 ground-truth simulator runs as one batched schedule replay over the
    same cached CSR (bit-identical to the per-point reference engine).
    ``backend`` selects where the level passes run (cuda / cpu) for the
    analytic span/bandwidth passes and the simulator alike, as do
    ``replay_dtype`` (exact float64, or the default error-bounded float32
    mode with per-column float64 demotion — results are bit-identical
    under every policy), ``mem_budget`` (replay chunk bytes) and
    ``use_cache`` (schedule reuse within the process).
    """
    from .cost import non_memory_cost, total_cost_bounds
    from .scheduler import latency_sweep as _sim_sweep

    pol = ExecPolicy.resolve(backend=backend, replay_dtype=replay_dtype,
                             mem_budget=mem_budget, use_cache=use_cache,
                             policy=policy)
    g._finalize()
    alphas = np.asarray(alphas, dtype=np.float64)
    lay = g.mem_layers()
    C = non_memory_cost(g, params.unit)
    lam = lambda_abs(lay.W, lay.D, params.m)
    t_inf = t_inf_sweep(g, alphas, params.unit, policy=pol)
    B = bandwidth_sweep(g, alphas, params.unit, policy=pol)
    lo, hi = total_cost_bounds(lay.W, lay.D, params.m, alphas, C)
    denom = lam * alphas + C
    Lam = np.divide(lam, denom, out=np.zeros_like(denom), where=denom > 0)
    out = dict(alphas=alphas, W=lay.W, D=lay.D, C=C, lam=lam, Lam=Lam,
               t_inf=t_inf, t_lower=lo, t_upper=hi, B_gbs=B / 1e9)
    if simulate_points:
        out["simulated"] = _sim_sweep(g, alphas, m=params.m,
                                      unit=params.unit,
                                      compute_slots=compute_slots,
                                      policy=pol)
    return out


def grid_report(g: EDag, alphas, ms=(4,), compute_slots=(0,),
                params: CostModelParams = CostModelParams(),
                simulate_points: bool = False,
                backend: Optional[str] = None,
                mem_budget: Optional[int] = None,
                use_cache: bool = True,
                replay_dtype: Optional[str] = None, *,
                policy: Optional[ExecPolicy] = None) -> dict:
    """§3.3 metrics on the alpha × m grid — the analytic side of the
    capacity-planning sweep — plus, with ``simulate_points=True``, the §4
    simulated grid over the full alpha × m × compute_slots product.

    W, D and C are configuration-independent and computed once; the span
    ``t_inf`` depends only on alpha (unbounded parallelism) and comes
    from one batched level pass.  Everything that varies with m — Eq 3
    lambda, Eq 4 Lambda and the Eq 1-2 bounds — is evaluated over the
    whole (n_alphas, n_ms) grid as stacked numpy expressions, exactly
    equal to calling the scalar ``lambda_abs`` / ``total_cost_bounds``
    per point.  The simulated grid rides ``scheduler.sweep_grid`` (one
    recorded schedule per (m, compute_slots) pair, shared finalize,
    in-process schedule reuse, memory-budget chunking).

    Returns ``dict(alphas, ms, compute_slots, W, D, C, lam (n_ms,),
    t_inf (n_alphas,), t_lower/t_upper/Lam (n_alphas, n_ms), and
    simulated (n_alphas, n_ms, n_compute_slots) when requested)``.

    A 2-D ``(P, n_classes)`` alpha matrix evaluates latency-class
    vectors against the eDAG's ``set_mem_classes`` overlay: ``t_inf``
    and ``simulated`` price each vertex by its own class exactly, while
    the closed-form Eq 1-2 bounds bracket *any* per-vertex assignment —
    ``t_lower`` uses each row's smallest class alpha, ``t_upper`` (and
    the Eq 4 Lambda built on it) its largest.
    """
    from .cost import non_memory_cost
    from .scheduler import _sweep_grid_spec

    pol = ExecPolicy.resolve(backend=backend, replay_dtype=replay_dtype,
                             mem_budget=mem_budget, use_cache=use_cache,
                             policy=policy)
    spec = SweepSpec.make(alphas, ms=ms, compute_slots=compute_slots,
                          unit=params.unit)
    g._finalize()
    alphas = spec.alphas
    ms_arr = np.asarray(spec.ms, dtype=np.int64)
    css = np.asarray(spec.css, dtype=np.int64)
    lay = g.mem_layers()
    W, D = lay.W, lay.D
    C = non_memory_cost(g, params.unit)
    lam = lambda_abs(W, D, ms_arr)                         # Eq 3, per m
    t_inf = t_inf_sweep(g, alphas, params.unit, policy=pol)
    if alphas.ndim == 2:
        # class rows: the scalar bounds hold at the extreme class alphas
        # of each row, bracketing every per-vertex class assignment
        if alphas.shape[1]:
            a_lo, a_hi = alphas.min(axis=1), alphas.max(axis=1)
        else:
            a_lo = a_hi = np.zeros(len(alphas))
    else:
        a_lo = a_hi = alphas
    # Eq 1-2 bounds and Eq 4 Lambda over the (alpha, m) grid in one shot
    mem_lo = np.maximum(D, W / ms_arr)[None, :] * a_lo[:, None]
    mem_hi = lam[None, :] * a_hi[:, None]
    denom = mem_hi + C
    Lam = np.divide(lam[None, :], denom,
                    out=np.zeros_like(denom), where=denom > 0)
    out = dict(alphas=alphas, ms=ms_arr, compute_slots=css,
               W=W, D=D, C=C, lam=lam, Lam=Lam, t_inf=t_inf,
               t_lower=mem_lo + C, t_upper=mem_hi + C)
    if simulate_points:
        out["simulated"] = _sweep_grid_spec(g, spec, pol)
    return out


def suite_grid_report(suite, alphas, ms=(4,), compute_slots=(0,),
                      params: CostModelParams = CostModelParams(),
                      simulate_points: bool = False,
                      backend: Optional[str] = None,
                      mem_budget: Optional[int] = None,
                      use_cache: bool = True,
                      replay_dtype: Optional[str] = None, *,
                      policy: Optional[ExecPolicy] = None) -> dict:
    """§3.3 metrics for a whole ``EDagSuite`` on the alpha × m grid:
    per-trace Eq 1-4 tables from one pass over the block-diagonal union.

    The union's memory layering is one level pass (the blocks are
    disconnected, so member layers come out bit-identical); per-trace W, D
    and C are segmented reductions over the members' boundaries, the span
    sweep is one union-batched pass (``suite_t_inf_sweep``), and the Eq 1-4
    grid is one broadcast over the (trace, alpha, m) product.  Every
    per-trace table equals ``grid_report(member_k, ...)`` exactly.

    Returns ``dict(names, alphas, ms, compute_slots, W/D/C (K,), lam (K,
    n_ms), t_inf (K, n_alphas), t_lower/t_upper/Lam (K, n_alphas, n_ms),
    and simulated (K, n_alphas, n_ms, n_css) when requested)``."""
    from .suite import _suite_sweep_grid_spec, suite_t_inf_sweep

    pol = ExecPolicy.resolve(backend=backend, replay_dtype=replay_dtype,
                             mem_budget=mem_budget, use_cache=use_cache,
                             policy=policy)
    spec = SweepSpec.make(alphas, ms=ms, compute_slots=compute_slots,
                          unit=params.unit)
    alphas = spec.alphas
    ms_arr = np.asarray(spec.ms, dtype=np.int64)
    css = np.asarray(spec.css, dtype=np.int64)
    K = suite.n_traces
    if K and suite.n_vertices:
        u = suite.union
        lay = u.mem_layers()                       # one union level pass
        W = suite.segment_sum(u.is_mem.astype(np.float64)).astype(np.int64)
        D = suite.segment_max(lay.level).astype(np.int64)
        counts = np.diff(suite.offsets)
        C = (counts - W) * params.unit
        t_inf = suite_t_inf_sweep(suite, alphas, params.unit, policy=pol)
    else:
        W = D = np.zeros(K, dtype=np.int64)
        C = np.zeros(K)
        t_inf = np.zeros((K, len(alphas)))
    lam = lambda_abs(W[:, None].astype(np.float64), D[:, None], ms_arr)
    if alphas.ndim == 2:
        # class rows bracket per-vertex assignments (see grid_report)
        if alphas.shape[1]:
            a_lo, a_hi = alphas.min(axis=1), alphas.max(axis=1)
        else:
            a_lo = a_hi = np.zeros(len(alphas))
    else:
        a_lo = a_hi = alphas
    # Eq 1-2 bounds and Eq 4 Lambda over the (trace, alpha, m) grid
    mem_lo = np.maximum(D[:, None], W[:, None] / ms_arr)[:, None, :] * \
        a_lo[None, :, None]
    mem_hi = lam[:, None, :] * a_hi[None, :, None]
    denom = mem_hi + C[:, None, None]
    Lam = np.divide(lam[:, None, :], denom,
                    out=np.zeros_like(denom), where=denom > 0)
    out = dict(names=list(suite.names), alphas=alphas, ms=ms_arr,
               compute_slots=css, W=W, D=D, C=C, lam=lam, Lam=Lam,
               t_inf=t_inf, t_lower=mem_lo + C[:, None, None],
               t_upper=mem_hi + C[:, None, None])
    if simulate_points:
        out["simulated"] = _suite_sweep_grid_spec(suite, spec, pol)
    return out


def report(g: EDag, params: CostModelParams = CostModelParams()) -> Report:
    """One-stop §3.3 report for an eDAG: W, D, C, lambda, Lambda, B."""
    lay = g.mem_layers()
    C = non_memory_cost(g, params.unit)
    lam = lambda_abs(lay.W, lay.D, params.m)
    Lam = lambda_rel(lam, params.alpha0, C)
    B = bandwidth_utilization(g, params.alpha, params.unit) / 1e9
    c = cost_vector(g, params.alpha, params.unit)
    t_inf = g.t_inf(c)
    t1 = float(c.sum())
    return Report(W=lay.W, D=lay.D, C=C, lam=lam, Lam=Lam, B_gbs=B,
                  t1=t1, t_inf=t_inf,
                  parallelism=t1 / t_inf if t_inf else 0.0,
                  layer_sizes=lay.layer_sizes)
