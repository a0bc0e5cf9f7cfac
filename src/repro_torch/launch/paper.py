"""The paper's figures and tables through the port: figs 9–13, tables 1–2.

Mirrors the reference package's benchmark runner (``benchmarks/run.py``):
the same workloads at the paper's sizes (``configs/paper_suite.py``), the
same CSV rows ``name,us_per_call,derived`` and the same detail lines, so
the derived columns (W, D, λ, Λ, B, the rank matches) can be compared line
by line.  Each figure also returns its values at full precision
(``results``), which ``chip_smoke.py`` holds against
``configs/paper_expected.json``.

Usage::

    python -m repro_torch.launch.paper [--only fig09,fig10_11,...] [--full]

The device and the replay dtype policy come from the environment, as
everywhere in the port: ``$EDAN_TORCH_BACKEND`` (``cuda`` by default, or
``cpu``) and ``$EDAN_X64`` / ``$EDAN_REPLAY_DTYPE``.

Every figure takes an ``api`` namespace of engine entry points
(``port_api()`` by default) and a ``policy`` for the sweeps, so the same
figure code can be fed by the JAX package's engine too (the tests do).
"""
from __future__ import annotations

import argparse
import hashlib
import time
from types import SimpleNamespace

import numpy as np

from ..configs.paper_suite import (ANALYSIS, HPCG_ITERS, HPCG_N, LULESH_ITERS,
                                   LULESH_NE, POLYBENCH_N, SIM_COMPUTE_SLOTS)

#: fig 13's extra kernels (beside PAPER_15), sizes and register-pressure rows
FIG13_EXTRA = ["trmm_spill", "cholesky", "durbin"]
FIG13_REG_PRESSURE = (("trmm", 3), ("trmm", 8))
FIG13_SIZES = (6, 10, 14, 18)
FIGURES = ("fig09", "fig10_11", "fig12", "fig13", "table1", "table2")


def port_api() -> SimpleNamespace:
    """The port's engine entry points, as the figures call them."""
    from ..apps import hpcg, lulesh, polybench
    from ..core import (CostModelParams, data_movement_over_time, lambda_rel,
                        make_cache, report, sweep_report)
    return SimpleNamespace(
        polybench=polybench, hpcg=hpcg, lulesh=lulesh, make_cache=make_cache,
        data_movement_over_time=data_movement_over_time,
        sweep_report=sweep_report, report=report,
        CostModelParams=CostModelParams, lambda_rel=lambda_rel)


def spearman(a, b) -> float:
    """Spearman rank correlation without scipy."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    ra = np.argsort(np.argsort(a)).astype(float)
    rb = np.argsort(np.argsort(b)).astype(float)
    ra -= ra.mean()
    rb -= rb.mean()
    den = np.sqrt((ra ** 2).sum() * (rb ** 2).sum())
    return float((ra * rb).sum() / den) if den else 0.0


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a, dtype=np.float64)
                          .tobytes()).hexdigest()


def _peaks(U, frac=0.5) -> int:
    """Bursts above frac*max (the paper counts one per iteration)."""
    th = U.max() * frac
    above = U > th
    return int(np.sum(above[1:] & ~above[:-1]))


def _dm(t, U, frac) -> dict:
    return dict(T_inf=float(t[-1]), peak_bytes=float(U.max()),
                mean_bytes=float(U.mean()), bursts=_peaks(U, frac),
                U_sha256=_sha(U))


# ------------------------------------------------------------------ figures

def fig09(api, policy=None) -> dict:
    """Fig 9/15/16: data movement over time (lu N=32 tau=1; HPCG and
    LULESH under each cache size, tau=100)."""
    g = api.polybench.trace_kernel("lu", 32)
    t, U = api.data_movement_over_time(g, alpha=ANALYSIS.alpha_mem, tau=1.0)
    out = dict(lu=_dm(t, U, 0.3), apps=[])
    for app in ("hpcg", "lulesh"):
        for cs in ANALYSIS.cache_sizes:
            if app == "hpcg":
                g, _ = api.hpcg.trace_cg(n=HPCG_N, iters=HPCG_ITERS,
                                         cache=api.make_cache(cs))
            else:
                g = api.lulesh.trace_step(ne=LULESH_NE, iters=LULESH_ITERS,
                                          cache=api.make_cache(cs))
            t, U = api.data_movement_over_time(g, alpha=ANALYSIS.alpha_mem,
                                               tau=ANALYSIS.tau)
            out["apps"].append(dict(app=app, cache=cs, **_dm(t, U, 0.5)))
    return out


def _rank_rows(names, truth_key: dict, pred_key: dict):
    truth = sorted(names, key=lambda n: -truth_key[n])
    pred = sorted(names, key=lambda n: -pred_key[n])
    t_rank = {n: i for i, n in enumerate(truth)}
    p_rank = {n: i for i, n in enumerate(pred)}
    return t_rank, p_rank, [abs(t_rank[n] - p_rank[n]) for n in names]


def fig10_11(api, policy=None, full_sweep: bool = False,
             N: int = POLYBENCH_N, m: int = 4) -> dict:
    """Fig 10-11: rank the 15 kernels by mean simulated runtime and by
    lambda (m=4) over the latency sweep."""
    alphas = (ANALYSIS.alpha_sweep_full if full_sweep
              else ANALYSIS.alpha_sweep)
    names = api.polybench.PAPER_15
    params = api.CostModelParams(m=m)
    sim_mean, lam, per = {}, {}, {}
    for name in names:
        g = api.polybench.trace_kernel(name, N)
        rep = api.sweep_report(g, alphas, params=params, simulate_points=True,
                               compute_slots=SIM_COMPUTE_SLOTS, policy=policy)
        lam[name] = float(rep["lam"])
        sim_mean[name] = float(np.mean(rep["simulated"]))
        per[name] = dict(simulated=[float(v) for v in rep["simulated"]],
                         t_inf=[float(v) for v in rep["t_inf"]],
                         Lam=[float(v) for v in rep["Lam"]],
                         B_gbs=[float(v) for v in rep["B_gbs"]])
    t_rank, p_rank, dists = _rank_rows(names, sim_mean, lam)
    rows = [dict(kernel=n, sim_rank=t_rank[n], lambda_rank=p_rank[n],
                 lam=lam[n], sim_mean=sim_mean[n], **per[n]) for n in names]
    return dict(rows=rows, exact=sum(d == 0 for d in dists),
                max_dist=max(dists), mean_dist=float(np.mean(dists)),
                spearman=spearman([sim_mean[n] for n in names],
                                  [lam[n] for n in names]))


def fig12(api, policy=None, full_sweep: bool = False,
          N: int = POLYBENCH_N, m: int = 4) -> dict:
    """Fig 12: rank by mean relative slowdown against the alpha0 baseline
    and by Lambda; the W/C > 0.3 split."""
    alphas = np.asarray(ANALYSIS.alpha_sweep_full if full_sweep
                        else ANALYSIS.alpha_sweep, float)
    names = api.polybench.PAPER_15
    params = api.CostModelParams(m=m)
    rel_slow, Lam, wc = {}, {}, {}
    for name in names:
        g = api.polybench.trace_kernel(name, N)
        rep = api.sweep_report(g, alphas, params=params, simulate_points=True,
                               compute_slots=SIM_COMPUTE_SLOTS, policy=policy)
        C = rep["C"]
        Lam[name] = float(api.lambda_rel(rep["lam"], ANALYSIS.alpha0, C))
        wc[name] = float(rep["W"] / max(C, 1))
        times = rep["simulated"]
        rel_slow[name] = float(np.mean(times / times[0] - 1.0))
    t_rank, p_rank, dists = _rank_rows(names, rel_slow, Lam)
    hi_d = [abs(t_rank[n] - p_rank[n]) for n in names if wc[n] > 0.3]
    return dict(
        rows=[dict(kernel=n, sim_rank=t_rank[n], Lambda_rank=p_rank[n],
                   Lam=Lam[n], rel_slow=rel_slow[n], w_over_c=wc[n])
              for n in names],
        exact=sum(d == 0 for d in dists),
        mean_dist=float(np.mean(dists)),
        mean_dist_high_wc=float(np.mean(hi_d)) if hi_d else None,
        n_high_wc=len(hi_d),
        spearman=spearman([rel_slow[n] for n in names],
                          [Lam[n] for n in names]))


def fig13(api, policy=None) -> dict:
    """Fig 13: memory depth D against data size N."""
    out = {}
    for name in api.polybench.PAPER_15 + FIG13_EXTRA:
        out[name] = [int(api.polybench.trace_kernel(name, N).mem_layers().D)
                     for N in FIG13_SIZES]
    for name, regs in FIG13_REG_PRESSURE:
        out[f"{name}@regs{regs}"] = [
            int(api.polybench.trace_kernel(name, N, max_regs=regs)
                .mem_layers().D) for N in FIG13_SIZES]
    return out


def _cache_table(api, trace) -> list:
    rows, base = [], None
    for cs in ANALYSIS.cache_sizes:
        g = trace(api.make_cache(cs, ANALYSIS.cache_line, ANALYSIS.cache_ways))
        r = api.report(g, api.CostModelParams(
            m=ANALYSIS.m, alpha=ANALYSIS.alpha_mem, alpha0=1.0))
        row = dict(cache=cs, W=int(r.W), D=int(r.D), lam=float(r.lam),
                   Lam=float(r.Lam), B_gbs=float(r.B_gbs),
                   t_inf=float(r.t_inf), t1=float(r.t1))
        if base is None:
            base = row
        for key in ("W", "D", "lam", "Lam"):
            row[f"{key}_red"] = (float((1 - row[key] / base[key]) * 100)
                                 if base[key] else 0.0)
        rows.append(row)
    return rows


def table1(api, policy=None) -> list:
    """Table 1: HPCG CG under each cache configuration."""
    return _cache_table(api, lambda c: api.hpcg.trace_cg(
        n=HPCG_N, iters=HPCG_ITERS, cache=c)[0])


def table2(api, policy=None) -> list:
    """Table 2: the LULESH proxy under each cache configuration."""
    return _cache_table(api, lambda c: api.lulesh.trace_step(
        ne=LULESH_NE, iters=LULESH_ITERS, cache=c))


# ----------------------------------------------------------------- printing

def derived(name: str, res) -> str:
    """The ``derived`` column of the reference runner's CSV row."""
    if name == "fig09":
        return f"lu_peak_bytes={res['lu']['peak_bytes']:.0f}"
    if name == "fig10_11":
        return (f"exact={res['exact']}/15;mean_dist={res['mean_dist']:.2f};"
                f"spearman={res['spearman']:.3f}")
    if name == "fig12":
        return (f"exact={res['exact']}/15;mean_dist={res['mean_dist']:.2f};"
                f"high_WC_dist={res['mean_dist_high_wc']}")
    if name == "fig13":
        return ("const=" + str(sum(1 for v in res.values()
                                   if len(set(v)) == 1)) +
                f"/{len(res)};trmm_spill=" +
                "-".join(map(str, res["trmm_spill"])))
    if name == "table1":
        return (f"W_red32k={res[1]['W_red']:.0f}%;"
                f"lam_red32k={res[1]['lam_red']:.0f}%")
    if name == "table2":
        return (f"W_red32k={res[1]['W_red']:.0f}%;"
                f"D_red32k={res[1]['D_red']:.0f}%")
    raise KeyError(name)


ROW_NAMES = dict(fig09="fig09_15_16_data_movement",
                 fig10_11="fig10_11_lambda_ranking",
                 fig12="fig12_Lambda_ranking", fig13="fig13_depth_vs_N",
                 table1="table1_hpcg_cache", table2="table2_lulesh_cache")


def detail_lines(name: str, res) -> list:
    """The indented detail lines the reference runner prints under a row."""
    if name == "fig09":
        lu = res["lu"]
        out = [f"lu_n32,tau=1,T_inf={lu['T_inf']:.0f},"
               f"peak_bytes={lu['peak_bytes']:.0f},bursts={lu['bursts']}"]
        for r in res["apps"]:
            iters = HPCG_ITERS if r["app"] == "hpcg" else LULESH_ITERS
            out.append(f"{r['app']},cache={r['cache']},T_inf={r['T_inf']:.0f},"
                       f"peak_bytes={r['peak_bytes']:.0f},"
                       f"mean_bytes={r['mean_bytes']:.1f},"
                       f"bursts>half-peak={r['bursts']} "
                       f"(expect ~{iters} bursts)")
        return ["  " + line for line in out]
    if name == "fig10_11":
        return [f"  {r['kernel']},sim={r['sim_rank']},lam={r['lambda_rank']}"
                for r in sorted(res["rows"], key=lambda r: r["sim_rank"])]
    if name in ("table1", "table2"):
        return [f"  cache={r['cache']},W={r['W']},D={r['D']},"
                f"lam={r['lam']:.0f},Lam={r['Lam']:.4f},B={r['B_gbs']:.2f}GB/s"
                for r in res]
    return []


_FIGS = dict(fig09=fig09, fig10_11=fig10_11, fig12=fig12, fig13=fig13,
             table1=table1, table2=table2)


def run(figures=FIGURES, api=None, policy=None, full_sweep: bool = False,
        emit=print) -> dict:
    """Run ``figures`` in order, emitting each CSV row and its detail
    lines as it completes; returns ``{figure: results}``."""
    api = api or port_api()
    out = {}
    for name in figures:
        t0 = time.time()
        if name in ("fig10_11", "fig12"):
            res = _FIGS[name](api, policy, full_sweep=full_sweep)
        else:
            res = _FIGS[name](api, policy)
        us = (time.time() - t0) * 1e6
        emit(f"{ROW_NAMES[name]},{us:.0f},{derived(name, res)}")
        for line in detail_lines(name, res):
            emit(line)
        out[name] = res
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=",".join(FIGURES),
                    help="comma-separated subset of " + ",".join(FIGURES))
    ap.add_argument("--full", action="store_true",
                    help="paper-fidelity latency sweep (5ns steps)")
    args = ap.parse_args(argv)
    figures = [f for f in args.only.split(",") if f]
    unknown = sorted(set(figures) - set(FIGURES))
    if unknown:
        raise SystemExit(f"unknown figures {unknown}; pick from {FIGURES}")
    print("name,us_per_call,derived")
    return run(figures, full_sweep=args.full)


if __name__ == "__main__":
    main()
